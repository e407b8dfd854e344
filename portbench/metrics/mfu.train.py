"""Model FLOPs of the window's updates (remat recompute not counted) over its
seconds, % of the bf16 peak."""

from portbench import readers


def read(m):
    return readers.mfu(m, "pretrain")

"""Forward FLOPs of the window's clips over its seconds, % of the bf16 peak."""

from portbench import readers


def read(m):
    return readers.mfu(m, "serve_video")

"""Clips of all updates completed in the window over its seconds."""

from portbench import readers


def read(m):
    return readers.rate(m, "pretrain")

"""Clips of all requests completed in the window over its seconds."""

from portbench import readers


def read(m):
    return readers.rate(m, "serve_video")

"""The 90th percentile of every request's latency in the window, ms."""

from portbench import readers


def read(m):
    return readers.p90_ms(m, "serve_video")

"""Bound of the traced requests' attention over the device time of the kernels
its calls launched, %."""

from portbench import readers


def read(m):
    return readers.roofline(m, "serve_video", "portbench.attn", "attn_bound_ms")

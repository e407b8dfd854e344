"""Bound of the traced requests' fused fc1 + GELU over the device time of the
kernels its calls launched, %."""

from portbench import readers


def read(m):
    return readers.roofline(m, "serve_video", "portbench.fc1", "fc1_bound_ms")

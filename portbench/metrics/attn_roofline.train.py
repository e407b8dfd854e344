"""Bound of the traced updates' attention, forward and backward, over the device
time of the kernels its calls launched, %."""

from portbench import readers


def read(m):
    return readers.roofline(m, "pretrain", "portbench.attn", "attn_bound_ms")

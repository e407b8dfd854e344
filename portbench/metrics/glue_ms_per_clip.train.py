"""Device ms a clip of the kernels launched neither by attention, fc1 nor a
matmul op, in the traced updates."""

from portbench import readers


def read(m):
    return readers.kernel_ms_per_item(m, "pretrain", "glue")

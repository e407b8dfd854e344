"""torch.cuda.max_memory_allocated over the window, GiB."""

from portbench import readers


def read(m):
    return readers.peak_gib(m, "serve_video")

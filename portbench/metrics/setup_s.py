"""Process start to the first timed moment: imports, the kernel library's
load (or build), weights and inputs, warm-up."""


def read(m):
    return m["setup_s"]

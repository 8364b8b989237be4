"""Seconds from the process's start to the window's: imports, the CUDA
context, the program's kernels loaded (built, on a checkout's first run),
the inputs made from the seed, the warm-up calls."""


def read(rec):
    return rec.setup_s

"""Device milliseconds a call in work that is not one of the program's own
kernels: PyTorch's kernels, cuBLAS, copies and memsets, which the panel
sweep and the batched solver API run around the kernels."""


def read(rec):
    t = rec.trace
    return None if t is None else 1e3 * t["glue_s"] / rec.calls

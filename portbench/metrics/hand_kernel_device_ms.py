"""Device milliseconds a call in the program's own kernels (the
``__global__`` functions of ``m4ri_tpu_torch/csrc/``)."""


def read(rec):
    t = rec.trace
    if t is None or not t["own_launches"]:
        return None
    return 1e3 * t["own_s"] / rec.calls

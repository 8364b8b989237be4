"""Launches a call of the program's own kernels, counted in the trace."""


def read(rec):
    t = rec.trace
    if t is None or not t["own_launches"]:
        return None
    return t["own_launches"] / rec.calls

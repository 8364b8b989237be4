"""Share of the traced window in which nothing ran on the device: one
less the union of the device's kernels, copies and memsets over the
window's span, from the window's own trace."""


def read(rec):
    t = rec.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

"""95th percentile of the time of every call in the window, each taken on
the device's clock by CUDA events recorded before and after the call (the
host's clock is too coarse for calls of a few milliseconds)."""

from portbench.timeline import p95


def read(rec):
    return p95(rec.call_ms) if rec.call_ms else None

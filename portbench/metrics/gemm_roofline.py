"""The least time of a call's GF(2) products on one H100 (``peaks``: the
larger of the operations at the 1-bit peak and the bytes at the memory
peak) over the call's device busy time.  Only where the entry names its
products (``work["gemm"]``)."""

from portbench.peaks import gemm_least_s


def read(rec):
    t = rec.trace
    shapes = rec.work.get("gemm")
    if t is None or not shapes or t["busy_s"] <= 0:
        return None
    least = sum(gemm_least_s(m, k, n) for m, k, n in shapes)
    return 100.0 * least / (t["busy_s"] / rec.calls)

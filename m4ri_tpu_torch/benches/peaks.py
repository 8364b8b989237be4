"""Peaks of one H100 SXM and the least time of the Schur update, for the
bounds that ``chip_smoke.py`` and the benches print beside measured times.

NVIDIA's data sheet gives the memory rate and the dense int8 tensor-core
rate (1,979 TOP/s) and no 1-bit rate.  The kernels run the 1-bit instruction
(m16n8k256), which issues at the rate of the s8 one (m16n8k32) and contracts
8 times as many elements, so the operand type's peak is taken as 8 times the
int8 one.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_B1_OPS_PER_S = 8 * 1979e12
# 32-bit operations outside the tensor cores (an XOR of two words is one):
# the data sheet's float32 rate, 67 TFLOP/s, for want of an integer one
PEAK_ALU32_OPS_PER_S = 67e12
# shared-memory loads of a 4-byte word: 32 banks a clock an SM, 132 SMs at
# the 1,980 MHz boost clock
PEAK_SMEM_WORDS_PER_S = 32 * 132 * 1.98e9


def schur_bound(m: int, k: int, nw: int, r0: int, c0w: int, skip_words: int = 0) -> dict:
    """Least time of one Schur update C[m, nw words] ^= Lp[m, k] Up[k, nw]
    under the bounds (r0, c0w): only the exact active rectangle counts, rows
    >= r0 and words >= max(c0w, skip_words), whatever tile a kernel uses.
    Bytes: that part of C read and written, its rows of Lp and its words of
    Up read once.  Operations: 2 per bit of the rectangle and of the
    contraction, at the 1-bit peak."""
    rows = max(0, m - max(r0, 0))
    words = max(0, nw - max(c0w, skip_words, 0))
    if rows == 0 or words == 0:
        rows = words = 0
    kw = (k + 31) // 32
    t_bytes = 4 * (2 * rows * words + rows * kw + k * words) / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * rows * k * words * 32 / PEAK_B1_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "active_rows": rows, "active_words": words}

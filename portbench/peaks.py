"""Peaks of one NVIDIA H100 SXM (80 GB HBM3) and the least time of a GF(2)
product, frozen here so that no later change to the program moves them.

- Memory: 3.35 TB/s, NVIDIA's data sheet.
- 1-bit operations: the data sheet gives the dense int8 tensor-core rate,
  1,979 TOP/s, and no 1-bit rate.  The GF(2) kernels run the 1-bit MMA
  (m16n8k256, AND and popcount), which issues at the rate of the int8 one
  (m16n8k32) and contracts 8 times as many elements, so the 1-bit peak is
  taken as 8 x 1,979 TOP/s.  A probe of the 1-bit ``wgmma`` on an H100 at
  700 W measured 15,544 Tbit-op/s against this 15,832 (PERF.md), so the
  inference is not too low.  Copied from the program's
  ``m4ri_tpu_torch/benches/peaks.py``.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_B1_OPS_PER_S = 8 * 1979e12
WORD_BYTES = 4


def gemm_least_s(m: int, k: int, n: int) -> float:
    """Least time of C[m, n] = A[m, k] B[k, n] over GF(2) on one H100: the
    larger of 2 m k n bit operations at the 1-bit peak and A, B and C
    (packed, 32 columns a word) each moved once at the memory peak.  The
    count is the direct product's; a route with fewer operations, such as
    Strassen-Winograd, would need a new count here."""
    words = lambda rows, cols: rows * -(-cols // 32)  # noqa: E731
    nbytes = WORD_BYTES * (words(m, k) + words(k, n) + words(m, n))
    return max(2 * m * k * n / PEAK_B1_OPS_PER_S, nbytes / PEAK_BYTES_PER_S)

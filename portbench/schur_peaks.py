"""The least time of one Schur update C ^= Lp Up on one H100, from the
operands a ``kernel.gf2_schur_update_hopper`` span records: frozen here
from the program's ``m4ri_tpu_torch/benches/peaks.py::schur_bound`` so that
no later change to the program moves it.

Only the exact active rectangle counts (rows >= r0, words >= max(c0w, the
skipped column tiles)), whatever tile a kernel uses, so a kernel can meet
the bound and never beat it.  Bytes: that part of C read and written, its
rows of Lp and its words of Up read once, at the memory peak.  Operations:
2 per bit of the rectangle and of the contraction, at the 1-bit peak.
"""

from __future__ import annotations

from .peaks import PEAK_B1_OPS_PER_S, PEAK_BYTES_PER_S, WORD_BYTES

TILE_WORDS = 8    # a Schur tile's words (TW of csrc/gf2_schur_hopper.cu)


def schur_least_s(m: int, k: int, nw: int, r0: int, c0w: int,
                  skip_words: int = 0) -> float:
    """Least seconds of C[m, nw words] ^= Lp[m, k bits] Up[k, nw words]
    under the bounds (r0, c0w)."""
    rows = max(0, m - max(r0, 0))
    words = max(0, nw - max(c0w, skip_words, 0))
    if rows == 0 or words == 0:
        return 0.0
    kw = (k + 31) // 32
    nbytes = WORD_BYTES * (2 * rows * words + rows * kw + k * words)
    return max(nbytes / PEAK_BYTES_PER_S,
               2 * rows * k * words * 32 / PEAK_B1_OPS_PER_S)


def span_least_s(attrs: dict):
    """``schur_least_s`` of a span's attributes; None where the program
    passed a bound as a tensor (the span then has no value for it)."""
    if attrs.get("r0") is None or attrs.get("c0w") is None:
        return None
    return schur_least_s(attrs["m"], attrs["k"], attrs["nw"], attrs["r0"],
                         attrs["c0w"],
                         attrs.get("col_tile_skip", 0) * TILE_WORDS)

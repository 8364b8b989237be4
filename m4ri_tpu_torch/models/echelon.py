"""Echelon-form entry points built on the panel factorization.

Reference analogue: echelonform.c, brilliantrussian.c.  Only ``rank`` is
here so far; ``echelonize``, ``top_echelonize`` and ``invert`` need the
triangular solves of models/triangular.py and arrive with it.
"""

from __future__ import annotations

from ..core.bitmatrix import BitMatrix
from .ple import block_factor

__all__ = ["rank"]


def rank(a: BitMatrix, nb: int | None = None) -> int:
    """Rank of ``a``: the number of pivots of the panel factorization
    (reference: the return value of mzd_echelonize, echelonform.c:26)."""
    _, _, _, r = block_factor(a, preserve_l=False, nb=nb)
    return r

"""Triangular solve (TRSM, 4 variants) and triangular inverse (TRTRI).

Reference analogue: triangular.c (recursive 2x2 TRSM in all four
upper/lower x left/right variants, base cases via parity dot products or
Gray-code tables, triangular_russian.c) and mzd_trtri_upper
(triangular.c:518-546).

Over GF(2) an invertible triangular matrix is unit triangular, T = I + N
with N strictly triangular and nilpotent.  The JAX package inverts the base
blocks as T^{-1} = prod_k (I + N^(2^k)), log2(n) products; here a base
block is one call of ``ops/hopper_trinv.py::unit_tri_inv_hopper``, a
blocked back-substitution on the packed words (one launch a batch of blocks
on the card, the same steps in plain PyTorch on the CPU).  TRTRI recurses
2x2 on word-aligned halves ([A B; 0 D]^{-1} = [Ai, Ai B Di; 0, Di]).  TRSM
substitutes 2x2 blockwise down to ``Config.trsm_base`` (``trsm_wide_base``
when B is at least a quarter as wide as T), then multiplies by the block's
inverse.  The large products go through ``ops/mul.py::mul``, so on the card
through the GF(2) GEMM kernel and Strassen.  Blocks are views of their
parent (every split is on a word boundary); nothing writes to an argument.

The recursion indexes the last two axes only, so a stack of matrices
(``BitMatrix`` with data ``[B, rows, words]``) runs through it unchanged when
``mul_fn`` multiplies stacks: models/batched_solve.py passes
``mul_packed_batched`` and so gets every element's TRSM / TRTRI on the same
static splits.
"""

from __future__ import annotations

import torch

from ..core.bitmatrix import BitMatrix, mask_padding, width_for
from ..core.bitops import _triangle_mask
from ..ops.hopper_trinv import unit_tri_inv_hopper
from ..ops.mul import mul
from ..utils.config import WORD_BITS, get_config

__all__ = ["trtri_upper", "trtri_lower", "trsm_upper_left",
           "trsm_lower_left", "trsm_upper_right", "trsm_lower_right"]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _clean_tri(t: BitMatrix, upper: bool) -> BitMatrix:
    """Mask the input to the relevant (inclusive) triangle.  The reference
    TRSM/TRTRI routines only ever *read* that triangle (e.g.
    _mzd_trsm_upper_right_trtri first takes mzd_extract_u, and
    mzd_pluq_solve_left hands the combined L\\U in-place matrix straight to
    TRSM), so junk in the opposite triangle must not leak into the
    inverse."""
    return BitMatrix(t.data & _triangle_mask(t.ncols, upper, t.device),
                     t.ncols)


def _block(t: BitMatrix, r0: int, c0: int, r1: int, c1: int) -> BitMatrix:
    """Rows [r0, r1) x columns [c0, c1) as a view; c0 is a multiple of 32
    and c1 too, or the last column, so the padding bits stay zero."""
    assert c0 % WORD_BITS == 0 and (c1 % WORD_BITS == 0 or c1 == t.ncols)
    return BitMatrix(t.data[..., r0:r1, c0 // WORD_BITS: width_for(c1)],
                     c1 - c0)


def _split(n: int) -> int:
    return _round_up(n // 2, WORD_BITS)


def _trtri(t: BitMatrix, upper: bool, mul_fn=mul, cfg=None) -> BitMatrix:
    """2x2 word-aligned recursion.  ``mul_fn`` makes the block products:
    the distributed layer passes its mesh product (parallel/dist_solve.py),
    the batched one ``mul_packed_batched`` (models/batched_solve.py)."""
    cfg = cfg or get_config()
    n = t.ncols
    assert t.nrows == n
    if n <= cfg.trsm_base:
        # the base block's words as they are, its diagonal read as ones
        return mask_padding(BitMatrix(unit_tri_inv_hopper(t.data, upper), n))
    n1 = _split(n)
    w1 = n1 // WORD_BITS
    ai = _trtri(_block(t, 0, 0, n1, n1), upper, mul_fn, cfg)
    di = _trtri(_block(t, n1, n1, n, n), upper, mul_fn, cfg)
    out = torch.zeros((*t.data.shape[:-2], n, width_for(n)),
                      dtype=torch.int32, device=t.device)
    out[..., :n1, :w1] = ai.data
    out[..., n1:, w1:] = di.data
    if upper:
        b = _block(t, 0, n1, n1, n)
        out[..., :n1, w1:] = mul_fn(mul_fn(ai, b), di).data  # Ai B Di
    else:
        c = _block(t, n1, 0, n, n1)
        out[..., n1:, :w1] = mul_fn(mul_fn(di, c), ai).data  # Di C Ai
    return mask_padding(BitMatrix(out, n))


def _trsm_left_rec(t: BitMatrix, b: BitMatrix, upper: bool, mul_fn=mul,
                   cfg=None) -> BitMatrix:
    """Solve T X = B by 2x2 block substitution WITHOUT forming T^{-1}
    (the reference's TRSM recursion, triangular.c:396-516).  For a narrow B
    this costs O(n^2 ncols(B)) work instead of the O(n^3) full inverse.
    A wide B substitutes down to trsm_wide_base before inverting."""
    cfg = cfg or get_config()
    n = t.ncols
    wide = b.ncols * 4 >= n
    if n <= cfg.trsm_base or (wide and n <= cfg.trsm_wide_base):
        return mul_fn(_trtri(t, upper, mul_fn, cfg), b)
    n1 = _split(n)
    a = _block(t, 0, 0, n1, n1)
    d = _block(t, n1, n1, n, n)
    b_top = BitMatrix(b.data[..., :n1, :], b.ncols)
    b_bot = BitMatrix(b.data[..., n1:, :], b.ncols)
    if upper:
        # [A B; 0 D] [X1; X2] = [R1; R2]
        x2 = _trsm_left_rec(d, b_bot, upper, mul_fn, cfg)
        r1 = b_top.data ^ mul_fn(_block(t, 0, n1, n1, n), x2).data
        x1 = _trsm_left_rec(a, BitMatrix(r1, b.ncols), upper, mul_fn, cfg)
    else:
        # [A 0; C D] [X1; X2] = [R1; R2]
        x1 = _trsm_left_rec(a, b_top, upper, mul_fn, cfg)
        r2 = b_bot.data ^ mul_fn(_block(t, n1, 0, n, n1), x1).data
        x2 = _trsm_left_rec(d, BitMatrix(r2, b.ncols), upper, mul_fn, cfg)
    return mask_padding(BitMatrix(torch.cat([x1.data, x2.data], dim=-2),
                                  b.ncols))


def _trsm_right_rec(t: BitMatrix, b: BitMatrix, upper: bool, mul_fn=mul,
                    cfg=None) -> BitMatrix:
    """Solve X T = B by 2x2 block substitution (reference:
    triangular.c:41-111, 301-390); the same strategy as _trsm_left_rec with
    the rows of B in the place of its columns."""
    cfg = cfg or get_config()
    n = t.ncols
    wide = b.nrows * 4 >= n
    if n <= cfg.trsm_base or (wide and n <= cfg.trsm_wide_base):
        return mul_fn(b, _trtri(t, upper, mul_fn, cfg))
    n1 = _split(n)
    a = _block(t, 0, 0, n1, n1)
    d = _block(t, n1, n1, n, n)
    b_l = _block(b, 0, 0, b.nrows, n1)
    b_r = _block(b, 0, n1, b.nrows, n)
    if upper:
        # [X1 X2] [A B; 0 D] = [R1 R2]: X1 A = R1; X2 D = R2 + X1 B
        x1 = _trsm_right_rec(a, b_l, upper, mul_fn, cfg)
        r2 = b_r.data ^ mul_fn(x1, _block(t, 0, n1, n1, n)).data
        x2 = _trsm_right_rec(d, BitMatrix(r2, n - n1), upper, mul_fn, cfg)
    else:
        # [X1 X2] [A 0; C D] = [R1 R2]: X2 D = R2; X1 A = R1 + X2 C
        x2 = _trsm_right_rec(d, b_r, upper, mul_fn, cfg)
        r1 = b_l.data ^ mul_fn(x2, _block(t, n1, 0, n, n1)).data
        x1 = _trsm_right_rec(a, BitMatrix(r1, n1), upper, mul_fn, cfg)
    return mask_padding(BitMatrix(torch.cat([x1.data, x2.data], dim=-1), n))


def trtri_upper(t: BitMatrix) -> BitMatrix:
    """U^{-1} for unit upper triangular U (reference: mzd_trtri_upper)."""
    return _trtri(_clean_tri(t, True), True)


def trtri_lower(t: BitMatrix) -> BitMatrix:
    """L^{-1} for unit lower triangular L."""
    return _trtri(_clean_tri(t, False), False)


def trsm_upper_left(u: BitMatrix, b: BitMatrix) -> BitMatrix:
    """Solve U X = B, i.e. X = U^{-1} B (reference: mzd_trsm_upper_left,
    triangular.c:457-516)."""
    assert u.nrows == u.ncols == b.nrows
    return _trsm_left_rec(_clean_tri(u, True), b, True)


def trsm_lower_left(l: BitMatrix, b: BitMatrix) -> BitMatrix:
    """Solve L X = B (reference: mzd_trsm_lower_left, triangular.c:396-451)."""
    assert l.nrows == l.ncols == b.nrows
    return _trsm_left_rec(_clean_tri(l, False), b, False)


def trsm_upper_right(u: BitMatrix, b: BitMatrix) -> BitMatrix:
    """Solve X U = B, i.e. X = B U^{-1} (reference: mzd_trsm_upper_right,
    triangular.c:41-111)."""
    assert u.nrows == u.ncols == b.ncols
    return _trsm_right_rec(_clean_tri(u, True), b, True)


def trsm_lower_right(l: BitMatrix, b: BitMatrix) -> BitMatrix:
    """Solve X L = B (reference: mzd_trsm_lower_right, triangular.c:301-390)."""
    assert l.nrows == l.ncols == b.ncols
    return _trsm_right_rec(_clean_tri(l, False), b, False)

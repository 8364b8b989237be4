"""Reference-parity matrix helpers on top of BitMatrix.

Covers the remaining mzd_* API surface: multi-bit field access
(mzd_read_bits / mzd_xor_bits / mzd_and_bits / mzd_clear_bits,
mzd.h:472-523, 892-901), row combination (mzd_row_add,
mzd_row_add_offset), triangle extraction (mzd_extract_u / mzd_extract_l,
mzd.c:1843-1866), pivot search (mzd_find_pivot, mzd.c:1661-1776), and
set_ui (mzd_set_ui).

Row and column positions are Python ints.  The words are int32, so three
things differ from the JAX package's uint32 code, and none of them changes
a bit: every right shift is masked (``>>`` copies the sign), masks come from
the 33-entry tables below (a shift by 32 is never taken), and words are
compared as unsigned by widening them to int64 first.  A field read back by
``read_bits`` is an int32 tensor holding the same 32 bits as the JAX
package's uint32 value.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.config import WORD_BITS
from .bitmatrix import (BitMatrix, keep_below, mask_padding, submatrix,
                        width_for)

__all__ = [
    "read_bits", "xor_bits", "and_bits", "clear_bits", "row_add",
    "row_add_offset", "extract_u", "extract_l", "find_pivot", "set_ui",
    "copy",
]

_U32 = 0xFFFFFFFF
# LOW[s]: the low s bits set; HIGH[s]: bits s..31 set (s = 0..32), as int32
_LOW = np.array([(1 << s) - 1 for s in range(WORD_BITS + 1)],
                np.uint64).astype(np.uint32).view(np.int32)
_HIGH = np.array([(_U32 << s) & _U32 for s in range(WORD_BITS + 1)],
                 np.uint64).astype(np.uint32).view(np.int32)


def _i32(x: int) -> int:
    """The int32 value with the low 32 bits of ``x``."""
    x &= _U32
    return x - (1 << WORD_BITS) if x >> (WORD_BITS - 1) else x


def _low(n_bits: int) -> int:
    return (1 << n_bits) - 1


def read_bits(m: BitMatrix, i, j: int, n_bits: int) -> torch.Tensor:
    """n_bits <= 32 bits of row i starting at column j (mzd_read_bits)."""
    assert n_bits <= WORD_BITS
    w, s = divmod(int(j), WORD_BITS)
    val = (m.data[i, w] >> s) & int(_LOW[WORD_BITS - s])
    if s and w + 1 < m.width:
        val = val | (m.data[i, w + 1] << (WORD_BITS - s))
    return val & _i32(_low(n_bits))


def _apply_bits(m: BitMatrix, i, j: int, n_bits: int, values, op) -> BitMatrix:
    w, s = divmod(int(j), WORD_BITS)
    mask = _low(n_bits)
    values = int(values) & mask
    data = m.data.clone()
    data[i, w] = op(data[i, w], _i32(values << s), _i32(mask << s))
    if s and n_bits > WORD_BITS - s and w + 1 < m.width:
        sh = WORD_BITS - s
        data[i, w + 1] = op(data[i, w + 1], _i32(values >> sh),
                            _i32(mask >> sh))
    return BitMatrix(data, m.ncols)


def xor_bits(m: BitMatrix, i, j: int, n_bits: int, values) -> BitMatrix:
    return _apply_bits(m, i, j, n_bits, values,
                       lambda old, v, msk: old ^ v)


def and_bits(m: BitMatrix, i, j: int, n_bits: int, values) -> BitMatrix:
    return _apply_bits(m, i, j, n_bits, values,
                       lambda old, v, msk: old & (v | ~msk))


def clear_bits(m: BitMatrix, i, j: int, n_bits: int) -> BitMatrix:
    return _apply_bits(m, i, j, n_bits, 0,
                       lambda old, v, msk: old & ~msk)


def row_add(m: BitMatrix, src, dst) -> BitMatrix:
    """row[dst] ^= row[src] (mzd_row_add)."""
    data = m.data.clone()
    data[dst] = m.data[dst] ^ m.data[src]
    return BitMatrix(data, m.ncols)


def _word_masks(width: int, offset: int, device, below: bool) -> torch.Tensor:
    """int32[width]: the columns >= offset of a row (``below``: < offset)."""
    w0, s = divmod(int(offset), WORD_BITS)
    widx = torch.arange(width, device=device)
    keep = torch.where(widx > w0, -1, 0).to(torch.int32)
    if w0 < width:
        keep[w0] = int(_HIGH[s])
    return ~keep if below else keep


def row_add_offset(m: BitMatrix, dst, src, offset: int) -> BitMatrix:
    """row[dst] ^= row[src] restricted to columns >= offset
    (mzd_row_add_offset, mzd.h:537)."""
    wmask = _word_masks(m.width, offset, m.device, below=False)
    data = m.data.clone()
    data[dst] = m.data[dst] ^ (m.data[src] & wmask)
    return BitMatrix(data, m.ncols)


def _triangle_mask(k: int, upper: bool, device) -> torch.Tensor:
    """Packed int32[k, width(k)] mask of the (inclusive) triangle: upper
    keeps the columns >= row, lower the columns <= row.  Made on the device
    (no copy from the host, so a batched caller does not wait for it)."""
    rows = torch.arange(k, device=device)
    if upper:
        return ~keep_below(rows, width_for(k))
    return keep_below(rows + 1, width_for(k))


def extract_u(m: BitMatrix) -> BitMatrix:
    """Upper-triangular k x k submatrix, k = min(m, n) (mzd_extract_u)."""
    k = min(m.nrows, m.ncols)
    s = submatrix(m, 0, 0, k, k)
    return mask_padding(BitMatrix(s.data & _triangle_mask(k, True, m.device),
                                  k))


def extract_l(m: BitMatrix) -> BitMatrix:
    """Lower-triangular k x k submatrix (mzd_extract_l)."""
    k = min(m.nrows, m.ncols)
    s = submatrix(m, 0, 0, k, k)
    return mask_padding(BitMatrix(s.data & _triangle_mask(k, False, m.device),
                                  k))


def find_pivot(m: BitMatrix, start_row: int, start_col: int):
    """First (i, j) with bit 1, scanning columns left-to-right from
    (start_row, start_col), rows >= start_row (mzd_find_pivot semantics).
    Returns (found, i, j) as 0-dim tensors on the matrix's device; with
    nothing found, i = j = 0 as in the JAX package."""
    from ..ops.mul import unpack_bits
    bits = unpack_bits(m.data, torch.uint8)[:, : m.ncols]
    bits[:start_row] = 0
    bits[:, :start_col] = 0
    anyc = bits.amax(dim=0)
    j = torch.argmax(anyc)
    i = torch.argmax(bits[:, j])
    return (anyc != 0).any(), i.to(torch.int32), j.to(torch.int32)


def set_ui(m: BitMatrix, value: int) -> BitMatrix:
    """Zero the matrix and set the main diagonal to value&1 (mzd_set_ui)."""
    if not (value & 1):
        return BitMatrix(torch.zeros_like(m.data), m.ncols)
    rows = torch.arange(m.nrows, dtype=torch.int32, device=m.device)[:, None]
    words = torch.arange(m.width, dtype=torch.int32, device=m.device)[None, :]
    one = torch.ones((), dtype=torch.int32, device=m.device)
    data = torch.where((rows // WORD_BITS == words) & (rows < m.ncols),
                       one << (rows % WORD_BITS), 0).to(torch.int32)
    return mask_padding(BitMatrix(data, m.ncols))


def copy(m: BitMatrix) -> BitMatrix:
    return BitMatrix(m.data.clone(), m.ncols)


def copy_row(m: BitMatrix, dst, src_mat: BitMatrix, src) -> BitMatrix:
    """row[dst] = src_mat.row[src] (mzd_copy_row)."""
    data = m.data.clone()
    data[dst] = src_mat.data[src]
    return BitMatrix(data, m.ncols)


def row_clear_offset(m: BitMatrix, row, offset: int) -> BitMatrix:
    """Zero row bits at columns >= offset (mzd_row_clear_offset)."""
    keep = _word_masks(m.width, offset, m.device, below=True)
    data = m.data.clone()
    data[row] = m.data[row] & keep
    return BitMatrix(data, m.ncols)


def row_combine(m: BitMatrix, dst, srcs) -> BitMatrix:
    """row[dst] = XOR of the listed source rows (reference analogue:
    _mzd_combine_N, xor.h:96-122 — the N-ary XOR kernel family)."""
    acc = torch.zeros((m.width,), dtype=torch.int32, device=m.device)
    for s in srcs:
        acc = acc ^ m.data[s]
    data = m.data.clone()
    data[dst] = acc
    return BitMatrix(data, m.ncols)


def cmp(a: BitMatrix, b: BitMatrix) -> torch.Tensor:
    """Lexicographic compare like mzd_cmp (mzd.c:1333-1361): -1/0/1 with
    rows scanned top-down and, *within* a row, the high-index word most
    significant ("columns with larger index are larger").  Reversing the
    32-bit words per row reproduces the reference's 64-bit-word order
    exactly: a 64-bit compare looks at its high half (our word 2j+1)
    before its low half (our word 2j).  The words are compared unsigned."""
    assert a.shape == b.shape
    fa = a.data.flip(1).reshape(-1).to(torch.int64) & _U32
    fb = b.data.flip(1).reshape(-1).to(torch.int64) & _U32
    diff = fa != fb
    first = torch.argmax(diff.to(torch.uint8))
    sign = torch.where(fa[first] < fb[first], -1, 1)
    return torch.where(diff.any(), sign, 0).to(torch.int32)


def first_zero_row(m: BitMatrix) -> torch.Tensor:
    """Index of the first all-zero row scanning from the BOTTOM up, i.e.
    the number of leading nonzero rows if the zero rows form a tail
    (mzd_first_zero_row, mzd.c semantics: rows after it are all zero)."""
    nonzero = (m.data != 0).any(dim=1)
    idx = torch.arange(1, m.nrows + 1, dtype=torch.int32, device=m.device)
    return torch.where(nonzero, idx, 0).amax() if m.nrows else \
        torch.zeros((), dtype=torch.int32, device=m.device)

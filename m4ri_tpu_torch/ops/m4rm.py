"""M4RM (Method of the Four Russians) multiplication: the Gray-table engine.

Reference analogue: _mzd_mul_m4rm (brilliantrussian.c:1032-1190): for each
k-bit column slice of A, build a 2^k-row table of the XOR combinations of k
rows of B, then process each row of A with one table lookup per slice and
XOR the looked-up rows together.

On the card (the same code runs on the CPU for the tests):
- table build: row x of a slice's table is the XOR of the rows j of B whose
  bit j is set in x, built by k doubling steps ``T[2^j + x] = T[x] ^ B[j]``.
  That is the JAX package's ``S @ B_slice`` selector product, word for word,
  with no product at all;
- row processing: each row's k-bit index of every slice is cut out of the
  packed words of A, all slices of a block gather from one flattened table
  with ``index_select``, and the gathered rows are XOR-folded over the slice
  axis in halving passes (torch has no XOR reduction; a sum of words is not
  their XOR).

Production dispatch never picks this engine: the GEMM kernels are faster on
dense operands.  It is the cross-validation sibling the reference's test
suite expects (test_multiplication.c compares M4RM, naive and Strassen).
"""

from __future__ import annotations

import torch

from ..core.bitmatrix import BitMatrix, xor_reduce
from ..utils.config import WORD_BITS
from ..utils.graycode import opt_k

__all__ = ["mul_m4rm", "addmul_m4rm"]

# the tables of a block and its gathered temporary are each bounded to this
# many bytes (the JAX package's bound; it changes no result)
_BLOCK_BYTES = 1 << 28


def mul_m4rm(a: BitMatrix, b: BitMatrix, k: int = 0) -> BitMatrix:
    """C = A*B via Gray-code tables (reference API: mzd_mul_m4rm,
    brilliantrussian.c:999).  ``k <= 0`` picks the table width."""
    return addmul_m4rm(None, a, b, k)


def addmul_m4rm(c: BitMatrix | None, a: BitMatrix, b: BitMatrix,
                k: int = 0) -> BitMatrix:
    """C + A*B as a new matrix on A's device (reference API:
    mzd_addmul_m4rm); ``c=None`` is a zero C."""
    assert a.ncols == b.nrows
    if k <= 0:
        k = min(opt_k(a.nrows, a.ncols, b.ncols), 12)
    if c is None:
        acc = torch.zeros((a.nrows, b.width), dtype=torch.int32,
                          device=a.device)
    else:
        acc = c.data.clone()
    return BitMatrix(_addmul_m4rm_(acc, a.data, b.data, a.ncols, k), b.ncols)


def _slice_indices(adata: torch.Tensor, nslices: int, k: int) -> torch.Tensor:
    """int64[m, nslices]: bits s*k .. s*k+k-1 of each row, LSB first.  A
    field spans at most two words, so it is cut from the 64-bit value of
    the word pair it starts in."""
    w = adata.shape[1]
    last = (nslices - 1) * k // WORD_BITS
    starts = torch.arange(nslices, device=adata.device) * k
    widx, sh = starts // WORD_BITS, starts % WORD_BITS
    words = torch.nn.functional.pad(adata, (0, last + 2 - w)).long()
    pair = (words[:, widx] & 0xFFFFFFFF) | (words[:, widx + 1] << WORD_BITS)
    return (pair >> sh) & ((1 << k) - 1)


def _tables(b3: torch.Tensor, k: int) -> torch.Tensor:
    """int32[cs, 2^k, nw]: row x of slice s is the XOR of b3[s, j] over the
    bits j of x."""
    cs, _, nw = b3.shape
    t = torch.zeros((cs, 1 << k, nw), dtype=torch.int32, device=b3.device)
    for j in range(k):
        half = 1 << j
        t[:, half:2 * half] = t[:, :half] ^ b3[:, j, None, :]
    return t


def _addmul_m4rm_(acc: torch.Tensor, adata: torch.Tensor, bdata: torch.Tensor,
                  kk: int, k: int) -> torch.Tensor:
    """acc ^= A*B in place, a giant-step block of slices at a time
    (reference: __M4RI_MUL_BLOCKSIZE, mzd.h:59; brilliantrussian.c:
    1106-1111): the tables of at most _BLOCK_BYTES of slices are live at
    once, and the rows they gather take no more."""
    m = adata.shape[0]
    nw = bdata.shape[1]
    nslices = (kk + k - 1) // k
    if m == 0 or nw == 0 or nslices == 0:
        return acc
    idx = _slice_indices(adata, nslices, k)
    kk_pad = nslices * k
    b3 = torch.nn.functional.pad(bdata, (0, 0, 0, kk_pad - kk)
                                 ).reshape(nslices, k, nw)
    cs = max(1, min(_BLOCK_BYTES // max(1, (1 << k) * nw * 4),
                    _BLOCK_BYTES // max(1, m * nw * 4)))
    for s0 in range(0, nslices, cs):
        s1 = min(s0 + cs, nslices)
        tflat = _tables(b3[s0:s1], k).view(-1, nw)
        offs = torch.arange(s1 - s0, device=idx.device) << k
        fidx = (idx[:, s0:s1] + offs[None, :]).reshape(-1)
        g = tflat.index_select(0, fidx).view(m, s1 - s0, nw)
        acc ^= xor_reduce(g, 1)
    return acc

"""Bit-matrix transpose.

Reference analogue: the transpose family in mzd.c:236-1139 — a 64x64
butterfly with 6 shift/mask stages plus a cache-oblivious block walker.
With 32-bit words the butterfly needs 5 stages; it is vectorized across
*all* 32x32 tiles at once, followed by one word-level permute.

The words are int32, so ``>>`` is arithmetic.  That is safe here: each
stage masks the shifted value with a constant whose top ``j`` bits are
clear, which are exactly the bits the sign would be copied into.
"""

from __future__ import annotations

import torch

from ..utils.config import WORD_BITS
from .bitmatrix import BitMatrix, padding_words, width_for

_STAGES = (
    (16, 0x0000FFFF),
    (8, 0x00FF00FF),
    (4, 0x0F0F0F0F),
    (2, 0x33333333),
    (1, 0x55555555),
)


def _transpose32_tiles(x: torch.Tensor) -> torch.Tensor:
    """Bit-transpose 32x32 tiles.

    ``x`` has shape (..., 32, w): axis -2 indexes tile rows r, each word
    holds bits s (LSB-first).  Returns the same shape where axis -2 indexes
    bit position s and bit r of each word is the original (r, s) bit.
    Classic butterfly (reference: _mzd_copy_transpose_64x64, mzd.c:249-309),
    vectorized over all leading axes.
    """
    lead = x.shape[:-2]
    w = x.shape[-1]
    for j, m in _STAGES:
        xr = x.reshape(lead + (32 // (2 * j), 2, j, w))
        a = xr[..., 0, :, :]  # tile rows with (r & j) == 0
        b = xr[..., 1, :, :]  # tile rows with (r & j) == j
        t = ((a >> j) ^ b) & m
        a = a ^ (t << j)
        b = b ^ t
        x = torch.stack([a, b], dim=-3).reshape(lead + (32, w))
    return x


def transpose_words(data: torch.Tensor, nrows: int, ncols: int
                    ) -> torch.Tensor:
    """The packed words of A^T: int32[..., nrows, width(ncols)] ->
    int32[..., ncols, width(nrows)], leading batch axes passed through.
    The padding mask is made on the device (no copy from the host)."""
    *lead, nr, w = data.shape
    mr = (nr + WORD_BITS - 1) // WORD_BITS
    if mr * WORD_BITS != nr:
        data = torch.nn.functional.pad(data, (0, 0, 0, mr * WORD_BITS - nr))
    tiles = data.reshape(*lead, mr, WORD_BITS, w)
    u = _transpose32_tiles(tiles)  # [..., a, s, b] bit r = A(32a+r, 32b+s)
    k = len(lead)
    out = u.permute(*range(k), k + 2, k + 1, k).reshape(*lead, w * WORD_BITS,
                                                        mr)
    out = out[..., :ncols, : width_for(nrows)]
    return out & padding_words(nrows, data.device)


def transpose(mat: BitMatrix) -> BitMatrix:
    """B = A^T (reference: mzd_transpose, mzd.c:1118-1139)."""
    return BitMatrix(transpose_words(mat.data, mat.nrows, mat.ncols),
                     mat.nrows)

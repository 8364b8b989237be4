"""The rank over the reals of a stack of packed 0/1 matrices: the control
of the cells that ask for the exact rank over GF(2) (whose reference is
``rref.rref``'s rank).  Nearly every uniform 0/1 matrix is regular over the
reals, while 71 % of the 32 x 32 ones are singular over GF(2)."""

from __future__ import annotations

import torch

from .gf2 import unpack

# matrices a float64 rank takes at once: 2^16 32 x 32 is 512 MiB
REAL_BLOCK = 1 << 16


def real_ranks(words: torch.Tensor, ncols: int) -> torch.Tensor:
    """Stack ``words`` [B, m, w] -> the rank over the reals of each
    element's 0/1 entries (``torch.linalg.matrix_rank`` in float64), int64
    [B]."""
    return torch.cat([
        torch.linalg.matrix_rank(unpack(words[b0:b0 + REAL_BLOCK], ncols,
                                        torch.float64)).long()
        for b0 in range(0, words.shape[0], REAL_BLOCK)])

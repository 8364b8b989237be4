"""Reduced row echelon forms of a stack of matrices, and linear solves.

The RREF of a matrix is unique, whatever the order of the row operations,
so the rows here never move while they are eliminated: a column's pivot is
any row not yet used with a 1 there, every other row with a 1 there adds
it, and at the end the pivot rows are gathered in the order of their
columns, the rest (all zero over the pivot columns) after them.  One
column at a time for the whole stack, nothing read back but a check every
32 columns whether every element's rows are all used.

``reduce_above=False`` leaves the rows above a pivot as they are, which
gives a row echelon form that is not reduced: the control of the cells
that ask for the reduced one.
"""

from __future__ import annotations

import torch

from .gf2 import WORD, pack, unpack


def rref(words: torch.Tensor, pivot_cols: int, reduce_above: bool = True):
    """Stack ``words`` [B, m, w] -> ``(R [B, m, w], rank int64 [B], cols
    int64 [B, m])``: R reduced over the first ``pivot_cols`` columns (the
    columns past them ride along), ``cols[b, i]`` the pivot column of row i
    of R for i < rank[b], ``pivot_cols`` beyond."""
    X = words.clone()
    B, m, _ = X.shape
    dev = X.device
    bi = torch.arange(B, device=dev)
    used = torch.zeros((B, m), dtype=torch.bool, device=dev)
    slot = torch.full((B, m), m, dtype=torch.int64, device=dev)
    cols = torch.full((B, m + 1), pivot_cols, dtype=torch.int64, device=dev)
    rank = torch.zeros(B, dtype=torch.int64, device=dev)
    for c in range(pivot_cols):
        if c % WORD == 0 and c and bool((rank == m).all()):
            break
        wi, b = divmod(c, WORD)
        bit = ((X[:, :, wi] >> b) & 1).bool()
        cand = bit & ~used
        has = cand.any(1)
        prow = cand.to(torch.uint8).argmax(1)
        prow_words = X[bi, prow]
        clear = (bit if reduce_above else cand) & has[:, None]
        clear[bi, prow] = False
        X ^= torch.where(clear[:, :, None], prow_words[:, None, :], 0)
        used[bi, prow] |= has
        slot[bi, prow] = torch.where(has, rank, slot[bi, prow])
        cols[bi, torch.where(has, rank, m)] = c
        rank += has.to(torch.int64)
    order = slot.argsort(dim=1, stable=True)
    return X[bi[:, None], order], rank, cols[:, :m]


def solve_left(a: torch.Tensor, ncols: int, b: torch.Tensor,
               reduce_above: bool = True):
    """``A X = B`` for a stack of square-or-not ``a`` [B, m, w(ncols)] and
    one right-hand column ``b`` [B, m, 1] (bit 0): ``(X [B, ncols, 1],
    consistent bool [B])``.  X is the solution whose free variables are
    zero (the entries at the pivot columns are the reduced right-hand side
    of the pivot rows); it is meaningless where ``consistent`` is False."""
    Bn, m, _ = a.shape
    aug = pack(torch.cat([unpack(a, ncols), (b[:, :, :1] & 1).to(torch.uint8)],
                         dim=2))
    R, rank, cols = rref(aug, ncols, reduce_above)
    rhs = unpack(R[:, :, ncols // WORD: ncols // WORD + 1] >> (ncols % WORD),
                 1).squeeze(2)                                 # [B, m]
    k = torch.arange(m, device=a.device)
    pivot = k[None, :] < rank[:, None]
    consistent = ~(rhs.bool() & ~pivot).any(1)
    x = torch.zeros((Bn, ncols + 1), dtype=torch.int32, device=a.device)
    x.scatter_(1, torch.where(pivot, cols, ncols),
               torch.where(pivot, rhs.to(torch.int32), 0))
    return x[:, :ncols, None], consistent


"""Distributed (row-sharded) echelonization over a device mesh.

The reference has no distributed factorization (its only parallelism is
OpenMP loop splitting over rows, brilliantrussian.c:364-367); the design is
the JAX package's:

- A is row-sharded along mesh axis "x"; rows never move between ranks.
  Pivoting is lazy: a replicated ``pivoted`` mask and pivot row list stand
  in for row swaps, so no rank sends rows to another.
- Per column panel: one all-gather of the m x NB panel, a replicated
  branchless pivot hunt (every rank factors the same small panel), one XOR
  all-reduce that assembles the <= NB pivot rows' trailing words, and a
  local Schur update of each shard (ops/mul.py, on the card the GF(2) GEMM
  kernel).
- The pivot is the first unpivoted physical row, so P/Q differ from the
  single-device engine's swap order; rank and RREF are the same, and the
  output words are the JAX package's ``dist_echelonize``'s.

The pivot hunt is a Python loop of tensor operations a column, with the
rank kept on the device: nothing is read back until the end.
"""

from __future__ import annotations

import torch

from ..core.bitmatrix import BitMatrix, mask_padding, width_for
from ..models.ple import _unit_upper_inv
from ..ops.mul import mul_packed_data, pack_bits
from ..utils.config import WORD_BITS
from .mesh import all_gather, axis_index, axis_size, xor_allgather_reduce

__all__ = ["dist_echelonize", "dist_rank"]

# bit s of an int32 word, as an int32 value
_BIT = [1 << s for s in range(WORD_BITS - 1)] + [-(1 << (WORD_BITS - 1))]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _factor_local(a_loc: torch.Tensor, m: int, nb: int, mesh):
    """The per-rank body: a_loc is this rank's row block (mloc, w_pad), in
    place.  Returns (a_loc, pivrows, r) with pivrows and r replicated and on
    the device."""
    mloc, w_pad = a_loc.shape
    dev = a_loc.device
    nbw = nb // WORD_BITS
    m_tot = mloc * axis_size(mesh, "x")
    offset = axis_index(mesh, "x") * mloc

    gidx = torch.arange(m_tot, dtype=torch.int32, device=dev)
    jrow = torch.arange(nb, dtype=torch.int32, device=dev)
    widx = torch.arange(w_pad, dtype=torch.int32, device=dev)
    eye_nb = torch.eye(nb, dtype=torch.int8, device=dev)
    steps = max(0, (nb - 1).bit_length() - 1)

    # rows that may still pivot (real and unpivoted), and the pivot rows in
    # pivot order; each has one slot more, where a column without a pivot
    # writes, so that no step branches on a value on the device
    avail = torch.cat([gidx < m, gidx.new_zeros(1, dtype=torch.bool)])
    pivrows = torch.zeros(m_tot + 1, dtype=torch.int32, device=dev)
    r = torch.zeros(1, dtype=torch.long, device=dev)
    for t in range(w_pad // nbw):
        c0w = t * nbw
        pan = all_gather(a_loc[:, c0w:c0w + nbw], mesh, "x")   # (m_tot, nbw)
        lp = torch.zeros((m_tot, nb), dtype=torch.bool, device=dev)
        r_in = r.clone()
        for j in range(nb):
            cand = (pan[:, j // WORD_BITS] & _BIT[j % WORD_BITS]) != 0
            cand &= avail[:m_tot]
            f8, piv = cand.to(torch.uint8).max(0, keepdim=True)  # first one
            found = f8.bool()
            pivrow = pan.index_select(0, piv) * f8
            # eliminate the whole panel row of every other candidate (no L
            # layout to keep: echelon rows only)
            elim = cand.index_fill_(0, piv, False)
            pan ^= elim[:, None] * pivrow
            lp.index_copy_(1, r - r_in, elim[:, None])   # the slot's column
            pivrows.index_copy_(0, torch.where(found, r, m_tot),
                                piv.to(torch.int32))
            avail.index_fill_(0, torch.where(found, piv, m_tot), False)
            r += f8
        a_loc[:, c0w:c0w + nbw] = pan[offset:offset + mloc]

        # L11 in pivot order: rows = the panel's pivot rows
        rank_panel = r - r_in
        live = (jrow < rank_panel).to(torch.int32)
        block_rows = pivrows[(r_in + jrow).clamp(0, m_tot - 1)].long()
        l11 = (lp[block_rows] * live[:, None]).to(torch.int8)
        s = _unit_upper_inv(l11, eye_nb, steps)

        # the pivot rows' trailing words: local contribution + XOR-reduce
        loc_rows = block_rows - offset
        mine = (loc_rows >= 0) & (loc_rows < mloc) & (live == 1)
        contrib = a_loc[loc_rows.clamp(0, mloc - 1)] * mine.to(torch.int32)[:, None]
        block = xor_allgather_reduce(contrib, mesh, "x")
        up = mul_packed_data(pack_bits(s), block) * live[:, None]
        up *= (widx >= (t + 1) * nbw).to(torch.int32)[None, :]

        lp_loc = pack_bits(lp[offset:offset + mloc])
        a_loc ^= mul_packed_data(lp_loc, up)
    return a_loc, pivrows, r


def _dist_factor(a: BitMatrix, mesh, nb: int = 128):
    rx = axis_size(mesh, "x")
    m_, n_ = a.nrows, a.ncols
    nb = _round_up(max(WORD_BITS, min(nb, _round_up(n_, WORD_BITS))), WORD_BITS)
    n_pad = _round_up(n_, nb)
    m_pad = _round_up(m_, rx)
    mloc = m_pad // rx
    data = torch.nn.functional.pad(
        a.data, (0, n_pad // WORD_BITS - a.width, 0, m_pad - m_))
    xi = axis_index(mesh, "x")
    a_loc = data[xi * mloc:(xi + 1) * mloc].clone()
    a_loc, pivrows, r = _factor_local(a_loc, m_, nb, mesh)
    return a_loc, pivrows, r, m_pad, n_pad


def dist_rank(a: BitMatrix, mesh, nb: int = 128) -> int:
    """Rank of A computed with row-sharded elimination."""
    return int(_dist_factor(a, mesh, nb)[2])


def dist_echelonize(a: BitMatrix, mesh, nb: int = 128):
    """Row echelon form via the distributed factorization.  Returns
    (REF BitMatrix, replicated on every rank, rank).  Pivot columns are
    canonical (left to right) but the pivot-row choice differs from the
    single-device swap-based engine, so the REF is row-equivalent to its,
    not the same words (the RREF of both is the same)."""
    a_loc, pivrows, r, m_pad, _ = _dist_factor(a, mesh, nb)
    a_out = all_gather(a_loc, mesh, "x")
    m, n = a.nrows, a.ncols
    r = int(r)
    rmax = min(m, n)
    out = torch.zeros((m, width_for(n)), dtype=torch.int32, device=a_out.device)
    rows = pivrows[:min(r, rmax)].long().clamp(0, m_pad - 1)
    out[:rows.shape[0]] = a_out[rows, : width_for(n)]
    return mask_padding(BitMatrix(out, n)), r

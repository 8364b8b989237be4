"""Distributed (row-sharded) canonical PLE factorization.

The reference has no distributed factorization (mp.c is OpenMP loop
splitting).  Unlike parallel/dist_echelon.py's lazy-pivot engine, this one
reproduces the single-device factorization (models/ple.py) word for word:
the same canonical pivot order, the same P/Q swap arrays, the same in-place
L\\E layout.  The design is the JAX package's.

Physical rows never move between ranks.  A replicated position -> row
permutation ``perm`` stands in for the reference's row swaps; per column
panel each rank

1. all-gathers the m x NB packed panel (the only O(m) communication),
2. runs the same canonical window pivot loop as the single-device engine
   (models/ple.run_panel_loop, on the card the pivot-loop kernel),
   replicated: every rank computes the same result, with no traffic,
3. eliminates its own rows below the window with the batched multiplier
   solve (lambda = X_piv @ U_piv^{-1}, small replicated factors, float32
   products with TF32 off),
4. XOR-reduces the <= NB pivot rows' trailing words and applies the Schur
   update to its own shard (ops/mul.py, on the card the GF(2) GEMM kernel).

The exact miss check (the window is rank deficient but a pivot exists below
it) is reduced over the ranks and read back once a panel together with the
window's rank; both are shared by all ranks, so every rank takes the same
branch.  The rare slow branch reruns the panel loop on the whole gathered
panel in position order: replicated compute, no extra traffic.
"""

from __future__ import annotations

import torch

from ..core.bitmatrix import BitMatrix, mask_padding, width_for
from ..models.ple import (_compress_l_impl, _dot2, _round_up, _unit_upper_inv,
                          default_engine, run_panel_loop)
from ..ops.mul import mul_packed_data, pack_bits, unpack_bits
from ..utils import spans
from ..utils.config import WORD_BITS, get_config
from .mesh import (all_gather, any_reduce, axis_index, axis_size, psum,
                   xor_allgather_reduce)

__all__ = ["dist_ple", "dist_block_factor"]


def _ple_local(a_loc: torch.Tensor, m: int, n: int, nb: int, W: int,
               preserve_l: bool, engine: str, mesh):
    """The per-rank body.  a_loc: this rank's row block (mloc, w_pad),
    updated in place.  Everything else is replicated.  Returns (a_loc, perm,
    P, Q, r) with r a Python int."""
    mloc, w_pad = a_loc.shape
    dev = a_loc.device
    nbw = nb // WORD_BITS
    m_pad = mloc * axis_size(mesh, "x")   # includes the W rows of padding
    offset = axis_index(mesh, "x") * mloc

    gidx = offset + torch.arange(mloc, dtype=torch.int32, device=dev)
    slotv = torch.arange(nb, dtype=torch.int32, device=dev)
    widx = torch.arange(w_pad, dtype=torch.int32, device=dev)
    posv = torch.arange(m_pad, dtype=torch.int32, device=dev)
    eye_nb = torch.eye(nb, dtype=torch.int8, device=dev)
    upper = (slotv[None, :] > slotv[:, None]).to(torch.int8)
    steps = max(0, (nb - 1).bit_length() - 1)

    perm = posv.clone()                  # position -> row
    pos_of = posv.clone()                # row -> position
    Pv = posv.clone()                    # P (swap targets)
    # Q has nb slack beyond n_pad for the per-panel updates
    Qv = torch.arange(w_pad * WORD_BITS + nb, dtype=torch.int32, device=dev)
    r = 0
    for t in range(w_pad // nbw):
        r_in = r
        c0w = t * nbw
        pan_loc = a_loc[:, c0w:c0w + nbw]
        pan_all = all_gather(pan_loc, mesh, "x")         # (m_pad, nbw)

        # ---- replicated canonical window loop on positions r..r+W ----
        win_rows = perm[r_in:r_in + W].long()
        ALw, rpw, r_f, _, p_f, q_f = run_panel_loop(
            pan_all[win_rows], r_in, r_in, t, m, nb, preserve_l, 0, engine)

        # ---- batched elimination factors (replicated, small) ----
        live = slotv < r_f - r_in
        live8 = live.to(torch.int8)[:, None]
        cloc = torch.where(live, q_f - t * nb, 0)
        Pw = ALw[:nb]
        urows = unpack_bits(Pw[:, :nbw], torch.int8) * live8
        E = ((cloc[:, None] == slotv[None, :]) & live[:, None]).to(torch.int8)
        if preserve_l:
            Lbits = unpack_bits(Pw[:, nbw:], torch.int8)
            u_clean = (urows ^ _dot2(Lbits, E)) * live8
        else:
            u_clean = urows
        T = _unit_upper_inv(_dot2(u_clean, E.T) * upper, eye_nb, steps)
        wmat = (u_clean ^ E) if preserve_l else u_clean

        # ---- local below-window elimination ----
        below_loc = pos_of[gidx.long()] >= r_in + W
        Xu = unpack_bits(pan_loc, torch.int8)
        lam = _dot2(_dot2(Xu, E.T), T) \
            * (live[None, :] & below_loc[:, None]).to(torch.int8)
        vbits = Xu ^ _dot2(lam, wmat)
        pivcol = E.any(dim=0)
        validcol = (t * nb + slotv) < n
        miss_loc = ((vbits != 0) & (~pivcol & validcol)[None, :]
                    & (below_loc & (gidx < m))[:, None]).any()
        miss = any_reduce(miss_loc, mesh, "x")

        # the one read-back of the panel, the same value on every rank
        r_fast, missed = torch.stack(
            [r_f.reshape(()).to(torch.int32), miss.to(torch.int32)]).tolist()
        spans.count("readback.dist_block_factor")

        if missed:
            # full-height canonical loop on the position-ordered panel
            spans.count("fallback.dist_block_factor")
            ALf, rpf, r_s, _, p_pan, q_pan = run_panel_loop(
                pan_all[perm.long()], r_in, 0, t, m, nb, preserve_l, 0, engine)
            r = int(r_s)
            spans.count("readback.dist_block_factor")
            perm = perm[rpf.long()]
            pos_of = torch.empty_like(pos_of)
            pos_of[perm.long()] = posv
            mine_f = ALf[pos_of[gidx.long()].long()]   # my rows' panel + L
            pan_out, lp_loc = mine_f[:, :nbw], mine_f[:, nbw:]
        else:
            r, p_pan, q_pan = r_fast, p_f, q_f
            # window slot i now holds the row that was at window slot
            # rpw[i], i.e. original row win_rows[rpw[i]]
            new_win_rows = win_rows[rpw.long()]
            perm[r_in:r_in + W] = new_win_rows.to(torch.int32)
            pos_of[new_win_rows] = posv[r_in:r_in + W]
            # my rows in the window take their window slot's panel and L
            # words (a gather: a scatter by a mask would read back its size)
            slot = pos_of[gidx.long()].long() - r_in
            in_win = ((slot >= 0) & (slot < W))[:, None]
            src = ALw[slot.clamp(0, W - 1)]
            pan_out = torch.where(in_win, src[:, :nbw], torch.where(
                below_loc[:, None], pack_bits(vbits), pan_loc))
            lp_loc = torch.where(in_win, src[:, nbw:], torch.where(
                below_loc[:, None], pack_bits(lam), 0))

        rank_panel = r - r_in
        Pv[r_in:r] = p_pan[:rank_panel]
        Qv[r_in:r] = q_pan[:rank_panel]
        a_loc[:, c0w:c0w + nbw] = pan_out

        # ---- U rows: trailing words of the nb pivot-position rows ----
        loc = perm[r_in:r_in + nb].long() - offset
        mine = ((loc >= 0) & (loc < mloc)).to(torch.int32)[:, None]
        lsafe = loc.clamp(0, mloc - 1)
        # the pivot rows' multipliers, in slot order (summed over ranks)
        l11_mine = unpack_bits(lp_loc[lsafe], torch.int32) * mine
        l11 = psum(l11_mine, mesh, "x").to(torch.int8)
        s = _unit_upper_inv(l11, eye_nb, steps)
        block = xor_allgather_reduce(a_loc[lsafe] * mine, mesh, "x")
        up = mul_packed_data(pack_bits(s), block)
        up[rank_panel:] = 0
        up *= (widx >= (t + 1) * nbw).to(torch.int32)[None, :]

        # ---- Schur update on the local shard ----
        a_loc ^= mul_packed_data(lp_loc, up)
    return a_loc, perm, Pv, Qv, r


def _dist_factor_impl(data: torch.Tensor, m: int, n: int, nb: int, W: int,
                      preserve_l: bool, engine: str, mesh):
    rx = axis_size(mesh, "x")
    n_pad = _round_up(n, nb)
    m_pad = _round_up(_round_up(m, nb) + W, rx)
    mloc = m_pad // rx
    xi = axis_index(mesh, "x")
    a_loc = torch.zeros((mloc, n_pad // WORD_BITS), dtype=torch.int32,
                        device=data.device)
    rows = data[xi * mloc:(xi + 1) * mloc]
    a_loc[: rows.shape[0], : data.shape[1]] = rows
    a_loc, perm, Pv, Qv, r = _ple_local(a_loc, m, n, nb, W, preserve_l,
                                        engine, mesh)
    # the rows into position order (the reference's physical layout)
    a_pos = all_gather(a_loc, mesh, "x")[perm[:m].long()]
    return (a_pos[:, : width_for(n)].contiguous(), Pv[:m].contiguous(),
            Qv[:n].contiguous(), r)


def dist_block_factor(a: BitMatrix, mesh, preserve_l: bool, nb: int = 128,
                      window: int | None = None, engine: str | None = None):
    """Distributed panel factorization; the same outputs as the
    single-device models/ple.block_factor: data in position order, P/Q in
    the reference's swap format (int32 tensors), rank a Python int.

    ``engine``: "hopper" (the hand-written kernels; the default on the
    card) or "plain" (plain PyTorch; the default on the CPU), as for
    block_factor."""
    cfg = get_config()
    if window is None:
        window = cfg.panel_window
    window = max(min(window, _round_up(a.nrows, nb)), nb)
    if engine is None:
        engine = default_engine(a.data)
    return _dist_factor_impl(a.data, a.nrows, a.ncols, nb, window,
                             preserve_l, engine, mesh)


def dist_ple(a: BitMatrix, mesh, nb: int = 128, window: int | None = None):
    """Distributed PLE (reference API: mzd_ple under SPMD): returns
    (M, P, Q, rank), the same as models/ple.ple."""
    data, p, q, r = dist_block_factor(a, mesh, preserve_l=True, nb=nb,
                                      window=window)
    data = _compress_l_impl(data, q, r, a.nrows, a.ncols)
    return mask_padding(BitMatrix(data, a.ncols)), p, q, r

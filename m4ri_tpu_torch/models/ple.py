"""Blocked PLE factorization over GF(2).

Reference analogue: ple.c (block-recursive PLE), ple_russian.c (MMPF
Gray-code basecase).  The design is the JAX package's, a *panel
factorization with tensor-core Schur updates*:

- The matrix is swept in column panels of width NB.  Within a panel the
  canonical pivot hunt (columns left to right, first row >= rank with a 1:
  the pivot order of the reference `_mzd_ple_naive`, ple.c:223-273, so P/Q
  are reproduced exactly) runs as one sequential loop on a W-row *window* at
  positions r..r+W (ops/hopper_panel.py).  Rows below the window are
  eliminated afterwards in one batched step (ops/hopper_post.py; multipliers
  lambda = X_piv @ U_piv^{-1}).  Exactness: every window candidate
  precedes every outside row in position order, so the window pivot *is*
  the canonical pivot whenever the window has one; the only failure mode,
  a column where the window has no candidate but an outside row does, is
  detected exactly from the batched residuals and the panel is then redone
  with a full-height window.
- The below-window elimination's operands, U_piv^{-1} among them, are one
  wrapper call a panel (ops/hopper_operands.py: packed words, where the JAX
  package takes one-hot products and the nilpotent series).  The panel's
  unit-lower transform L11 is inverted on packed words
  (ops/hopper_trinv.py: one blocked back-substitution), giving the panel's
  U rows in one packed multiply (ops/hopper_mul.py).  The trailing Schur
  update is one fused in-place GF(2) product (ops/hopper_schur.py).
- Like the reference, the in-place result preserves L in the pivot columns
  (elimination touches only columns right of the pivot, cf.
  `mzd_row_add_offset(A, l, row, j+1)` in ple.c:245), then `_compress_l_impl`
  moves the L columns to the left (reference: ple.c:259-268, mzp.c:294).

Where the JAX package scans with a traced rank, this sweep is a Python loop
that reads ``[rank, miss]`` back from the device once a panel and slices with
Python ints; it works in place on its own padded copy of the input, never on
the caller's tensor.  ``pluq`` is ``ple`` followed by the triangular
column permutation of core/permutation.py.
"""

from __future__ import annotations

import math

import torch

from ..core.bitmatrix import BitMatrix, mask_padding, width_for
from ..core.permutation import apply_p_right_trans_tri
from ..core.transpose import transpose
from ..ops.hopper_mul import gf2_mul_hopper, gf2_mul_plain
from ..ops.hopper_operands import post_operands_hopper, post_operands_plain
from ..ops.hopper_panel import panel_loop_hopper, panel_loop_plain
from ..ops.hopper_post import panel_post_hopper, panel_post_plain
# the series stays importable from here for parallel/ (dist_ple, dist_echelon)
from ..ops.hopper_trinv import _unit_upper_inv  # noqa: F401
from ..ops.hopper_trinv import unit_tri_inv_hopper, unit_tri_inv_plain
from ..ops.hopper_schur import (TILE_WORDS, gf2_schur_update_hopper,
                                gf2_schur_update_plain)
from ..ops.mul import exact_float32
from ..utils import spans
from ..utils.config import WORD_BITS, get_config

__all__ = ["ple", "pluq", "block_factor"]

ENGINES = ("hopper", "plain")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _dot2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """0/1 int8 @ 0/1 int8 mod 2 -> int8.  The product runs in float32,
    exact below 2**24 terms (an int8 matmul wraps on the CPU; TF32 would
    round the counts, so it is off around the product)."""
    with exact_float32():
        prod = a.to(torch.float32) @ b.to(torch.float32)
    return (prod.to(torch.int32) & 1).to(torch.int8)


def tri_inv(engine: str):
    """The sweep's unit-triangular inverse: the kernel's wrapper (the plain
    version on a CPU tensor), or the plain version everywhere."""
    return unit_tri_inv_plain if engine == "plain" else unit_tri_inv_hopper


def post_operands(engine: str):
    """The below-window elimination's operands (m_small = E^T T, wmat, the
    column mask; ops/hopper_operands.py): the kernel's wrapper (the plain
    version on a CPU tensor), or the plain version everywhere."""
    return post_operands_plain if engine == "plain" else post_operands_hopper


def run_panel_loop(panel_words: torch.Tensor, r, base: int, t: int, m: int,
                   nb: int, preserve_l: bool, search_window: int, engine: str):
    """The canonical nb-column pivot loop on an h-row window (row 0 at
    global position ``base``).  ``r``: the rank so far, an int or a tensor on
    the device.  Returns (AL, rowperm, r, touched, p_pan, q_pan) with p/q
    global.  A window of any height takes the same engine."""
    h = panel_words.shape[0]
    nbw = nb // WORD_BITS
    al0 = torch.cat([panel_words, panel_words.new_zeros((h, nbw))], dim=1)
    loop = panel_loop_plain if engine == "plain" else panel_loop_hopper
    AL, rowperm, r2, touched, p_loc, q_loc = loop(
        al0, r, base, m, nb, preserve_l, search_window)
    return AL, rowperm, r2, touched, base + p_loc, t * nb + q_loc


def _apply_row_perm_window(A: torch.Tensor, rpw: torch.Tensor, r_in: int):
    """Apply a window-local row permutation in place: every swap endpoint
    of the fast path lies inside the W-row window at r_in, so one W-row slab
    gather does it."""
    W = rpw.shape[0]
    A[r_in : r_in + W] = A[r_in : r_in + W][rpw.long()]
    return A


def _apply_row_perm_full(A: torch.Tensor, rp: torch.Tensor):
    """Full-height row permutation (miss fallback only)."""
    return A[rp.long()]


def _write_panel_cols(A: torch.Tensor, panel_full: torch.Tensor, c0w: int):
    """Write the factored panel words back at word offset c0w, in place."""
    A[:, c0w : c0w + panel_full.shape[1]] = panel_full
    return A


def _block_factor_impl(data: torch.Tensor, m: int, n: int, nb: int,
                       preserve_l: bool, search_window: int = 0,
                       window: int = 0, engine: str = "plain"):
    if engine not in ENGINES:
        raise ValueError(f"engine={engine!r}, want one of {ENGINES}")
    with spans.span("sweep", m=m, n=n, nb=nb, window=window, batch=1):
        return _sweep(data, m, n, nb, preserve_l, search_window, window,
                      engine)


def _sweep(data: torch.Tensor, m: int, n: int, nb: int, preserve_l: bool,
           search_window: int, window: int, engine: str):
    hopper = engine == "hopper"
    dev = data.device
    nbw = nb // WORD_BITS
    W = window
    assert W >= nb + search_window, (W, nb, search_window)
    # rounded to a multiple of the Schur kernels' row tile; the extra all-zero
    # rows can never pivot (pos < m guards) so every engine is unaffected
    m_pad = _round_up(_round_up(m, nb) + W, 256)
    n_pad = _round_up(n, nb)
    w_pad = n_pad // WORD_BITS
    n_panels = n_pad // nb

    A = torch.zeros((m_pad, w_pad), dtype=torch.int32, device=dev)
    A[: data.shape[0], : data.shape[1]] = data
    P = torch.arange(m_pad, dtype=torch.int32, device=dev)
    Q = torch.arange(n_pad, dtype=torch.int32, device=dev)
    post = panel_post_hopper if hopper else panel_post_plain
    operands = post_operands(engine)
    inverse = tri_inv(engine)
    tiles_j = -(-w_pad // TILE_WORDS)
    # the panel's U rows, written anew each panel: one buffer for the sweep
    up = torch.empty((nb, w_pad), dtype=torch.int32, device=dev)

    r = 0
    for t in range(n_panels):
        with spans.span("panel", t=t):
            r_in = r
            c0w = t * nbw
            # the padding makes every slice below whole (torch would shorten
            # it)
            assert r_in + W <= m_pad and r_in + nb <= m_pad, (r_in, W, nb,
                                                              m_pad)
            Xw = A[:, c0w : c0w + nbw]                  # stale panel words

            # ---- fast path: sequential loop on the W-row window only ----
            with spans.span("panel.loop"):
                ALw, rpw, r_f, _, p_f, q_f = run_panel_loop(
                    Xw[r_in : r_in + W], r_in, r_in, t, m, nb, preserve_l,
                    search_window, engine)

            # ---- batched elimination of the rows below the window ----
            # search_window: restricted search never pivots outside the
            # window by construction (r + search_window <= r_in + W), so a
            # bare below-window 1 is legitimate and the miss check is
            # disabled.
            with spans.span("panel.operands"):
                m_small, wmat, cmb = operands(
                    ALw[:nb], r_f, r_in, q_f, t * nb, t * nb, n, preserve_l,
                    not search_window)
            with spans.span("panel.post"):
                vw_full, lamw_full, miss = post(Xw, m_small, wmat, cmb,
                                                r_in + W, m)

            # the one read-back of the panel: the window's rank and the miss
            # flag
            flags = torch.stack([r_f.to(torch.int32), miss.to(torch.int32)])
            with spans.span("panel.readback"):
                r_fast, missed = flags.tolist()
            spans.count("readback.block_factor")

            fell_back = bool(missed) and not search_window
            if fell_back:
                # exact full-height panel sweep; runs only when the window
                # missed
                with spans.span("panel.fallback"):
                    spans.count("fallback.block_factor")
                    AL, rp, r_s, _, p_pan, q_pan = run_panel_loop(
                        Xw, r_in, 0, t, m, nb, preserve_l, search_window,
                        engine)
                    with spans.span("panel.readback"):
                        r = int(r_s)
                    spans.count("readback.block_factor")
                    panel_full, Lpw = AL[:, :nbw], AL[:, nbw:]
                    A = _apply_row_perm_full(A, rp)

            # commit the panel's pivot records into the global swap arrays
            with spans.span("panel.commit"):
                if not fell_back:
                    r = r_fast
                    panel_full, Lpw = vw_full, lamw_full
                    p_pan, q_pan = p_f, q_f
                    panel_full[r_in : r_in + W] = ALw[:, :nbw]
                    Lpw[r_in : r_in + W] = ALw[:, nbw:]
                    A = _apply_row_perm_window(A, rpw, r_in)
                rank_panel = r - r_in
                P[r_in : r] = p_pan[:rank_panel]
                Q[r_in : r] = q_pan[:rank_panel]
                A = _write_panel_cols(A, panel_full, c0w)

            if t == n_panels - 1:
                break                   # no trailing column is left to update
            # --- U rows of this panel: S = L11^{-1} (unit lower triangular,
            # packed) times the panel's rows ---
            with spans.span("panel.u_rows"):
                s_pk = inverse(Lpw[r_in : r_in + nb], False)
                a_block = A[r_in : r_in + nb]
                if hopper:
                    gf2_mul_hopper(s_pk, a_block, out=up)
                else:
                    up.copy_(gf2_mul_plain(s_pk, a_block))
                up[rank_panel:] = 0
                c0n = (t + 1) * nbw
                up[:, :c0n] = 0   # only trailing columns take the update

            # --- Schur update: A ^= Lp @ U, in place; tiles above the rank
            # or left of the trailing edge are skipped by the kernels ---
            with spans.span("panel.schur"):
                if not hopper:
                    gf2_schur_update_plain(A, Lpw, up)
                else:
                    # t is known here, so the finished column tiles are not
                    # launched
                    gf2_schur_update_hopper(
                        A, Lpw, up, r_in, c0n,
                        col_tile_skip=min(c0n // TILE_WORDS, tiles_j - 1))
    return (A[:m, : data.shape[1]].contiguous(), P[:m].contiguous(),
            Q[:n].contiguous(), r)


def default_engine(t: torch.Tensor) -> str:
    """The sweeps' engine for a tensor: "hopper" on the card, "plain"
    elsewhere."""
    return "hopper" if t.is_cuda else "plain"


def panel_widths(nrows: int, ncols: int, nb: int | None = None,
                 window: int | None = None, search_window: int = 0):
    """(nb, window) of the sweep: the configured panel width (the wide one
    from ``panel_width_big_min`` on), cut to the matrix, and its window."""
    cfg = get_config()
    big = min(nrows, ncols) >= cfg.panel_width_big_min
    nb_default = nb is None
    if nb_default:
        nb = cfg.panel_width_big if big else cfg.panel_width
    nb = max(WORD_BITS, _round_up(min(nb, max(WORD_BITS, ncols)), WORD_BITS))
    if window is None:
        if nb_default:
            window = cfg.panel_window_big if big else cfg.panel_window
        else:
            # keep the 64-row search margin over a caller nb
            window = nb + (cfg.panel_window - cfg.panel_width)
    # no point in a window taller than the padded matrix; never shorter
    # than the panel (all pivot slots) plus any restricted-search depth
    return nb, max(min(window, _round_up(nrows, nb)), nb + search_window)


def block_factor(a: BitMatrix, preserve_l: bool, nb: int | None = None,
                 search_window: int = 0, window: int | None = None,
                 engine: str | None = None):
    """Shared panel factorization.  Returns (data, P, Q, rank) where data is
    the in-place pre-compress layout: rows 0..r-1 are the echelon rows E
    (pivot i at column Q[i]); if preserve_l, the L multipliers are preserved
    in the pivot columns below each pivot (reference pre-compress layout).
    P and Q are int32 tensors, rank a Python int.

    ``engine``: "hopper" (the hand-written kernels; the default for a matrix
    on the card, where each kernel launches or raises; on a CPU matrix the
    same wrappers run their plain versions) or "plain" (plain PyTorch
    everywhere; the default for a matrix on the CPU)."""
    nb, window = panel_widths(a.nrows, a.ncols, nb, window, search_window)
    if engine is None:
        engine = default_engine(a.data)
    return _block_factor_impl(a.data, a.nrows, a.ncols, nb, preserve_l,
                              search_window, window, engine)


def _compress_l_seq(data: torch.Tensor, q: torch.Tensor, r: int, m: int,
                    n: int) -> torch.Tensor:
    """Sequential reference semantics of the L compression (one masked
    column swap per pivot), kept as the cross-validation sibling of the
    vectorized version below."""
    data = data.clone()
    ridx = torch.arange(m, device=data.device)
    for j, a in enumerate(q[: min(m, n, r)].tolist()):
        wa, sa = divmod(a, WORD_BITS)
        wb, sb = divmod(j, WORD_BITS)
        diff = ((data[:, wa] >> sa) ^ (data[:, wb] >> sb)) & 1
        diff = diff * (ridx >= j)
        data[:, wa] ^= diff << sa
        data[:, wb] ^= diff << sb
    return data


def _row_ge_mask(th: torch.Tensor, wm: int) -> torch.Tensor:
    """int32[..., n, wm]: bit i of row c set iff i >= th[..., c]."""
    wi = torch.arange(wm, dtype=torch.int32, device=th.device)
    th = th[..., None]
    ones = torch.full((), -1, dtype=torch.int32, device=th.device)
    full = torch.where(wi >= (th + 31) // 32, ones, 0)
    part = torch.where(wi == th // 32, ones << (th % 32), 0)
    return full | part


def _compress_l_impl(data: torch.Tensor, q: torch.Tensor, r: int, m: int,
                     n: int) -> torch.Tensor:
    """Move L columns into 0..r-1 (reference: _mzd_ple_naive compression,
    ple.c:259-268: for j < r ascending, col_swap_in_rows(A, Q[j], j,
    rows j..m)).

    Vectorized: because Q is injective and Q[j] >= j, each column's content
    changes at most twice across the whole ascending swap sequence: once in
    its *source* role (some j with Q[j] = c pulls the then-current column j
    into c, whose origin is resolved by chasing the j <- Q[j'] = j chain
    with pointer doubling) and once in its *target* role (column c < r
    receives the original column Q[c]; Q[c]'s content is provably untouched
    before step c).  The sequential loop therefore collapses into two column
    gathers and masked selects on the transposed, still packed matrix."""
    rmax = min(m, n)
    if rmax == 0:
        return data
    dev = data.device
    c = torch.arange(n, dtype=torch.int64, device=dev)
    t = torch.arange(rmax, dtype=torch.int64, device=dev)
    qv = q[:rmax].long()
    real = (t < r) & (qv != t)   # real swaps (Q[j] > j since Q[j] >= j)

    # src_event[c] = the j with Q[j] = c (if any real one exists); the
    # others all land in one slot past the end, which is cut off
    src_event = torch.full((n + 1,), n, dtype=torch.int64, device=dev)
    src_event[torch.where(real, qv, n)] = t
    src_event = src_event[:n]
    # chase the chain j <- (j' with Q[j'] = j) to its origin column
    f = torch.where(src_event[:rmax] < n, src_event[:rmax], t)
    for _ in range(max(1, math.ceil(math.log2(max(rmax, 2))))):
        f = f[f]

    sv = src_event < n           # column is a swap source
    o1 = torch.where(sv, f[src_event.clamp(0, rmax - 1)], c)
    tv = torch.zeros(n, dtype=torch.bool, device=dev)
    tv[:rmax] = real             # column is a target
    o2 = torch.where(tv, torch.nn.functional.pad(qv, (0, n - rmax)), c)

    dt = transpose(BitMatrix(data[:, : width_for(n)], n)).data   # (n, w(m))
    wm = dt.shape[1]
    g1 = dt[o1]                  # packed source-origin columns
    g2 = dt[o2]                  # packed target-origin columns
    m1 = _row_ge_mask(torch.where(sv, src_event, m).to(torch.int32), wm)
    m2 = _row_ge_mask(torch.where(tv, c, m).to(torch.int32), wm)
    # per column: [0, src): orig, [src, c): g1, [c, m): g2
    out_t = (dt & ~m1 & ~m2) | (g1 & m1 & ~m2) | (g2 & m2)
    packed = transpose(BitMatrix(out_t, m)).data
    w = data.shape[1]
    if packed.shape[1] < w:
        packed = torch.nn.functional.pad(packed, (0, w - packed.shape[1]))
    return packed[:, :w]


@spans.entry("ple")
def ple(a: BitMatrix, nb: int | None = None):
    """PLE decomposition (reference API: mzd_ple, ple.c:33).

    Returns (M, P, Q, rank): M holds L (unit lower, columns 0..r-1,
    compressed) and S=E in place exactly like the reference; P, Q are
    LAPACK-style swap arrays (mzp_t format) as int32 tensors.

    An empty matrix (0 x n, m x 0, 0 x 0) factors to rank 0, an empty body
    and identity swap arrays.  Here the port differs from the JAX package,
    whose ``ple`` raises ``TypeError`` on such shapes."""
    data, p, q, r = block_factor(a, preserve_l=True, nb=nb)
    with spans.span("compress_l"):
        data = _compress_l_impl(data, q, r, a.nrows, a.ncols)
    return mask_padding(BitMatrix(data, a.ncols)), p, q, r


def pluq(a: BitMatrix, nb: int | None = None):
    """PLUQ decomposition (reference API: mzd_pluq = _mzd_ple +
    mzd_apply_p_right_trans_tri, ple.c:50-60): ``ple``'s result with the
    pivot columns moved onto the diagonal of the triangular region, so the
    body holds L strictly below the diagonal and U on and above it."""
    m, p, q, r = ple(a, nb=nb)
    return apply_p_right_trans_tri(m, q), p, q, r

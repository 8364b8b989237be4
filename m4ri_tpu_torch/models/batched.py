"""Batched GF(2) linear algebra: many independent small systems at once.

The JAX package has no module for this.  Its functional ``BitMatrix``
composes with ``jax.vmap``, and ``tests/test_vmap.py`` pins two batched
entry points that way: ``jax.vmap`` of ``mul_packed_data(...,
allow_pallas=False)`` (m4ri_tpu/ops/mul.py:79) and of ``block_factor(...,
engine="xla")`` (m4ri_tpu/models/ple.py:537) for per-matrix ranks.  The use
is the cryptanalytic sweep over many small GF(2) systems: the rank test of
NIST SP 800-22 over 2^20 matrices of 32 x 32, or information-set decoding
that eliminates one McEliece parity-check matrix per iteration.

``torch.vmap`` can batch the product (``mul_packed_data(allow_kernel=False)``
is a chain of tensor operations) but not the port's ``block_factor``: its
sweep reads the rank and the miss flag back once a panel and slices with
Python ints.  So the batched sweep here is ``_block_factor_impl``
(models/ple.py) with an explicit leading batch axis:

- every per-matrix offset (the rank at the panel's entry, the window's base,
  the rank after it) is an int32 ``[B]`` tensor on the device;
- the W-row windows at ``r_in[b]`` are gathered through one index tensor;
  the window's row permutation, the panel write-back and the P/Q records at
  the slots ``s < rank_panel[b]`` (the JAX package's
  ``dynamic_update_slice``s) are one wrapper call a panel
  (``panel_commit_hopper_batched``), which reads ``miss`` on the device and
  leaves the elements that missed to their full-height redo;
- the elimination's operands (U_piv^{-1} among them) are one wrapper call
  a panel for the batch (``post_operands_hopper``), and L11^{-1} for the U
  rows one batched launch on packed words (``unit_tri_inv_hopper``);
- the pivot loop, the below-window elimination and the U rows / trailing
  update run as one batched launch each (``panel_loop_hopper_batched``,
  ``panel_post_hopper_batched``, ``gf2_schur_update_batched_hopper``);
- one read-back a panel for the whole batch: how many elements' windows
  missed.  On a panel where some did, one more read-back gives their indices
  and ranks, and each of them is redone at full height by the single-matrix
  pivot loop (modes grid / tall);
- with a ``search_window`` (the restricted pivot search of
  ``top_echelonize``) a pivot is never looked for below the window, so no
  window can miss: the miss check is off and the sweep reads nothing back.

Element ``i`` of every result equals, word for word, the single-matrix call
on element ``i``.  The counters ``readback.block_factor_batched`` and
``fallback.block_factor_batched`` (``utils/spans.py``) count the read-backs
and the panels redone at full height.
"""

from __future__ import annotations

import torch

from ..core.bitmatrix import padding_words, width_for
from ..core.permutation import (_doubling_steps,
                                apply_p_right_trans_tri_batched)
from ..core.transpose import transpose_words
from ..ops.hopper_commit import (_rows, panel_commit_batched_plain,
                                 panel_commit_hopper_batched)
from ..ops.hopper_mul import gf2_mul_plain
from ..ops.hopper_panel import panel_loop_batched_plain, panel_loop_hopper_batched
from ..ops.hopper_post import panel_post_batched_plain, panel_post_hopper_batched
from ..ops.hopper_schur import (gf2_schur_update_batched_hopper,
                                gf2_schur_update_plain)
from ..utils import spans
from ..utils.config import WORD_BITS
from .ple import (ENGINES, _round_up, _row_ge_mask, default_engine,
                  panel_widths, post_operands, run_panel_loop, tri_inv)

__all__ = ["mul_packed_batched", "block_factor_batched", "rank_batched",
           "ple_batched", "pluq_batched"]


def _check_stack(name: str, t: torch.Tensor) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 \
            or t.dim() != 3:
        raise TypeError(f"{name}: want a 3-D int32 tensor [B, rows, words]")


def mul_packed_batched(a: torch.Tensor, b: torch.Tensor,
                       allow_kernel: bool = True) -> torch.Tensor:
    """Packed int32 ``[B, m, kw]`` x ``[B, k, nw]`` -> ``[B, m, nw]``: element
    i is ``mul_packed_data(a[i], b[i])``.  As there, b's padding bits are
    zero and the contraction runs over a's padded width (``k <= 32*kw``).

    On the card: the batched Schur kernel on a zeroed C with ``r0 = 0`` and
    ``c0w = 0`` (a contraction deeper than ``KW_MAX`` words in slices).
    ``allow_kernel=False`` or CPU tensors: one batched float32 product of the
    unpacked bits (``gf2_mul_plain``), the lowering of the JAX package's
    vmap."""
    _check_stack("a", a)
    _check_stack("b", b)
    B, m, kw = a.shape
    if b.shape[0] != B or b.shape[1] > WORD_BITS * kw:
        raise ValueError(f"a {tuple(a.shape)}, b {tuple(b.shape)}: want "
                         "[B, m, kw] and [B, k <= 32*kw, nw]")
    if b.device != a.device:
        raise ValueError(f"a lies on {a.device}, b on {b.device}")
    if not (allow_kernel and a.is_cuda):
        return gf2_mul_plain(a, b)
    c = torch.zeros((B, m, b.shape[2]), dtype=torch.int32, device=a.device)
    return gf2_schur_update_batched_hopper(c, a, b, 0, 0)


def _block_factor_batched_impl(data: torch.Tensor, m: int, n: int, nb: int,
                               preserve_l: bool, search_window: int,
                               window: int, engine: str):
    if engine not in ENGINES:
        raise ValueError(f"engine={engine!r}, want one of {ENGINES}")
    with spans.span("sweep", m=m, n=n, nb=nb, window=window,
                    batch=data.shape[0]):
        return _sweep(data, m, n, nb, preserve_l, search_window, window,
                      engine)


def _sweep(data: torch.Tensor, m: int, n: int, nb: int, preserve_l: bool,
           search_window: int, window: int, engine: str):
    hopper = engine == "hopper"
    dev = data.device
    B = data.shape[0]
    nbw = nb // WORD_BITS
    W = window
    assert W >= nb + search_window, (W, nb, search_window)
    # the padding as the single-matrix sweep has it: every gathered window
    # and U-row block lies inside, and the extra rows never pivot (pos < m)
    m_pad = _round_up(_round_up(m, nb) + W, 256)
    n_pad = _round_up(n, nb)
    w_pad = n_pad // WORD_BITS
    n_panels = n_pad // nb

    A = torch.zeros((B, m_pad, w_pad), dtype=torch.int32, device=dev)
    A[:, : data.shape[1], : data.shape[2]] = data
    P = torch.arange(m_pad, dtype=torch.int32, device=dev).repeat(B, 1)
    Q = torch.arange(n_pad, dtype=torch.int32, device=dev).repeat(B, 1)
    slotv = torch.arange(nb, dtype=torch.int32, device=dev)
    inverse = tri_inv(engine)
    operands = post_operands(engine)
    wv = torch.arange(W, dtype=torch.int32, device=dev)
    loop = panel_loop_hopper_batched if hopper else panel_loop_batched_plain
    post = panel_post_hopper_batched if hopper else panel_post_batched_plain
    commit = (panel_commit_hopper_batched if hopper
              else panel_commit_batched_plain)
    schur = (gf2_schur_update_batched_hopper if hopper
             else lambda c, lp, up, r0, c0w: gf2_schur_update_plain(c, lp, up))

    r = torch.zeros(B, dtype=torch.int32, device=dev)
    for t in range(n_panels):
        with spans.span("panel", t=t):
            r_in = r
            c0w = t * nbw
            Xw = A[:, :, c0w : c0w + nbw]              # stale panel words

            # ---- fast path: the pivot loop on every element's window ----
            with spans.span("panel.loop"):
                win = (r_in[:, None] + wv[None, :]).long()  # [B, W] rows
                al0 = torch.cat([_rows(Xw, win), Xw.new_zeros((B, W, nbw))],
                                dim=2)
                ALw, rpw, r_f, _, p_f, q_f = loop(al0, r_in, r_in, m, nb,
                                                  preserve_l, search_window)

            # ---- batched elimination of the rows below each window ----
            # search_window: the restricted search never pivots below the
            # window (r + search_window <= r_in + W), so a bare below-window
            # 1 is legitimate: no miss check, and nothing to read back
            with spans.span("panel.operands"):
                m_small, wmat, cmb = operands(
                    ALw[:, :nb], r_f, r_in, q_f, 0, t * nb, n, preserve_l,
                    not search_window)
            with spans.span("panel.post"):
                vw_full, lamw_full, miss = post(Xw, m_small, wmat, cmb,
                                                r_in + W, m)

            fallbacks = []
            n_missed = 0
            if not search_window:
                # the one read-back of the panel for the whole batch
                with spans.span("panel.readback"):
                    n_missed = int(miss.sum())
                spans.count("readback.block_factor_batched")
            if n_missed:
                # their indices (a stable sort puts the n_missed flagged ones
                # first, with no read-back of its own) and ranks: one more
                # read-back; then each is redone at full height, before A
                # changes (Xw is a view of it)
                with spans.span("panel.fallback"):
                    which = torch.argsort((~miss).to(torch.int8),
                                          stable=True)[:n_missed]
                    redo = torch.stack([which.to(torch.int32), r_in[which]],
                                       1)
                    with spans.span("panel.readback"):
                        redo = redo.tolist()
                    spans.count("readback.block_factor_batched")
                    for i, ri in redo:
                        spans.count("fallback.block_factor_batched")
                        fallbacks.append((i, ri, run_panel_loop(
                            Xw[i], ri, 0, t, m, nb, preserve_l, 0, engine)))

            # ---- commit: the window path for every element that did not
            # miss, one call; an element that did is redone at full height
            # after it ----
            with spans.span("panel.commit"):
                r = _commit(commit, A, P, Q, vw_full, lamw_full, ALw, rpw,
                            p_f, q_f, r_f, r_in, miss, fallbacks, t, nb, m)

            if t == n_panels - 1:
                break                   # no trailing column is left to update
            # ---- U rows: S_b * A_b[r_b : r_b + nb], words from c0n on ----
            with spans.span("panel.u_rows"):
                sl = win[:, :nb]
                keep = slotv[None, :] < (r - r_in)[:, None]    # [B, nb]
                c0n = (t + 1) * nbw
                s_pk = inverse(_rows(lamw_full, sl), False)  # L11^{-1}, packed
                a_block = _rows(A, sl)
                a_block[:, :, :c0n] = 0
                up = schur(torch.zeros_like(a_block), s_pk, a_block, 0,
                           c0n)
                up *= keep[:, :, None].to(torch.int32)
            # ---- trailing update: A ^= Lp * U, in place, rows from r_in[b]
            # to m (the padding rows below stay zero: no launch touches
            # them) ----
            with spans.span("panel.schur"):
                schur(A[:, :m], lamw_full[:, :m], up, r_in, c0n)
    return (A[:, :m, : data.shape[2]].contiguous(), P[:, :m].contiguous(),
            Q[:, :n].contiguous(), r)


def _commit(commit, A, P, Q, vw_full, lamw_full, ALw, rpw, p_f, q_f, r_f,
            r_in, miss, fallbacks, t: int, nb: int, m: int) -> torch.Tensor:
    """Panel t's commit, in place on A, P, Q and lamw_full: ``commit`` (the
    kernel's wrapper or its plain version) for every element that did not
    miss, then each element redone at full height, ``(i, r_in[i], the
    pivot loop's outputs)`` of ``fallbacks``: its rows permuted, its panel
    and L words and its P and Q at the slots below its rank.  Returns the
    rank after the panel."""
    commit(A, P, Q, vw_full, lamw_full, ALw, rpw, p_f, q_f, r_f, r_in, miss,
           t, nb, m)
    if not fallbacks:
        return r_f
    nbw = nb // WORD_BITS
    c0w = t * nbw
    slotv = torch.arange(nb, dtype=torch.int32, device=A.device)
    r = r_f.clone()
    for i, ri, (AL, rp, r_s, _, p_i, q_i) in fallbacks:
        A[i] = A[i][rp.long()]
        A[i, :, c0w : c0w + nbw] = AL[:, :nbw]
        lamw_full[i] = AL[:, nbw:]
        keep = slotv < r_s - ri
        P[i, ri : ri + nb] = torch.where(keep, p_i, P[i, ri : ri + nb])
        Q[i, ri : ri + nb] = torch.where(keep, q_i, Q[i, ri : ri + nb])
        r[i] = r_s
    return r


def block_factor_batched(data: torch.Tensor, ncols: int, preserve_l: bool,
                         nb: int | None = None, search_window: int = 0,
                         window: int | None = None, engine: str | None = None):
    """``block_factor`` of every element of a batch.  ``data``: int32
    ``[B, m, width_for(ncols)]``, element i a packed m x ncols matrix with
    zero padding bits.  Returns ``(data [B, m, w], P int32 [B, m], Q int32
    [B, ncols], r int32 [B])``, the rank on the device.  Element i equals,
    word for word, ``block_factor(BitMatrix(data[i], ncols), preserve_l, nb,
    search_window, window)``: ``nb`` and ``window`` default as there, and
    ``engine`` is "hopper" for a batch on the card (each kernel launches or
    raises) and "plain" on the CPU.  With a ``search_window`` the call reads
    nothing back from the device."""
    _check_stack("data", data)
    B, m, w = data.shape
    if w != width_for(ncols):
        raise ValueError(f"data has {w} words a row, {ncols} columns want "
                         f"{width_for(ncols)}")
    nb, window = panel_widths(m, ncols, nb, window, search_window)
    if engine is None:
        engine = default_engine(data)
    if B == 0 or m == 0 or ncols == 0:
        dev = data.device
        ar = torch.arange
        return (data.clone(), ar(m, dtype=torch.int32, device=dev).repeat(B, 1),
                ar(ncols, dtype=torch.int32, device=dev).repeat(B, 1),
                torch.zeros(B, dtype=torch.int32, device=dev))
    return _block_factor_batched_impl(data, m, ncols, nb, preserve_l,
                                      search_window, window, engine)


@spans.entry("rank_batched")
def rank_batched(data: torch.Tensor, ncols: int) -> torch.Tensor:
    """The rank of every element of a batch, int32 ``[B]`` on the device:
    ``block_factor_batched(data, ncols, preserve_l=False)``'s ``r``."""
    return block_factor_batched(data, ncols, preserve_l=False)[3]


def _compress_l_batched(data: torch.Tensor, q: torch.Tensor, r: torch.Tensor,
                        m: int, n: int) -> torch.Tensor:
    """``_compress_l_impl(data[i], q[i], r[i], m, n)`` for every element
    (models/ple.py): the same two column gathers on the packed transpose,
    with the source events, the pointer doubling and the row thresholds per
    element ([B, n] index tensors) and the rank as an int32 ``[B]``."""
    rmax = min(m, n)
    B = data.shape[0]
    if rmax == 0 or B == 0:
        return data
    dev = data.device
    c = torch.arange(n, dtype=torch.int64, device=dev)
    t = torch.arange(rmax, dtype=torch.int64, device=dev)
    qv = q[:, :rmax].long()
    real = (t < r[:, None]) & (qv != t)
    # src_event[b, c] = the j with Q_b[j] = c (a real swap), else n; the
    # others land in one slot past the end, which is cut off
    src_event = torch.full((B, n + 1), n, dtype=torch.int64, device=dev)
    src_event.scatter_(1, torch.where(real, qv, n), t.expand(B, -1))
    src_event = src_event[:, :n]
    f = torch.where(src_event[:, :rmax] < n, src_event[:, :rmax], t)
    for _ in range(_doubling_steps(rmax)):
        f = f.gather(1, f)
    sv = src_event < n
    o1 = torch.where(sv, f.gather(1, src_event.clamp(0, rmax - 1)), c)
    tv = torch.nn.functional.pad(real, (0, n - rmax))
    o2 = torch.where(tv, torch.nn.functional.pad(qv, (0, n - rmax)), c)

    dt = transpose_words(data[:, :, : width_for(n)], m, n)   # [B, n, w(m)]
    wm = dt.shape[2]
    g1, g2 = _rows(dt, o1), _rows(dt, o2)
    m1 = _row_ge_mask(torch.where(sv, src_event, m).to(torch.int32), wm)
    m2 = _row_ge_mask(torch.where(tv, c, m).to(torch.int32), wm)
    out_t = (dt & ~m1 & ~m2) | (g1 & m1 & ~m2) | (g2 & m2)
    packed = transpose_words(out_t, n, m)
    w = data.shape[2]
    if packed.shape[2] < w:
        packed = torch.nn.functional.pad(packed, (0, w - packed.shape[2]))
    return packed[:, :, :w]


def ple_batched(data: torch.Tensor, ncols: int, nb: int | None = None):
    """``ple`` of every element of a batch: ``(M [B, m, w], P int32 [B, m],
    Q int32 [B, ncols], r int32 [B])``, element i word for word
    ``ple(BitMatrix(data[i], ncols), nb)``.  ``block_factor_batched`` with
    L kept, then the L compression of every element at once; no read-back
    beyond the sweep's."""
    d, p, q, r = block_factor_batched(data, ncols, preserve_l=True, nb=nb)
    d = _compress_l_batched(d, q, r, data.shape[1], ncols)
    return d & padding_words(ncols, d.device), p, q, r


def pluq_batched(data: torch.Tensor, ncols: int, nb: int | None = None):
    """``pluq`` of every element of a batch: ``ple_batched`` with each
    element's pivot columns moved onto the diagonal of its triangular
    region (``apply_p_right_trans_tri_batched`` with the element's Q)."""
    d, p, q, r = ple_batched(data, ncols, nb=nb)
    return apply_p_right_trans_tri_batched(d, ncols, q), p, q, r

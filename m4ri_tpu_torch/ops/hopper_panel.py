"""The PLE panel's sequential pivot loop on the card, one launch a panel.

Replaces the TPU kernel ``panel_loop`` (m4ri_tpu/ops/pallas_panel.py).  Same
contract: ``al0`` is a fused window ``[panel | L]`` of h rows and 2*nb/32
words whose row 0 sits at global position ``base``; the loop runs the nb
canonical column steps that ``panel_loop_plain`` spells out, from rank ``r0``,
and returns
``(AL, rowperm[h], r, touched[2*nb], p[nb], q[nb])`` with p and q local to
the window (the caller adds ``base`` and the panel's column offset).

What bounds it on an H100: the chain of nb dependent steps, not bytes or
operations.  The kernel (csrc/gf2_panel_hopper.cu) takes the columns in
groups of 32: inside a group a step touches one word a row, in shared
memory whatever the window's height, and the update of all other words
waits for the group's end, where it is one parallel pass.  Mode "shared":
one thread block, the panel half in shared memory (the windows of the fast
path, h = 576 and 1088).  Mode "grid": a cooperative grid over the panel in
device memory, the chain on one block and the group-end pass on all (the
full-height window of the miss fallback).  Mode "tall": the grid with the
chain's word column in device scratch instead of shared memory, for windows
above about 48,000 rows.  A window of any height fits one of them; a mode
asked for that does not fit is refused.  ``r0 >= base`` is the contract: an
int below it raises, a device value below it is taken as ``base``.

The plain version runs ``colstep`` nb times with tensor operations only (no
value is read back to the host); it is also the engine on the CPU.
``panel_loop_grouped_plain`` is the same function in the kernel's schedule.

``panel_loop_hopper_batched`` runs a batch of windows ``al0 [B, h, 2*nb/32]``
at once, each with its own rank ``r0[b]`` and base ``base[b]`` (int32 tensors
on the card), and returns the outputs of the single call stacked along a
leading batch axis.  The kernel follows the window's shape: a warp a window
(``panel_warp_kernel``) where h <= 64 and nb <= 64 (NIST's 32 x 32
matrices), else mode "shared", a block a window (``panel_kernel``), several
windows an SM where they fit and the batch outnumbers the SMs; a window that
fits neither is refused.  In mode "shared" a window with no row in range
writes the loop's outputs without a step (``panel_loop_idle_plain``).
``panel_loop_batched_plain`` is its plain version: the nb column steps, each
a few tensor operations for the whole batch; ``panel_loop_warp_plain`` is the
warp kernel's schedule in numpy and ``panel_warp_schedule_plain`` its walk of
the batch, for the tests.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils import spans
from ..utils.config import WORD_BITS

__all__ = ["panel_loop_hopper", "panel_loop_plain",
           "panel_loop_grouped_plain", "panel_loop_hopper_batched",
           "panel_loop_batched_plain", "panel_loop_warp_plain",
           "panel_loop_idle_plain", "panel_warp_schedule_plain", "MODES"]

# one block; a cooperative grid; the grid with the word column in scratch
MODES = {1: "shared", 2: "grid", 3: "tall"}
_MAX_NBW = 64                                     # MAX_NBW of the kernel
# the warp kernel's windows: h <= 64 rows (two a lane), nb <= 64 (2 * 2 words
# a row in registers: the widest the batched sweep gives a window of 64 rows,
# whose nb <= h), WARP_WINDOWS windows a block (csrc/gf2_panel_hopper.cu)
WARP_MAX_H, WARP_MAX_NBW, WARP_WINDOWS = 64, 2, 8
# the kinds of kernel the batched launch takes (batched_plan in the source),
# each counted as ``launch.panel_batched.<kind>``
BATCHED_KINDS = {1: "panel_warp_kernel", 2: "panel_kernel (several an SM)",
                 3: "panel_kernel (one an SM)"}


@functools.lru_cache(maxsize=32)
def _tables(nb: int, preserve_l: bool):
    """Per-column masks as numpy uint32 (a signed shift would overflow at bit
    31): wmask[j] keeps the panel columns that the elimination of column j
    may touch (> j when L is preserved in place, every panel column
    otherwise); lbit[s] is the multiplier bit of pivot slot s in the L half."""
    nbw = nb // WORD_BITS
    wmask = np.zeros((nb, 2 * nbw), np.uint32)
    lbit = np.zeros((nb, 2 * nbw), np.uint32)
    for j in range(nb):
        w, s = divmod(j, WORD_BITS)
        if preserve_l:
            wmask[j, w] = (0xFFFFFFFF << (s + 1)) & 0xFFFFFFFF if s < 31 else 0
            wmask[j, w + 1 : nbw] = 0xFFFFFFFF
        else:
            wmask[j, :nbw] = 0xFFFFFFFF
        lbit[j, nbw + w] = np.uint32(1) << s
    return wmask.view(np.int32), lbit.view(np.int32)


def _check(al0: torch.Tensor, nb: int) -> None:
    if al0.dtype != torch.int32 or al0.ndim != 2:
        raise TypeError(f"al0: want a 2-D int32 tensor, got {al0.dtype} "
                        f"with {al0.ndim} dims")
    if nb <= 0 or nb % WORD_BITS:
        raise ValueError(f"nb={nb} is not a positive multiple of {WORD_BITS}")
    if al0.shape[1] != 2 * (nb // WORD_BITS) or al0.shape[0] < 1:
        raise ValueError(f"al0 is {tuple(al0.shape)}, want [h >= 1, "
                         f"{2 * (nb // WORD_BITS)}]")
    if nb // WORD_BITS > _MAX_NBW:
        raise ValueError(f"nb={nb} exceeds {_MAX_NBW * WORD_BITS} columns")


def _check_batch(al0: torch.Tensor, nb: int) -> None:
    if al0.shape[0] < 1:
        raise ValueError("al0: an empty batch")
    _check(al0[0], nb)


def _scalar(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device).reshape(())


def panel_loop_plain(al0: torch.Tensor, r0, base: int, m: int, nb: int,
                     preserve_l: bool, search_window: int = 0):
    """The same function in plain PyTorch: nb column steps, each a masked
    min for the pivot, a two-row swap and one outer-product XOR.  ``r0`` may
    be an int or a tensor on al0's device."""
    _check(al0, nb)
    dev = al0.device
    h = al0.shape[0]
    wmask_np, lbit_np = _tables(nb, bool(preserve_l))
    wmask, lbit = (torch.from_numpy(t).to(dev) for t in (wmask_np, lbit_np))
    AL = al0.clone()
    idx = torch.arange(h, dtype=torch.int32, device=dev)
    pos = base + idx
    rowperm = idx.clone()
    touched = torch.zeros(2 * nb, dtype=torch.int32, device=dev)
    p_pan = torch.zeros(nb, dtype=torch.int32, device=dev)
    q_pan = torch.zeros(nb, dtype=torch.int32, device=dev)
    r_in = _scalar(r0, dev)
    r = r_in.clone()
    none = torch.full((), h, dtype=torch.int32, device=dev)
    for j in range(nb):
        wloc, sh = divmod(j, WORD_BITS)
        col = (AL[:, wloc] >> sh) & 1            # & 1 drops the sign copies
        cand = (col == 1) & (pos >= r) & (pos < m)
        if search_window:
            cand = cand & (pos < r + search_window)
        first = torch.where(cand, idx, none).min()
        found = first < h
        rs = torch.clamp(r - base, min=0, max=h - 1)
        ps = torch.where(found, first, rs)
        pair = torch.stack([rs, ps]).long()
        rows, perm, bits = AL[pair], rowperm[pair], col[pair]
        back = pair.flip(0)                      # rs == ps writes a row twice,
        AL[back] = rows                          # with the same words
        rowperm[back] = perm
        col[back] = bits                         # the column after the swap
        touched[2 * j : 2 * j + 2] = pair.to(torch.int32)
        slot = (r - r_in).long().reshape(1)      # 0 <= slot <= j
        p_pan[slot] = ps
        q_pan[slot] = j
        elim_row = (rows[1] & wmask[j]) | lbit[slot][0]
        elim = (col == 1) & (pos > r) & found
        AL ^= torch.where(elim[:, None], elim_row[None, :], 0)
        r = r + found.to(torch.int32)
    return AL, rowperm, r, touched, p_pan, q_pan


def panel_loop_batched_plain(al0: torch.Tensor, r0: torch.Tensor,
                             base: torch.Tensor, m: int, nb: int,
                             preserve_l: bool, search_window: int = 0):
    """``panel_loop_plain`` over a leading batch axis, vectorised: window b
    (``al0[b]``, row 0 at global position ``base[b]``) starts from rank
    ``r0[b]``; every step is one masked min, one two-row swap and one
    outer-product XOR for the whole batch.  Returns the single call's
    outputs stacked: (AL [B, h, 2nbw], rowperm [B, h], r [B], touched
    [B, 2nb], p [B, nb], q [B, nb])."""
    if al0.dim() != 3:
        raise TypeError(f"al0: want a 3-D int32 tensor, got {al0.dim()} dims")
    B, h, w2 = al0.shape
    _check_batch(al0, nb)
    dev = al0.device
    wmask_np, lbit_np = _tables(nb, bool(preserve_l))
    wmask, lbit = (torch.from_numpy(t).to(dev) for t in (wmask_np, lbit_np))
    AL = al0.clone()
    idx = torch.arange(h, dtype=torch.int32, device=dev)
    base = base.to(device=dev, dtype=torch.int32)
    pos = base[:, None] + idx[None, :]                       # [B, h]
    rowperm = idx.repeat(B, 1)
    touched = torch.zeros((B, 2 * nb), dtype=torch.int32, device=dev)
    p_pan = torch.zeros((B, nb), dtype=torch.int32, device=dev)
    q_pan = torch.zeros((B, nb), dtype=torch.int32, device=dev)
    r_in = r0.to(device=dev, dtype=torch.int32)
    r = r_in.clone()
    for j in range(nb):
        wloc, sh = divmod(j, WORD_BITS)
        col = (AL[:, :, wloc] >> sh) & 1                     # [B, h]
        cand = (col == 1) & (pos >= r[:, None]) & (pos < m)
        if search_window:
            cand = cand & (pos < (r + search_window)[:, None])
        first = torch.where(cand, idx[None, :], h).min(dim=1).values
        found = first < h
        rs = torch.clamp(r - base, min=0, max=h - 1)
        ps = torch.where(found, first, rs)
        pair = torch.stack([rs, ps], dim=1).long()           # [B, 2]
        pair_w = pair[:, :, None].expand(B, 2, w2)
        rows = AL.gather(1, pair_w)
        perm, bits = rowperm.gather(1, pair), col.gather(1, pair)
        back = pair.flip(1)          # rs == ps writes a row twice, the same
        AL.scatter_(1, back[:, :, None].expand(B, 2, w2), rows)
        rowperm.scatter_(1, back, perm)
        col.scatter_(1, back, bits)                          # after the swap
        touched[:, 2 * j:2 * j + 2] = pair.to(torch.int32)
        slot = (r - r_in).long()[:, None]                    # 0 <= slot <= j
        p_pan.scatter_(1, slot, ps[:, None])
        q_pan.scatter_(1, slot, torch.full_like(ps[:, None], j))
        elim_row = (rows[:, 1] & wmask[j]) | lbit[slot[:, 0]]
        elim = (col == 1) & (pos > r[:, None]) & found[:, None]
        AL ^= torch.where(elim[:, :, None], elim_row[:, None, :], 0)
        r = r + found.to(torch.int32)
    return AL, rowperm, r, touched, p_pan, q_pan


def _net_permutation(swaps):
    """The transpositions (rs, ps) of one group, applied in order, as one
    gather: position dst[i] ends up with the row that sat at src[i]."""
    content = {}
    for rs, ps in swaps:
        a, b = content.get(rs, rs), content.get(ps, ps)
        content[rs], content[ps] = b, a
    dst = np.fromiter(content, dtype=np.int64, count=len(content))
    src = np.array([content[d] for d in dst], dtype=np.int64)
    return dst, src


def panel_loop_grouped_plain(al0: torch.Tensor, r0, base: int, m: int,
                             nb: int, preserve_l: bool,
                             search_window: int = 0):
    """The same function in the schedule the kernel follows (numpy, for the
    tests): columns in groups of 32 = one packed word column.  Inside a
    group the chain of steps sees one word a row; each step logs its pivot's
    column, its masked pivot word and its swap.  At the group's end the
    swaps move whole rows as one gather, every row replays the group on its
    own word (which gives its multiplier word), the pivot rows' multipliers
    resolve into combinations of the *raw* pivot rows, every lower row takes
    the XOR of the raw pivot rows its combination selects on the other
    words, and its multiplier word lands in the L half at the group's first
    slot (across two words if need be).  ``r0 >= base`` is assumed."""
    _check(al0, nb)
    dev = al0.device
    AL = al0.detach().cpu().contiguous().numpy().view(np.uint32).copy()
    h, nbw = AL.shape[0], nb // WORD_BITS
    pan, lh = AL[:, :nbw], AL[:, nbw:]
    full = np.uint32(0xFFFFFFFF)
    pos = np.arange(h)
    rowperm = np.arange(h, dtype=np.int32)
    touched = np.zeros(2 * nb, np.int32)
    p_pan, q_pan = np.zeros(nb, np.int32), np.zeros(nb, np.int32)
    r_in = r = int(r0)
    if r_in < base:
        raise ValueError(f"r0={r_in} lies above the window's base {base}")
    for g in range(nbw):
        c = pan[:, g].copy()             # all the chain reads and writes
        rl0, slot0 = r - base, r - r_in
        shs, pvs, swaps = [], [], []
        for sh in range(WORD_BITS):
            j = WORD_BITS * g + sh
            rl = r - base
            rs = min(rl, h - 1)
            hi = min(h, m - base)
            if search_window:
                hi = min(hi, rl + search_window)
            cand = np.flatnonzero((((c >> np.uint32(sh)) & 1) == 1)
                                  & (pos >= rl) & (pos < hi))
            found = cand.size > 0
            ps = int(cand[0]) if found else rs
            touched[2 * j : 2 * j + 2] = rs, ps
            p_pan[r - r_in], q_pan[r - r_in] = ps, j
            if not found:
                continue
            keep = full if not preserve_l else \
                np.uint32(0) if sh == 31 else full << np.uint32(sh + 1)
            pv = c[ps] & keep
            c[ps] = c[rs]                # slot rs is dead to the chain now
            take = (pos > rl) & (((c >> np.uint32(sh)) & 1) == 1)
            c[take] ^= pv
            shs.append(np.uint32(sh))
            pvs.append(pv)
            swaps.append((rs, ps))
            r += 1
        K = len(shs)
        if K == 0:
            continue
        dst, src = _net_permutation(swaps)
        AL[dst] = AL[src]
        rowperm[dst] = rowperm[src]
        raw = pan[rl0 : rl0 + K].copy()  # the pivot rows, not yet up to date
        comb = []                        # pivot k = XOR of raw rows comb[k]
        for k in range(K):
            x, t = raw[k, g], np.uint32(1 << k)
            for k2 in range(k):
                if (x >> shs[k2]) & 1:
                    x ^= pvs[k2]
                    t ^= comb[k2]
            comb.append(t)
        rows = np.arange(rl0, h)
        x = pan[rows, g].copy()
        mu = np.zeros(rows.size, np.uint32)
        sel = np.zeros(rows.size, np.uint32)
        for k in range(K):               # a pivot row stops at its own step
            act = (rows - rl0 > k) & (((x >> shs[k]) & 1) == 1)
            x[act] ^= pvs[k]
            mu[act] |= np.uint32(1 << k)
            sel[act] ^= comb[k]
        pan[rows, g] = x
        ws = [w for w in range(nbw) if (w > g if preserve_l else w != g)]
        for k in range(K):
            hit = rows[((sel >> np.uint32(k)) & 1) == 1]
            if ws and hit.size:
                pan[np.ix_(hit, ws)] ^= raw[k, ws][None, :]
        lw, s = divmod(slot0, WORD_BITS)
        wide = mu.astype(np.uint64) << np.uint64(s)
        lh[rows, lw] ^= (wide & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        if lw + 1 < nbw:
            lh[rows, lw + 1] ^= (wide >> np.uint64(32)).astype(np.uint32)
    ints = dict(dtype=torch.int32, device=dev)
    return (torch.from_numpy(AL.view(np.int32)).to(dev),
            torch.from_numpy(rowperm).to(dev), torch.tensor(r, **ints),
            torch.from_numpy(touched).to(dev), torch.from_numpy(p_pan).to(dev),
            torch.from_numpy(q_pan).to(dev))


def panel_loop_idle_plain(al0: torch.Tensor, r0, base: int, m: int, nb: int):
    """The kernel's exit for a window with no row in range, in plain
    PyTorch: None if some step could find a row (a row of the window lies at
    a position in [r_in, m), r_in = max(r0, base)), else the outputs the loop
    leaves: AL = al0, the identity, r = r_in, every step's swap (rs, rs)
    with rs = min(r_in - base, h - 1), and slot 0 written by every step, so
    p[0] = rs, q[0] = nb - 1, the other slots 0.  A search window only
    narrows the range from below r_in + 1, so it never opens one."""
    _check(al0, nb)
    h = al0.shape[0]
    r_in = max(int(r0), base)
    if min(h, m - base) > r_in - base:
        return None
    dev = al0.device
    rs = min(r_in - base, h - 1)
    p_pan = torch.zeros(nb, dtype=torch.int32, device=dev)
    q_pan = torch.zeros(nb, dtype=torch.int32, device=dev)
    p_pan[0], q_pan[0] = rs, nb - 1
    return (al0.clone(), torch.arange(h, dtype=torch.int32, device=dev),
            torch.tensor(r_in, dtype=torch.int32, device=dev),
            torch.full((2 * nb,), rs, dtype=torch.int32, device=dev),
            p_pan, q_pan)


def panel_warp_schedule_plain(batch: int, windows: int = WARP_WINDOWS):
    """The warp kernel's walk of a batch (numpy): [blocks, windows] window
    indices, block x's warp w taking window x * windows + w, -1 where that
    is past the batch (the tail of the last block)."""
    blocks = -(-batch // windows)
    e = np.arange(blocks * windows).reshape(blocks, windows)
    return np.where(e < batch, e, -1)


def panel_loop_warp_plain(al0: torch.Tensor, r0, base: int, m: int, nb: int,
                          preserve_l: bool, search_window: int = 0):
    """The same function in the warp kernel's schedule (numpy, for the
    tests): lane l holds rows l and l + 32 with all their words and the
    position each has reached (h <= 64, nb <= 64).  A step takes the least
    key (position << 6 | holder) over the rows in range with a 1 (the
    warp's min-reduction), the pivot's panel words from its holder (a
    shuffle), exchanges the positions of the rank's slot and the pivot,
    XORs the pivot's masked words and the slot's multiplier bit into the
    rows below with a 1; every row lands at its position at the end.  A step
    logs only its pivot position and whether it found one: at the group's
    end each step's rank is the group's first rank plus the pivots found
    before it, which gives its swap and its slot; the slot's writer that
    stays is the step that found a pivot there or a group's last step, and
    the slots past the last one written are 0."""
    _check(al0, nb)
    h, nbw = al0.shape[0], nb // WORD_BITS
    if h > WARP_MAX_H or nbw > WARP_MAX_NBW:
        raise ValueError(f"h={h}, nb={nb}: past the warp kernel's window")
    dev = al0.device
    src = al0.detach().cpu().contiguous().numpy().view(np.uint32)
    R = 1 if h <= 32 else 2
    lane = np.arange(32)
    row = lane[None, :] + 32 * np.arange(R)[:, None]          # [R, 32]
    v = np.zeros((R, 32, 2 * nbw), np.uint32)
    v[row < h] = src[row[row < h]]
    pos = np.where(row < h, row, WARP_MAX_H)
    holder = (np.arange(R)[:, None] << 5) | lane[None, :]
    r_in = r = max(int(r0), base)
    hi_all = min(h, m - base)
    touched = np.zeros(2 * nb, np.int32)
    p_pan, q_pan = np.full(nb, -1, np.int32), np.full(nb, -1, np.int32)
    t_ps = np.zeros(WORD_BITS, np.int32)                       # a lane a step
    for j in range(nb):
        g, sh = divmod(j, WORD_BITS)
        if sh == 0:
            r_g, fmask = r, 0
        rl = r - base
        hi = min(hi_all, rl + search_window) if search_window else hi_all
        bit = ((v[:, :, g] >> np.uint32(sh)) & 1) == 1
        cand = bit & (pos >= rl) & (pos < hi)
        keys = np.where(cand, (pos << 6) | holder, np.iinfo(np.int64).max)
        key = int(keys.min())                                  # the reduction
        found = bool(cand.any())
        rs = max(0, min(rl, h - 1))
        ps = key >> 6 if found else rs
        t_ps[sh] = ps
        if found:
            fmask |= 1 << sh
            slot = r - r_in
            _warp_step(v, pos, bit, key, rs, ps, rl, slot, g, sh, nbw,
                       preserve_l)
            r += 1
        if sh == WORD_BITS - 1:        # the group's end: its log written out
            for ln in range(WORD_BITS):
                rb = r_g + bin(fmask & ((1 << ln) - 1)).count("1")
                j2 = WORD_BITS * g + ln
                touched[2 * j2:2 * j2 + 2] = max(0, min(rb - base, h - 1)), \
                    t_ps[ln]
                if (fmask >> ln) & 1 or ln == WORD_BITS - 1:
                    p_pan[rb - r_in], q_pan[rb - r_in] = t_ps[ln], j2
    last = r - r_in - (fmask >> 31)
    assert (p_pan[:last + 1] >= 0).all()          # every slot up to it written
    p_pan[last + 1:] = q_pan[last + 1:] = 0
    AL = np.zeros_like(src)
    rowperm = np.zeros(h, np.int32)
    live = row < h
    AL[pos[live]] = v[live]
    rowperm[pos[live]] = row[live]
    ints = dict(dtype=torch.int32, device=dev)
    return (torch.from_numpy(AL.view(np.int32)).to(dev),
            torch.from_numpy(rowperm).to(dev), torch.tensor(r, **ints),
            torch.from_numpy(touched).to(dev), torch.from_numpy(p_pan).to(dev),
            torch.from_numpy(q_pan).to(dev))


def _warp_step(v, pos, bit, key, rs, ps, rl, slot, g, sh, nbw, preserve_l):
    """One step of the warp kernel that found its pivot (numpy, in place):
    the pivot's panel words from its holder, the exchange of two positions,
    the masked XOR and the multiplier bit into the rows below with a 1."""
    full = np.uint32(0xFFFFFFFF)
    pw = v[(key >> 5) & 1, key & 31, :nbw].copy()             # the shuffle
    pos[:] = np.where(pos == rs, ps, np.where(pos == ps, rs, pos))
    keep = np.full(nbw, full)
    if preserve_l:
        keep[:g] = 0
        keep[g] = 0 if sh == 31 else full << np.uint32(sh + 1)
    elim = bit & (pos > rl)
    v[elim, :nbw] ^= pw & keep
    v[elim, nbw + slot // WORD_BITS] ^= np.uint32(1 << (slot % WORD_BITS))


_VOID, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_long


@functools.lru_cache(maxsize=None)
def _fns():
    from ._build import load
    lib = load("gf2_panel_hopper")
    launch, mode = lib.gf2_panel_loop_hopper_launch, lib.gf2_panel_loop_hopper_mode
    scratch, floor, threads = (lib.gf2_panel_loop_hopper_scratch_words,
                               lib.gf2_panel_chain_floor_launch,
                               lib.gf2_panel_loop_hopper_threads)
    launch.argtypes = [_VOID] * 9 + [_INT] * 9 + [_VOID]
    mode.argtypes = [_INT] * 3
    scratch.argtypes = [_INT] * 2
    floor.argtypes = [_INT, _INT, _VOID, _VOID]
    threads.argtypes = [_INT]
    batched = lib.gf2_panel_loop_hopper_batched_launch
    batched.argtypes = [_VOID] * 9 + [_INT] * 6 + [_VOID] * 2
    launch.restype = mode.restype = floor.restype = threads.restype = _INT
    batched.restype = _INT
    scratch.restype = _LONG
    return launch, mode, scratch, floor, threads, batched


def window_mode(h: int, nb: int, mode: int = 0) -> str:
    """How the kernel runs a window of h rows on the current card: a value
    of MODES.  Raises if the mode asked for does not fit.  Builds the kernel
    if need be."""
    got = _fns()[1](mode, h, nb // WORD_BITS)
    if got not in MODES:
        raise RuntimeError(f"a window of {h} rows, nb={nb}, does not fit "
                           f"shared memory in mode {MODES.get(mode, mode)}")
    return MODES[got]


def _launch(al0, r0, base, m, nb, preserve_l, search_window, mode=0,
            row_work=True):
    """Launch the kernel.  ``mode``: 0 lets the kernel choose, else a key of
    MODES, refused when it does not fit.  ``row_work=False`` leaves every
    group's end out (timing of the chain alone; the outputs are then not the
    function's)."""
    dev = al0.device
    h, w2 = al0.shape
    nbw = nb // WORD_BITS
    al0 = al0.contiguous()
    launch, _, scratch_words = _fns()[:3]
    # every output and the scratch from one allocation, cut into views
    sizes = (h * w2, h, 2 * nb, nb, nb, 1, scratch_words(h, nbw))
    offs = [0]
    for n in sizes:
        offs.append(offs[-1] + n)
    buf = torch.empty(offs[-1], dtype=torch.int32, device=dev)
    al = buf.as_strided((h, w2), (w2, 1), 0)
    rowperm, touched, p_pan, q_pan = (
        buf.as_strided((sizes[k],), (1,), offs[k]) for k in (1, 2, 3, 4))
    r_out = buf.as_strided((), (), offs[5])
    ptr = [buf.data_ptr() + 4 * o for o in offs]
    if isinstance(r0, torch.Tensor):   # read on the card, no round trip
        r_dev = r0.to(device=dev, dtype=torch.int32)
        r_ptr, r_val = r_dev.data_ptr(), 0
    else:
        r_ptr, r_val = None, int(r0)
        if r_val < base:
            raise ValueError(f"r0={r0} lies above the window's base {base}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(al0.data_ptr(), ptr[0], ptr[1], ptr[5], ptr[2], ptr[3],
                     ptr[4], r_ptr, ptr[6],
                     base, m, h, nbw, int(bool(preserve_l)), search_window,
                     mode, int(row_work), r_val, stream)
    spans.count("launch.panel_loop_hopper")
    if err:
        raise RuntimeError(f"panel_loop_hopper: CUDA error {err} at launch "
                           f"(h={h}, nb={nb}, mode={mode})")
    return al, rowperm, r_out, touched, p_pan, q_pan


def chain_floor(steps: int, threads: int) -> None:
    """Launch the probe of the chain's floor: ``steps`` dependent steps of a
    barrier, a warp ballot and a shared-memory round trip in one block of
    ``threads`` threads.  For timing; needs the card."""
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    err = _fns()[3](steps, threads, out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"chain_floor: CUDA error {err} at launch")


def kernel_threads(h: int) -> int:
    """The block size the kernel takes for a window of h rows."""
    return _fns()[4](h)


def panel_loop_hopper(al0: torch.Tensor, r0, base: int, m: int, nb: int,
                      preserve_l: bool, search_window: int = 0):
    """The canonical nb-column pivot loop on a fused window; see the module
    text for the contract.  ``r0``: an int, or a tensor on al0's device (the
    rank a previous launch left there).  A window of any height goes to the
    kernel.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    _check(al0, nb)
    with spans.span("kernel.panel_loop_hopper", h=al0.shape[0], nb=nb,
                    base=base, search_window=search_window):
        if not al0.is_cuda:
            return panel_loop_plain(al0, r0, base, m, nb, preserve_l,
                                    search_window)
        return _launch(al0, r0, base, m, nb, preserve_l, search_window)


def panel_loop_hopper_batched(al0: torch.Tensor, r0: torch.Tensor,
                              base: torch.Tensor, m: int, nb: int,
                              preserve_l: bool, search_window: int = 0):
    """The pivot loop on a batch of fused windows; see the module text.
    ``r0`` and ``base``: int32 tensors ``[B]`` on al0's device (``r0 >=
    base`` is the contract; a value below is taken as the base).  CPU
    tensors take the plain version; CUDA tensors launch the kernel (a warp
    a window, or mode shared) or raise."""
    if al0.dtype != torch.int32 or al0.dim() != 3:
        raise TypeError(f"al0: want a 3-D int32 tensor, got {al0.dtype} with "
                        f"{al0.dim()} dims")
    B = al0.shape[0]
    _check_batch(al0, nb)
    for name, t in (("r0", r0), ("base", base)):
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != (B,):
            raise TypeError(f"{name}: want a tensor of shape ({B},)")
        if t.device != al0.device:
            raise ValueError(f"{name} lies on {t.device}, al0 on {al0.device}")
    with spans.span("kernel.panel_loop_hopper_batched", batch=B,
                    h=al0.shape[1], nb=nb, search_window=search_window):
        if not al0.is_cuda:
            return panel_loop_batched_plain(al0, r0, base, m, nb, preserve_l,
                                            search_window)
        return _launch_batched(al0, r0, base, m, nb, preserve_l,
                               search_window)


def _launch_batched(al0, r0, base, m, nb, preserve_l, search_window):
    """Launch the batched pivot loop (checked by the caller)."""
    B = al0.shape[0]
    dev = al0.device
    h, w2 = al0.shape[1:]
    al0 = al0.contiguous()
    if al0.data_ptr() % 16:            # the kernels load 8 or 16 bytes a row
        al0 = al0.clone()
    r0, base = (t.to(torch.int32).contiguous() for t in (r0, base))
    sizes = (B * h * w2, B * h, B, B * 2 * nb, B * nb, B * nb)
    offs = [0]
    for n in sizes:
        offs.append(offs[-1] + n)
    buf = torch.empty(offs[-1], dtype=torch.int32, device=dev)
    al = buf.as_strided((B, h, w2), (h * w2, w2, 1), 0)
    rowperm = buf.as_strided((B, h), (h, 1), offs[1])
    r_out = buf.as_strided((B,), (1,), offs[2])
    touched = buf.as_strided((B, 2 * nb), (2 * nb, 1), offs[3])
    p_pan = buf.as_strided((B, nb), (nb, 1), offs[4])
    q_pan = buf.as_strided((B, nb), (nb, 1), offs[5])
    ptr = [buf.data_ptr() + 4 * o for o in offs]
    kind_out = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = _fns()[5](al0.data_ptr(), ptr[0], ptr[1], ptr[2], ptr[3],
                        ptr[4], ptr[5], r0.data_ptr(), base.data_ptr(), B, m,
                        h, nb // WORD_BITS, int(bool(preserve_l)),
                        search_window, ctypes.addressof(kind_out),
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"panel_loop_hopper_batched: CUDA error {err} at "
                           f"launch (B={B}, h={h}, nb={nb}: neither a warp "
                           "nor mode shared takes the window)")
    spans.count("launch.panel_loop_hopper_batched")
    spans.count(f"launch.panel_batched.{BATCHED_KINDS[kind_out.value]}")
    return al, rowperm, r_out, touched, p_pan, q_pan

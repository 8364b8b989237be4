"""The PLE panel's sequential pivot loop on the card, one launch a panel.

Replaces the TPU kernel ``panel_loop`` (m4ri_tpu/ops/pallas_panel.py).  Same
contract: ``al0`` is a fused window ``[panel | L]`` of h rows and 2*nb/32
words whose row 0 sits at global position ``base``; the loop runs the nb
canonical column steps that ``panel_loop_plain`` spells out, from rank ``r0``,
and returns
``(AL, rowperm[h], r, touched[2*nb], p[nb], q[nb])`` with p and q local to
the window (the caller adds ``base`` and the panel's column offset).

What bounds it on an H100: the chain of nb dependent steps, not bytes or
operations.  The kernel (csrc/gf2_panel_hopper.cu) gives the window to one
thread block, keeps it in shared memory when it fits (all of it, or the
panel half with the L half in device memory) and works in device memory when
it does not, as for the full-height window of the miss fallback.

The plain version runs ``colstep`` nb times with tensor operations only (no
value is read back to the host); it is also the engine on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils.config import WORD_BITS

__all__ = ["panel_loop_hopper", "panel_loop_plain", "MODES"]

MODES = {1: "shared", 2: "split", 3: "global"}   # where the window lives
_MAX_NBW = 64                                     # MAX_NBW of the kernel


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


_VOID, _INT = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fns():
    from ._build import load
    lib = load("gf2_panel_hopper")
    launch, mode = lib.gf2_panel_loop_hopper_launch, lib.gf2_panel_loop_hopper_mode
    launch.argtypes = [_VOID] * 8 + [_INT] * 8 + [_VOID]
    mode.argtypes = [_INT] * 3
    launch.restype = mode.restype = _INT
    return launch, mode


def window_mode(h: int, nb: int, mode: int = 0) -> str:
    """Where the kernel keeps a window of h rows on the current card:
    "shared", "split" or "global".  Builds the kernel if need be."""
    got = _fns()[1](mode, h, nb // WORD_BITS)
    if got not in MODES:
        raise RuntimeError(f"a window of {h} rows, nb={nb}, does not fit "
                           f"shared memory in mode {MODES.get(mode, mode)}")
    return MODES[got]


def _launch(al0, r0, base, m, nb, preserve_l, search_window, mode=0,
            row_work=True):
    """Launch the kernel.  ``mode``: 0 lets the kernel choose, else a key of
    MODES, refused when it does not fit.  ``row_work=False`` leaves the update
    of the lower rows out (timing of the serial skeleton only)."""
    dev = al0.device
    h = al0.shape[0]
    al0 = al0.contiguous()
    al = torch.empty_like(al0)
    ints = dict(dtype=torch.int32, device=dev)
    rowperm = torch.empty(h, **ints)
    touched = torch.empty(2 * nb, **ints)
    p_pan, q_pan = torch.empty(nb, **ints), torch.empty(nb, **ints)
    r_out = torch.empty((), **ints)
    r_in = _scalar(r0, dev)
    launch = _fns()[0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(al0.data_ptr(), al.data_ptr(), rowperm.data_ptr(),
                     r_out.data_ptr(), touched.data_ptr(), p_pan.data_ptr(),
                     q_pan.data_ptr(), r_in.data_ptr(), base, m, h,
                     nb // WORD_BITS, int(bool(preserve_l)), search_window,
                     mode, int(row_work), stream)
    panel_loop_hopper.launches += 1
    if err:
        raise RuntimeError(f"panel_loop_hopper: CUDA error {err} at launch "
                           f"(h={h}, nb={nb}, mode={mode})")
    return al, rowperm, r_out, touched, p_pan, q_pan


def panel_loop_hopper(al0: torch.Tensor, r0, base: int, m: int, nb: int,
                      preserve_l: bool, search_window: int = 0):
    """The canonical nb-column pivot loop on a fused window; see the module
    text for the contract.  ``r0``: an int, or a tensor on al0's device (the
    rank a previous launch left there).  A window of any height goes to the
    kernel.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    _check(al0, nb)
    if not al0.is_cuda:
        return panel_loop_plain(al0, r0, base, m, nb, preserve_l, search_window)
    return _launch(al0, r0, base, m, nb, preserve_l, search_window)


panel_loop_hopper.launches = 0

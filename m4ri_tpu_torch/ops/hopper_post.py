"""The PLE panel's elimination of the rows below the window, on the card.

Replaces the TPU kernel ``panel_post`` (m4ri_tpu/ops/pallas_post.py).  Same
contract: ``xw`` int32 ``[m, nb/32]`` packed stale panel words; ``m_small``
(= E^T T) and ``wmat`` 0/1 int8 ``[nb, nb]``; ``colmask_bits`` 0/1 int8
``[nb]`` (1 at the valid columns declared non-pivot; all zero switches the
miss check off).  For the rows in ``[below0, mvalid)``

    lam = X * m_small,   v = X ^ lam * wmat,   miss = any(v & colmask)

and every other row passes through with lam = 0.  Returns ``(vw, lamw,
miss)``: packed v, packed lam, and a 0-dim bool tensor.

What bounds it on an H100: bytes; the panel's words and the two small
operands, which arrive as one byte a bit, against microseconds of 1-bit MMA.
A call is two launches of the same source (csrc/gf2_post_hopper.cu) from one
call into the library: a packing kernel, a grid sized to the card, writes
M^T and W^T transposed and packed along the contraction (the layout of a
right operand of the 1-bit MMA), the packed column mask and the zeroed flag,
and copies X to v with lam zeroed on every row out of range
(``_packed_transposed`` and ``_packed_colmask`` are its plain versions);
then a persistent grid of MMA blocks takes the 128-row tiles that hold a
row in range, forms lam and v there with the packed tile product, writes
both once and sets the miss flag, one device byte.

``panel_post_hopper_batched`` is the same function over a batch of panels:
``xw [B, m, nb/32]``, ``m_small`` / ``wmat [B, nb, nb]``, ``colmask_bits
[B, nb]``, ``below0`` one int32 an element on the card, ``mvalid`` shared;
it returns ``(vw [B], lamw [B], miss bool [B])``.  An element with no row
in range passes through whole and its operands are never read; the MMA
blocks walk the in-range tiles of the batch through their prefix sum, made
on the card (``_in_range_tiles``; ``post_schedule_batched_plain`` is the
grid's walk in numpy).  The single call is the batch of one.
``panel_post_batched_plain`` is its plain version, vectorised over the
batch.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils import spans
from ..utils.config import WORD_BITS
from .mul import _dot_parity, pack_bits, unpack_bits

__all__ = ["panel_post_hopper", "panel_post_plain", "pack_operands_hopper",
           "panel_post_hopper_batched", "panel_post_batched_plain",
           "post_schedule_batched_plain", "post_pack_schedule_plain"]

_MAX_GRID_X = 2**31 - 1
_TILE_ROWS = 128  # BM of csrc/gf2_tile.cuh


def _check(xw, m_small, wmat, colmask_bits) -> None:
    if xw.dtype != torch.int32 or xw.ndim != 2:
        raise TypeError(f"xw: want a 2-D int32 tensor, got {xw.dtype} with "
                        f"{xw.ndim} dims")
    nb = xw.shape[1] * WORD_BITS
    if xw.shape[1] > 1 and xw.stride(1) != 1:
        raise ValueError("xw: the words of a row must be adjacent")
    for name, t, shape in (("m_small", m_small, (nb, nb)),
                           ("wmat", wmat, (nb, nb)),
                           ("colmask_bits", colmask_bits, (nb,))):
        if t.dtype != torch.int8 or tuple(t.shape) != shape:
            raise TypeError(f"{name}: want int8 {shape}, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.device != xw.device:
            raise ValueError(f"{name} lies on {t.device}, xw on {xw.device}")
    if -(-xw.shape[0] // _TILE_ROWS) > _MAX_GRID_X:
        raise ValueError(f"{xw.shape[0]} rows exceed the launch grid")


def panel_post_plain(xw: torch.Tensor, m_small: torch.Tensor,
                     wmat: torch.Tensor, colmask_bits: torch.Tensor,
                     below0: int, mvalid: int):
    """The same function in plain PyTorch, unfused: unpack the panel, two
    ``torch.matmul`` products with parity, pack twice, reduce the flag."""
    _check(xw, m_small, wmat, colmask_bits)
    m = xw.shape[0]
    pos = torch.arange(m, device=xw.device)
    rows = ((pos >= below0) & (pos < mvalid))[:, None]
    lamw = torch.where(
        rows, _dot_parity(unpack_bits(xw), m_small.to(torch.float32)), 0)
    vw = xw ^ _dot_parity(unpack_bits(lamw), wmat.to(torch.float32))
    colmask = _packed_colmask(colmask_bits)
    miss = (torch.where(rows, vw & colmask[None, :], 0) != 0).any()
    return vw, lamw, miss


_VOID, _LONG, _INT = ctypes.c_void_p, ctypes.c_long, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fns():
    from ._build import load
    lib = load("gf2_post_hopper")
    post, pack = lib.gf2_panel_post_hopper_launch, lib.gf2_panel_post_pack_launch
    post.argtypes = [_VOID, _LONG] + [_VOID] * 7 + [_INT] * 4 + [_VOID]
    pack.argtypes = [_VOID] * 5 + [_LONG, _VOID, _VOID, _INT, _VOID]
    scratch = lib.gf2_panel_post_scratch_words
    scratch.argtypes, scratch.restype = [_INT], _LONG
    bpost = lib.gf2_panel_post_hopper_batched_launch
    bpost.argtypes = [_VOID, _LONG, _LONG] + [_VOID] * 9 + [_INT] * 5 + [_VOID]
    post.restype = pack.restype = bpost.restype = _INT
    return post, pack, scratch, bpost


def _row_words(nb: int) -> int:
    """Words a packed row of M^T or W^T takes: a multiple of 4 (16 bytes)."""
    return (nb // WORD_BITS + 3) // 4 * 4


@functools.lru_cache(maxsize=None)
def _scratch_words(nb: int) -> int:
    """Words the kernels want for M^T, W^T and the packed column mask."""
    return _fns()[2](nb)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` dense and 16-byte aligned, as the packing kernel loads it: no
    copy unless it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _in_range_tiles(below0: torch.Tensor, m: int, mvalid: int) -> torch.Tensor:
    """Each element's 128-row tiles that hold a row of ``[max(below0_e, 0),
    min(mvalid, m))``, int64 ``[B]`` on below0's device: the MMA items of the
    batched launch, whose prefix sum its blocks search (the launch makes the
    sum on the card itself; this is it in plain PyTorch, for the schedule
    below).  0: no row in range, and the element's operands are never
    read."""
    hi = min(mvalid, m)
    lo = below0.to(torch.int64).clamp(min=0)
    t_hi = -(-hi // _TILE_ROWS) if hi > 0 else 0
    return torch.where(lo < hi, t_hi - lo // _TILE_ROWS, 0)


def post_schedule_batched_plain(m: int, below0s, mvalid: int,
                                blocks: int) -> list:
    """The MMA grid's walk in numpy: for each of ``blocks`` blocks the
    (element, 128-row tile) pairs it takes, in order.  Item s of the
    concatenated in-range tiles (``_in_range_tiles``, element after
    element) goes to block s % blocks; it is tile ``max(below0_e, 0) // 128
    + s - cum[e - 1]`` of the element e with ``cum[e - 1] <= s < cum[e]``."""
    below0s = np.asarray(below0s, np.int64)
    cum = torch.cumsum(_in_range_tiles(torch.from_numpy(below0s), m, mvalid),
                       0).numpy()
    total = int(cum[-1]) if len(cum) else 0
    out = []
    for b in range(blocks):
        s = np.arange(b, total, blocks)
        e = np.searchsorted(cum, s, side="right")
        first = np.where(e > 0, cum[np.maximum(e - 1, 0)], 0)
        t0 = np.maximum(below0s[e], 0) // _TILE_ROWS
        out.append(np.stack([e, t0 + s - first], axis=1))
    return out


def post_pack_schedule_plain(B: int, nb: int, below0s, m: int, mvalid: int,
                             warps: int) -> list:
    """The packing kernel's walk in numpy: for each of ``warps`` warps the
    units it packs, in order, as (element, plane, 32-column strip, 4-word
    group) rows; plane 0 is M, 1 is W.  Lane l of warp w tests unit ``r +
    l * warps`` for r = w, w + 32 * warps, ...; the warp packs, lane after
    lane, those of elements with a row in range, and no unit of the others
    (``_in_range_tiles`` 0)."""
    nbw = nb // WORD_BITS
    groups = _row_words(nb) // 4
    per = 2 * nbw * groups
    units = per * B
    live = (_in_range_tiles(torch.as_tensor(np.asarray(below0s)), m, mvalid)
            > 0).numpy()
    out = []
    for w in range(warps):
        got = []
        for r in range(w, units, 32 * warps):
            u = r + np.arange(32, dtype=np.int64) * warps
            u = u[u < units]
            got.append(u[live[u // per]])
        u = np.concatenate(got) if got else np.zeros(0, np.int64)
        e, rem = u // per, u % per
        z, rem = rem // (nbw * groups), rem % (nbw * groups)
        out.append(np.stack([e, z, rem // groups, rem % groups], axis=1))
    return out


def _packed_transposed(bits: torch.Tensor) -> torch.Tensor:
    """0/1 int8 [nb, nb] -> its transpose packed along the contraction,
    int32 [nb, ld] with ld a multiple of 4 words (16-byte rows).  The plain
    version of the packing kernel."""
    nb = bits.shape[0]
    nbw = nb // WORD_BITS
    out = torch.zeros((nb, _row_words(nb)), dtype=torch.int32,
                      device=bits.device)
    out[:, :nbw] = pack_bits(bits.t().to(torch.int32))
    return out


def _packed_colmask(colmask_bits: torch.Tensor) -> torch.Tensor:
    """0/1 int8 [nb] -> int32 [nb/32].  Plain version, as above."""
    return pack_bits(colmask_bits[None, :].to(torch.int32))[0].contiguous()


def pack_operands_hopper(m_small: torch.Tensor, wmat: torch.Tensor,
                         colmask_bits: torch.Tensor):
    """The packing kernel alone: (M^T packed, W^T packed, packed column
    mask), as ``_packed_transposed`` / ``_packed_colmask`` give them.  CUDA
    tensors only."""
    nb = m_small.shape[0]
    ld, nbw = _row_words(nb), nb // WORD_BITS
    buf = torch.empty(2 * nb * ld + nbw + 1, dtype=torch.int32,
                      device=m_small.device)
    mt, wt = (buf.as_strided((nb, ld), (ld, 1), k * nb * ld) for k in (0, 1))
    colmask = buf.as_strided((nbw,), (1,), 2 * nb * ld)
    m_small, wmat = _aligned(m_small), _aligned(wmat)
    colmask_bits = colmask_bits.contiguous()
    with torch.cuda.device(buf.device):
        err = _fns()[1](m_small.data_ptr(), wmat.data_ptr(),
                        colmask_bits.data_ptr(), mt.data_ptr(), wt.data_ptr(),
                        ld, colmask.data_ptr(), buf[-1:].data_ptr(), nb,
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"pack_operands_hopper: CUDA error {err} at launch")
    return mt, wt, colmask


def panel_post_hopper(xw: torch.Tensor, m_small: torch.Tensor,
                      wmat: torch.Tensor, colmask_bits: torch.Tensor,
                      below0: int, mvalid: int):
    """Fused elimination of the rows below the window; see the module text
    for the contract.  ``xw`` may be a view with any row stride.  CPU tensors
    take the plain version; CUDA tensors launch the kernels or raise.  On the
    card the call is two hand-written launches (packing, elimination) from
    one call into the library, and two allocations: the flag, and one that
    vw, lamw and the packed operands are cut from."""
    _check(xw, m_small, wmat, colmask_bits)
    with spans.span("kernel.panel_post_hopper", m=xw.shape[0],
                    nb=m_small.shape[0], mvalid=mvalid,
                    below0=below0 if isinstance(below0, int) else None):
        if not xw.is_cuda:
            return panel_post_plain(xw, m_small, wmat, colmask_bits, below0,
                                    mvalid)
        return _launch(xw, m_small, wmat, colmask_bits, below0, mvalid)


def _launch(xw, m_small, wmat, colmask_bits, below0, mvalid):
    """Launch the single elimination (checked by the caller)."""
    m, nbw = xw.shape
    dev = xw.device
    body = (m * nbw + 3) // 4 * 4           # keeps every part 16-byte aligned
    buf = torch.empty(2 * body + _scratch_words(nbw * WORD_BITS),
                      dtype=torch.int32, device=dev)
    vw = buf.as_strided((m, nbw), (nbw, 1), 0)
    lamw = buf.as_strided((m, nbw), (nbw, 1), body)
    miss = torch.empty((), dtype=torch.bool, device=dev)
    if m == 0 or nbw == 0:
        return vw, lamw, miss.zero_()
    m_small, wmat = _aligned(m_small), _aligned(wmat)
    colmask_bits = colmask_bits.contiguous()
    base = buf.data_ptr()
    with torch.cuda.device(dev):
        err = _fns()[0](xw.data_ptr(), xw.stride(0), m_small.data_ptr(),
                        wmat.data_ptr(), colmask_bits.data_ptr(),
                        base + 8 * body, base, base + 4 * body,
                        miss.data_ptr(), m, nbw, int(below0), int(mvalid),
                        torch.cuda.current_stream().cuda_stream)
    spans.count("launch.panel_post_hopper")
    if err:
        raise RuntimeError(f"panel_post_hopper: CUDA error {err} at launch")
    return vw, lamw, miss


def _check_batched(xw, m_small, wmat, colmask_bits, below0) -> None:
    if xw.dtype != torch.int32 or xw.ndim != 3:
        raise TypeError(f"xw: want a 3-D int32 tensor, got {xw.dtype} with "
                        f"{xw.ndim} dims")
    B, m, nbw = xw.shape
    nb = nbw * WORD_BITS
    if nbw > 1 and xw.stride(2) != 1:
        raise ValueError("xw: the words of a row must be adjacent")
    for name, t, shape in (("m_small", m_small, (B, nb, nb)),
                           ("wmat", wmat, (B, nb, nb)),
                           ("colmask_bits", colmask_bits, (B, nb))):
        if t.dtype != torch.int8 or tuple(t.shape) != shape:
            raise TypeError(f"{name}: want int8 {shape}, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.device != xw.device:
            raise ValueError(f"{name} lies on {t.device}, xw on {xw.device}")
    if not isinstance(below0, torch.Tensor) or tuple(below0.shape) != (B,):
        raise TypeError(f"below0: want a tensor of shape ({B},)")
    if below0.device != xw.device:
        raise ValueError(f"below0 lies on {below0.device}, xw on {xw.device}")
    if B * -(-m // _TILE_ROWS) > _MAX_GRID_X:
        raise ValueError(f"{B} x {m} rows exceed the launch grid")


def panel_post_batched_plain(xw: torch.Tensor, m_small: torch.Tensor,
                             wmat: torch.Tensor, colmask_bits: torch.Tensor,
                             below0: torch.Tensor, mvalid: int):
    """The batched function in plain PyTorch, each step one tensor
    operation for the whole batch: unpack, two batched products with
    parity, pack, reduce each element's flag."""
    _check_batched(xw, m_small, wmat, colmask_bits, below0)
    B, m, nbw = xw.shape
    pos = torch.arange(m, device=xw.device)
    rows = ((pos[None, :] >= below0[:, None]) & (pos[None, :] < mvalid))
    lamw = torch.where(rows[:, :, None],
                       _dot_parity(unpack_bits(xw), m_small.to(torch.float32)), 0)
    vw = xw ^ _dot_parity(unpack_bits(lamw), wmat.to(torch.float32))
    colmask = pack_bits(colmask_bits.to(torch.int32))            # [B, nbw]
    miss = (torch.where(rows[:, :, None], vw & colmask[:, None, :], 0)
            != 0).flatten(1).any(dim=1)
    return vw, lamw, miss


def panel_post_hopper_batched(xw: torch.Tensor, m_small: torch.Tensor,
                              wmat: torch.Tensor, colmask_bits: torch.Tensor,
                              below0: torch.Tensor, mvalid: int):
    """The fused elimination of every panel of a batch, in one call into
    the library: the prefix sum of the in-range tiles, the packing and copy,
    the elimination.  ``xw`` may be a view with any row and batch stride.
    CPU tensors take the plain version; CUDA tensors launch the kernels or
    raise.  Nothing is read back: each element's row range stays on the
    card."""
    _check_batched(xw, m_small, wmat, colmask_bits, below0)
    with spans.span("kernel.panel_post_hopper_batched", batch=xw.shape[0],
                    m=xw.shape[1], nb=m_small.shape[1], mvalid=mvalid):
        if not xw.is_cuda:
            return panel_post_batched_plain(xw, m_small, wmat, colmask_bits,
                                            below0, mvalid)
        return _launch_batched(xw, m_small, wmat, colmask_bits, below0,
                               mvalid)


def _launch_batched(xw, m_small, wmat, colmask_bits, below0, mvalid):
    """Launch the batched elimination (checked by the caller)."""
    device = xw.get_device()
    if torch.cuda.current_device() != device:
        with torch.cuda.device(device):
            return _launch_batched(xw, m_small, wmat, colmask_bits, below0,
                                   mvalid)
    B, m, nbw = xw.shape
    dev = xw.device
    body = (B * m * nbw + 3) // 4 * 4       # keeps every part 16-byte aligned
    ops = B * _scratch_words(nbw * WORD_BITS)
    # v, lam, the packed operands, then the in-range tiles' prefix sum that
    # the launch makes on the card (B long longs)
    buf = torch.empty(2 * body + ops + 2 * B, dtype=torch.int32, device=dev)
    vw = buf.as_strided((B, m, nbw), (m * nbw, nbw, 1), 0)
    lamw = buf.as_strided((B, m, nbw), (m * nbw, nbw, 1), body)
    miss = torch.empty(B, dtype=torch.bool, device=dev)
    if m == 0 or nbw == 0:
        return vw, lamw, miss.zero_()
    m_small, wmat = _aligned(m_small), _aligned(wmat)
    colmask_bits = colmask_bits.contiguous()
    below0 = below0.to(torch.int32).contiguous()
    base = buf.data_ptr()
    err = _fns()[3](xw.data_ptr(), xw.stride(1), xw.stride(0),
                    m_small.data_ptr(), wmat.data_ptr(),
                    colmask_bits.data_ptr(), base + 8 * body, base,
                    base + 4 * body, miss.data_ptr(), below0.data_ptr(),
                    base + 4 * (2 * body + ops), 0, B, m, nbw, int(mvalid),
                    torch._C._cuda_getCurrentRawStream(device))
    spans.count("launch.panel_post_hopper_batched")
    if err:
        raise RuntimeError(f"panel_post_hopper_batched: CUDA error {err} at "
                           "launch")
    return vw, lamw, miss

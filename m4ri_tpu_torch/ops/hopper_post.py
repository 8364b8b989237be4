"""The PLE panel's elimination of the rows below the window, on the card.

Replaces the TPU kernel ``panel_post`` (m4ri_tpu/ops/pallas_post.py).  Same
contract: ``xw`` int32 ``[m, nb/32]`` packed stale panel words; ``m_small``
(= E^T T) and ``wmat`` 0/1 int8 ``[nb, nb]``; ``colmask_bits`` 0/1 int8
``[nb]`` (1 at the valid columns declared non-pivot; all zero switches the
miss check off).  For the rows in ``[below0, mvalid)``

    lam = X * m_small,   v = X ^ lam * wmat,   miss = any(v & colmask)

and every other row passes through with lam = 0.  Returns ``(vw, lamw,
miss)``: packed v, packed lam, and a 0-dim bool tensor.

What bounds it on an H100: bytes; three panels of words against a
microsecond of 1-bit MMA.  The kernel (csrc/gf2_post_hopper.cu) reads X
once, forms lam and v a 128-row tile at a time with the packed tile product,
writes both once and sets the miss flag, one device byte.  It wants the
two small operands transposed and packed along the contraction, the layout
of a right operand of the 1-bit MMA: a packing kernel of the same source
makes them, the packed column mask and the zeroed flag in one launch ahead
of it, so that a call is two launches (``_packed_transposed`` and
``_packed_colmask`` are that kernel's plain versions).

``panel_post_hopper_batched`` is the same function over a batch of panels:
``xw [B, m, nb/32]``, ``m_small`` / ``wmat [B, nb, nb]``, ``colmask_bits
[B, nb]``, ``below0`` one int32 an element on the card, ``mvalid`` shared;
it returns ``(vw [B], lamw [B], miss bool [B])``.  The same two kernels run
it, the batch folded into the grid's x.  ``panel_post_batched_plain`` is its
plain version, vectorised over the batch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.config import WORD_BITS
from .mul import _dot_parity, pack_bits, unpack_bits

__all__ = ["panel_post_hopper", "panel_post_plain", "pack_operands_hopper",
           "panel_post_hopper_batched", "panel_post_batched_plain"]

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
    bpost.argtypes = [_VOID, _LONG, _LONG] + [_VOID] * 8 + [_INT] * 4 + [_VOID]
    post.restype = pack.restype = bpost.restype = _INT
    return post, pack, scratch, bpost


def _row_words(nb: int) -> int:
    """Words a packed row of M^T or W^T takes: a multiple of 4 (16 bytes)."""
    return (nb // WORD_BITS + 3) // 4 * 4


@functools.lru_cache(maxsize=None)
def _scratch_words(nb: int) -> int:
    """Words the kernels want for M^T, W^T and the packed column mask."""
    return _fns()[2](nb)


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
    m_small, wmat, colmask_bits = (t.contiguous()       # no copy if dense
                                   for t in (m_small, wmat, colmask_bits))
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
    if not xw.is_cuda:
        return panel_post_plain(xw, m_small, wmat, colmask_bits, below0, mvalid)
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
    m_small, wmat, colmask_bits = (t.contiguous()       # no copy if dense
                                   for t in (m_small, wmat, colmask_bits))
    base = buf.data_ptr()
    with torch.cuda.device(dev):
        err = _fns()[0](xw.data_ptr(), xw.stride(0), m_small.data_ptr(),
                        wmat.data_ptr(), colmask_bits.data_ptr(),
                        base + 8 * body, base, base + 4 * body,
                        miss.data_ptr(), m, nbw, int(below0), int(mvalid),
                        torch.cuda.current_stream().cuda_stream)
    panel_post_hopper.launches += 1
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
    """The fused elimination of every panel of a batch, in one call of two
    launches.  ``xw`` may be a view with any row and batch stride.  CPU
    tensors take the plain version; CUDA tensors launch the kernels or
    raise."""
    _check_batched(xw, m_small, wmat, colmask_bits, below0)
    if not xw.is_cuda:
        return panel_post_batched_plain(xw, m_small, wmat, colmask_bits,
                                        below0, mvalid)
    B, m, nbw = xw.shape
    dev = xw.device
    body = (B * m * nbw + 3) // 4 * 4       # keeps every part 16-byte aligned
    buf = torch.empty(2 * body + B * _scratch_words(nbw * WORD_BITS),
                      dtype=torch.int32, device=dev)
    vw = buf.as_strided((B, m, nbw), (m * nbw, nbw, 1), 0)
    lamw = buf.as_strided((B, m, nbw), (m * nbw, nbw, 1), body)
    miss = torch.empty(B, dtype=torch.bool, device=dev)
    if m == 0 or nbw == 0:
        return vw, lamw, miss.zero_()
    m_small, wmat, colmask_bits = (t.contiguous()       # no copy if dense
                                   for t in (m_small, wmat, colmask_bits))
    below0 = below0.to(torch.int32).contiguous()
    base = buf.data_ptr()
    with torch.cuda.device(dev):
        err = _fns()[3](xw.data_ptr(), xw.stride(1), xw.stride(0),
                        m_small.data_ptr(), wmat.data_ptr(),
                        colmask_bits.data_ptr(), base + 8 * body, base,
                        base + 4 * body, miss.data_ptr(), below0.data_ptr(),
                        B, m, nbw, int(mvalid),
                        torch.cuda.current_stream().cuda_stream)
    panel_post_hopper_batched.launches += 1
    if err:
        raise RuntimeError(f"panel_post_hopper_batched: CUDA error {err} at "
                           "launch")
    return vw, lamw, miss


panel_post_hopper.launches = 0
panel_post_hopper_batched.launches = 0

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
writes both once and ORs the miss flag into one device int.  The wrapper
hands it the two small operands transposed and packed, which is the layout
the 1-bit MMA wants for a right operand.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.config import WORD_BITS
from .mul import _dot_parity, pack_bits, unpack_bits

__all__ = ["panel_post_hopper", "panel_post_plain"]

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
    colmask = pack_bits(colmask_bits[None, :].to(torch.int32))[0]
    miss = (torch.where(rows, vw & colmask[None, :], 0) != 0).any()
    return vw, lamw, miss


_VOID, _LONG, _INT = ctypes.c_void_p, ctypes.c_long, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fn():
    from ._build import load
    fn = load("gf2_post_hopper").gf2_panel_post_hopper_launch
    fn.argtypes = [_VOID, _LONG, _VOID, _VOID, _LONG, _VOID, _VOID, _LONG,
                   _VOID, _LONG, _VOID, _INT, _INT, _INT, _INT, _VOID]
    fn.restype = _INT
    return fn


def _packed_transposed(bits: torch.Tensor) -> torch.Tensor:
    """0/1 int8 [nb, nb] -> its transpose packed along the contraction,
    int32 [nb, ld] with ld a multiple of 4 words (16-byte rows)."""
    nb = bits.shape[0]
    nbw = nb // WORD_BITS
    out = torch.zeros((nb, (nbw + 3) // 4 * 4), dtype=torch.int32,
                      device=bits.device)
    out[:, :nbw] = pack_bits(bits.t().to(torch.int32))
    return out


def panel_post_hopper(xw: torch.Tensor, m_small: torch.Tensor,
                      wmat: torch.Tensor, colmask_bits: torch.Tensor,
                      below0: int, mvalid: int):
    """Fused elimination of the rows below the window; see the module text
    for the contract.  ``xw`` may be a view with any row stride.  CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    _check(xw, m_small, wmat, colmask_bits)
    if not xw.is_cuda:
        return panel_post_plain(xw, m_small, wmat, colmask_bits, below0, mvalid)
    m, nbw = xw.shape
    dev = xw.device
    vw = torch.empty((m, nbw), dtype=torch.int32, device=dev)
    lamw = torch.empty((m, nbw), dtype=torch.int32, device=dev)
    miss = torch.zeros((), dtype=torch.int32, device=dev)  # zeroed on the stream
    if m == 0 or nbw == 0:
        return vw, lamw, miss != 0
    mt, wt = _packed_transposed(m_small), _packed_transposed(wmat)
    colmask = pack_bits(colmask_bits[None, :].to(torch.int32))[0].contiguous()
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xw.data_ptr(), xw.stride(0), mt.data_ptr(), wt.data_ptr(),
                 mt.stride(0), colmask.data_ptr(), vw.data_ptr(), vw.stride(0),
                 lamw.data_ptr(), lamw.stride(0), miss.data_ptr(), m, nbw,
                 int(below0), int(mvalid), stream)
    panel_post_hopper.launches += 1
    if err:
        raise RuntimeError(f"panel_post_hopper: CUDA error {err} at launch")
    return vw, lamw, miss != 0


panel_post_hopper.launches = 0

"""The PLE sweep's trailing update C ^= Lp*Up on the card, in place.

Replaces the TPU kernels ``gf2_schur_update`` and ``gf2_schur_update_dyn``
(m4ri_tpu/ops/pallas_schur.py).  Same contract: c ``[m, nw]`` words, lp
``[m, kw]``, up ``[k, nw]`` with ``k <= 32*kw``; rows of lp above ``r0`` are
zero and words of up left of ``c0w`` are zero, so every tile of c that lies
wholly above r0 or wholly left of c0w keeps its words, and the kernels never
load such a tile.  The bounds go to the card as two ints in device memory;
they may be given as Python ints or as tensors that are already there.

What bounds it on an H100: bytes.  One panel of contraction is a step or two
of the 1-bit MMA, then c is read and written, and over a sweep three quarters
of c need neither.  ``gf2_schur_update_hopper`` launches a grid over the
column tiles right of ``col_tile_skip`` and lets inactive blocks return at
once; ``gf2_schur_update_dyn_hopper`` is a persistent grid that derives the
active rectangle from the bounds on the device (csrc/gf2_schur_hopper.cu).
A tile is 128 rows by 4 words.

Both update ``c`` in place and return it.  Strides are passed through: c,
lp and up may be views with any row stride, the words of a row adjacent.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .hopper_mul import bt_scratch, check_operands, gf2_mul_plain

__all__ = ["gf2_schur_update_hopper", "gf2_schur_update_dyn_hopper",
           "gf2_schur_update_plain", "TILE_ROWS", "TILE_WORDS"]

TILE_ROWS = 128   # BM of csrc/gf2_tile.cuh
TILE_WORDS = 4    # BN / 32


def gf2_schur_update_plain(c: torch.Tensor, lp: torch.Tensor,
                           up: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch, in place: the whole product is
    formed and XORed in.  Under the contract the tiles a kernel skips have a
    zero delta, so no bound is needed here."""
    c ^= gf2_mul_plain(lp, up)
    return c


def _bounds(r0, c0w, device) -> torch.Tensor:
    """int32[2] on the device from ints or from tensors already there."""
    if isinstance(r0, torch.Tensor) or isinstance(c0w, torch.Tensor):
        parts = [torch.as_tensor(x, dtype=torch.int32, device=device).reshape(1)
                 for x in (r0, c0w)]
        return torch.cat(parts)
    return torch.tensor([r0, c0w], dtype=torch.int32, device=device)


_VOID, _LONG, _INT = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
_COMMON = [_VOID, _LONG, _VOID, _LONG, _VOID, _LONG, _VOID, _LONG, _VOID,
           _INT, _INT, _INT, _INT]


@functools.lru_cache(maxsize=None)
def _fns():
    from ._build import load
    lib = load("gf2_schur_hopper")
    static, dyn = (lib.gf2_schur_update_hopper_launch,
                   lib.gf2_schur_update_dyn_hopper_launch)
    static.argtypes = _COMMON + [_INT, _VOID]
    dyn.argtypes = _COMMON + [_VOID]
    static.restype = dyn.restype = _INT
    return static, dyn


def _launch(which: int, c, lp, up, r0, c0w, extra: tuple) -> int:
    m, kw = lp.shape
    k, nw = up.shape
    upt = bt_scratch(kw, nw, c.device)
    bounds = _bounds(r0, c0w, c.device)
    fn = _fns()[which]
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        return fn(c.data_ptr(), c.stride(0), lp.data_ptr(), lp.stride(0),
                  up.data_ptr(), up.stride(0), upt.data_ptr(), upt.stride(0),
                  bounds.data_ptr(), m, kw, k, nw, *extra, stream)


def gf2_schur_update_hopper(c: torch.Tensor, lp: torch.Tensor,
                            up: torch.Tensor, r0, c0w,
                            col_tile_skip: int = 0) -> torch.Tensor:
    """c ^= lp*up in place under the contract above.  ``col_tile_skip``
    leading column tiles (of ``TILE_WORDS`` words) are not launched at all:
    the caller vouches that ``col_tile_skip * TILE_WORDS <= c0w``.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or raise."""
    check_operands(lp, up, c)   # c: the shape of lp*up, same type and device
    tiles_j = -(-c.shape[1] // TILE_WORDS)
    if not 0 <= col_tile_skip < max(tiles_j, 1):
        raise ValueError(f"col_tile_skip={col_tile_skip} of {tiles_j} tiles")
    if isinstance(c0w, int) and col_tile_skip * TILE_WORDS > c0w:
        raise ValueError(f"col_tile_skip={col_tile_skip} reaches past "
                         f"c0w={c0w}")
    if not c.is_cuda:
        return gf2_schur_update_plain(c, lp, up)
    if c.numel() == 0 or up.shape[0] == 0:
        return c
    err = _launch(0, c, lp, up, r0, c0w, (col_tile_skip,))
    gf2_schur_update_hopper.launches += 1
    if err:
        raise RuntimeError(f"gf2_schur_update_hopper: CUDA error {err} at launch")
    return c


def gf2_schur_update_dyn_hopper(c: torch.Tensor, lp: torch.Tensor,
                                up: torch.Tensor, r0, c0w) -> torch.Tensor:
    """c ^= lp*up in place; the kernel derives the active tiles from
    (r0, c0w) on the device, in both dimensions.  Needs whole tiles:
    ``m % TILE_ROWS == 0`` and ``nw % TILE_WORDS == 0``.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    check_operands(lp, up, c)   # c: the shape of lp*up, same type and device
    m, nw = c.shape
    if m % TILE_ROWS or nw % TILE_WORDS:
        raise ValueError(f"c is {m} x {nw} words, want multiples of "
                         f"{TILE_ROWS} x {TILE_WORDS}")
    if not c.is_cuda:
        return gf2_schur_update_plain(c, lp, up)
    if c.numel() == 0 or up.shape[0] == 0:
        return c
    err = _launch(1, c, lp, up, r0, c0w, ())
    gf2_schur_update_dyn_hopper.launches += 1
    if err:
        raise RuntimeError(
            f"gf2_schur_update_dyn_hopper: CUDA error {err} at launch")
    return c


gf2_schur_update_hopper.launches = 0
gf2_schur_update_dyn_hopper.launches = 0

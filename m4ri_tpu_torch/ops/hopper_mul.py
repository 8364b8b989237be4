"""gf2_mul_hopper: packed GF(2) product on the card, the contraction inside
each block.

Replaces the TPU kernel ``gf2_mul_pallas`` (m4ri_tpu/ops/pallas_mul.py,
``_mul_padded``).  Same contract: a ``[m, kw]`` words, b ``[k, nw]`` words
with ``k <= 32*kw`` and padding bits zero, out ``[m, nw]`` words.

Both GEMM wrappers, this one and ``gf2_mul_hopper_v2`` (ops/hopper_mul2.py),
launch one kernel, csrc/gf2_gemm_hopper.cu, through ``launch_gemm`` below:
a cooperative persistent grid that first writes B^T (the pre-pass, spread
over its blocks, then a grid barrier) and then walks 128 x 256-bit tiles of C,
operands brought by tensor copies into a ring that a producer thread keeps
full, the 1-bit warpgroup MMA (``wgmma`` b1, AND + popcount over 256
contraction bits) on the packed words as they lie.  This wrapper never
splits the contraction across blocks, so each word of C is written once.

What bounds it on an H100: operations, not bytes, at the large shapes
(thousands of bit operations per byte moved); bytes at the PLE's U rows
(k = 512), where the wrapper's own host time was most of a call.  So the
host path of a call is one ctypes call and, mostly, one launch (the kernel
with its pre-pass; a copy of A or the zeroing of a split C where needed, all
launched from C), the kernel's attribute set once per process
and device, and the B^T scratch kept per (device, stream), grown on demand
and never shrunk: a launch only ever reuses the scratch of its own stream,
so stream order alone keeps an earlier launch's reads safe, and a grown
scratch's old memory goes back to the caching allocator on that stream.

Strides are passed through: a, b and out may be views with any row stride
(the quadrants Strassen cuts), provided the words of a row are adjacent.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils import spans
from ..utils.config import WORD_BITS

__all__ = ["gf2_mul_hopper", "gf2_mul_plain", "check_operands",
           "launch_gemm", "gemm_plan", "gemm_schedule_plain", "bt_row",
           "TILE_ROWS", "TILE_WORDS", "STAGE_WORDS"]

TILE_ROWS = 128    # TM of csrc/gf2_gemm_hopper.cu: rows of a tile of C
TILE_WORDS = 8     # TW: words of a tile row (256 columns)
STAGE_WORDS = 32   # KC: contraction words of a stage of the ring
GROUP_M = 8        # row tiles a group of the kernel's walk
_MAX_ITEMS = 2**31 - 1
_I32 = torch.int32


def gf2_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: unpack to 0/1 float32, one
    ``torch.matmul`` (in full float32: TF32 would keep about 10 bits of
    each count and corrupt the parity), parity, pack.  With a leading batch
    axis ([B, m, kw] x [B, k, nw]) one batched product, the lowering of
    ``jax.vmap`` over the JAX package's ``mul_packed_data``."""
    from .mul import exact_float32, pack_bits, unpack_bits
    k = b.shape[-2]
    a_u = unpack_bits(a, torch.float32)[..., :k]
    b_u = unpack_bits(b, torch.float32)
    with exact_float32():
        prod = a_u @ b_u
    return pack_bits(prod.to(torch.int32) & 1)


def check_operands(a: torch.Tensor, b: torch.Tensor, out) -> tuple:
    """Raise on anything the kernels do not take; else (m, kw, k, nw)."""
    for name, t in (("a", a), ("b", b), ("out", out)):
        if t is None:
            continue
        if t.dtype is not _I32 or t.dim() != 2:
            raise TypeError(f"{name}: want a 2-D int32 tensor, got "
                            f"{t.dtype} with {t.dim()} dims")
        (rows, words), (row_stride, word_stride) = t.shape, t.stride()
        if words > 1 and word_stride != 1:
            raise ValueError(f"{name}: the words of a row must be adjacent "
                             f"(stride {word_stride})")
        if rows > 1 and row_stride < words:
            raise ValueError(f"{name}: rows overlap (stride {row_stride})")
    if b.device != a.device or (out is not None and out.device != a.device):
        raise ValueError(f"operands on {a.device}, {b.device}"
                         + ("" if out is None else f", {out.device}"))
    (m, kw), (k, nw) = a.shape, b.shape
    if k > WORD_BITS * kw:
        raise ValueError(f"b has {k} rows, a only {kw} words of contraction")
    if out is not None and out.shape != (m, nw):
        raise ValueError(f"out is {tuple(out.shape)}, want {(m, nw)}")
    return m, kw, k, nw


def bt_row(col: int) -> int:
    """Row of a tile's staged B^T that holds column ``col`` (0..255) of the
    tile (word col // 32, bit col % 32): 8 * bit + word.  The MMA gives a
    thread the columns 8*i + 2*t + e, i = 0..31, which are then all 32 bits
    of words 2*t + e; csrc/gf2_gemm_hopper.cu writes B^T in this order."""
    return (col % 32) * 8 + col // 32


@functools.lru_cache(maxsize=1024)
def gemm_plan(m: int, nw: int, kw: int, sms: int,
              split: bool) -> tuple[int, int, int]:
    """(splits, chunk, grid) of a launch.  The contraction is ceil(kw/32)
    stages; it is cut into ``splits`` runs of ``chunk`` stages (every run
    non-empty) only where ``split`` allows it, the tiles of C do not fill
    the ``sms`` SMs and there is more than one stage.  The grid has at most
    one block an SM and never more blocks than (tile, run) items."""
    tiles = -(-m // TILE_ROWS) * -(-nw // TILE_WORDS)
    stages = -(-kw // STAGE_WORDS)
    splits = 1
    if split and tiles < sms and stages > 1:
        splits = min(-(-sms // tiles), stages)
    chunk = -(-stages // splits)
    splits = -(-stages // chunk)
    return splits, chunk, min(tiles * splits, sms)


def gemm_schedule_plain(m: int, nw: int, kw: int, sms: int,
                        split: bool) -> list:
    """The kernel's walk in numpy: for each block of the grid, the items it
    takes in order, as rows (row tile, column tile, first stage, end
    stage).  Block b takes items b, b + grid, ...; item L is run
    L % splits of tile L // splits, tiles numbered in groups of GROUP_M
    row tiles, column-major inside a group."""
    splits, chunk, grid = gemm_plan(m, nw, kw, sms, split)
    tiles_m, tiles_n = -(-m // TILE_ROWS), -(-nw // TILE_WORDS)
    stages = -(-kw // STAGE_WORDS)
    items = tiles_m * tiles_n * splits
    out = []
    for blk in range(grid):
        L = np.arange(blk, items, grid)
        s, t = L % splits, L // splits
        span = GROUP_M * tiles_n
        first = t // span * GROUP_M
        gsz = np.minimum(tiles_m - first, GROUP_M)
        r = t % span
        s0 = s * chunk
        out.append(np.stack([first + r % gsz, r // gsz, s0,
                             np.minimum(s0 + chunk, stages)], axis=1))
    return out


_VOID, _LONG, _INT = ctypes.c_void_p, ctypes.c_long, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fn():
    from ._build import load
    fn = load("gf2_gemm_hopper").gf2_gemm_hopper_launch
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    fn.argtypes = [_VOID, _LONG, _VOID, _LONG, _VOID, _INT, _VOID, _LONG,
                   _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _VOID]
    fn.restype = _INT
    return fn


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_SCRATCH: dict = {}   # (device, stream) -> int32 scratch, only ever grown


def launch_gemm(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                shape: tuple, accumulate: bool, split: bool) -> None:
    """out = a*b, or out ^= a*b, on the card: one call of the C library.
    ``shape`` is what ``check_operands`` returned; all on one card and
    m, nw, k > 0."""
    device = a.get_device()
    if torch.cuda.current_device() != device:
        with torch.cuda.device(device):
            return launch_gemm(a, b, out, shape, accumulate, split)
    m, kw, k, nw = shape
    splits, chunk, grid = gemm_plan(m, nw, kw, _sms(device), split)
    tiles_n = -(-nw // TILE_WORDS)
    # the walk's (tile, split) items and the pre-pass's units are ints
    if (-(-m // TILE_ROWS) * tiles_n * splits > _MAX_ITEMS
            or -(-nw // 32) * -(-kw // 8) > _MAX_ITEMS):
        raise ValueError(f"a {m} x {kw}-word by {k} x {nw}-word product "
                         "exceeds the launch grid")
    ldbt = (kw + 3) & ~3
    words = tiles_n * TILE_WORDS * WORD_BITS * ldbt
    # a tensor copy needs a 16-byte aligned base and row stride
    lda, a_ptr = a.stride(0), a.data_ptr()
    copy_a = (a_ptr | lda << 2) & 15 != 0
    if copy_a:
        words += m * ldbt
    stream = torch._C._cuda_getCurrentRawStream(device)
    scratch = _SCRATCH.get((device, stream))
    if scratch is None or scratch.numel() < words:
        scratch = _SCRATCH[device, stream] = torch.empty(
            words, dtype=_I32, device=a.device)
    err = _fn()(a_ptr, lda, b.data_ptr(), b.stride(0), scratch.data_ptr(),
                copy_a, out.data_ptr(), out.stride(0), m, kw, k, nw,
                accumulate, splits, chunk, grid, stream)
    if err:
        raise RuntimeError(f"gf2_gemm_hopper: CUDA error {err} at launch "
                           f"({m} x {kw} words by {k} x {nw})")


def gf2_mul_hopper(a: torch.Tensor, b: torch.Tensor,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """Packed GF(2) product C = A*B.  ``out`` may be a strided view (a
    quadrant of a larger matrix) and is written in place; it must not
    overlap a or b.  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    shape = check_operands(a, b, out)
    m, _, k, nw = shape
    with spans.span("kernel.gf2_mul_hopper", m=m, k=k, nw=nw):
        if not a.is_cuda:
            res = gf2_mul_plain(a, b)
            return res if out is None else out.copy_(res)
        if out is None:
            out = torch.empty((m, nw), dtype=_I32, device=a.device)
        if m == 0 or nw == 0:
            return out
        if k == 0:
            return out.zero_()
        launch_gemm(a, b, out, shape, False, False)
        spans.count("launch.gf2_mul_hopper")
        return out

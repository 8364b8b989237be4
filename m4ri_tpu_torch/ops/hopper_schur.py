"""The PLE sweep's trailing update C ^= Lp*Up on the card, in place.

Replaces the TPU kernels ``gf2_schur_update`` and ``gf2_schur_update_dyn``
(m4ri_tpu/ops/pallas_schur.py).  Same contract: c ``[m, nw]`` words, lp
``[m, kw]``, up ``[k, nw]`` with ``k <= 32*kw``; rows of lp above ``r0`` are
zero and words of up left of ``c0w`` are zero, so every tile of c that lies
wholly above r0 or wholly left of c0w keeps its words, and the kernel never
reads such a tile.  A tile is ``TILE_ROWS`` rows by ``TILE_WORDS`` words.

Both entry points launch one kernel (csrc/gf2_schur_hopper.cu): a
persistent grid over the active rectangle
``[r0 // TILE_ROWS, tiles_i) x [max(c0w // TILE_WORDS, skip), tiles_j)``,
each block one contiguous run of it in row-major order
(``schur_schedule_plain`` is that partition in numpy), the block's band of
lp kept in registers, Up^T streamed through a ring of shared-memory stages
that the block's two 128-row groups share, each C tile read ahead and
written back whole.  The bounds go to the kernel without a copy: an int by
value, a tensor on the card by pointer (read there), a tensor on the host by
value.  ``gf2_schur_update_hopper`` sizes its
grid from what it knows on the host (with int bounds, no block is launched
for a finished tile, and nothing at all when every tile is finished);
``gf2_schur_update_dyn_hopper`` launches the same grid whatever the bounds
and lets the kernel find the rectangle, as the JAX package's dynamic
pipeline does.

What bounds it on an H100: bytes at nb=512, operations at nb=1024 (see the
source).  A contraction deeper than ``KW_MAX`` words is split into launches
of at most that depth (XOR is associative).

Both update ``c`` in place and return it.  Strides are passed through: c,
lp and up may be views with any row stride, the words of a row adjacent.

``gf2_schur_update_batched_hopper`` is the same update over a batch axis,
``c[b] ^= lp[b]*up[b]`` for each element, with ``r0`` an int or one int32 a
element on the card and ``c0w`` an int.  One call into the library (one for
each KW_MAX words of contraction) makes the prefix sum of the elements'
active tiles on the card, then the pre-pass, then runs a persistent grid
over the concatenation of the elements' active rectangles
(``schur_schedule_batched_plain`` is that partition in numpy); batch strides
are passed through.
``gf2_schur_update_plain`` on the stacks is its plain version: one batched
product for the whole batch, no loop over it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils import spans
from ..utils.config import WORD_BITS
from .hopper_mul import check_operands, gf2_mul_plain

__all__ = ["gf2_schur_update_hopper", "gf2_schur_update_dyn_hopper",
           "gf2_schur_update_plain", "schur_schedule_plain", "grid_blocks",
           "gf2_schur_update_batched_hopper", "schur_schedule_batched_plain",
           "TILE_ROWS", "TILE_WORDS", "KW_MAX"]

TILE_ROWS = 256   # TM of csrc/gf2_schur_hopper.cu
TILE_WORDS = 8    # TW: a tile row is one 32-byte sector of c
KW_MAX = 32       # contraction words of one launch
_TILE_COLS = TILE_WORDS * WORD_BITS


def gf2_schur_update_plain(c: torch.Tensor, lp: torch.Tensor,
                           up: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch, in place: the whole product is
    formed and XORed in.  Under the contract the tiles a kernel skips have a
    zero delta, so no bound is needed here.  With a leading batch axis it is
    the batched kernel's plain version: one batched product for the whole
    batch."""
    c ^= gf2_mul_plain(lp, up)
    return c


def _tiles(m: int, nw: int) -> tuple[int, int]:
    return -(-m // TILE_ROWS), -(-nw // TILE_WORDS)


def _rect(m: int, nw: int, r0, c0w, skip: int) -> tuple[int, int, int, int]:
    """(i0, j0, n_i, n_j) of the active rectangle, as the kernel reckons it;
    a bound given as None is taken as 0 (not known on the host)."""
    tiles_i, tiles_j = _tiles(m, nw)
    i0 = max(r0 or 0, 0) // TILE_ROWS
    j0 = max(max(c0w or 0, 0) // TILE_WORDS, skip)
    return i0, j0, max(tiles_i - i0, 0), max(tiles_j - j0, 0)


def grid_blocks(m: int, nw: int, r0, c0w, skip: int, dyn: bool,
                capacity: int) -> int:
    """The grid a launch gets: at most ``capacity`` (the blocks the card
    holds at once), and no more than the tiles that may be active as far as
    the host knows (``r0``/``c0w`` None: read on the card).  The persistent
    entry counts every tile whatever the bounds.  0: nothing to launch."""
    if dyn:
        r0 = c0w = None
        skip = 0
    _, _, n_i, n_j = _rect(m, nw, r0, c0w, skip)
    return min(n_i * n_j, capacity)


def schur_schedule_plain(m: int, nw: int, r0: int, c0w: int, skip: int,
                         blocks: int) -> list:
    """The kernel's schedule in numpy: for each of ``blocks`` blocks the
    (row tile, column tile) pairs it takes, in order.  Block b takes tiles
    [T*b // blocks, T*(b+1) // blocks) of the T active ones, counted
    row-major over the rectangle."""
    i0, j0, n_i, n_j = _rect(m, nw, r0, c0w, skip)
    total = n_i * n_j
    out = []
    for b in range(blocks):
        s = np.arange(total * b // blocks, total * (b + 1) // blocks)
        out.append(np.stack([i0 + s // max(n_j, 1), j0 + s % max(n_j, 1)],
                            axis=1))
    return out


def _batched_cum(m: int, nw: int, r0, c0w: int, B: int, device):
    """The inclusive prefix sum over the batch of each element's active
    tiles (int64 [B] on ``device``), the array the batched kernel's blocks
    search: rows from max(r0_e, 0) // TILE_ROWS, column tiles from
    max(c0w, 0) // TILE_WORDS.  ``r0``: an int, or an int tensor [B].  The
    launch makes it on the card itself (``prefix_sum_kernel``, its first
    kernel); this is that sum in plain PyTorch, for the schedule below."""
    tiles_i, tiles_j = _tiles(m, nw)
    n_j = max(tiles_j - max(c0w, 0) // TILE_WORDS, 0)
    if isinstance(r0, torch.Tensor):
        r0 = r0.to(device=device, dtype=torch.int64)
    else:
        r0 = torch.full((B,), int(r0), dtype=torch.int64, device=device)
    i0 = r0.clamp(min=0) // TILE_ROWS
    return torch.cumsum((tiles_i - i0).clamp(min=0) * n_j, 0)


def schur_schedule_batched_plain(m: int, nw: int, r0s, c0w: int,
                                 blocks: int) -> list:
    """The batched kernel's schedule in numpy: for each of ``blocks`` blocks
    the (element, row tile, column tile) triples it takes, in order.  The
    active tiles of all elements are counted element after element (the
    wrapper's ``_batched_cum``), each element's row-major over its
    rectangle; block b takes [T*b // blocks, T*(b+1) // blocks) of the T of
    them."""
    r0s = np.asarray(r0s, np.int64)
    cum = _batched_cum(m, nw, torch.from_numpy(r0s), c0w, len(r0s),
                       "cpu").numpy()
    cnt = np.diff(cum, prepend=0)
    tiles_j = _tiles(m, nw)[1]
    j0 = max(c0w, 0) // TILE_WORDS
    n_j = max(tiles_j - j0, 1)
    i0 = np.maximum(r0s, 0) // TILE_ROWS
    total = int(cum[-1]) if len(cum) else 0
    out = []
    for b in range(blocks):
        s = np.arange(total * b // blocks, total * (b + 1) // blocks)
        e = np.searchsorted(cum, s, side="right")
        loc = s - (cum[e] - cnt[e])
        out.append(np.stack([e, i0[e] + loc // n_j, j0 + loc % n_j], axis=1))
    return out


def _slices(lp: torch.Tensor, up: torch.Tensor):
    """(lp, up, k-steps) of each launch: the contraction KW_MAX words at a
    time, views of the operands (any leading batch axis kept); words of lp
    past up's rows are left out."""
    kwords = -(-up.shape[-2] // WORD_BITS)
    for w0 in range(0, kwords, KW_MAX):
        ups = up[..., w0 * WORD_BITS:(w0 + KW_MAX) * WORD_BITS, :]
        yield lp[..., w0:w0 + KW_MAX], ups, -(-ups.shape[-2] // 256)


def _host(x):
    """A bound as a span attribute: the int, or None for a tensor (a span
    reads nothing from the card)."""
    return x if isinstance(x, int) else None


def _bound(x, name: str, device):
    """(tensor on the card or None, value or None): a tensor on the card is
    read there by the kernel; an int or a tensor on the host goes by value."""
    if isinstance(x, torch.Tensor):
        if x.numel() != 1:
            raise ValueError(f"{name}: want one value, got shape "
                             f"{tuple(x.shape)}")
        if not x.is_cuda:
            return None, int(x)
        if x.device != device:
            raise ValueError(f"{name} lies on {x.device}, c on {device}")
        return x.reshape(()).to(torch.int32), None
    return None, int(x)


_VOID, _LONG, _INT = ctypes.c_void_p, ctypes.c_long, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fns():
    from ._build import load
    lib = load("gf2_schur_hopper")
    launch, capacity = (lib.gf2_schur_hopper_launch,
                        lib.gf2_schur_hopper_capacity)
    launch.argtypes = [_VOID, _LONG, _VOID, _LONG, _INT, _VOID, _LONG, _INT,
                       _VOID, _VOID, _VOID] + [_INT] * 8 + [_VOID]
    blaunch, bcapacity = (lib.gf2_schur_hopper_batched_launch,
                          lib.gf2_schur_hopper_batched_capacity)
    blaunch.argtypes = ([_VOID, _LONG, _LONG, _VOID, _LONG, _LONG, _INT,
                         _VOID, _LONG, _LONG, _INT, _VOID, _VOID, _VOID]
                        + [_INT] * 7 + [_VOID])
    capacity.argtypes = bcapacity.argtypes = [_INT]
    launch.restype = capacity.restype = _INT
    blaunch.restype = bcapacity.restype = _INT
    return launch, capacity, blaunch, bcapacity


@functools.lru_cache(maxsize=None)
def _capacity(ks: int, batched: bool = False) -> int:
    got = _fns()[3 if batched else 1](ks)
    if got < 1:
        raise RuntimeError(f"gf2_schur_hopper: no block of {ks} k-steps "
                           f"fits the card ({got})")
    return got


def _launch(fn, c, lp, up, r0, c0w, skip: int, dyn: bool) -> None:
    """One launch for each KW_MAX words of contraction, each counted as
    ``launch.<fn's name>``."""
    m, nw = c.shape
    r0_t, r0_v = _bound(r0, "r0", c.device)
    c0w_t, c0w_v = _bound(c0w, "c0w", c.device)
    _, j0, n_i, n_j = _rect(m, nw, r0_v, c0w_v, skip)
    if dyn:
        j0 = 0
    elif n_i * n_j == 0:                   # every tile finished: no launch
        return
    launch = _fns()[0]
    tiles_j = _tiles(m, nw)[1]
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        for lps, ups, ks in _slices(lp, up):
            blocks = grid_blocks(m, nw, r0_v, c0w_v, skip, dyn, _capacity(ks))
            ut = torch.empty(tiles_j * _TILE_COLS * 8 * ks, dtype=torch.int32,
                             device=c.device)
            err = launch(
                c.data_ptr(), c.stride(0), lps.data_ptr(), lps.stride(0),
                lps.shape[1], ups.data_ptr(), ups.stride(0), ups.shape[0],
                ut.data_ptr(), None if r0_t is None else r0_t.data_ptr(),
                None if c0w_t is None else c0w_t.data_ptr(), r0_v or 0,
                c0w_v or 0, m, nw, ks, skip, j0, blocks, stream)
            spans.count(f"launch.{fn.__name__}")
            if err:
                raise RuntimeError(f"{fn.__name__}: CUDA error {err} at "
                                   f"launch (c {m}x{nw} words, k={up.shape[0]})")


def gf2_schur_update_hopper(c: torch.Tensor, lp: torch.Tensor,
                            up: torch.Tensor, r0, c0w,
                            col_tile_skip: int = 0) -> torch.Tensor:
    """c ^= lp*up in place under the contract above.  ``col_tile_skip``
    leading column tiles (of ``TILE_WORDS`` words) are never touched: the
    caller vouches that ``col_tile_skip * TILE_WORDS <= c0w``.  ``r0``,
    ``c0w``: ints, or one-value tensors.  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    check_operands(lp, up, c)   # c: the shape of lp*up, same type and device
    tiles_j = _tiles(*c.shape)[1]
    if not 0 <= col_tile_skip < max(tiles_j, 1):
        raise ValueError(f"col_tile_skip={col_tile_skip} of {tiles_j} tiles")
    if isinstance(c0w, int) and col_tile_skip * TILE_WORDS > c0w:
        raise ValueError(f"col_tile_skip={col_tile_skip} reaches past "
                         f"c0w={c0w}")
    with spans.span("kernel.gf2_schur_update_hopper", m=c.shape[0],
                    nw=c.shape[1], k=up.shape[0], r0=_host(r0),
                    c0w=_host(c0w), col_tile_skip=col_tile_skip):
        if not c.is_cuda:
            return gf2_schur_update_plain(c, lp, up)
        if c.numel() == 0 or up.shape[0] == 0:
            return c
        _launch(gf2_schur_update_hopper, c, lp, up, r0, c0w, col_tile_skip,
                False)
        return c


def gf2_schur_update_dyn_hopper(c: torch.Tensor, lp: torch.Tensor,
                                up: torch.Tensor, r0, c0w) -> torch.Tensor:
    """c ^= lp*up in place; the kernel derives the active tiles from
    (r0, c0w) on the device, in both dimensions, and the launch is the same
    whatever the bounds.  Needs whole tiles: ``m % TILE_ROWS == 0`` and
    ``nw % TILE_WORDS == 0``.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    check_operands(lp, up, c)   # c: the shape of lp*up, same type and device
    m, nw = c.shape
    if m % TILE_ROWS or nw % TILE_WORDS:
        raise ValueError(f"c is {m} x {nw} words, want multiples of "
                         f"{TILE_ROWS} x {TILE_WORDS}")
    with spans.span("kernel.gf2_schur_update_dyn_hopper", m=m, nw=nw,
                    k=up.shape[0], r0=_host(r0), c0w=_host(c0w)):
        if not c.is_cuda:
            return gf2_schur_update_plain(c, lp, up)
        if c.numel() == 0 or up.shape[0] == 0:
            return c
        _launch(gf2_schur_update_dyn_hopper, c, lp, up, r0, c0w, 0, True)
        return c


def _check_batched(c, lp, up):
    for name, t in (("c", c), ("lp", lp), ("up", up)):
        if t.dtype != torch.int32 or t.dim() != 3:
            raise TypeError(f"{name}: want a 3-D int32 tensor, got {t.dtype} "
                            f"with {t.dim()} dims")
        if t.shape[2] > 1 and t.stride(2) != 1:
            raise ValueError(f"{name}: the words of a row must be adjacent")
        if t.device != c.device:
            raise ValueError(f"{name} lies on {t.device}, c on {c.device}")
    B, m, nw = c.shape
    if lp.shape[:2] != (B, m) or up.shape[0] != B or up.shape[2] != nw:
        raise ValueError(f"c {tuple(c.shape)}, lp {tuple(lp.shape)}, up "
                         f"{tuple(up.shape)}: want [B, m, nw], [B, m, kw], "
                         "[B, k, nw]")
    if up.shape[1] > WORD_BITS * lp.shape[2]:
        raise ValueError(f"up has {up.shape[1]} rows, lp only {lp.shape[2]} "
                         "words of contraction")


def gf2_schur_update_batched_hopper(c: torch.Tensor, lp: torch.Tensor,
                                    up: torch.Tensor, r0, c0w: int
                                    ) -> torch.Tensor:
    """``c[b] ^= lp[b]*up[b]`` in place for every element, under the
    contract above taken element by element: rows of lp[b] above r0[b] and
    words of up[b] left of c0w are zero.  ``r0``: an int for all, or an
    int32 tensor ``[B]`` on c's device (read there); ``c0w``: an int.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    _check_batched(c, lp, up)
    if not isinstance(c0w, int):
        raise TypeError(f"c0w: want an int, got {type(c0w).__name__}")
    B, m, nw = c.shape
    r0_t = None
    if isinstance(r0, torch.Tensor):
        if tuple(r0.shape) != (B,):
            raise ValueError(f"r0: want shape ({B},), got {tuple(r0.shape)}")
        if r0.device != c.device:
            raise ValueError(f"r0 lies on {r0.device}, c on {c.device}")
        r0_t = r0.to(torch.int32).contiguous()
    with spans.span("kernel.gf2_schur_update_batched_hopper", batch=B, m=m,
                    nw=nw, k=up.shape[1], r0=_host(r0), c0w=c0w):
        if not c.is_cuda:
            return gf2_schur_update_plain(c, lp, up)
        return _launch_batched(c, lp, up, r0, r0_t, c0w)


def _launch_batched(c, lp, up, r0, r0_t, c0w: int) -> torch.Tensor:
    """Launch the batched update (checked by the caller); ``r0_t`` is r0 as
    an int32 tensor on the card, or None for an int."""
    B, m, nw = c.shape
    tiles_i, tiles_j = _tiles(m, nw)
    j0 = max(c0w, 0) // TILE_WORDS
    if c.numel() == 0 or up.shape[1] == 0 or j0 >= tiles_j:
        return c
    # the grid no larger than the tiles that may be active as far as the
    # host knows; the launch writes the prefix sum of the elements' active
    # tiles (``_batched_cum``) on the card itself
    i0 = 0 if r0_t is not None else max(int(r0), 0) // TILE_ROWS
    if i0 >= tiles_i:
        return c
    n_j = tiles_j - j0
    upper = B * (tiles_i - i0) * n_j
    blaunch = _fns()[2]
    device = c.get_device()
    if torch.cuda.current_device() != device:
        with torch.cuda.device(device):
            return _launch_batched(c, lp, up, r0, r0_t, c0w)
    stream = torch._C._cuda_getCurrentRawStream(device)
    for lps, ups, ks in _slices(lp, up):
        blocks = min(upper, _capacity(ks, True))
        # Up^T scratch, then the prefix sum (B long longs, 16-byte aligned)
        tw = B * n_j * _TILE_COLS * 8 * ks
        scratch = torch.empty(tw + 2 * B, dtype=torch.int32, device=c.device)
        base = scratch.data_ptr()
        err = blaunch(
            c.data_ptr(), c.stride(1), c.stride(0), lps.data_ptr(),
            lps.stride(1), lps.stride(0), lps.shape[2], ups.data_ptr(),
            ups.stride(1), ups.stride(0), ups.shape[1], base,
            None if r0_t is None else r0_t.data_ptr(), base + 4 * tw,
            0 if r0_t is not None else int(r0), c0w, m, nw, B, ks, blocks,
            stream)
        spans.count("launch.gf2_schur_update_batched_hopper")
        if err:
            raise RuntimeError(
                f"gf2_schur_update_batched_hopper: CUDA error {err} at "
                f"launch (B={B}, c {m}x{nw} words, k={up.shape[1]})")
    return c

"""The inverse of unit-triangular GF(2) matrices, a batch at a time, on the
card.

``unit_tri_inv_hopper(nil, upper)``: ``nil`` int32 ``[..., n, w(n)]``, packed
rows of a strictly upper (``upper``) or strictly lower N; returns (I + N)^{-1}
in the same layout, int32 ``[..., n, w(n)]`` contiguous.  Bits outside the
strict triangle are ignored, so a unit-triangular T may be passed as it is
(its diagonal read as ones).  Padding bits beyond column n must be zero, and
stay so.

Replaces no TPU kernel: the JAX package computes this inverse as the
nilpotent series prod_i (I + N^(2^i)), log2(n) pairs of products on unpacked
bits (``_unit_upper_inv`` below, kept as the reference of the tests).  On
the card that was float32 GEMMs of n^3 each; the kernel
(csrc/gf2_trinv_hopper.cu) is a blocked back-substitution on packed words,
one launch an inverse.  What bounds it: at a batch that fills the card,
the update's shared-memory loads (~n^3/192 words an element); at a batch
of one, the chain of n/32 dependent block steps, which ``chain_floor``
times alone; its bytes are far below both.  ``trinv_plan`` is the
launch's shape, from (B, n) and the SM count alone: a block an element when
the batch fills the card, else column strips of a few words, a block each;
a warp an element at n = 32.

``unit_tri_inv_plain`` is the plain version: the same blocked
back-substitution (the 32 x 32 diagonal blocks inverted by the series,
then one step a row block), in float32 products of the unpacked bits.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import spans
from ..utils.config import WORD_BITS
from .mul import exact_float32, pack_bits, unpack_bits

__all__ = ["unit_tri_inv_hopper", "unit_tri_inv_plain", "trinv_plan"]

_MAX_WORDS = 32          # n <= 1024
_MAX_GRID_X = 2**31 - 1
_BLOCK = 256             # threads a block when the batch fills the card
_WARP_ELEMS = 8          # elements a block at n = 32, a warp each


def _unit_upper_inv(nilp: torch.Tensor, eye: torch.Tensor, steps: int):
    """(I + N)^{-1} for nilpotent N via the product form
    prod_i (I + N^(2^i)): log-depth small products.  0/1 int8 in and out;
    inside, the matrices stay float32 (XOR of 0/1 values is their sum mod 2,
    and sums below 2**24 are exact), so a step is two products and three
    elementwise passes and nothing is converted back and forth."""
    p = nilp.to(torch.float32)
    s = torch.fmod(eye.to(torch.float32) + p, 2)
    with exact_float32():
        for _ in range(steps):
            p = torch.fmod(p @ p, 2)
            s = torch.fmod(s + p @ s, 2)
    return s.to(torch.int8)


def series_steps(n: int) -> int:
    """The squarings ``_unit_upper_inv`` takes for an n x n N."""
    return max(0, (n - 1).bit_length() - 1)


def _strict(n: int, upper: bool, device) -> torch.Tensor:
    i = torch.arange(n, device=device)
    return (i[None, :] > i[:, None]) if upper else (i[None, :] < i[:, None])


def _check(nil: torch.Tensor) -> None:
    if not isinstance(nil, torch.Tensor) or nil.dtype != torch.int32 \
            or nil.dim() < 2:
        raise TypeError("nil: want an int32 tensor [..., n, words]")
    n, w = nil.shape[-2:]
    if w != -(-n // WORD_BITS):
        raise ValueError(f"nil: {n} rows want {-(-n // WORD_BITS)} words a "
                         f"row, got {w}")
    if w > _MAX_WORDS:
        raise ValueError(f"n = {n}: the kernel takes n <= "
                         f"{_MAX_WORDS * WORD_BITS}")


def unit_tri_inv_plain(nil: torch.Tensor, upper: bool) -> torch.Tensor:
    """(I + N)^{-1} in plain PyTorch, step for step the kernel's blocked
    back-substitution: the diagonal blocks D_K = (I + N_KK)^{-1} by the
    series, then for each row block K (from the last for upper N, from the
    first for lower) S_K = D_K S_K and S_i += N_{i,K} S_K on the rows that
    depend on it, every row starting as its identity row."""
    _check(nil)
    *lead, n, w = nil.shape
    if n == 0:
        return nil.clone()
    n32, dev = w * WORD_BITS, nil.device
    bits = unpack_bits(nil, torch.float32)
    if n32 > n:
        bits = torch.nn.functional.pad(bits, (0, 0, 0, n32 - n))
    bits = bits * _strict(n32, upper, dev)
    blocks = range(w - 1, -1, -1) if upper else range(w)
    eye = torch.eye(WORD_BITS, dtype=torch.int8, device=dev)
    diag = torch.stack([bits[..., 32 * k:32 * k + 32, 32 * k:32 * k + 32]
                        for k in range(w)], dim=-3)
    dinv = _unit_upper_inv(diag, eye, series_steps(WORD_BITS)).to(
        torch.float32)
    s = torch.eye(n32, dtype=torch.float32, device=dev).expand(
        *lead, n32, n32).clone()
    # a row's sums stay below 2**24 until its block reduces them mod 2
    with exact_float32():
        for k in blocks:
            rk = slice(32 * k, 32 * k + 32)
            # the columns row block k can hold: right of it, or left
            cols = slice(32 * k, n32) if upper else slice(0, 32 * k + 32)
            sk = torch.fmod(dinv[..., k, :, :] @ s[..., rk, cols], 2)
            s[..., rk, cols] = sk
            dep = slice(0, 32 * k) if upper else slice(32 * k + 32, n32)
            s[..., dep, cols] += bits[..., dep, rk] @ sk
    return pack_bits(s[..., :n, :n].to(torch.int8))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def trinv_plan(batch: int, n: int, sms: int) -> tuple[int, int, int]:
    """(strips an element, words a strip, threads a block) of the launch
    for ``batch`` inverses of n x n on a card of ``sms`` SMs.  A batch that
    fills the card takes a block an element, 256 threads (several blocks an
    SM hide each other's chains); a smaller one cuts each element into
    column strips until the grid covers the SMs, with a thread for each row
    up to 1024 (the strip's step is then one pass).  n <= 32: a warp an
    element, eight a block."""
    w = -(-n // WORD_BITS)
    if w <= 1:
        return 1, 1, 32 * _WARP_ELEMS
    if batch >= sms:
        return 1, w, _BLOCK
    sw = -(-w // min(w, -(-sms // batch)))
    threads = min(1024, max(_BLOCK, w * WORD_BITS * sw))
    return -(-w // sw), sw, threads


_VOID, _LONG, _INT = ctypes.c_void_p, ctypes.c_long, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fn():
    from ._build import load
    f = load("gf2_trinv_hopper").gf2_unit_tri_inv_launch
    f.argtypes = [_VOID, _LONG, _LONG, _VOID] + [_INT] * 5 + [_VOID]
    f.restype = _INT
    return f


def chain_floor(batch: int, n: int) -> None:
    """Launch the probe of the chain's floor at the launch shape of
    ``batch`` inverses of n x n: the n/32 dependent steps of a D_K product
    and two barriers, on the kernel's grid, block size and shared memory.
    For timing; needs the card."""
    from ._build import load
    w = -(-n // WORD_BITS)
    strips, sw, threads = trinv_plan(batch, n, _sms(torch.cuda.current_device()))
    if w <= 1:
        blocks, smem = -(-batch // _WARP_ELEMS), 128
    else:
        blocks, smem = batch * strips, 4 * (w * WORD_BITS * ((sw | 1) + 1))
    f = load("gf2_trinv_hopper").gf2_trinv_chain_floor_launch
    f.argtypes = [_INT] * 4 + [_VOID, _VOID]
    f.restype = _INT
    out = torch.empty(1, dtype=torch.int32, device="cuda")   # never written
    err = f(blocks, threads, smem, w, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"trinv chain_floor: CUDA error {err} at launch")


def unit_tri_inv_hopper(nil: torch.Tensor, upper: bool) -> torch.Tensor:
    """(I + N)^{-1} of every element; see the module text for the contract.
    ``nil`` may be a view with any row and batch stride whose words of a
    row are adjacent.  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    _check(nil)
    *lead, n, w = nil.shape
    batch = 1
    for d in lead:
        batch *= d
    with spans.span("kernel.unit_tri_inv_hopper", batch=batch, n=n,
                    upper=int(upper)):
        if not nil.is_cuda:
            return unit_tri_inv_plain(nil, upper)
        return _launch(nil, upper, batch)


def _launch(nil: torch.Tensor, upper: bool, batch: int) -> torch.Tensor:
    """Launch the kernel (checked by the caller)."""
    device = nil.get_device()
    if torch.cuda.current_device() != device:
        with torch.cuda.device(device):
            return _launch(nil, upper, batch)
    *lead, n, w = nil.shape
    n32 = w * WORD_BITS
    dev = nil.device
    out = torch.empty((*lead, n, w), dtype=torch.int32, device=dev)
    if batch == 0 or n == 0:
        return out
    x = nil.reshape(batch, n, w)
    if w > 1 and x.stride(2) != 1:
        x = x.contiguous()
    if n32 > n:                    # zero rows to a whole word of rows
        x = torch.nn.functional.pad(x, (0, 0, 0, n32 - n))
    res = out if n32 == n else torch.empty((batch, n32, w), dtype=torch.int32,
                                           device=dev)
    strips, sw, threads = trinv_plan(batch, n32, _sms(device))
    if batch * strips > _MAX_GRID_X:
        raise ValueError(f"{batch} inverses exceed the launch grid")
    err = _fn()(x.data_ptr(), x.stride(1), x.stride(0), res.data_ptr(), batch,
                w, sw, threads, int(upper),
                torch._C._cuda_getCurrentRawStream(device))
    spans.count("launch.unit_tri_inv_hopper")
    if err:
        raise RuntimeError(f"unit_tri_inv_hopper: CUDA error {err} at launch")
    if res is not out:
        out.copy_(res[:, :n].reshape(out.shape))
    return out

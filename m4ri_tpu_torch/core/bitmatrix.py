"""BitMatrix: the dense GF(2) matrix container of the PyTorch/CUDA port.

Reference analogue: ``mzd_t`` (mzd.h:68-99) — a bit-packed matrix with an
excess-bit discipline (mzd.h:102-139: bits beyond ``ncols`` in the last word
are undefined there; here they are *always zero*, which every op preserves
and the tests assert).

Design:
- ``data: int32[nrows, width]`` with ``width = ceil(ncols/32)``; column ``c``
  lives in word ``c // 32`` at bit ``c % 32`` (LSB first).  The bits are
  those of the JAX package's uint32 words; the type is int32 because torch
  has no right shift for uint32.  int32 ``>>`` is arithmetic, so every
  right shift here is followed by a mask that clears the copied sign bits.
- Ops are functional: they return a new matrix and leave their inputs.
- Every function that creates a matrix takes ``device=None``; ``None`` means
  the card, and raises when there is none.  Pass ``device="cpu"`` to run on
  the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.config import WORD_BITS

__all__ = [
    "BitMatrix", "width_for", "padding_mask", "zeros", "identity",
    "from_numpy", "to_numpy", "from_packed", "randomize",
    "randomize_reference", "add", "equal", "is_zero", "read_bit",
    "write_bit", "submatrix", "stack", "concat", "row_swap", "col_swap",
    "mask_padding", "density", "shift_columns_left", "shift_columns_right",
    "randomize_custom", "resolve_device", "popcount32", "xor_reduce",
    "keep_below", "padding_words",
]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card.  A CUDA device that is not there raises: the
    port does not carry on on the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "m4ri_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the host")
    return dev


def width_for(ncols: int) -> int:
    return (ncols + WORD_BITS - 1) // WORD_BITS


def padding_mask(ncols: int) -> np.ndarray:
    """uint32[width] mask with 1s at valid column positions."""
    w = width_for(ncols)
    mask = np.full(w, 0xFFFFFFFF, dtype=np.uint32)
    rem = ncols % WORD_BITS
    if rem:
        mask[-1] = np.uint32((1 << rem) - 1)
    return mask


def _words(a: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 words -> int32 tensor with the same bits (always a copy:
    the tensor never shares memory with the caller's array)."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    return torch.tensor(a.view(np.int32), device=resolve_device(device))


@dataclasses.dataclass(frozen=True)
class BitMatrix:
    data: torch.Tensor  # int32[nrows, width]; a stack [..., nrows, width]
    ncols: int

    @property
    def nrows(self) -> int:
        return self.data.shape[-2]

    @property
    def width(self) -> int:
        return self.data.shape[-1]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nrows, self.ncols)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def __repr__(self) -> str:  # pragma: no cover
        return f"BitMatrix({self.nrows}x{self.ncols}, {self.data.device})"


def zeros(nrows: int, ncols: int, device=None) -> BitMatrix:
    return BitMatrix(torch.zeros((nrows, width_for(ncols)), dtype=torch.int32,
                                 device=resolve_device(device)), ncols)


def identity(n: int, device=None) -> BitMatrix:
    dev = resolve_device(device)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    words = torch.arange(width_for(n), dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    data = torch.where(rows[:, None] // WORD_BITS == words[None, :],
                       one << (rows[:, None] % WORD_BITS), 0)
    return BitMatrix(data.to(torch.int32), n)


def from_numpy(a: np.ndarray, device=None) -> BitMatrix:
    """Dense 0/1 numpy array -> BitMatrix."""
    a = np.asarray(a).astype(np.uint8) & 1
    nrows, ncols = a.shape
    w = width_for(ncols)
    padded = np.zeros((nrows, w * WORD_BITS), dtype=np.uint8)
    padded[:, :ncols] = a
    # little bit order within each 32-bit word
    packed = np.packbits(padded.reshape(nrows, w, 4, 8), axis=-1,
                         bitorder="little")
    data = packed.reshape(nrows, w, 4).view(np.uint32).reshape(nrows, w)
    return BitMatrix(_words(data, device), ncols)


def to_numpy(m: BitMatrix) -> np.ndarray:
    """BitMatrix -> dense uint8 0/1 numpy array."""
    data = np.ascontiguousarray(m.data.detach().cpu().numpy())
    bytes_ = data.view(np.uint8).reshape(m.nrows, m.width * 4)
    bits = np.unpackbits(bytes_, axis=1, bitorder="little")
    return bits[:, : m.ncols]


def from_packed(data, ncols: int, device=None) -> BitMatrix:
    """Packed words (numpy uint32/int32 or an int32 tensor) -> BitMatrix,
    padding bits cleared."""
    if isinstance(data, torch.Tensor):
        data = data.to(device=resolve_device(device), dtype=torch.int32)
    else:
        data = np.asarray(data)
        if data.dtype != np.int32:
            data = data.astype(np.uint32)
        data = _words(data.view(np.uint32), device)
    assert data.ndim == 2 and data.shape[1] == width_for(ncols)
    return mask_padding(BitMatrix(data, ncols))


def keep_below(bounds: torch.Tensor, nwords: int) -> torch.Tensor:
    """Packed int32 [..., nwords] row masks keeping bit positions k <
    bounds[...], made on bounds' device (no copy from the host)."""
    w = torch.arange(nwords, device=bounds.device)
    rem = (bounds[..., None] - w * WORD_BITS).clamp(0, WORD_BITS)
    mask = (torch.ones_like(rem) << rem) - 1          # int64: no shift by 32
    return torch.where(mask > 2**31 - 1, mask - 2**32, mask).to(torch.int32)


def padding_words(ncols: int, device) -> torch.Tensor:
    """int32 [width(ncols)]: the valid bits of a row (``padding_mask``'s
    words), made on the device by two fills: no copy from the host, which
    on the card would wait for the stream."""
    mask = torch.full((width_for(ncols),), -1, dtype=torch.int32,
                      device=device)
    rem = ncols % WORD_BITS
    if rem:
        mask[-1:].fill_((1 << rem) - 1)     # a scalar argument, no copy
    return mask


def mask_padding(m: BitMatrix) -> BitMatrix:
    """Force padding bits (columns >= ncols) to zero; leading batch axes of
    ``m.data`` pass through."""
    return BitMatrix(m.data & padding_words(m.ncols, m.device), m.ncols)


def randomize(nrows: int, ncols: int, generator: torch.Generator,
              device=None) -> BitMatrix:
    """Uniform random fill from ``generator``, which must live on the
    matrix's device."""
    dev = resolve_device(device)
    bits = torch.randint(-2**31, 2**31, (nrows, width_for(ncols)),
                         dtype=torch.int32, generator=generator, device=dev)
    return mask_padding(BitMatrix(bits, ncols))


def randomize_reference(nrows: int, ncols: int, seed: int = 17,
                        rng=None, device=None) -> BitMatrix:
    """Fill exactly like mzd_randomize under srandom(seed) (mzd.c:1270)."""
    from ..utils.rng import reference_random_data
    return BitMatrix(
        _words(reference_random_data(nrows, ncols, seed, rng), device), ncols)


def add(a: BitMatrix, b: BitMatrix) -> BitMatrix:
    """GF(2) addition == XOR (reference: mzd_add, mzd.c)."""
    assert a.shape == b.shape
    return BitMatrix(a.data ^ b.data, a.ncols)


def equal(a: BitMatrix, b: BitMatrix) -> torch.Tensor:
    if a.shape != b.shape:
        return torch.tensor(False, device=a.data.device)
    return torch.all(a.data == b.data)


def is_zero(a: BitMatrix) -> torch.Tensor:
    return torch.all(a.data == 0)


def read_bit(m: BitMatrix, i: int, j: int) -> torch.Tensor:
    w, s = divmod(int(j), WORD_BITS)
    return (m.data[i, w] >> s) & 1  # the & 1 drops the copied sign bits


def write_bit(m: BitMatrix, i: int, j: int, value: int) -> BitMatrix:
    w, s = divmod(int(j), WORD_BITS)
    bit = np.array([1 << s], np.uint32).view(np.int32)[0].item()
    data = m.data.clone()
    data[i, w] = (data[i, w] & ~bit) | (bit if int(value) & 1 else 0)
    return BitMatrix(data, m.ncols)


def _low_mask(nbits: int) -> int:
    """int32 value with the low ``nbits`` bits set (0 < nbits < 32)."""
    return (1 << nbits) - 1


def _pad_words(data: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(data, (0, pad))


def shift_columns_left(data: torch.Tensor, shift_bits: int,
                       out_width: int) -> torch.Tensor:
    """Shift every row's bitstring down by ``shift_bits`` (dropping the low
    columns), producing ``out_width`` words."""
    sw, sb = divmod(shift_bits, WORD_BITS)
    w = data.shape[1]
    pad = sw + out_width + 1 - w
    if pad > 0:
        data = _pad_words(data, pad)
    lo = data[:, sw : sw + out_width]
    if sb == 0:
        return lo.clone()
    hi = data[:, sw + 1 : sw + 1 + out_width]
    # arithmetic >> copies the sign into the top sb bits: mask them off
    return ((lo >> sb) & _low_mask(WORD_BITS - sb)) | (hi << (WORD_BITS - sb))


def shift_columns_right(data: torch.Tensor, shift_bits: int,
                        out_width: int) -> torch.Tensor:
    """Shift every row's bitstring up by ``shift_bits`` (inserting zero low
    columns), producing ``out_width`` words."""
    sw, sb = divmod(shift_bits, WORD_BITS)
    nrows, w = data.shape
    out = torch.zeros((nrows, out_width), dtype=torch.int32,
                      device=data.device)
    n_copy = min(w, out_width - sw)
    if n_copy <= 0:
        return out
    if sb == 0:
        out[:, sw : sw + n_copy] = data[:, :n_copy]
        return out
    lo = data << sb
    hi = (data >> (WORD_BITS - sb)) & _low_mask(sb)
    out[:, sw : sw + n_copy] = lo[:, :n_copy]
    n_hi = min(w, out_width - sw - 1)
    if n_hi > 0:
        out[:, sw + 1 : sw + 1 + n_hi] ^= hi[:, :n_hi]
    return out


def submatrix(m: BitMatrix, r0: int, c0: int, r1: int, c1: int) -> BitMatrix:
    """Copy rows [r0,r1) x cols [c0,c1); arbitrary offsets (reference:
    mzd_submatrix / mzd_init_window)."""
    assert 0 <= r0 <= r1 <= m.nrows and 0 <= c0 <= c1 <= m.ncols
    ncols = c1 - c0
    out = shift_columns_left(m.data[r0:r1], c0, width_for(ncols))
    return mask_padding(BitMatrix(out, ncols))


def stack(a: BitMatrix, b: BitMatrix) -> BitMatrix:
    """Vertical concatenation [A; B] (reference: mzd_stack)."""
    assert a.ncols == b.ncols
    return BitMatrix(torch.cat([a.data, b.data], dim=0), a.ncols)


def concat(a: BitMatrix, b: BitMatrix) -> BitMatrix:
    """Horizontal concatenation / augmentation [A | B] (reference:
    mzd_concat)."""
    assert a.nrows == b.nrows
    ncols = a.ncols + b.ncols
    out_w = width_for(ncols)
    out = shift_columns_right(b.data, a.ncols, out_w)
    out[:, : a.width] ^= a.data
    return BitMatrix(out, ncols)


def row_swap(m: BitMatrix, i: int, j: int) -> BitMatrix:
    data = m.data.clone()
    data[i], data[j] = m.data[j], m.data[i]
    return BitMatrix(data, m.ncols)


def col_swap(m: BitMatrix, a: int, b: int) -> BitMatrix:
    """Swap columns a and b (reference: mzd_col_swap, mzd.h:325-415).
    Vectorized over rows: pull both bits, XOR-difference, scatter back."""
    wa, sa = divmod(int(a), WORD_BITS)
    wb, sb = divmod(int(b), WORD_BITS)
    data = m.data.clone()
    diff = ((data[:, wa] >> sa) ^ (data[:, wb] >> sb)) & 1
    data[:, wa] ^= diff << sa
    data[:, wb] ^= diff << sb
    return BitMatrix(data, m.ncols)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-word count of one-bits of an int32 tensor (torch has no
    popcount).  Every right shift is masked, so the arithmetic shift of a
    negative word does no harm; the products wrap in int32 as intended."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + ((x >> 4) & 0x0F0F0F0F)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR of all entries along ``dim`` (torch has no such reduction): fold
    the axis in halves, an odd last slice XORed into the first."""
    while x.shape[dim] > 1:
        n = x.shape[dim]
        half = n // 2
        y = x.narrow(dim, 0, half) ^ x.narrow(dim, half, half)
        if n % 2:
            y.narrow(dim, 0, 1).bitwise_xor_(x.narrow(dim, n - 1, 1))
        x = y
    if x.shape[dim] == 0:
        shape = list(x.shape)
        del shape[dim]
        return torch.zeros(shape, dtype=x.dtype, device=x.device)
    return x.squeeze(dim)


def density(m: BitMatrix) -> torch.Tensor:
    """Fraction of one-bits (reference: mzd_density, mzd.c:1792)."""
    per_row = popcount32(m.data).sum(dim=1, dtype=torch.int32)
    ones = per_row.to(torch.float32).sum()
    return ones / (m.nrows * m.ncols)


def randomize_custom(nrows: int, ncols: int, callback,
                     device=None) -> BitMatrix:
    """Fill from a user RNG callback returning 64-bit words, following the
    exact consumption order of mzd_randomize_custom (mzd.c:1287-1300):
    row-major, ceil(ncols/64) words per row, last word masked."""
    w64 = (ncols + 63) // 64
    mask_bits = (ncols - 1) % 64 + 1
    mask_end = (1 << mask_bits) - 1
    flat = [int(callback()) & 0xFFFFFFFFFFFFFFFF
            for _ in range(nrows * w64)]
    rows64 = np.array(flat, dtype=np.uint64).reshape(nrows, w64)
    rows64[:, w64 - 1] &= np.uint64(mask_end)
    lo = (rows64 & 0xFFFFFFFF).astype(np.uint32)
    hi = (rows64 >> np.uint64(32)).astype(np.uint32)
    out = np.empty((nrows, 2 * w64), dtype=np.uint32)
    out[:, 0::2] = lo
    out[:, 1::2] = hi
    return BitMatrix(_words(out[:, : width_for(ncols)], device), ncols)

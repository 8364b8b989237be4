"""GF(2) matrix multiplication.

Two engines:

1. ``mul_naive`` — popcount/parity oracle (reference: mzd_mul_naive,
   mzd.c:1141-1254, built on m4ri_parity64, parity.h:80-125).  Used as the
   independent cross-validation algorithm in tests, exactly as the reference
   test suite cross-checks naive vs M4RM vs Strassen.  It shares nothing
   with the matmul path or the kernels.

2. ``mul`` — the production engine.  AND is multiply and XOR is add mod 2,
   so ``C = (A @ B) & 1`` on 0/1 operands is the exact GF(2) product.  On
   the card, products past the gates of ``utils/config.py`` go to the two
   hand-written kernels (ops/hopper_mul.py, ops/hopper_mul2.py), which work
   on the packed words directly.  Everything else, and everything on the
   CPU, unpacks to float32, calls ``torch.matmul`` and packs the parity;
   large operands go in row/depth blocks so the unpacked tiles stay bounded
   (reference analogue: __M4RI_MUL_BLOCKSIZE, mzd.h:59), and depth-block
   partial products combine by XOR since parity(a+b) = parity(a) ^ parity(b).
"""

from __future__ import annotations

import torch

from ..core.bitmatrix import BitMatrix, popcount32, width_for
from ..core.transpose import transpose
from ..utils import spans
from ..utils.config import WORD_BITS, get_config

__all__ = ["unpack_bits", "pack_bits", "mul_naive", "mul", "addmul",
           "mul_packed_data", "addmul_packed_data_", "exact_float32"]


class exact_float32:
    """``with exact_float32():`` float32 products on the card run in full
    float32, then the caller's setting comes back.  TF32 keeps about 10 bits
    of a sum, so it would round the 0/1 counts whose parity the GF(2)
    products read; sums below 2**24 are exact in float32."""

    __slots__ = ("_saved",)

    def __enter__(self):
        flags = torch.backends.cuda.matmul
        self._saved = flags.allow_tf32
        flags.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self._saved


# int64 constants of the byte-wise (un)packing, as signed 64-bit values: a
# byte copied into all eight bytes, bit j kept in byte j; and the multiplier
# that gathers bit 0 of byte j at bit 56 + j
_REPEAT = 0x0101010101010101
_SELECT = 0x8040201008040201 - (1 << 64)
_GATHER = sum(1 << (56 - 7 * j) for j in range(8))


def _flat(t: torch.Tensor, align: int = 1) -> torch.Tensor:
    """t's elements in row-major order, 1-D with stride 1 and a storage
    offset a multiple of ``align`` elements (a copy where t's is not)."""
    x = t.reshape(-1)
    if x.stride(0) != 1 or x.storage_offset() % align:
        x = x.clone(memory_format=torch.contiguous_format)
    return x


def unpack_bits(data: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """int32[..., m, w] -> dtype[..., m, w*32] of 0/1 lanes (column c at
    lane c; leading batch axes pass through).  Each byte of the words is
    spread over one int64 by a multiply, so every pass is a dense one over
    8-byte elements; a 1-byte ``dtype`` is a view of the result."""
    *lead, w = data.shape
    x = _flat(data).view(torch.uint8).to(torch.int64)
    x.mul_(_REPEAT).bitwise_and_(_SELECT)
    bits = x.view(torch.int8).ne(0).reshape(*lead, w * WORD_BITS)
    if dtype == torch.bool:
        return bits
    return bits.view(dtype) if dtype.itemsize == 1 else bits.to(dtype)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """0/1 integer [..., m, n] -> packed int32[..., m, ceil(n/32)]: the
    bits as bytes, padded to whole words, each 8 of them read as one int64
    and gathered into a byte by a multiply."""
    *lead, n = bits.shape
    w = width_for(n)
    x = bits.to(torch.int8)
    if w * WORD_BITS > n:
        x = torch.nn.functional.pad(x, (0, w * WORD_BITS - n))
    x = _flat(x, 8).view(torch.int64) * _GATHER
    # the cast to uint8 keeps the low byte of the shifted product
    x = x.bitwise_right_shift_(56).to(torch.uint8).view(torch.int32)
    return x.reshape(*lead, w)


def _dot_parity(a_u: torch.Tensor, b_u: torch.Tensor) -> torch.Tensor:
    """(unpacked A) @ (unpacked B) mod 2, packed (a leading batch axis is a
    batched product).  float32 operands and a
    float32 result: exact for k < 2**24.  (An int8 matmul on the CPU wraps
    at 8 bits, a bf16/fp16 one on the card rounds its result; TF32 is
    switched off around the product because it would round the counts.)"""
    with exact_float32():
        prod = a_u @ b_u
    return pack_bits(prod.to(torch.int32) & 1)


def _on_card(t: torch.Tensor) -> bool:
    """Whether the kernel gates apply (the tests patch this to drive the
    routing on CPU tensors, where the wrappers run their plain versions)."""
    return t.is_cuda


def _route(m: int, kw: int, nw: int, cfg) -> str:
    """Which engine a product of these word shapes takes on the card:
    "hopper", "hopper_v2" or "matmul"."""
    kp = kw * WORD_BITS
    # Shallow contractions: the matmul path would write an m x n float32
    # product to device memory, 32 times the packed result.
    if kw <= 32 and m >= 2048 and nw >= 128:
        return "hopper"
    # Large products: contractions of more than one chunk go to the
    # split-contraction kernel, single-chunk ones stay with the kernel that
    # writes C once (both routes timed in turns on an H100 at 4096^3 to
    # 16384^3 and 8192 x 512 x 8192: the gate at 64 words held).
    if (m >= 2048 and nw >= 128
            and max(m, kp, nw * WORD_BITS) >= cfg.hopper_big_min):
        return "hopper_v2" if kw > 64 else "hopper"
    return "matmul"


def _block_mul(a_blk: torch.Tensor, b_blk: torch.Tensor) -> torch.Tensor:
    a_u = unpack_bits(a_blk)
    b_u = unpack_bits(b_blk)
    short = a_blk.shape[1] * WORD_BITS - b_blk.shape[0]
    if short > 0:
        b_u = torch.nn.functional.pad(b_u, (0, 0, 0, short))
    return _dot_parity(a_u, b_u)


def _matmul_path(a_data, b_data, cfg) -> torch.Tensor:
    m, kw = a_data.shape
    k, nw = b_data.shape
    if max(m, kw * WORD_BITS, nw * WORD_BITS) <= cfg.mul_block_threshold:
        return _block_mul(a_data, b_data)
    # Blocked path: XOR partial parities over depth blocks, tile rows.
    bm, bk = cfg.mul_block_m, cfg.mul_block_k
    bkw = bk // WORD_BITS
    out = torch.zeros((m, nw), dtype=torch.int32, device=a_data.device)
    for r0 in range(0, m, bm):
        r1 = min(r0 + bm, m)
        for c0 in range(0, kw, bkw):
            c1 = min(c0 + bkw, kw)
            b_blk = b_data[c0 * WORD_BITS : min(c1 * WORD_BITS, k), :]
            out[r0:r1] ^= _block_mul(a_data[r0:r1, c0:c1], b_blk)
    return out


def mul_packed_data(a_data: torch.Tensor, b_data: torch.Tensor,
                    cfg=None, allow_kernel: bool = True) -> torch.Tensor:
    """Packed int32[m, kw] x int32[k, nw] -> packed int32[m, nw].

    Requires b_data padding bits to be zero (BitMatrix invariant).  The
    contraction runs over a_data's padded width; A's padding lanes are zero
    so the padded rows of B (all-zero) contribute nothing.  The operands
    may be strided views.  ``allow_kernel=False`` pins the matmul path.
    """
    if cfg is None:
        cfg = get_config()
    route = "matmul"
    if allow_kernel and _on_card(a_data):
        route = _route(a_data.shape[0], a_data.shape[1], b_data.shape[1], cfg)
    if route == "hopper":
        from . import hopper_mul
        return hopper_mul.gf2_mul_hopper(a_data, b_data)
    if route == "hopper_v2":
        from . import hopper_mul2
        return hopper_mul2.gf2_mul_hopper_v2(a_data, b_data)
    return _matmul_path(a_data, b_data, cfg)


def addmul_packed_data_(c_data: torch.Tensor, a_data: torch.Tensor,
                        b_data: torch.Tensor, cfg=None) -> torch.Tensor:
    """In place: c_data ^= a_data * b_data; returns c_data (which may be a
    strided view).  On the split-contraction route the kernel XORs straight
    into C; elsewhere the product is formed and XORed in."""
    if cfg is None:
        cfg = get_config()
    if _on_card(a_data) and _route(a_data.shape[0], a_data.shape[1],
                                   b_data.shape[1], cfg) == "hopper_v2":
        from . import hopper_mul2
        return hopper_mul2.gf2_mul_hopper_v2(a_data, b_data, out=c_data,
                                             accumulate=True)
    c_data ^= mul_packed_data(a_data, b_data, cfg)
    return c_data


def _is_sqr(a: BitMatrix, b: BitMatrix) -> bool:
    """Same-operand detection (reference: mzd_mul dispatches A == B to the
    squaring specialization, strassen.c:358-364): the same object, or the
    same buffer seen through the same shape and strides."""
    if a is b or a.data is b.data:
        return True
    return (a.ncols == b.ncols and a.data.shape == b.data.shape
            and a.data.data_ptr() == b.data.data_ptr()
            and a.data.stride() == b.data.stride()
            and a.data.device == b.data.device)


@spans.entry("mul")
def mul(a: BitMatrix, b: BitMatrix) -> BitMatrix:
    """C = A*B over GF(2) (reference API: mzd_mul, strassen.c:345)."""
    assert a.ncols == b.nrows, (a.shape, b.shape)
    from .strassen import strassen_mul_data, strassen_sqr_data
    cfg = get_config()
    if min(a.nrows, a.ncols, b.ncols) >= cfg.strassen_cutoff * 2:
        if _is_sqr(a, b):
            out = strassen_sqr_data(a.data, a.ncols)
        else:
            out = strassen_mul_data(a.data, b.data, a.nrows, a.ncols, b.ncols)
    else:
        out = mul_packed_data(a.data, b.data)
    return BitMatrix(out, b.ncols)


def addmul(c: BitMatrix, a: BitMatrix, b: BitMatrix) -> BitMatrix:
    """C += A*B (reference API: mzd_addmul, strassen.c:675), as a new
    matrix: the Strassen range uses the fused-accumulate schedule (no
    full-product temporary); below it the product is XORed into a copy of C,
    by the kernel itself where the split-contraction kernel runs."""
    from .strassen import strassen_addmul_data, strassen_addsqr_data
    cfg = get_config()
    if min(a.nrows, a.ncols, b.ncols) >= cfg.strassen_cutoff * 2:
        if _is_sqr(a, b):
            out = strassen_addsqr_data(c.data, a.data, a.ncols)
        else:
            out = strassen_addmul_data(c.data, a.data, b.data,
                                       a.nrows, a.ncols, b.ncols)
        return BitMatrix(out, c.ncols)
    return BitMatrix(addmul_packed_data_(c.data.clone(), a.data, b.data),
                     c.ncols)


def mul_naive(a: BitMatrix, b: BitMatrix, chunk: int = 1024) -> BitMatrix:
    """Cubic popcount-parity oracle (reference: mzd_mul_naive, mzd.c:1141).

    C[i, j] = parity(popcount_w(A[i, w] & B^T[j, w])).  Independent of the
    matmul path and of the kernels — used for cross-validation.
    """
    assert a.ncols == b.nrows
    bt = transpose(b)  # (n, kw)
    outs = []
    for r0 in range(0, a.nrows, chunk):
        blk = a.data[r0 : r0 + chunk]  # (mb, kw)
        cnt = popcount32(blk[:, None, :] & bt.data[None, :, :]).sum(
            dim=-1, dtype=torch.int32)
        outs.append(pack_bits(cnt & 1))
    return BitMatrix(torch.cat(outs, dim=0), b.ncols)

"""Packed GF(2) words and the GF(2) product by float matrix products."""

from __future__ import annotations

import torch

WORD = 32

# The contraction is cut into blocks of 1024 bits.  A block's sums of 0/1
# products are at most 1024: exact in float16 (integers to 2048), not in
# bfloat16 (integers to 256), which is the control's precision.
BLOCK_K = 1024


def words_for(ncols: int) -> int:
    return (ncols + WORD - 1) // WORD


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD, dtype=torch.int32, device=device)


def unpack(words: torch.Tensor, ncols: int, dtype=torch.uint8) -> torch.Tensor:
    """[..., w] int32 words -> [..., ncols] 0/1 of ``dtype``."""
    bits = (words[..., None] >> _shifts(words.device)) & 1
    return bits.flatten(-2)[..., :ncols].to(dtype)


def pack(bits: torch.Tensor) -> torch.Tensor:
    """[..., n] 0/1 (any integer or float type) -> [..., words_for(n)]
    int32.  Distinct bits never carry, so an int32 sum with wrap-around is
    their OR."""
    n = bits.shape[-1]
    pad = words_for(n) * WORD - n
    b = bits.to(torch.int32)
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.unflatten(-1, (-1, WORD)) << _shifts(bits.device)
    return b.sum(-1, dtype=torch.int32)


def random_words(shape, ncols: int, generator: torch.Generator,
                 device) -> torch.Tensor:
    """Uniform random packed rows with zero padding bits: ``shape`` ends in
    the word count of ``ncols`` columns.  One call on ``device``."""
    x = torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                      generator=generator, device=device)
    rem = ncols % WORD
    if rem:
        x[..., -1] &= (1 << rem) - 1
    return x


def matmul_bits(a: torch.Tensor, b: torch.Tensor,
                dtype=torch.float16) -> torch.Tensor:
    """(a @ b) mod 2 as uint8 for 0/1 tensors ``a`` [M, K] and ``b`` [K,
    N], each contraction block a float product in ``dtype``."""
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.uint8,
                      device=a.device)
    for k0 in range(0, a.shape[1], BLOCK_K):
        part = a[:, k0:k0 + BLOCK_K].to(dtype) @ b[k0:k0 + BLOCK_K].to(dtype)
        out ^= (part.to(torch.int32) & 1).to(torch.uint8)
    return out


def mul_packed(a: torch.Tensor, b: torch.Tensor, k: int, n: int,
               dtype=torch.float16, block_m: int = 4096) -> torch.Tensor:
    """C = A B over GF(2) for packed ``a`` [m, words_for(k)] and ``b`` [k,
    words_for(n)]: packed [m, words_for(n)].  The contraction in blocks of
    ``BLOCK_K`` bits, rows of A in blocks of ``block_m``, each block product
    a float product of the unpacked bits in ``dtype``."""
    block_k = BLOCK_K
    m = a.shape[0]
    out = torch.zeros((m, words_for(n)), dtype=torch.int32, device=a.device)
    for k0 in range(0, k, block_k):
        k1 = min(k, k0 + block_k)
        bb = unpack(b[k0:k1], n, dtype)
        for r0 in range(0, m, block_m):
            ab = unpack(a[r0:r0 + block_m, k0 // WORD: words_for(k1)],
                        k1 - k0, dtype)
            out[r0:r0 + block_m] ^= pack((ab @ bb).to(torch.int32) & 1)
    return out

"""Debug-dump hashing (reference analogue: debug_dump.[ch], mzd_hash
mzd.h:1174-1180 — a rolling row-rotate XOR hash printed after every mutator
when built with --enable-debug-dump; the key mechanism for diffing two
implementations op by op).

The hash is the one the JAX package computes, bit for bit, so the two dump
streams can be diffed against each other: per-row FNV-style fold over 32-bit
words, rotated by row index, XOR-combined.  Enable op-level logging with
``debug_dump(True)``; every instrumented entry point then logs
``name: hash`` like the reference's __M4RI_DD_MZD macros.
"""

from __future__ import annotations

import functools

import torch

from ..core.bitmatrix import BitMatrix, xor_reduce

_ENABLED = False
_U32 = 0xFFFFFFFF


def debug_dump(enable: bool = True) -> None:
    global _ENABLED
    _ENABLED = enable


def matrix_hash(a: BitMatrix) -> torch.Tensor:
    """Order-sensitive 32-bit hash of a BitMatrix (int64 scalar tensor in
    [0, 2**32)).  Worked in int64 and masked to 32 bits, so the wrapping
    products and the rotation need no unsigned type."""
    data = a.data.to(torch.int64) & _U32
    nrows, width = data.shape
    dev = data.device
    widx = torch.arange(width, dtype=torch.int64, device=dev)
    words = ((data * 16777619) & _U32) ^ ((widx[None, :] * 0x9E3779B9) & _U32)
    rowh = xor_reduce(words, 1) ^ 2166136261
    rot = torch.arange(nrows, dtype=torch.int64, device=dev) % 32
    rolled = ((rowh << rot) | (rowh >> ((32 - rot) % 32))) & _U32
    return xor_reduce(rolled, 0) ^ a.ncols


def dd(name: str, a: BitMatrix) -> None:
    """Log ``name: hash`` when debug-dump is enabled (reference:
    __M4RI_DD_MZD, debug_dump.h:29-61)."""
    if _ENABLED:
        print(f"[m4ri_tpu_torch dd] {name}: 0x{int(matrix_hash(a)):08x}")


def instrument(name: str, fn):
    """Wrap a public matrix-producing entry point so that, with
    debug_dump(True), every call logs the op name and result hash.  Zero
    overhead when disabled."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        if _ENABLED:
            items = out if isinstance(out, tuple) else (out,)
            for i, it in enumerate(items):
                if isinstance(it, BitMatrix):
                    dd(f"{name}[{i}]" if isinstance(out, tuple) else name, it)
        return out

    return wrapped

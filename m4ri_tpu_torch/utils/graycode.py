"""Gray code tables (reference analogue: graycode.[ch]).

The reference builds a global codebook `m4ri_codebook[k]` for k = 1..16 at
library load (graycode.c:52-62), holding for each k the Gray-code ordering
``ord`` and the per-step changed-bit index ``inc``; the M4RM/MMPF engines use
these to build 2^k-row XOR tables incrementally.

Here the codebook is host-side numpy, computed once and cached; there is
no global mutable state (the reference's codebook is explicitly not
thread-safe, graycode.h:93-98).  The JAX package's module of the same name
holds the same code; the port keeps its own copy, numpy only.
"""

from __future__ import annotations

import functools

import numpy as np

MAXK = 16  # reference: __M4RI_MAXKAY, graycode.h:55


def gray_code(number: int, length: int) -> int:
    """The Gray code of ``number`` over ``length`` bits (graycode.c:31-40)."""
    lastbit = 0
    res = 0
    for i in range(length - 1, -1, -1):
        bit = number & (1 << i)
        res |= (lastbit >> 1) ^ bit
        lastbit = bit
    return res


@functools.lru_cache(maxsize=MAXK + 1)
def codebook(k: int) -> tuple[np.ndarray, np.ndarray]:
    """(ord, inc) arrays for k bits (reference: m4ri_build_code,
    graycode.c:42-50)."""
    assert 1 <= k <= MAXK
    n = 1 << k
    ord_ = np.array([gray_code(i, k) for i in range(n)], np.int32)
    inc = np.zeros(n, np.int32)
    for i in range(k, 0, -1):
        for j in range(1, (1 << i) + 1):
            idx = j * (1 << (k - i)) - 1
            if idx < n:
                inc[idx] = k - i
    return ord_, inc


def opt_k(a: int, b: int, c: int = 0) -> int:
    """Optimal Gray-table width ~ 0.75 * (1 + floor(log2(min(a, b)))).

    Bit-exact port of m4ri_opt_k (graycode.c:75-79) — including the fact
    that the third argument is accepted but unused (the reference's
    signature keeps it for historic call sites; see graycode.c:76-78,
    which only ever reads MIN(a, b))."""
    n = min(a, b)
    return min(MAXK, max(1, int(0.75 * (1 + int(np.log2(max(n, 1)))))))

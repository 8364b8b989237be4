"""M4RI's PLE decomposition over GF(2), by a plain blocked sweep.

The result is the one ``mzd_ple`` defines (M4RI ple.c, ``_mzd_ple_naive``
and the L compression after it):

- columns are taken left to right; the pivot of a column is the first row
  at or below the rank whose current entry is 1; that row and the row at
  the rank swap whole (LAPACK style), ``P[rank] = pivot row``,
  ``Q[rank] = column``; entries past the rank keep ``P[i] = i``, ``Q[i] = i``;
- rows below the pivot with a 1 in its column add the pivot row to their
  columns right of it, so the 1 stays where it was as the multiplier of L;
- then, for j < rank ascending, columns ``Q[j]`` and ``j`` swap in rows j
  and below, which moves L into columns 0..rank-1.

The pivot order is unique, so the body, P, Q and the rank are compared word
for word.  The sweep takes panels of ``panel`` columns: inside a panel,
one column at a time on the panel's words, with the pivot row read back to
the host; after it, the panel's row order applied to the rest of the rows,
the pivot rows' trailing words ``U = L11^-1 T`` and the rows below
``T ^= L21 U``, both as float products of the unpacked bits (``dtype``
float16 is exact; bfloat16, the control, is not).
"""

from __future__ import annotations

import torch

from .gf2 import WORD, matmul_bits, pack, unpack, words_for


def _above_masks(panel: int, device) -> torch.Tensor:
    """int32 [panel, panel // 32]: row j keeps the panel's columns > j."""
    cols = torch.arange(panel, device=device)
    keep = (cols[None, :] > cols[:, None]).to(torch.uint8)
    return pack(keep)


def _unit_lower_inverse(strict: torch.Tensor, dtype) -> torch.Tensor:
    """(I + N)^-1 over GF(2) for strictly lower 0/1 ``N`` [k, k]: the
    product of (I + N^(2^i)) while the power is not zero."""
    k = strict.shape[0]
    eye = torch.eye(k, dtype=torch.uint8, device=strict.device)
    inv = eye ^ strict
    power = strict
    for _ in range(max(0, (k - 1).bit_length() - 1)):
        power = matmul_bits(power, power, dtype)
        inv = matmul_bits(inv, eye ^ power, dtype)
    return inv


def _eliminate_panel(pan: torch.Tensor, c0: int, c1: int, masks):
    """Canonical elimination of the panel words ``pan`` [M, pw] in place
    over columns c0..c1-1 (c0 a multiple of 32).  Returns the swaps as
    (local position, local pivot row) pairs, the local row order after
    them, and the panel's pivot columns (local)."""
    M, pw = pan.shape
    order = list(range(M))
    swaps, qloc = [], []
    rl = 0
    for j in range(c1 - c0):
        if rl == M:
            break
        wi, b = divmod(j, WORD)
        col = (pan[rl:, wi] >> b) & 1
        best, at = col.max(0)
        found, i = torch.stack([best.to(torch.int64), at]).tolist()
        if not found:
            continue
        p = rl + i
        if i:
            row = pan[rl].clone()
            pan[rl] = pan[p]
            pan[p] = row
            order[rl], order[p] = order[p], order[rl]
            col[i] = 0        # the row now at p had no 1 here (p was first)
        swaps.append((rl, p))
        qloc.append(j)
        pan[rl + 1:] ^= (-col[1:])[:, None] & (pan[rl] & masks[j, :pw])
        rl += 1
    return swaps, order, qloc


def ple(words: torch.Tensor, ncols: int, panel: int = 1024,
        dtype=torch.float16, block_cols: int = 4096):
    """PLE of the packed m x ncols matrix ``words`` [m, words_for(ncols)]:
    ``(body int32 [m, w], P int32 [m], Q int32 [ncols], rank)``."""
    assert panel % WORD == 0 and block_cols % WORD == 0
    m, w = words.shape
    dev = words.device
    A = words.clone()
    P = list(range(m))
    Q = list(range(ncols))
    masks = _above_masks(panel, dev)
    r = 0
    for c0 in range(0, ncols, panel):
        if r == m:
            break
        c1 = min(ncols, c0 + panel)
        w0, w1 = c0 // WORD, words_for(c1)
        pan = A[r:, w0:w1].clone()
        swaps, order, qloc = _eliminate_panel(pan, c0, c1, masks)
        ri = len(qloc)
        if ri == 0:
            continue
        for rl, p in swaps:
            P[r + rl] = r + p
        for s, j in enumerate(qloc):
            Q[r + s] = c0 + j
        if any(rl != p for rl, p in swaps):
            A[r:] = A[r:][torch.tensor(order, device=dev)]
        A[r:, w0:w1] = pan
        if w1 < w:
            qw = torch.tensor(qloc, device=dev)
            lbits = ((pan[:, qw // WORD] >> (qw % WORD)) & 1).to(torch.uint8)
            strict = torch.tril(lbits[:ri], diagonal=-1)
            inv = _unit_lower_inverse(strict, dtype)
            nt = ncols - w1 * WORD
            for b0 in range(0, nt, block_cols):
                bw0 = w1 + b0 // WORD
                bw1 = min(w, bw0 + block_cols // WORD)
                nbits = min(block_cols, nt - b0)
                t = A[r:, bw0:bw1]
                u = matmul_bits(inv, unpack(t[:ri], nbits), dtype)
                if ri < t.shape[0]:
                    t[ri:] ^= pack(matmul_bits(lbits[ri:], u, dtype))
                t[:ri] = pack(u)
        r += ri
    # L into columns 0..r-1: one masked column swap per pivot whose column
    # is not already its slot
    for j in range(r):
        a = Q[j]
        if a == j:
            continue
        wa, sa = divmod(a, WORD)
        wb, sb = divmod(j, WORD)
        diff = ((A[j:, wa] >> sa) ^ (A[j:, wb] >> sb)) & 1
        A[j:, wa] ^= diff << sa
        A[j:, wb] ^= diff << sb
    return (A, torch.tensor(P, dtype=torch.int32, device=dev),
            torch.tensor(Q, dtype=torch.int32, device=dev), r)

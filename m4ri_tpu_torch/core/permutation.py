"""LAPACK-style permutations (reference: mzp_t, mzp.h:37-49, mzp.c).

A permutation is stored as a swap array ``v`` with ``v[i] >= i``; applying it
"left" (to rows) means performing ``swap(i, v[i])`` for i ascending
(mzd_apply_p_left, mzp.c:65-72); the transpose applies the swaps descending
(mzp.c:74-81).  The format is kept exactly, so P/Q are interchangeable with
the reference's and the JAX package's.  Swap arrays are int32 tensors on the
matrix's device.

Instead of one row copy a swap, the swap sequence is folded into one
permutation vector with a few vectorised passes (pointer doubling), and the
matrix is permuted with one gather.  Column applications gather bit-columns
through unpack/pack.  ``apply_p_right_trans_tri`` is the row-chunked gather
form of the JAX package (its banded and path-blend engines exist because
gathers on the TPU lower to per-element selects; a CUDA gather is native).
"""

from __future__ import annotations

import math

import torch

from ..ops.mul import pack_bits, unpack_bits
from ..utils.config import WORD_BITS
from .bitmatrix import BitMatrix, mask_padding, padding_words

__all__ = [
    "swaps_to_perm", "invert_perm", "apply_p_left", "apply_p_left_trans",
    "apply_p_right", "apply_p_right_trans", "apply_p_right_trans_tri",
    "permute_rows", "permute_cols", "swaps_to_perm_batched",
    "apply_p_left_batched", "apply_p_right_trans_tri_batched",
]

# elements of each (rows x ncols) temporary of apply_p_right_trans_tri (of
# each [B, rows, ncols] one of its batched form); the gather's int64 index
# is the largest, 1 GB at this size.  Module-level so tests can shrink it to
# force several chunks.
_TRANS_TRI_CHUNK_ELEMS = 1 << 27
_SENTINEL = 2**31 - 1


def _doubling_steps(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2))))


def swaps_to_perm_seq(v: torch.Tensor, ascending: bool = True) -> torch.Tensor:
    """Sequential reference model of the swap fold (one step per swap, on
    the host) — kept as the cross-validation oracle for swaps_to_perm."""
    vs = v.tolist()
    n = len(vs)
    perm = list(range(n))
    for k in range(n):
        i = k if ascending else n - 1 - k
        j = vs[i]
        perm[i], perm[j] = perm[j], perm[i]
    return torch.tensor(perm, dtype=torch.int32, device=v.device)


def swaps_to_perm(v: torch.Tensor, ascending: bool = True) -> torch.Tensor:
    """Fold the swap sequence into a permutation ``perm`` such that
    ``new[i] = old[perm[i]]``.

    Vectorised (no O(n)-step loop): with the LAPACK contract ``v[i] >= i``,
    step i is the LAST step that touches slot i, so ``perm[i]`` equals the
    content of slot v[i] just before step i.  That content follows from
    ``pred(i)`` = previous step with the same target and ``tgt_pred(x)`` =
    last step before x that targeted slot x, whose chains are chased to
    their ends by pointer doubling (the technique of
    models/ple.py::_compress_l_impl).  Reference semantics: mzp.c:65-81."""
    n = v.shape[0]
    dev = v.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    v = v.long()
    idx = torch.arange(n, device=dev)
    # pred[i] = previous occurrence of value v[i] (or -1): a stable sort
    # groups equal values in index order
    order = torch.argsort(v, stable=True)
    sv = v[order]
    prev_sorted = torch.where((idx > 0) & (sv == sv.roll(1)), order.roll(1), -1)
    pred = torch.empty_like(prev_sorted)
    pred[order] = prev_sorted
    # last[c] = last step targeting slot c
    last = torch.full((n,), -1, dtype=torch.long, device=dev).scatter_reduce(
        0, v, idx, "amax")
    # tgt_pred(x): all targets of x are at steps <= x; step x itself targets
    # x only when v[x] == x, and then its previous occurrence is pred(x)
    tp = torch.where(v == idx, pred, last)
    f = torch.where(tp >= 0, tp, idx)       # terminal steps point to themselves
    for _ in range(_doubling_steps(n)):
        f = f[f]
    perm = torch.where(pred >= 0, f[pred.clamp(min=0)], v).to(torch.int32)
    if not ascending:
        # descending application composes the same transpositions in
        # reverse order: the inverse permutation (mzp.c:74-81)
        perm = invert_perm(perm)
    return perm


def invert_perm(perm: torch.Tensor) -> torch.Tensor:
    n = perm.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=perm.device)
    out[perm.long()] = torch.arange(n, dtype=torch.int32, device=perm.device)
    return out


def permute_rows(m: BitMatrix, perm: torch.Tensor) -> BitMatrix:
    return BitMatrix(m.data[perm.long()], m.ncols)


def permute_cols(m: BitMatrix, perm: torch.Tensor) -> BitMatrix:
    """new[:, j] = old[:, perm[j]] via unpack/gather/pack."""
    bits = unpack_bits(m.data, torch.uint8)
    return mask_padding(BitMatrix(pack_bits(bits[:, perm.long()]), m.ncols))


def apply_p_left(m: BitMatrix, v: torch.Tensor) -> BitMatrix:
    """Row swaps ascending (reference: mzd_apply_p_left, mzp.c:65)."""
    return permute_rows(m, swaps_to_perm(v[: m.nrows], True))


def apply_p_left_trans(m: BitMatrix, v: torch.Tensor) -> BitMatrix:
    """Row swaps descending (reference: mzd_apply_p_left_trans, mzp.c:74)."""
    return permute_rows(m, swaps_to_perm(v[: m.nrows], False))


def apply_p_right(m: BitMatrix, v: torch.Tensor) -> BitMatrix:
    """Column swaps descending (reference: mzd_apply_p_right applies swaps
    from the last index down, mzp.c:252-262)."""
    return permute_cols(m, swaps_to_perm(v[: m.ncols], False))


def apply_p_right_trans(m: BitMatrix, v: torch.Tensor) -> BitMatrix:
    """Column swaps ascending (reference: mzd_apply_p_right_trans)."""
    return permute_cols(m, swaps_to_perm(v[: m.ncols], True))


def apply_p_right_trans_tri_seq(m: BitMatrix, v: torch.Tensor) -> BitMatrix:
    """Sequential reference model (one masked column swap a step, the swap
    array read on the host) — the cross-validation oracle for
    apply_p_right_trans_tri, and the exact semantics for arbitrary (non-PLE)
    swap arrays."""
    n = min(m.ncols, v.shape[0])
    data = m.data.clone()
    for a, b in enumerate(v[:n].tolist()):
        if a == b or a == 0:
            continue
        wa, sa = divmod(a, WORD_BITS)
        wb, sb = divmod(b, WORD_BITS)
        rows = data[:a]
        diff = ((rows[:, wa] >> sa) ^ (rows[:, wb] >> sb)) & 1
        rows[:, wa] ^= diff << sa
        rows[:, wb] ^= diff << sb
    return BitMatrix(data, m.ncols)


def apply_p_right_trans_tri(m: BitMatrix, v: torch.Tensor) -> BitMatrix:
    """For i ascending: swap columns (i, v[i]) in rows [0, i) only
    (reference: mzd_apply_p_right_trans_tri, mzp.c:279-292).  Moves pivot
    columns onto the diagonal in the triangular region after PLE.

    Assumes the PLE-Q contract: v[i] >= i, and at most one *real* swap
    (v[j] > j) targets any column, which holds for PLE's Q since pivot
    columns are distinct and the tail is identity.  Other swap arrays go
    through apply_p_right_trans_tri_seq.

    Each real-step column c receives the pristine column v[c] in rows < c;
    every other cell chains through ``pre(x)`` = the real step targeting
    column x.  Both pre and its inverse are partial functions, so the chains
    are disjoint descending paths, and the answer at (r, c) is
    ``orig[r, min(A[r, path(c)], c)]`` where A[r, T] = the smallest node of
    path T that is > r: one scatter and a reverse running minimum down the
    rows, then one gather along each row.  Rows go in chunks from the bottom
    up, with the running minimum carried, so the temporaries stay bounded."""
    nrows, ncols = m.nrows, m.ncols
    dev = m.device
    if nrows == 0 or ncols == 0:
        return BitMatrix(m.data.clone(), ncols)
    n = min(ncols, v.shape[0])
    c = torch.arange(ncols, device=dev)
    v_ext = torch.cat([v[:n].long(), c[n:]])
    real = v_ext > c
    # pre[x] = the real step targeting column x (unique by the contract);
    # the steps that are not real all land in one slot past the end
    pre = torch.full((ncols + 1,), -1, dtype=torch.long, device=dev)
    pre = pre.scatter_reduce(0, torch.where(real, v_ext, ncols), c, "amax")
    pre = pre[:ncols]
    f = torch.where(pre >= 0, pre, c)
    for _ in range(_doubling_steps(ncols)):
        f = f[f]
    pathid = f
    # node y activates the rows above it: it enters at row min(y-1, nrows-1)
    node_row = (c - 1).clamp(0, nrows - 1)
    node_val = torch.where(c >= 1, c, _SENTINEL).to(torch.int32)
    bits = unpack_bits(m.data, torch.uint8)[:, :ncols]
    chunk = max(1, min(nrows, _TRANS_TRI_CHUNK_ELEMS // ncols))
    carry = torch.full((ncols,), _SENTINEL, dtype=torch.int32, device=dev)
    out = torch.empty((nrows, ncols), dtype=torch.uint8, device=dev)
    c32 = c.to(torch.int32)
    for r1 in reversed(range(0, nrows, chunk)):
        rows = min(chunk, nrows - r1)
        local = node_row - r1
        ok = (local >= 0) & (local < rows)
        B = torch.full((rows * ncols,), _SENTINEL, dtype=torch.int32,
                       device=dev)
        B = B.scatter_reduce(0, (local * ncols + pathid)[ok], node_val[ok],
                             "amin").view(rows, ncols)
        A = torch.minimum(B.flip(0).cummin(dim=0).values.flip(0), carry[None])
        del B
        carry = A[0]
        sel = torch.minimum(A[:, pathid], c32[None])
        del A
        ridx = torch.arange(r1, r1 + rows, device=dev)[:, None]
        src = torch.where(real[None] & (ridx < c[None]), v_ext[None], sel)
        out[r1:r1 + rows] = torch.gather(bits[r1:r1 + rows], 1, src)
    packed = pack_bits(out)
    return mask_padding(BitMatrix(packed[:, : m.width], ncols))


# ---- batched forms: a leading batch axis, every element its own swap array
# on the device; element i equals the single function on element i ----


def swaps_to_perm_batched(v: torch.Tensor) -> torch.Tensor:
    """``swaps_to_perm(v[i], True)`` for every row i of the int ``[B, n]``
    swap arrays: the same pointer doubling along the last axis."""
    B, n = v.shape
    dev = v.device
    if n == 0:
        return torch.zeros((B, 0), dtype=torch.int32, device=dev)
    v = v.long()
    idx = torch.arange(n, device=dev).expand(B, n)
    order = torch.argsort(v, dim=1, stable=True)
    sv = v.gather(1, order)
    prev_sorted = torch.where((idx > 0) & (sv == sv.roll(1, 1)),
                              order.roll(1, 1), -1)
    pred = torch.empty_like(prev_sorted).scatter_(1, order, prev_sorted)
    last = torch.full((B, n), -1, dtype=torch.long, device=dev).scatter_reduce(
        1, v, idx, "amax")
    tp = torch.where(v == idx, pred, last)
    f = torch.where(tp >= 0, tp, idx)
    for _ in range(_doubling_steps(n)):
        f = f.gather(1, f)
    return torch.where(pred >= 0, f.gather(1, pred.clamp(min=0)),
                       v).to(torch.int32)


def apply_p_left_batched(data: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Row swaps ascending on every element: ``apply_p_left(data[i],
    v[i])`` for packed ``[B, m, w]`` and swap arrays ``[B, >= m]``."""
    perm = swaps_to_perm_batched(v[:, : data.shape[1]]).long()
    return data.gather(1, perm[:, :, None].expand(-1, -1, data.shape[2]))


def apply_p_right_trans_tri_batched(data: torch.Tensor, ncols: int,
                                    v: torch.Tensor) -> torch.Tensor:
    """``apply_p_right_trans_tri(BitMatrix(data[i], ncols), v[i])`` for
    every element of packed ``[B, nrows, w]``, each v[i] a PLE Q.  The
    single form's path ids, scatter and running minimum with the batch in
    front: the scatter's flat index is offset by the element, the minimum
    runs down each element's rows, and the row chunk counts the batch, so
    each temporary stays at ``_TRANS_TRI_CHUNK_ELEMS`` elements."""
    B, nrows, w = data.shape
    dev = data.device
    if B == 0 or nrows == 0 or ncols == 0:
        return data.clone()
    n = min(ncols, v.shape[1])
    c = torch.arange(ncols, device=dev)
    v_ext = torch.cat([v[:, :n].long(), c[n:].expand(B, -1)], dim=1)
    real = v_ext > c
    # pre[b, x] = the real step of element b targeting column x
    pre = torch.full((B, ncols + 1), -1, dtype=torch.long, device=dev)
    pre = pre.scatter_reduce(1, torch.where(real, v_ext, ncols),
                             c.expand(B, -1), "amax")[:, :ncols]
    f = torch.where(pre >= 0, pre, c)
    for _ in range(_doubling_steps(ncols)):
        f = f.gather(1, f)
    pathid = f
    node_row = (c - 1).clamp(0, nrows - 1)
    node_val = torch.where(c >= 1, c, _SENTINEL).to(torch.int32)
    bits = unpack_bits(data, torch.uint8)[:, :, :ncols]
    chunk = max(1, min(nrows, _TRANS_TRI_CHUNK_ELEMS // (B * ncols)))
    carry = torch.full((B, ncols), _SENTINEL, dtype=torch.int32, device=dev)
    out = torch.empty((B, nrows, ncols), dtype=torch.uint8, device=dev)
    c32 = c.to(torch.int32)
    boff = torch.arange(B, device=dev)[:, None]
    for r1 in reversed(range(0, nrows, chunk)):
        rows = min(chunk, nrows - r1)
        local = node_row - r1
        ok = (local >= 0) & (local < rows)
        # the nodes outside the chunk land in one slot past the end
        dump = B * rows * ncols
        flat = torch.where(ok, (boff * rows + local) * ncols + pathid, dump)
        A = torch.full((dump + 1,), _SENTINEL, dtype=torch.int32, device=dev)
        A = A.scatter_reduce(0, flat.reshape(-1),
                             node_val.expand(B, -1).reshape(-1), "amin")
        A = A[:dump].view(B, rows, ncols).flip(1).cummin(dim=1).values.flip(1)
        A = torch.minimum(A, carry[:, None])
        carry = A[:, 0]
        sel = torch.minimum(A.gather(2, pathid[:, None].expand(-1, rows, -1)),
                            c32)
        del A
        ridx = torch.arange(r1, r1 + rows, device=dev)[:, None]
        src = torch.where(real[:, None] & (ridx < c), v_ext[:, None], sel)
        out[:, r1:r1 + rows] = torch.gather(bits[:, r1:r1 + rows], 2, src)
    packed = pack_bits(out)[:, :, :w]
    return packed & padding_words(ncols, dev)

"""(Reduced) row echelon form, rank, inversion.

Reference analogue: brilliantrussian.c `_mzd_echelonize_m4ri` (Gray-code
M4RI elimination) and echelonform.c dispatch.  The engine reuses the panel
factorization of models/ple.py (same canonical pivot order, so the echelon
form matches the reference bit for bit — RREF is unique over GF(2) anyway)
and computes:

- REF directly from the factorization (rows 0..r-1 are the echelon rows);
- RREF as ``(U restricted to pivot columns)^{-1} @ U`` — one triangular
  solve (models/triangular.py) instead of the reference's sequential
  table-driven upward elimination;
- inversion as the right half of RREF([A | I]) (reference: mzd_inv_m4ri =
  RREF of [A|I], brilliantrussian.c:971-997).

The rank is a Python int (the factorization reads it back once a panel);
where the JAX package masks by a traced rank, this module slices.
"""

from __future__ import annotations

import torch

from ..core.bitmatrix import (BitMatrix, concat, density, identity,
                              mask_padding, submatrix, width_for)
from ..core.transpose import transpose
from ..utils.config import WORD_BITS, get_config
from .ple import block_factor
from .triangular import trsm_upper_left

__all__ = ["echelonize", "echelonize_pluq", "top_echelonize", "rank",
           "invert", "invert_naive", "echelonize_naive", "gauss_delayed"]


def _pivot_rows(q: torch.Tensor, r: int, rmax: int) -> torch.Tensor:
    """int64[rmax]: Q[k] for k < r, k for k >= r."""
    k = torch.arange(rmax, device=q.device)
    r = min(r, rmax)
    return torch.cat([q[:r].long(), k[r:]])


def _pivot_selection(q: torch.Tensor, r: int, n: int, rmax: int):
    """Packed selection matrix S (n x rmax) with S[Q[k], k] = 1 for k < r
    and S[k, k] = 1 for k >= r, so that REF @ S extracts the pivot columns
    as a GF(2) product (the form a distributed product can take)."""
    rows = _pivot_rows(q, r, rmax)
    k = torch.arange(rmax, device=q.device)
    out = torch.zeros((n, width_for(rmax)), dtype=torch.int32, device=q.device)
    # written packed; a row may take two bits (Q[k] = k' for a k' >= r),
    # in different places, so their sum is their OR
    out.index_put_((rows, k // WORD_BITS),
                   torch.ones_like(k, dtype=torch.int32)
                   << (k % WORD_BITS).to(torch.int32),
                   accumulate=True)
    return out


def select_pivot_cols(data: torch.Tensor, q: torch.Tensor, r: int, m: int,
                      n: int, rmax: int) -> torch.Tensor:
    """out[:, k] = data[:, Q[k]] for k < r, data[:, k] for k >= r — the
    same contraction as ``data @ _pivot_selection(...)`` computed as
    transpose -> packed-row gather -> transpose: O(m n / 32) word moves
    instead of an O(m n rmax) product."""
    dt = transpose(BitMatrix(data[:, : width_for(n)], n))    # (n, w(m))
    g = dt.data[_pivot_rows(q, r, rmax)]                    # (rmax, w(m))
    return transpose(BitMatrix(g, m)).data                  # (m, w(rmax))


def _rref_from_ref(data: torch.Tensor, q: torch.Tensor, r: int, m: int,
                   n: int) -> torch.Tensor:
    """Top rows of REF -> RREF rows via U_rr^{-1} @ U.

    U_rr = REF[:, pivot columns] via the packed transpose-gather
    (select_pivot_cols).  Rows r.. of the top block are zero, so U_rr gets a
    unit diagonal there."""
    rmax = min(m, n)
    top = data[:rmax]
    urr = select_pivot_cols(top, q, r, rmax, n, rmax)   # (rmax, rmax) upper tri
    urr[r:] |= identity(rmax, device=data.device).data[r:]
    x = trsm_upper_left(BitMatrix(urr, rmax), BitMatrix(top, n))
    out = x.data
    if m > rmax:
        out = torch.cat([out, out.new_zeros((m - rmax, width_for(n)))])
    return out


def echelonize(a: BitMatrix, full: bool = True, nb: int | None = None,
               strategy: str = "m4ri"):
    """Row echelon form (reference API: mzd_echelonize, echelonform.c:30;
    full=True gives the reduced form).  Returns (matrix, rank).

    ``strategy``: "m4ri" (direct factorization), "pluq" (reconstruct from the
    PLE factors, echelonform.c:38-137), or "heuristic" — measure the density
    and take the pluq path from ``Config.echelon_density_crossover`` up
    (echelonform.h:37).  All paths give identical results (RREF is unique
    and both use the canonical pivot order)."""
    if strategy == "heuristic":
        d = float(density(a))
        strategy = "pluq" if d >= get_config().echelon_density_crossover \
            else "m4ri"
    if strategy == "pluq":
        return echelonize_pluq(a, full=full, nb=nb)
    return _echelonize_m4ri(a, full, nb)


def _echelonize_m4ri(a: BitMatrix, full: bool = True, nb: int | None = None):
    data, _, q, r = block_factor(a, preserve_l=False, nb=nb)
    if not full:
        return mask_padding(BitMatrix(data, a.ncols)), r
    out = _rref_from_ref(data, q, r, a.nrows, a.ncols)
    return mask_padding(BitMatrix(out, a.ncols)), r


def echelonize_pluq(a: BitMatrix, full: bool = True, nb: int | None = None):
    """(R)REF reconstructed from the PLE factorization (reference API:
    mzd_echelonize_pluq, echelonform.c:38-137): factor with L preserved in
    the pivot columns, then clear the L bits from the echelon rows."""
    m, n = a.nrows, a.ncols
    data, _, q, r = block_factor(a, preserve_l=True, nb=nb)
    return _pluq_echelon_post(data, q, r, m, n, full)


def _pluq_echelon_post(data: torch.Tensor, q: torch.Tensor, r: int, m: int,
                       n: int, full: bool):
    rmax = min(m, n)
    dev = data.device
    # clear the L bits: entry (i, Q[k]) with k < i is an L multiplier, so
    # row i drops the pivot columns of the rows above it (rows r.. hold only
    # L bits and end up zero).  The pivot columns are distinct, so the
    # packed one-hot rows sum without carries: an exclusive running sum
    # over the rows is the mask to clear, in int64 words of 32 bits.
    qk = q[:r].long()
    onehot = torch.zeros((rmax, width_for(n)), dtype=torch.long, device=dev)
    onehot[torch.arange(r, device=dev), qk // WORD_BITS] = \
        torch.ones_like(qk) << (qk % WORD_BITS)
    clear = onehot.cumsum(dim=0) - onehot
    clear = torch.where(clear >= 2**31, clear - 2**32, clear).to(torch.int32)
    top = data[:rmax] & ~clear
    if m > rmax:
        top = torch.cat([top, top.new_zeros((m - rmax, top.shape[1]))])
    if not full:
        return mask_padding(BitMatrix(top, n)), r
    out = _rref_from_ref(top, q, r, m, n)
    return mask_padding(BitMatrix(out, n)), r


def top_echelonize(a: BitMatrix, k: int = 0, nb: int | None = None):
    """RREF variant whose pivot search is restricted to the next 6k rows
    below the current rank (reference API: mzd_top_echelonize_m4ri,
    brilliantrussian.c:846-969 — no deep row swaps).  Returns (matrix, rank).

    Contract (brilliantrussian.h:229-232): the input is already in
    upper-triangular (echelon) form, in which case the window always
    suffices and the result is bit-identical to the reference.  On
    non-echelon inputs whose pivots sit beyond the window, the reference's
    output is incidental; this recast keeps eliminating below the window
    instead, so it finds at least as many pivots (as the JAX package)."""
    from ..utils.graycode import opt_k
    if k <= 0:
        k = min(opt_k(a.nrows, a.ncols), 7)
    data, _, q, r = block_factor(a, preserve_l=False, nb=nb,
                                 search_window=6 * k)
    out = _rref_from_ref(data, q, r, a.nrows, a.ncols)
    return mask_padding(BitMatrix(out, a.ncols)), r


def echelonize_with_pivots(a: BitMatrix, nb: int | None = None):
    """RREF plus pivot-column swap array (used by kernel computation)."""
    data, _, q, r = block_factor(a, preserve_l=False, nb=nb)
    out = _rref_from_ref(data, q, r, a.nrows, a.ncols)
    return mask_padding(BitMatrix(out, a.ncols)), q, r


def rank(a: BitMatrix, nb: int | None = None) -> int:
    """Rank of ``a``: the number of pivots of the panel factorization
    (reference: the return value of mzd_echelonize, echelonform.c:26)."""
    _, _, _, r = block_factor(a, preserve_l=False, nb=nb)
    return r


def invert(a: BitMatrix, nb: int | None = None):
    """A^{-1} via RREF of [A | I] (reference: mzd_inv_m4ri).  Returns
    (inverse, rank), the rank a Python int; the inverse is valid iff
    rank == n."""
    n = a.ncols
    assert a.nrows == n, "inversion requires a square matrix"
    aug = concat(a, identity(n, device=a.device))
    data, _, q, r = block_factor(aug, preserve_l=False, nb=nb)
    return _invert_post(data, q, r, n)


def _invert_post(data: torch.Tensor, q: torch.Tensor, r: int, n: int):
    rref = mask_padding(BitMatrix(_rref_from_ref(data, q, r, n, 2 * n), 2 * n))
    # rank of A itself = pivots that fall in the left block (the pivot
    # columns increase, so they are the first ones)
    r_a = int((q[:r] < n).sum())
    return submatrix(rref, 0, n, n, 2 * n), r_a


def naive_sweep(data: torch.Tensor, m: int, n: int, full: bool,
                start_col: int = 0):
    """The naive engine's column steps over a leading batch axis: ``data``
    int32 [B, m, w(n)] -> (data, r int32 [B]), both on the device.  One
    step a column from ``start_col``: each element takes its first row at or
    below its rank with a 1 there, swaps it up to the rank's row and clears
    the column in the rows below (every other row with ``full``).  The swap
    is a gather, so no write depends on an element's pivot; nothing is read
    back."""
    dev = data.device
    B, W = data.shape[0], data.shape[2]
    ridx = torch.arange(m, device=dev)[None, :]
    r = torch.zeros(B, dtype=torch.int32, device=dev)
    for c in range(start_col, n):
        w, s = divmod(c, WORD_BITS)
        col = (data[:, :, w] >> s) & 1                      # [B, m]
        active = (col == 1) & (ridx >= r[:, None])
        found = active.any(dim=1)
        rs = r.clamp(max=m - 1).long()[:, None]
        ps = torch.where(found[:, None],
                         torch.argmax(active.to(torch.uint8), dim=1,
                                      keepdim=True), rs)
        swap = torch.where(ridx == rs, ps, torch.where(ridx == ps, rs, ridx))
        data = data.gather(1, swap[:, :, None].expand(-1, -1, W))
        col = col.gather(1, swap)
        pivrow = data.gather(1, rs[:, :, None].expand(-1, -1, W))
        below = (ridx != rs) if full else (ridx > rs)
        elim = (col == 1) & below & found[:, None]
        data = data ^ (elim.to(torch.int32)[:, :, None] * pivrow)
        r = r + found.to(torch.int32)
    return data, r


def echelonize_naive(a: BitMatrix, full: bool = True, start_col: int = 0):
    """Straightforward Gauss elimination, one pivot a column step — an
    engine-independent cross-validation path (reference API:
    mzd_echelonize_naive, and with start_col > 0, mzd_gauss_delayed).
    Returns (matrix, rank).  ``naive_sweep`` on a batch of one: the rank
    stays on the device through the column steps and is read back once at
    the end."""
    data, r = naive_sweep(a.data[None], a.nrows, a.ncols, full, start_col)
    return mask_padding(BitMatrix(data[0], a.ncols)), int(r[0])


def gauss_delayed(a: BitMatrix, start_col: int = 0, full: bool = False):
    """Gauss elimination starting at a column (reference API:
    mzd_gauss_delayed, mzd.c)."""
    return echelonize_naive(a, full=full, start_col=start_col)


def invert_naive(a: BitMatrix):
    """Inversion through the one-pivot-a-step naive Gauss engine — the
    independent cross-check path the reference's test_invert.c uses
    (reference API: mzd_invert_naive, mzd.c / mzd.h).  Returns
    (inverse, ok): ok is a 0-dim bool tensor on the matrix's device, False
    iff A is singular (the reference returns NULL then)."""
    n = a.ncols
    assert a.nrows == n, "inversion requires a square matrix"
    eye = identity(n, device=a.device)
    red, _ = echelonize_naive(concat(a, eye), full=True)
    ok = torch.all(submatrix(red, 0, 0, n, n).data == eye.data)
    return submatrix(red, 0, n, n, 2 * n), ok

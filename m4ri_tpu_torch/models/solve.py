"""Linear system solving and kernel (nullspace) computation.

Reference analogue: solve.c — mzd_solve_left (PLUQ, then P-apply, TRSM
lower, consistency check, TRSM upper, Q^T-apply; solve.c:30-152) and
mzd_kernel_left_pluq (solve.c:154-191).

The rank is a Python int, so where the JAX package masks by a traced rank
this module slices: free variables are zero and rows r.. of the forward
solve are the consistency residual.  Everything stays packed: one
pivot-column selection (echelon.select_pivot_cols) feeds both L and U
restricted to its pivot columns, masked with word-level row masks; the U
back-solve is an rmax x rmax system in pivot-slot space whose solution rows
scatter to the pivot columns.  No m x m or n x n unpacked intermediate is
made (the reference solve.c:55-120 likewise works in place).
"""

from __future__ import annotations

import torch

from ..core.bitmatrix import BitMatrix, identity, mask_padding, width_for
from ..core.bitmatrix import keep_below as _keep_below
from ..core.permutation import apply_p_left
from ..ops.mul import pack_bits
from .echelon import echelonize_with_pivots, select_pivot_cols
from .ple import block_factor
from .triangular import trsm_lower_left, trsm_upper_left

__all__ = ["solve_left", "kernel_left", "pluq_solve_left"]


def _pad_words(data: torch.Tensor, nwords: int) -> torch.Tensor:
    """The first ``nwords`` words of each row, zero-padded (leading axes
    pass through)."""
    if data.shape[-1] < nwords:
        return torch.nn.functional.pad(data, (0, nwords - data.shape[-1]))
    return data[..., :nwords]


def _packed_l(data: torch.Tensor, q: torch.Tensor, r: int, m: int, rmax: int,
              n: int, from_pivot_cols: bool, lcols=None) -> BitMatrix:
    """Unit lower-triangular m x m L, packed, from the in-place factor.

    from_pivot_cols: gather L[:, k] from column Q[k] (PLE layout); else L
    already sits in columns 0..rmax (PLUQ).  ``lcols`` lets the caller pass
    a precomputed selection."""
    if from_pivot_cols:
        if lcols is None:
            lcols = select_pivot_cols(data, q, r, m, n, rmax)   # (m, w_rmax)
    else:
        lcols = _pad_words(data, width_for(rmax))
    iidx = torch.arange(m, device=data.device)
    lcols = lcols & _keep_below(iidx.clamp(max=r), lcols.shape[1])
    return BitMatrix(_pad_words(lcols, width_for(m))
                     | identity(m, device=data.device).data, m)


def _packed_upiv(top: torch.Tensor, q: torch.Tensor, r: int, rmax: int,
                 n: int, from_pivot_cols: bool, upiv=None) -> BitMatrix:
    """U restricted to its pivot columns, in slot space: rmax x rmax unit
    upper triangular (identity beyond the rank), packed.  Junk below the
    diagonal (the in-place L multipliers) is masked by the TRSM entry
    point itself (triangular._clean_tri)."""
    if from_pivot_cols:
        if upiv is None:
            upiv = select_pivot_cols(top, q, r, rmax, n, rmax)   # (rmax, w_rmax)
    else:
        upiv = _pad_words(top, width_for(rmax))
    upiv = upiv.clone()
    upiv[r:] |= identity(rmax, device=top.device).data[r:]
    return BitMatrix(upiv, rmax)


def _solve_from_factors(data: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
                        r: int, b: BitMatrix, m: int, n: int,
                        from_pivot_cols: bool):
    rmax = min(m, n)
    if from_pivot_cols:
        # one pivot-column selection feeds both L (rows masked strictly
        # below the slot diagonal) and U_piv (its top rmax rows)
        sel = select_pivot_cols(data, q, r, m, n, rmax)
        lsrc, usrc = sel, sel[:rmax]
    else:
        lsrc = usrc = None

    lfull = _packed_l(data, q, r, m, rmax, n, from_pivot_cols, lcols=lsrc)
    y = trsm_lower_left(lfull, apply_p_left(b, p))
    consistent = torch.all(y.data[r:] == 0)

    upiv = _packed_upiv(data[:rmax], q, r, rmax, n, from_pivot_cols,
                        upiv=usrc)
    ydata = y.data[:rmax].clone()
    ydata[r:] = 0
    z = trsm_upper_left(upiv, BitMatrix(ydata, b.ncols))

    # x[Q[k]] = z[k] for k < r, all other entries zero (free vars = 0).
    # Q[k] is slot k's pivot column; the pivot columns increase, so the
    # scatter equals the reference's mzd_apply_p_right_trans replay of the
    # swap array (solve.c:117).
    x = torch.zeros((n, width_for(b.ncols)), dtype=torch.int32,
                    device=data.device)
    x[q[:r].long()] = z.data[:r]
    return mask_padding(BitMatrix(x, b.ncols)), consistent


def solve_left(a: BitMatrix, b: BitMatrix, nb: int | None = None):
    """Solve A X = B (reference API: mzd_solve_left, solve.c:30).

    Returns (X, consistent): X is ncols(A) x ncols(B) with free variables
    zero; ``consistent`` is a 0-dim bool tensor on the matrix's device (no
    read-back) — when False the system has no solution and X is
    meaningless (the reference returns -1)."""
    m, n = a.nrows, a.ncols
    assert b.nrows == m
    data, p, q, r = block_factor(a, preserve_l=True, nb=nb)
    return _solve_from_factors(data, p, q, r, b, m, n, from_pivot_cols=True)


def pluq_solve_left(m: BitMatrix, p: torch.Tensor, q: torch.Tensor, r: int,
                    b: BitMatrix):
    """Solve A X = B given an existing PLUQ factorization of A (reference
    API: mzd_pluq_solve_left, solve.c:55-120): M holds L strictly below the
    diagonal and U on/above it, with P/Q the swap arrays and r the rank."""
    return _solve_from_factors(m.data, p, q, int(r), b, m.nrows, m.ncols,
                               from_pivot_cols=False)


def kernel_left(a: BitMatrix, nb: int | None = None):
    """Basis X of the right kernel {x : A x = 0} (reference API:
    mzd_kernel_left_pluq, solve.c:154).

    Returns (X, count): X is n x n whose first columns in *column index
    order* are nonzero exactly at the n-r free columns (pivot columns of X
    are zero); count = n - r, a Python int.  A X == 0 always holds."""
    rref, q, r = echelonize_with_pivots(a, nb=nb)
    return _kernel_post(rref.data, q, r, a.nrows, a.ncols)


def _kernel_post(refdata: torch.Tensor, q: torch.Tensor, r: int, m: int,
                 n: int):
    dev = refdata.device
    w = width_for(n)
    piv = q[:r].long()
    ispivot = torch.zeros(n, dtype=torch.bool, device=dev)
    ispivot[piv] = True
    # pivot rows go to row Q[k]; the free columns get a diagonal 1
    xpack = torch.zeros((n, w), dtype=torch.int32, device=dev)
    xpack[piv] = refdata[:r, :w]
    xpack |= identity(n, device=dev).data * (~ispivot).to(torch.int32)[:, None]
    # zero the pivot columns entirely (a packed column mask)
    xpack &= ~pack_bits(ispivot[None, :].to(torch.int32))
    return mask_padding(BitMatrix(xpack, n)), n - r

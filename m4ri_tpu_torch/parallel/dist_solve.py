"""Distributed TRSM / TRTRI / solve over a device mesh.

Reference analogue: triangular.c + solve.c, which have no multi-processor
story.  The structure is the single-device modules' (so the results are the
same words), with the JAX package's design:

- TRTRI keeps the 2x2 word-aligned recursion of models/triangular._trtri,
  but every block product is a SUMMA mesh product (dist_mul.mul_dist).
- The TRSM variants are the single-device recursion with mesh products.
- solve_left follows models/solve.py step for step: the distributed
  canonical PLE (dist_ple.dist_block_factor), the packed pivot-column
  selection and the two triangular solves as mesh products, and the scatter
  of the solution rows to the pivot columns.
"""

from __future__ import annotations

import functools

import torch

from ..core.bitmatrix import BitMatrix, concat, identity, mask_padding, width_for
from ..core.permutation import apply_p_left
from ..models.echelon import _invert_post, _pivot_selection, _rref_from_ref
from ..models.solve import _keep_below, _kernel_post, _pad_words
from ..models.triangular import (_clean_tri, _trsm_left_rec, _trsm_right_rec,
                                 _trtri)
from .dist_mul import mul_dist
from .dist_ple import dist_block_factor

__all__ = ["dist_trtri_upper", "dist_trtri_lower", "dist_trsm_upper_left",
           "dist_trsm_lower_left", "dist_trsm_upper_right",
           "dist_trsm_lower_right", "dist_solve_left", "dist_invert",
           "dist_kernel_left"]


def _mesh_mul(mesh):
    return functools.partial(mul_dist, mesh=mesh)


def dist_trtri_upper(t: BitMatrix, mesh) -> BitMatrix:
    return _trtri(_clean_tri(t, True), True, _mesh_mul(mesh))


def dist_trtri_lower(t: BitMatrix, mesh) -> BitMatrix:
    return _trtri(_clean_tri(t, False), False, _mesh_mul(mesh))


def dist_trsm_upper_left(u: BitMatrix, b: BitMatrix, mesh) -> BitMatrix:
    assert u.nrows == u.ncols == b.nrows
    return _trsm_left_rec(_clean_tri(u, True), b, True, _mesh_mul(mesh))


def dist_trsm_lower_left(l: BitMatrix, b: BitMatrix, mesh) -> BitMatrix:
    assert l.nrows == l.ncols == b.nrows
    return _trsm_left_rec(_clean_tri(l, False), b, False, _mesh_mul(mesh))


def dist_trsm_upper_right(u: BitMatrix, b: BitMatrix, mesh) -> BitMatrix:
    assert u.nrows == u.ncols == b.ncols
    return _trsm_right_rec(_clean_tri(u, True), b, True, _mesh_mul(mesh))


def dist_trsm_lower_right(l: BitMatrix, b: BitMatrix, mesh) -> BitMatrix:
    assert l.nrows == l.ncols == b.ncols
    return _trsm_right_rec(_clean_tri(l, False), b, False, _mesh_mul(mesh))


def dist_solve_left(a: BitMatrix, b: BitMatrix, mesh, nb: int = 128,
                    window: int | None = None):
    """Solve A X = B over the mesh; the same as models/solve.solve_left (the
    same canonical factorization, the same free-variable convention).
    Returns (X, consistent), ``consistent`` a 0-dim bool tensor."""
    m, n = a.nrows, a.ncols
    assert b.nrows == m
    rmax = min(m, n)
    dev = a.device
    data, p, q, r = dist_block_factor(a, mesh, preserve_l=True, nb=nb,
                                      window=window)

    # packed unit-lower L through the selection product (a mesh product)
    s = BitMatrix(_pivot_selection(q, r, n, rmax), rmax)
    lcols = mul_dist(BitMatrix(data, n), s, mesh).data
    iidx = torch.arange(m, device=dev)
    lcols &= _keep_below(iidx.clamp(max=r), lcols.shape[1])
    lfull = BitMatrix(_pad_words(lcols, width_for(m))
                      | identity(m, device=dev).data, m)

    y = dist_trsm_lower_left(lfull, apply_p_left(b, p), mesh)
    consistent = torch.all(y.data[r:] == 0)

    # U restricted to its pivot columns, in slot space (rmax x rmax)
    upiv = mul_dist(BitMatrix(data[:rmax], n), s, mesh).data
    upiv[r:] |= identity(rmax, device=dev).data[r:]
    ydata = y.data[:rmax].clone()
    ydata[r:] = 0
    z = dist_trsm_upper_left(BitMatrix(upiv, rmax),
                             BitMatrix(ydata, b.ncols), mesh)

    x = torch.zeros((n, width_for(b.ncols)), dtype=torch.int32, device=dev)
    x[q[:r].long()] = z.data[:r]
    return mask_padding(BitMatrix(x, b.ncols)), consistent


def dist_invert(a: BitMatrix, mesh, nb: int = 128, window: int | None = None):
    """A^{-1} over the mesh via RREF of [A | I] (reference: mzd_inv_m4ri).
    Returns (inverse, rank); valid iff rank == n.  The same as
    models/echelon.invert: the mesh factorization is canonical and the RREF
    post-pass is the same replicated program."""
    n = a.ncols
    assert a.nrows == n, "inversion requires a square matrix"
    aug = concat(a, identity(n, device=a.device))
    data, _, q, r = dist_block_factor(aug, mesh, preserve_l=False, nb=nb,
                                      window=window)
    return _invert_post(data, q, r, n)


def dist_kernel_left(a: BitMatrix, mesh, nb: int = 128,
                     window: int | None = None):
    """Right-kernel basis over the mesh (reference: mzd_kernel_left_pluq).
    Returns (X, count) with the convention of models/solve.kernel_left (the
    same canonical factorization and the same post-pass)."""
    data, _, q, r = dist_block_factor(a, mesh, preserve_l=False, nb=nb,
                                      window=window)
    out = _rref_from_ref(data, q, r, a.nrows, a.ncols)
    return _kernel_post(out, q, r, a.nrows, a.ncols)

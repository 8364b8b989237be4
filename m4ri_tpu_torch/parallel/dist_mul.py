"""Distributed GF(2) multiplication over a device mesh.

Reference analogue: mzd_mul_mp (mp.c:39-160), a 2x2 OpenMP block split, the
reference's whole multi-processor story.  The same block decomposition runs
on an (R x C) mesh of ranks (parallel/mesh.py):

- ``mul_dist``: one-shot SUMMA.  Each rank all-gathers its A row panel along
  "y" and its B column panel along "x", and multiplies them locally (on the
  card through the GF(2) GEMM kernels of ops/mul.py); its C block is then
  gathered back along both axes.
- ``mul_dist_ksplit``: depth-sharded.  Each rank multiplies a k-slab and the
  packed partial parities are XOR-reduced along "x" (parity(a+b) =
  parity(a) ^ parity(b)).

Every block is word aligned and padded to the mesh shape; the padding is
zero and therefore exact over GF(2).  Every rank passes the same global
matrices and gets the whole product back.
"""

from __future__ import annotations

import torch

from ..core.bitmatrix import BitMatrix, width_for
from ..ops.mul import mul_packed_data
from ..utils.config import WORD_BITS
from .mesh import (all_gather, axis_index, axis_size,
                   xor_allgather_reduce)

__all__ = ["mul_dist", "mul_dist_ksplit"]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _pad2(data: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return torch.nn.functional.pad(
        data, (0, cols - data.shape[1], 0, rows - data.shape[0]))


def _block(data: torch.Tensor, i: int, j: int, rows: int, cols: int):
    """Block (i, j) of a matrix cut into rows x cols blocks."""
    return data[i * rows:(i + 1) * rows, j * cols:(j + 1) * cols]


def mul_dist(a: BitMatrix, b: BitMatrix, mesh) -> BitMatrix:
    """C = A*B with A, B, C block-sharded over a 2-D mesh (SUMMA
    all-gather)."""
    assert a.ncols == b.nrows
    rx, ry = axis_size(mesh, "x"), axis_size(mesh, "y")
    xi, yi = axis_index(mesh, "x"), axis_index(mesh, "y")
    m = _round_up(a.nrows, rx)
    kw = _round_up(a.width, ry)
    k = _round_up(b.nrows, rx * WORD_BITS)
    kw = _round_up(max(kw, width_for(k)), ry)
    nw = _round_up(b.width, ry)

    a_blk = _block(_pad2(a.data, m, kw), xi, yi, m // rx, kw // ry)
    b_blk = _block(_pad2(b.data, k, nw), xi, yi, k // rx, nw // ry)
    c_blk = _summa(a_blk, b_blk, mesh)
    c = all_gather(all_gather(c_blk, mesh, "y", dim=1), mesh, "x", dim=0)
    return BitMatrix(c[: a.nrows, : b.width].contiguous(), b.ncols)


def _summa(a_blk: torch.Tensor, b_blk: torch.Tensor, mesh) -> torch.Tensor:
    """The per-rank body: this rank's C block from its A and B blocks."""
    a_row = all_gather(a_blk, mesh, "y", dim=1)       # (m/rx, kw)
    b_col = all_gather(b_blk, mesh, "x", dim=0)       # (k, nw/ry)
    return mul_packed_data(a_row, b_col)


def mul_dist_ksplit(a: BitMatrix, b: BitMatrix, mesh) -> BitMatrix:
    """C = A*B with the contraction dimension sharded along "x" and the
    packed partial parities XOR-reduced (depth-parallel variant)."""
    assert a.ncols == b.nrows
    rx, ry = axis_size(mesh, "x"), axis_size(mesh, "y")
    xi, yi = axis_index(mesh, "x"), axis_index(mesh, "y")
    kw = _round_up(width_for(_round_up(b.nrows, rx * WORD_BITS)), rx)
    k = kw * WORD_BITS
    m = a.nrows
    nw = _round_up(b.width, ry)

    a_blk = _block(_pad2(a.data, m, kw), 0, xi, m, kw // rx)
    b_blk = _block(_pad2(b.data, k, nw), xi, yi, k // rx, nw // ry)
    c = all_gather(_ksplit(a_blk, b_blk, mesh), mesh, "y", dim=1)
    return BitMatrix(c[:m, : b.width].contiguous(), b.ncols)


def _ksplit(a_blk: torch.Tensor, b_blk: torch.Tensor, mesh) -> torch.Tensor:
    """The per-rank body: the partial product of this rank's k-slab,
    XOR-reduced along "x"."""
    return xor_allgather_reduce(mul_packed_data(a_blk, b_blk), mesh, "x")

"""DJB "optimizing linear maps mod 2" (reference analogue: djb.[ch], a port
of Bernstein's sort1.cpp — http://binary.cr.yp.to/linearmod2.html).

``djb_compile(A)`` turns a fixed m x n GF(2) matrix into a straight-line
XOR program with heuristically (m*n)/(log m - loglog m) operations;
``djb_apply`` evaluates W = A*V for a batch of input vectors, the columns
of V.

Compilation (as the reference, djb.c:110-140): keep the output rows in a
max-heap ordered by reverse-lexicographic row value; walk columns from the
highest down; when the largest row has a 1 in the current column, either
cancel it against the second-largest row (recording "target ^= target'"),
or clear the bit (recording "target ^= input[col]").  It runs on the host,
as the reference's does, and yields the JAX package's program exactly: a
row is held as one Python int with word j at bits 32j..32j+31, so the
reverse-lexicographic order of unsigned words is the order of the ints
(the port's int32 words, compared as they are, would order a row with bit
31 set below one without it and change the program).

Application replays the program in reverse on V's device, in runs of
instructions whose output sources no instruction of the run targets, so
that the order within a run does not matter.  Torch has no XOR scatter and
a run may hit one target several times, so W is kept as unpacked int32 bit
counts: a run gathers its source rows (the parity, ``& 1``, of a W row) and
``index_add_``s them into its targets; the parity of the counts is W.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.bitmatrix import BitMatrix
from ..ops.mul import pack_bits, unpack_bits
from ..utils.config import WORD_BITS

__all__ = ["DjbProgram", "SOURCE_INPUT", "SOURCE_OUTPUT", "djb_compile",
           "djb_apply"]

SOURCE_INPUT = 0   # reference: source_source (reads the input vector)
SOURCE_OUTPUT = 1  # reference: source_target (reads another output row)


@dataclasses.dataclass
class DjbProgram:
    nrows: int
    ncols: int
    target: list
    source: list
    srctyp: list

    @property
    def length(self) -> int:
        return len(self.target)


class _LiveHeap:
    """Max-heap of row indices compared against the *current* row values
    (the reference heap does the same: invariants are restored at push/pop
    after each mutation).  The sift steps are the JAX package's, with
    ``>=`` on the row ints in place of its word-by-word comparison."""

    def __init__(self, rows: list[int]):
        self.rows = rows
        self.data: list[int] = []

    def push(self, value: int) -> None:
        d, rows = self.data, self.rows
        d.append(value)
        i = len(d) - 1
        while i:
            parent = (i - 1) >> 1
            if rows[d[parent]] >= rows[value]:
                break
            d[i] = d[parent]
            i = parent
        d[i] = value

    def front(self) -> int:
        return self.data[0]

    def pop(self) -> int:
        d, rows = self.data, self.rows
        top = d[0]
        temp = d.pop()
        if not d:
            return top
        i = 0
        while True:
            swap = 2 * i + 1
            if swap >= len(d):
                break
            other = swap + 1
            if other < len(d) and rows[d[other]] >= rows[d[swap]]:
                swap = other
            if rows[temp] >= rows[d[swap]]:
                break
            d[i] = d[swap]
            i = swap
        d[i] = temp
        return top


def _row_ints(a: BitMatrix) -> list[int]:
    words = np.ascontiguousarray(a.data.detach().cpu().numpy()).view(np.uint32)
    return [int.from_bytes(row.astype("<u4").tobytes(), "little")
            for row in words]


def djb_compile(a: BitMatrix) -> DjbProgram:
    """The XOR program of A (reference API: djb_compile, djb.c:110)."""
    rows = _row_ints(a)
    m, n = a.nrows, a.ncols
    prog = DjbProgram(m, n, [], [], [])
    heap = _LiveHeap(rows)
    for i in range(m):
        heap.push(i)
    while n > 0:
        bit = 1 << (n - 1)
        if not rows[heap.front()] & bit:
            n -= 1
            continue
        temp = heap.pop()
        if m >= 2 and heap.data and rows[heap.front()] & bit:
            # cancel against the second-largest row:
            # row[temp] ^= row[front]  (mzd_row_add(A, front, temp))
            rows[temp] ^= rows[heap.front()]
            prog.target.append(temp)
            prog.source.append(heap.front())
            prog.srctyp.append(SOURCE_OUTPUT)
        else:
            rows[temp] &= ~bit
            prog.target.append(temp)
            prog.source.append(n - 1)
            prog.srctyp.append(SOURCE_INPUT)
        heap.push(temp)
    return prog


def _runs(prog: DjbProgram):
    """The replay order, in runs: (target, source, input?) arrays in the
    order instructions run, and [(start, mid, end)] per run, with the
    input-sourced instructions at [start, mid) and the output-sourced ones
    at [mid, end).  A run is the JAX package's batch: instructions from the
    end of the program down, until one reads an output row that an earlier
    instruction of the run targets."""
    tg = np.asarray(prog.target, np.int64)
    src = np.asarray(prog.source, np.int64)
    inp = np.asarray(prog.srctyp, np.int64) == SOURCE_INPUT
    order, runs = [], []
    i = prog.length - 1
    while i >= 0:
        touched = set()
        j = i
        while j >= 0:
            if not inp[j] and src[j] in touched:
                break
            touched.add(int(tg[j]))
            j -= 1
        run = np.arange(j + 1, i + 1)
        first = run[inp[run]]
        start = len(order)
        order.extend(first.tolist())
        order.extend(run[~inp[run]].tolist())
        runs.append((start, start + len(first), len(order)))
        i = j
    order = np.asarray(order, np.int64)
    return tg[order], src[order], runs


def djb_apply(prog: DjbProgram, v: BitMatrix) -> BitMatrix:
    """W = A * V by replaying the program in reverse (djb.c:142-153), on
    V's device.  V has ncols(A) rows; W gets nrows(A) rows."""
    assert v.nrows == prog.ncols
    dev = v.device
    tg, src, runs = _runs(prog)
    tg = torch.from_numpy(tg).to(dev)
    src = torch.from_numpy(src).to(dev)
    vu = unpack_bits(v.data, torch.int32)
    counts = torch.zeros((prog.nrows, v.width * WORD_BITS), dtype=torch.int32,
                         device=dev)
    for start, mid, end in runs:
        # the output rows a run reads are not targets of the run: read
        # them before it adds anything
        if end > mid:
            from_w = counts.index_select(0, src[mid:end]) & 1
        if mid > start:
            counts.index_add_(0, tg[start:mid], vu.index_select(0, src[start:mid]))
        if end > mid:
            counts.index_add_(0, tg[mid:end], from_w)
    return BitMatrix(pack_bits(counts & 1), v.ncols)

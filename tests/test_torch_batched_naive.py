"""The naive Gauss engines of the PyTorch/CUDA port over a batch
(``echelonize_naive_batched``, ``gauss_delayed_batched`` and
``invert_naive_batched`` in models/batched_solve.py) against ``jax.vmap`` of
the JAX package's ``echelonize_naive``, ``gauss_delayed`` and
``invert_naive`` on the same numpy inputs, on the CPU, and element by
element against the port's single-matrix calls.  Shapes: taller than wide,
wider than tall, one row, a batch of one; every batch holds a zero element
and a rank-deficient one, and bit 31 of every word is set in a dense one.
The inversions take an invertible, a singular, the zero and the identity
matrix.  Nothing is read back from the device (``Waits`` counts 0).
Equality of packed words, ranks and flags: tolerance 0."""

import numpy as np
import pytest
import torch

import m4ri_tpu_torch as mt
from m4ri_tpu.core.bitmatrix import BitMatrix as JBitMatrix
from m4ri_tpu.models import echelon as jech

import oracle
from conftest import random_dense
from torch_port import Waits, cpu, jvmap, rank_k, same, stacks, with_bit31


def _batch(rng, m, n, b):
    mats = [with_bit31(rng, m, n), np.zeros((m, n), np.uint8),
            rank_k(rng, m, n, min(m, n) // 2), random_dense(rng, m, n, 0.2)]
    return np.stack(mats[:b])


# (m, n, batch)
SHAPES = {"tall": (70, 40, 4), "wide": (30, 90, 4), "one_row": (1, 50, 3),
          "one_element": (40, 40, 1)}


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_echelonize_naive_batched_equals_jax_vmap(rng, shape, full):
    m, n, b = SHAPES[shape]
    mats = _batch(rng, m, n, b)
    jx, tx = stacks(mats)
    want = jvmap(lambda d: jech.echelonize_naive(JBitMatrix(d, n),
                                                 full=full), jx)
    with Waits() as waits:
        got = mt.echelonize_naive_batched(tx, n, full=full)
    assert waits.n == 0
    same(want[0], got[0], f"{shape} full={full}: E")
    same(want[1], got[1], "r")
    assert got[1].dtype == torch.int32 and got[1].shape == (b,)
    for i, a in enumerate(mats):
        e, r = mt.echelonize_naive(cpu(a), full=full)
        assert torch.equal(got[0][i], e.data) and int(got[1][i]) == r
        assert r == oracle.rank(a)
        if full:
            np.testing.assert_array_equal(mt.to_numpy(e), oracle.rref(a))


@pytest.mark.parametrize("start", ["0", "5", "n-1", "n"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_gauss_delayed_batched_equals_jax_vmap(rng, shape, start):
    m, n, b = SHAPES[shape]
    start_col = {"0": 0, "5": 5, "n-1": n - 1, "n": n}[start]
    mats = _batch(rng, m, n, b)
    jx, tx = stacks(mats)
    want = jvmap(lambda d: jech.gauss_delayed(JBitMatrix(d, n),
                                              start_col=start_col), jx)
    with Waits() as waits:
        got = mt.gauss_delayed_batched(tx, n, start_col=start_col)
    assert waits.n == 0
    same(want[0], got[0], f"{shape} start_col={start_col}: E")
    same(want[1], got[1], "r")
    for i, a in enumerate(mats):
        e, r = mt.gauss_delayed(cpu(a), start_col=start_col)
        assert torch.equal(got[0][i], e.data) and int(got[1][i]) == r
        assert r == oracle.rank(a[:, start_col:])


def _invertible(rng, n):
    l = np.tril(random_dense(rng, n, n), -1) ^ np.eye(n, dtype=np.uint8)
    u = np.triu(random_dense(rng, n, n), 1) ^ np.eye(n, dtype=np.uint8)
    return oracle.mul(l, u).astype(np.uint8)


@pytest.mark.parametrize("n", [1, 40, 70])
def test_invert_naive_batched_equals_jax_vmap(rng, n):
    singular = random_dense(rng, n, n)
    singular[-1] = 0
    mats = np.stack([_invertible(rng, n), singular,
                     np.zeros((n, n), np.uint8), np.eye(n, dtype=np.uint8),
                     with_bit31(rng, n, n)])
    jx, tx = stacks(mats)
    want = jvmap(lambda d: jech.invert_naive(JBitMatrix(d, n)), jx)
    with Waits() as waits:
        got = mt.invert_naive_batched(tx)
    assert waits.n == 0
    same(want[0], got[0], f"n={n}: inverse")
    same(want[1], got[1], f"n={n}: ok")
    assert got[1].dtype == torch.bool and got[1].shape == (len(mats),)
    assert got[1][:4].tolist() == [True, False, False, True]
    for i, a in enumerate(mats):
        inv, ok = mt.invert_naive(cpu(a))
        assert torch.equal(got[0][i], inv.data) and bool(got[1][i]) is bool(ok)
        assert bool(ok) == (oracle.rank(a) == n)


def test_invert_naive_batched_of_one(rng):
    a = _invertible(rng, 33)
    jx, tx = stacks(a[None])
    want = jvmap(lambda d: jech.invert_naive(JBitMatrix(d, 33)), jx)
    got = mt.invert_naive_batched(tx)
    same(want[0], got[0], "inverse")
    same(want[1], got[1], "ok")
    inv = mt.to_numpy(mt.from_packed(got[0][0], 33, device="cpu"))
    np.testing.assert_array_equal(oracle.mul(a, inv),
                                  np.eye(33, dtype=np.uint8))

"""The batched solves, kernels and inversions of the PyTorch/CUDA port
(``kernel_left``, ``solve_left``, ``pluq_solve_left`` and ``invert`` in
models/batched_solve.py) against ``jax.vmap`` of the JAX package's entry
points on the same numpy inputs, on the CPU, and element by element against
the port's own single-matrix calls.  Every batch holds a zero element and a
rank-deficient one; the solves an inconsistent system, the inversions a
singular matrix.  Ranks, flags and counts come back as ``[B]`` tensors and
nothing reads back from the device beyond ``block_factor_batched``'s one
read-back a panel, for every batched entry point.  Equality of packed
words, ranks and flags: tolerance 0.  (``ple`` / ``pluq`` / echelon forms:
test_torch_batched_echelon.py; the TRSMs: test_torch_batched_trsm.py.)"""

import numpy as np
import pytest
import torch

import m4ri_tpu_torch as mt
from m4ri_tpu.core.bitmatrix import BitMatrix as JBitMatrix
from m4ri_tpu.models import echelon as jech, ple as jple, solve as jsolve
from m4ri_tpu_torch.utils.spans import counts

import oracle
from conftest import random_dense
from torch_port import (CASES, NB, Waits, cpu, jvmap, rank_k, same,
                        stacks)


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_left_batched_equals_jax_vmap(rng, case):
    mats = CASES[case](rng)
    n = mats.shape[2]
    jx, tx = stacks(mats)
    nb = NB.get(case)
    want = jvmap(lambda d: jsolve.kernel_left(JBitMatrix(d, n), nb=nb), jx)
    got = mt.kernel_left_batched(tx, n, nb=nb)
    same(want[0], got[0], f"{case}: X")
    same(want[1], got[1], f"{case}: count")
    assert got[1].dtype == torch.int32
    for i, a in enumerate(mats):
        x, count = mt.kernel_left(cpu(a), nb=nb)
        assert torch.equal(got[0][i], x.data) and int(got[1][i]) == count
        assert not oracle.mul(a, mt.to_numpy(x)).any()
        assert count == n - oracle.rank(a)


def _systems(rng, case):
    """A stack and right-hand sides: element 0 consistent by construction
    (b = A x), the rank-deficient ones inconsistent for random b."""
    mats = CASES[case](rng)
    bcols = {"wide": 3, "tall": 1, "square": 2, "misses": 2}[case]
    rhs = np.stack([random_dense(rng, mats.shape[1], bcols) for _ in mats])
    rhs[0] = oracle.mul(mats[0], random_dense(rng, mats.shape[2], bcols))
    return mats, rhs, bcols


def _check_solutions(mats, rhs, x, consistent):
    flags = consistent.tolist()
    assert flags[0] and not all(flags)
    for i, a in enumerate(mats):
        if flags[i]:
            xi = mt.to_numpy(mt.BitMatrix(x[i], rhs.shape[2]))
            np.testing.assert_array_equal(oracle.mul(a, xi), rhs[i])


@pytest.mark.parametrize("case", list(CASES))
def test_solve_left_batched_equals_jax_vmap(rng, case):
    mats, rhs, bcols = _systems(rng, case)
    n = mats.shape[2]
    (ja, ta), (jb, tb) = stacks(mats), stacks(rhs)
    nb = NB.get(case)
    want = jvmap(lambda d, b: jsolve.solve_left(
        JBitMatrix(d, n), JBitMatrix(b, bcols), nb=nb), ja, jb)
    got = mt.solve_left_batched(ta, n, tb, bcols, nb=nb)
    same(want[0], got[0], f"{case}: X")
    same(want[1], got[1], f"{case}: consistent")
    assert got[1].dtype == torch.bool and got[1].shape == (len(mats),)
    for i, a in enumerate(mats):
        x, ok = mt.solve_left(cpu(a), cpu(rhs[i]), nb=nb)
        assert torch.equal(got[0][i], x.data) and bool(got[1][i]) == bool(ok)
    _check_solutions(mats, rhs, got[0], got[1])


@pytest.mark.parametrize("case", list(CASES))
def test_pluq_solve_left_batched_equals_jax_vmap(rng, case):
    mats, rhs, bcols = _systems(rng, case)
    n = mats.shape[2]
    (ja, ta), (jb, tb) = stacks(mats), stacks(rhs)

    nb = NB.get(case)

    def jfn(d, b):
        m, p, q, r = jple.pluq(JBitMatrix(d, n), nb=nb)
        return jsolve.pluq_solve_left(m, p, q, r, JBitMatrix(b, bcols))

    want = jvmap(jfn, ja, jb)
    m, p, q, r = mt.pluq_batched(ta, n, nb=nb)
    got = mt.pluq_solve_left_batched(m, n, p, q, r, tb, bcols)
    same(want[0], got[0], f"{case}: X")
    same(want[1], got[1], f"{case}: consistent")
    for i in range(len(mats)):
        x, ok = mt.pluq_solve_left(mt.BitMatrix(m[i], n), p[i], q[i],
                                   int(r[i]), cpu(rhs[i]))
        assert torch.equal(got[0][i], x.data) and bool(got[1][i]) == bool(ok)
    _check_solutions(mats, rhs, got[0], got[1])


@pytest.mark.parametrize("n", [64, 100])
def test_invert_batched_equals_jax_vmap(rng, n):
    mats = np.stack([random_dense(rng, n, n), rank_k(rng, n, n, 0),
                     rank_k(rng, n, n, n - 1), np.eye(n, dtype=np.uint8),
                     oracle.mul(np.triu(random_dense(rng, n, n), 1)
                                + np.eye(n, dtype=np.uint8),
                                np.tril(random_dense(rng, n, n), -1)
                                + np.eye(n, dtype=np.uint8))])
    jx, tx = stacks(mats)
    want = jvmap(lambda d: jech.invert(JBitMatrix(d, n)), jx)
    got = mt.invert_batched(tx)
    same(want[0], got[0], "inverse")
    same(want[1], got[1], "r_a")
    assert got[1].dtype == torch.int32
    ranks = got[1].tolist()
    assert ranks == [oracle.rank(a) for a in mats]
    assert ranks[1] == 0 and ranks[2] < n and ranks[3] == ranks[4] == n
    for i, a in enumerate(mats):
        inv, r_a = mt.invert(cpu(a))
        assert torch.equal(got[0][i], inv.data) and ranks[i] == r_a
        if r_a == n:
            np.testing.assert_array_equal(oracle.mul(a, mt.to_numpy(inv)),
                                          np.eye(n, dtype=np.uint8))


def _calls(mats, rhs, bcols):
    """Each batched entry point on the stack, with a 32-column panel so the
    sweep takes several panels; invert on the square left block."""
    n = mats.shape[2]
    tx, tb = stacks(mats)[1], stacks(rhs)[1]
    sq = stacks(mats[:, :, : mats.shape[1]])[1]
    return {
        "ple": (n, lambda: mt.ple_batched(tx, n, nb=32)),
        "pluq": (n, lambda: mt.pluq_batched(tx, n, nb=32)),
        "rref_m4ri": (n, lambda: mt.echelonize_batched(tx, n, nb=32)),
        "rref_pluq": (n, lambda: mt.echelonize_batched(
            tx, n, nb=32, strategy="pluq")),
        "kernel_left": (n, lambda: mt.kernel_left_batched(tx, n, nb=32)),
        "solve_left": (n, lambda: mt.solve_left_batched(tx, n, tb, bcols,
                                                        nb=32)),
        "invert": (2 * sq.shape[1], lambda: mt.invert_batched(sq, nb=32)),
    }


@pytest.mark.parametrize("entry", ["ple", "pluq", "rref_m4ri", "rref_pluq",
                                   "kernel_left", "solve_left", "invert"])
def test_no_read_back_beyond_the_sweeps(rng, entry):
    """A batched call waits for the device only where block_factor_batched
    does, once a panel (no element misses here): the dispatch mode sees as
    many waiting operators as the sweep counts read-backs, one a panel."""
    mats, rhs, bcols = _systems(rng, "wide")
    ncols, call = _calls(mats, rhs, bcols)[entry]
    before = counts()
    with Waits() as waits:
        call()
    after = counts()
    name = "block_factor_batched"
    assert after.get(f"fallback.{name}", 0) == before.get(f"fallback.{name}", 0)
    assert waits.n == after.get(f"readback.{name}", 0) - \
        before.get(f"readback.{name}", 0) == -(-ncols // 32)


def test_heuristic_strategy_raises():
    tx = torch.zeros((2, 40, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="heuristic"):
        mt.echelonize_batched(tx, 40, strategy="heuristic")


def test_operand_checks():
    t = torch.zeros((2, 40, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        mt.solve_left_batched(t, 40, torch.zeros((3, 40, 1),
                                                 dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        mt.solve_left_batched(t, 40, torch.zeros((2, 40, 2),
                                                 dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        mt.invert_batched(torch.zeros((2, 40, 1), dtype=torch.int32))
    with pytest.raises(TypeError):
        mt.ple_batched(t[0], 40)


@pytest.mark.parametrize("shape,n", [((0, 5, 1), 20), ((3, 0, 1), 20),
                                     ((2, 5, 0), 0)])
def test_empty_batches_and_matrices(shape, n):
    """An empty batch, or elements of no rows or no columns: rank 0, empty
    bodies, every flag and count of the right shape."""
    d = torch.zeros(shape, dtype=torch.int32)
    B, m = shape[:2]
    for fn in (mt.ple_batched, mt.pluq_batched):
        M, P, Q, r = fn(d, n)
        assert M.shape == shape and P.shape == (B, m) and Q.shape == (B, n)
        assert r.tolist() == [0] * B
    E, r = mt.echelonize_batched(d, n)
    assert E.shape == shape and r.tolist() == [0] * B
    K, count = mt.kernel_left_batched(d, n)
    assert K.shape == (B, n, (n + 31) // 32) and count.tolist() == [n] * B
    X, ok = mt.solve_left_batched(d, n, torch.zeros((B, m, 1),
                                                    dtype=torch.int32), 1)
    assert X.shape == (B, n, 1) and ok.tolist() == [True] * B
    sq = torch.zeros((B, m, (m + 31) // 32), dtype=torch.int32)
    inv, r_a = mt.invert_batched(sq)
    assert inv.shape == sq.shape and r_a.tolist() == [0] * B

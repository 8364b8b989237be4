"""Solving and the kernel of the PyTorch/CUDA port against the JAX package
(mirrors test_solve.py and test_misc.py's pluq_solve_left case), and the
slice as a whole: ``solve_left`` and ``kernel_left`` take the same numpy
input through both packages on the CPU, factorization, permutations, TRSMs
and all, with equality of packed words, ranks and flags (tolerance 0).
Factors cross between the packages through ``convert.py``."""

import numpy as np
import pytest
import torch

import m4ri_tpu_torch as mt
from m4ri_tpu.models import ple as jple
from m4ri_tpu.models import solve as jsolve
from m4ri_tpu_torch.models import solve as tsolve

import oracle
from conftest import random_dense
from torch_port import (assert_padding_zero, assert_same, both,
                        config_fields, with_bit31)  # noqa: F401 (a fixture)


def _low_rank(rng, m, n, k):
    return oracle.mul(random_dense(rng, m, k), random_dense(rng, k, n)).astype(
        np.uint8)


@pytest.mark.parametrize("m,n,cols", [
    (32, 32, 8), (64, 64, 64), (100, 100, 17), (96, 64, 10), (64, 96, 12),
    (129, 129, 32),
])
def test_solve_consistent_equals_jax(rng, m, n, cols):
    a = with_bit31(rng, m, n)
    b = oracle.mul(a, random_dense(rng, n, cols)).astype(np.uint8)
    (Aj, At), (Bj, Bt) = both(a), both(b)
    Xj, okj = jsolve.solve_left(Aj, Bj)
    Xt, okt = mt.solve_left(At, Bt)
    assert_same(Xj, Xt)
    assert_padding_zero(Xt)
    assert okt.dtype == torch.bool and okt.dim() == 0
    assert bool(okt) and bool(okj)
    np.testing.assert_array_equal(oracle.mul(a, mt.to_numpy(Xt)), b)


def test_solve_low_rank_consistent_equals_jax(rng):
    a = _low_rank(rng, 80, 100, 20)
    b = oracle.mul(a, random_dense(rng, 100, 5)).astype(np.uint8)
    (Aj, At), (Bj, Bt) = both(a), both(b)
    Xj, okj = jsolve.solve_left(Aj, Bj)
    Xt, okt = mt.solve_left(At, Bt)
    assert_same(Xj, Xt)
    assert bool(okt) and bool(okj)
    np.testing.assert_array_equal(oracle.mul(a, mt.to_numpy(Xt)), b)


def test_solve_inconsistent_equals_jax(rng):
    a = _low_rank(rng, 60, 40, 10)
    rng2 = np.random.default_rng(3)
    while True:
        b = (rng2.random((60, 3)) < 0.5).astype(np.uint8)
        if oracle.rank(np.concatenate([a, b], axis=1)) > oracle.rank(a):
            break
    (Aj, At), (Bj, Bt) = both(a), both(b)
    Xj, okj = jsolve.solve_left(Aj, Bj)
    Xt, okt = mt.solve_left(At, Bt)
    assert not bool(okt) and not bool(okj)
    assert_same(Xj, Xt)


def test_solve_with_a_deep_trsm_recursion_equals_jax(rng, config_fields):
    """With trsm_base shrunk, both triangular solves of the solver recurse
    several levels; the bits stay the JAX package's."""
    config_fields(trsm_base=32, trsm_wide_base=64)
    a = random_dense(rng, 200, 150)
    b = oracle.mul(a, random_dense(rng, 150, 20)).astype(np.uint8)
    (Aj, At), (Bj, Bt) = both(a), both(b)
    Xj, okj = jsolve.solve_left(Aj, Bj)
    Xt, okt = mt.solve_left(At, Bt)
    assert_same(Xj, Xt)
    assert bool(okt) and bool(okj)


@pytest.mark.parametrize("m,n,k", [(40, 60, 10), (64, 64, 32), (100, 70, 20)])
def test_kernel_equals_jax(rng, m, n, k):
    a = _low_rank(rng, m, n, k)
    r = oracle.rank(a)
    Aj, At = both(a)
    Xj, cj = jsolve.kernel_left(Aj)
    Xt, ct = mt.kernel_left(At)
    assert_same(Xj, Xt)
    assert isinstance(ct, int) and ct == int(cj) == n - r
    assert not oracle.mul(a, mt.to_numpy(Xt)).any()
    assert oracle.rank(mt.to_numpy(Xt)) == n - r


def test_kernel_full_rank_equals_jax():
    a = np.eye(30, dtype=np.uint8)
    Aj, At = both(a)
    Xj, cj = jsolve.kernel_left(Aj)
    Xt, ct = mt.kernel_left(At)
    assert_same(Xj, Xt)
    assert ct == int(cj) == 0 and not mt.to_numpy(Xt).any()


def test_pluq_solve_left_on_the_jax_packages_factors(rng):
    """The JAX package's own pluq output, carried across by convert.py, solves
    the system in the port exactly as it does in the JAX package; and the
    port's factors, carried back, equal the JAX package's."""
    a = random_dense(rng, 64, 64)
    b = oracle.mul(a, random_dense(rng, 64, 10)).astype(np.uint8)
    (Aj, At), (Bj, Bt) = both(a), both(b)
    Mj, Pj, Qj, rj = jple.pluq(Aj)
    fac = mt.factors_from_reference(np.asarray(Mj.data), Mj.ncols,
                                    np.asarray(Pj), np.asarray(Qj), rj,
                                    device="cpu")
    assert fac[1].dtype == fac[2].dtype == torch.int32 and isinstance(fac[3], int)
    Xt, okt = mt.pluq_solve_left(*fac, Bt)
    Xj, okj = jsolve.pluq_solve_left(Mj, Pj, Qj, rj, Bj)
    assert_same(Xj, Xt)
    assert bool(okt) and bool(okj)
    np.testing.assert_array_equal(oracle.mul(a, mt.to_numpy(Xt)), b)
    words, ncols, p, q, r = mt.factors_to_reference(*mt.pluq(At))
    np.testing.assert_array_equal(words, np.asarray(Mj.data))
    np.testing.assert_array_equal(p, np.asarray(Pj))
    np.testing.assert_array_equal(q, np.asarray(Qj))
    assert (ncols, r) == (64, int(rj))


def test_pluq_solve_left_low_rank_equals_jax(rng):
    a = _low_rank(rng, 70, 90, 25)
    b = oracle.mul(a, random_dense(rng, 90, 6)).astype(np.uint8)
    (Aj, At), (Bj, Bt) = both(a), both(b)
    Xj, okj = jsolve.pluq_solve_left(*jple.pluq(Aj), Bj)
    Xt, okt = mt.pluq_solve_left(*mt.pluq(At), Bt)
    assert_same(Xj, Xt)
    assert bool(okt) and bool(okj)


def test_the_slice_as_a_whole(rng):
    """solve_left and kernel_left on one wide, word-unaligned, rank-deficient
    input with bit 31 set: factorization, pivot selection, permutation, both
    TRSMs and the scatter, the same bits as the JAX package."""
    a = with_bit31(rng, 150, 199)
    a[40:60] = a[:20]                      # rank below full
    x0 = random_dense(rng, 199, 33)
    b = oracle.mul(a, x0).astype(np.uint8)
    (Aj, At), (Bj, Bt) = both(a), both(b)
    keep_a, keep_b = At.data.clone(), Bt.data.clone()
    Xj, okj = jsolve.solve_left(Aj, Bj)
    Xt, okt = mt.solve_left(At, Bt)
    assert_same(Xj, Xt)
    assert bool(okt) and bool(okj)
    Kj, cj = jsolve.kernel_left(Aj)
    Kt, ct = mt.kernel_left(At)
    assert_same(Kj, Kt)
    assert ct == int(cj) == 199 - oracle.rank(a)
    assert torch.equal(At.data, keep_a) and torch.equal(Bt.data, keep_b)


def test_helpers_equal_jax():
    from m4ri_tpu.models.solve import _keep_below as jkeep
    bounds = np.array([0, 1, 31, 32, 33, 64, 65, 100], np.int32)
    got = tsolve._keep_below(torch.as_tensor(bounds).long(), 4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(jkeep(bounds, 4)))


def test_solvers_are_dd_instrumented(rng, capsys):
    from m4ri_tpu_torch.utils import hashing
    a = random_dense(rng, 30, 30)
    A = mt.from_numpy(a, device="cpu")
    B = mt.from_numpy(random_dense(rng, 30, 4), device="cpu")
    hashing.debug_dump(True)
    try:
        mt.solve_left(A, B)
        mt.kernel_left(A)
        mt.pluq_solve_left(*mt.pluq(A), B)
    finally:
        hashing.debug_dump(False)
    out = capsys.readouterr().out
    for name in ("mzd_solve_left[0]", "mzd_kernel_left_pluq[0]",
                 "mzd_pluq_solve_left[0]"):
        assert f"{name}: 0x" in out, name

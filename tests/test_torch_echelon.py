"""Echelon forms and inversion of the PyTorch/CUDA port against the JAX
package (mirrors test_elimination.py with ref_top_model.py, and the
naive-engine and inversion cases of test_misc.py / test_solve.py): the same
numpy input through both packages on the CPU, equality of packed words,
ranks and flags, tolerance 0."""

import numpy as np
import pytest
import torch

import m4ri_tpu_torch as mt
from m4ri_tpu.models import echelon as jech
from m4ri_tpu_torch.models import echelon as tech
from m4ri_tpu_torch.utils import config as tconfig

import oracle
from conftest import random_dense
from ref_top_model import top_echelonize_model
from test_elimination import SIZES, _echelon_form
from torch_port import (assert_padding_zero, assert_same, both,
                        config_fields, with_bit31)  # noqa: F401 (a fixture)


@pytest.mark.parametrize("m,n", SIZES)
def test_rref_equals_jax(rng, m, n):
    a = random_dense(rng, m, n)
    J, T = both(a)
    Rj, rj = jech.echelonize(J, full=True)
    Rt, rt = mt.echelonize(T, full=True)
    assert_same(Rj, Rt)
    assert_padding_zero(Rt)
    assert isinstance(rt, int) and rt == int(rj) == oracle.rank(a)
    np.testing.assert_array_equal(mt.to_numpy(Rt), oracle.rref(a))


@pytest.mark.parametrize("m,n", [(64, 64), (128, 96), (100, 150)])
def test_rref_low_rank_equals_jax(rng, m, n):
    k = min(m, n) // 3
    a = oracle.mul(random_dense(rng, m, k), random_dense(rng, k, n)).astype(
        np.uint8)
    J, T = both(a)
    for strategy in ("m4ri", "pluq"):
        Rj, rj = jech.echelonize(J, full=True, strategy=strategy)
        Rt, rt = mt.echelonize(T, full=True, strategy=strategy)
        assert_same(Rj, Rt, strategy)
        assert rt == int(rj) <= k


@pytest.mark.parametrize("m,n", [(64, 64), (96, 128), (130, 70)])
def test_ref_non_reduced_equals_jax(rng, m, n):
    a = with_bit31(rng, m, n)
    J, T = both(a)
    for strategy in ("m4ri", "pluq"):
        Rj, rj = jech.echelonize(J, full=False, strategy=strategy)
        Rt, rt = mt.echelonize(T, full=False, strategy=strategy)
        assert_same(Rj, Rt, strategy)
        assert rt == int(rj)
        Rd = mt.to_numpy(Rt)
        assert not Rd[rt:].any()
        np.testing.assert_array_equal(oracle.rref(Rd), oracle.rref(a))


@pytest.mark.parametrize("m,n", [(64, 64), (100, 150), (128, 90)])
def test_elimination_paths_agree_with_jax(rng, m, n):
    """The independent paths, each equal to the JAX package's and to the
    unique RREF (test_elimination.c's elim_test_equality)."""
    a = random_dense(rng, m, n)
    J, T = both(a)
    expect = oracle.rref(a)
    for name, kw in [("echelonize", dict(full=True)),
                     ("echelonize", dict(full=True, strategy="heuristic")),
                     ("echelonize_pluq", dict(full=True)),
                     ("top_echelonize", dict()),
                     ("top_echelonize", dict(k=4))]:
        Rj, rj = getattr(jech, name)(J, **kw)
        Rt, rt = getattr(mt, name)(T, **kw)
        assert_same(Rj, Rt, f"{name} {kw}")
        assert rt == int(rj) == oracle.rank(a)
        np.testing.assert_array_equal(mt.to_numpy(Rt), expect)


def test_heuristic_crossover_is_a_float_config_field(rng, monkeypatch,
                                                     config_fields):
    """Config.echelon_density_crossover (a float) decides the strategy;
    both give the same bits."""
    assert tconfig.get_config().echelon_density_crossover == 0.15
    a = random_dense(rng, 90, 70, density=0.3)
    T = mt.from_numpy(a, device="cpu")
    calls = []
    real = tech.echelonize_pluq
    monkeypatch.setattr(tech, "echelonize_pluq",
                        lambda *args, **kw: calls.append(1) or real(*args, **kw))
    want, _ = tech.echelonize(T, strategy="m4ri")
    for crossover, pluq in ((0.5, False), (0.25, True)):
        config_fields(echelon_density_crossover=crossover)
        assert tconfig.get_config().echelon_density_crossover == crossover
        calls.clear()
        got, _ = tech.echelonize(T, strategy="heuristic")
        assert bool(calls) is pluq
        assert torch.equal(got.data, want.data)


def test_rank_equals_jax(rng):
    a = random_dense(rng, 150, 90)
    J, T = both(a)
    assert mt.rank(T) == int(jech.rank(J)) == oracle.rank(a)
    assert mt.rank(mt.zeros(10, 10, device="cpu")) == 0
    assert mt.rank(mt.identity(65, device="cpu")) == 65


def test_top_echelonize_equals_reference_model_and_jax(rng):
    """Inputs in echelon form (the reference's contract): the port equals
    the bit-faithful model of _mzd_top_echelonize_m4ri, the JAX package and
    the unique RREF."""
    cases = [_echelon_form((rng.random((m, n)) < d).astype(np.uint8))
             for (m, n, d) in ((40, 60, 0.5), (70, 50, 0.2), (64, 64, 0.05))]
    g = np.zeros((8, 120), np.uint8)
    for i, c in enumerate([0, 29, 30, 61, 93, 94, 95, 119]):
        g[i, c] = 1
        g[i, c + 1:] = (rng.random(119 - c) < 0.5)
    cases.append(g)
    cases.append(_echelon_form((rng.random((50, 40)) < 0.3).astype(np.uint8)))
    for i, a in enumerate(cases):
        J, T = both(a)
        for k in (1, 2, 4):
            got, rg = mt.top_echelonize(T, k=k)
            want, rw = top_echelonize_model(a, k)
            np.testing.assert_array_equal(mt.to_numpy(got), want)
            assert rg == rw
            if k == 1 + i % 3:      # the JAX package at one window a case
                Rj, rj = jech.top_echelonize(J, k=k)
                assert_same(Rj, got)


def test_top_echelonize_out_of_contract_matches_jax(rng):
    """Off the contract the port keeps the JAX package's divergence from the
    reference model: at least as many pivots, the same bits as JAX."""
    a = (rng.random((48, 48)) < 0.15).astype(np.uint8)
    a[:20, :10] = 0
    J, T = both(a)
    got, rg = mt.top_echelonize(T, k=1)
    _, rw = top_echelonize_model(a, 1)
    assert rg >= rw
    Rj, rj = jech.top_echelonize(J, k=1)
    assert_same(Rj, got)
    assert rg == int(rj)


def test_echelonize_with_pivots_and_selection_equal_jax(rng):
    a = with_bit31(rng, 70, 100)
    J, T = both(a)
    Rj, qj, rj = jech.echelonize_with_pivots(J)
    Rt, qt, rt = tech.echelonize_with_pivots(T)
    assert_same(Rj, Rt)
    np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
    assert rt == int(rj)
    data, _, q, r = mt.block_factor(T, preserve_l=False)
    jdata = data.numpy().view(np.uint32)
    sel = tech.select_pivot_cols(data, q, r, 70, 100, 70)
    assert_same(jech.select_pivot_cols(jdata, np.asarray(q), r, 70, 100, 70),
                sel)
    s = tech._pivot_selection(q, r, 100, 70)
    assert_same(jech._pivot_selection(np.asarray(q), r, 100, 70), s)


@pytest.mark.parametrize("n", [16, 64, 100, 129])
def test_invert_equals_jax(rng, n):
    l = np.tril(random_dense(rng, n, n), -1) ^ np.eye(n, dtype=np.uint8)
    u = np.triu(random_dense(rng, n, n), 1) ^ np.eye(n, dtype=np.uint8)
    a = oracle.mul(l, u).astype(np.uint8)[np.random.default_rng(5).permutation(n)]
    J, T = both(a)
    ij, rj = jech.invert(J)
    it, rt = mt.invert(T)
    assert_same(ij, it)
    assert isinstance(rt, int) and rt == int(rj) == n
    np.testing.assert_array_equal(oracle.mul(a, mt.to_numpy(it)),
                                  np.eye(n, dtype=np.uint8))


def test_invert_singular_equals_jax(rng):
    s = np.zeros((8, 8), np.uint8)
    s[0, 0] = 1
    a = random_dense(rng, 40, 40)
    a[7] = a[3]
    for x in (s, a):
        J, T = both(x)
        ij, rj = jech.invert(J)
        it, rt = mt.invert(T)
        assert rt == int(rj) < x.shape[0]
        assert_same(ij, it)


def test_naive_engines_equal_jax(rng):
    a = with_bit31(rng, 60, 90)
    J, T = both(a)
    for full in (True, False):
        Rj, rj = jech.echelonize_naive(J, full=full)
        Rt, rt = mt.echelonize_naive(T, full=full)
        assert_same(Rj, Rt, f"full={full}")
        assert rt == int(rj) == oracle.rank(a)
    np.testing.assert_array_equal(mt.to_numpy(mt.echelonize_naive(T)[0]),
                                  oracle.rref(a))
    Rj, rj = jech.gauss_delayed(J, start_col=20)
    Rt, rt = mt.gauss_delayed(T, start_col=20)
    assert_same(Rj, Rt)
    assert rt == int(rj) == oracle.rank(a[:, 20:])


def test_invert_naive_equals_jax(rng):
    n = 40
    l = np.tril(random_dense(rng, n, n), -1) ^ np.eye(n, dtype=np.uint8)
    u = np.triu(random_dense(rng, n, n), 1) ^ np.eye(n, dtype=np.uint8)
    a = oracle.mul(l, u).astype(np.uint8)
    s = np.zeros((8, 8), np.uint8)
    s[0, 0] = 1
    for x, ok in ((a, True), (s, False)):
        J, T = both(x)
        ij, okj = jech.invert_naive(J)
        it, okt = mt.invert_naive(T)
        assert_same(ij, it)
        assert okt.dtype == torch.bool and okt.dim() == 0
        assert bool(okt) is bool(okj) is ok
    inv, _ = mt.invert(mt.from_numpy(a, device="cpu"))
    assert torch.equal(inv.data, mt.invert_naive(mt.from_numpy(a, device="cpu"))[0].data)


def test_echelon_entry_points_are_dd_instrumented(rng, capsys):
    from m4ri_tpu_torch.utils import hashing
    T = mt.from_numpy(random_dense(rng, 30, 30), device="cpu")
    hashing.debug_dump(True)
    try:
        mt.echelonize(T)
        mt.invert(T)
        mt.top_echelonize(T)
    finally:
        hashing.debug_dump(False)
    out = capsys.readouterr().out
    for name in ("mzd_echelonize[0]", "mzd_inv_m4ri[0]",
                 "mzd_top_echelonize_m4ri[0]"):
        assert f"{name}: 0x" in out, name

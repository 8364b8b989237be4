"""TRSM / TRTRI of the PyTorch/CUDA port against the JAX package (mirrors
test_trsm.py: its SIZES, the TRTRI sizes and the junk-triangle case): the
same numpy input through both packages on the CPU, equality of packed words,
tolerance 0.  The recursion is covered twice: at the default bases (the JAX
package's 512 / 4096, reached by n = 600 and 700) and with ``trsm_base`` /
``trsm_wide_base`` shrunk through the port's Config, so that small inputs
take several levels of substitution and of the 2x2 inverse."""

import numpy as np
import pytest
import torch

import m4ri_tpu_torch as mt
from m4ri_tpu.models import triangular as jtri
from m4ri_tpu_torch.models import triangular as ttri
from m4ri_tpu_torch.utils import config as tconfig

import oracle
from conftest import random_dense
from test_trsm import SIZES, unit_upper
from torch_port import (assert_padding_zero, assert_same, both,
                        config_fields, with_bit31)  # noqa: F401 (a fixture)

LEFT = ("trsm_upper_left", "trsm_lower_left")
RIGHT = ("trsm_upper_right", "trsm_lower_right")


@pytest.fixture
def small_bases(config_fields):
    """trsm_base 64 and trsm_wide_base 128 in the port's config."""
    config_fields(trsm_base=64, trsm_wide_base=128)


def _operands(rng, name, n, other, junk=False):
    """(T, B) dense: T unit triangular of the variant's kind (junk in the
    other triangle if asked), B n x other (left) or other x n (right)."""
    u = unit_upper(rng, n)
    if junk:
        u = u | np.tril(with_bit31(rng, n, n), -1)
    t = u if "upper" in name else u.T.copy()
    b = with_bit31(rng, n, other) if name in LEFT else with_bit31(rng, other, n)
    return t, b


def _check_solution(name, t, b, x):
    tt = np.triu(t) if "upper" in name else np.tril(t)
    prod = oracle.mul(tt, x) if name in LEFT else oracle.mul(x, tt)
    np.testing.assert_array_equal(prod, b)


@pytest.mark.parametrize("name", LEFT + RIGHT)
@pytest.mark.parametrize("n,other", SIZES)
def test_trsm_equals_jax(rng, name, n, other):
    t, b = _operands(rng, name, n, other)
    (Tj, Tt), (Bj, Bt) = both(t), both(b)
    got = getattr(mt, name)(Tt, Bt)
    assert_same(getattr(jtri, name)(Tj, Bj), got, name)
    assert_padding_zero(got)
    _check_solution(name, t, b, mt.to_numpy(got))


@pytest.mark.parametrize("name", LEFT + RIGHT)
@pytest.mark.parametrize("n,other", [(300, 80), (300, 40), (129, 200),
                                     (250, 7)])
def test_trsm_recursion_with_small_bases_equals_jax(rng, small_bases, name,
                                                    n, other):
    """Substitution to the base (narrow B) or to the wide base then the
    inverse (wide B), several levels deep; the JAX package recurses at its
    own bases and the bits agree."""
    t, b = _operands(rng, name, n, other, junk=True)
    (Tj, Tt), (Bj, Bt) = both(t), both(b)
    got = getattr(mt, name)(Tt, Bt)
    assert_same(getattr(jtri, name)(Tj, Bj), got, name)
    _check_solution(name, t, b, mt.to_numpy(got))


@pytest.mark.parametrize("n", [5, 33, 64, 200, 513, 700])
def test_trtri_equals_jax(rng, n):
    u = unit_upper(rng, n)
    for fj, ft, mat in ((jtri.trtri_upper, mt.trtri_upper, u),
                        (jtri.trtri_lower, mt.trtri_lower, u.T.copy())):
        J, T = both(mat)
        got = ft(T)
        assert_same(fj(J), got)
        np.testing.assert_array_equal(oracle.mul(mat, mt.to_numpy(got)),
                                      np.eye(n, dtype=np.uint8))


@pytest.mark.parametrize("n", [100, 257])
def test_trtri_with_a_small_base_equals_jax(rng, small_bases, n):
    u = unit_upper(rng, n) | np.tril(random_dense(rng, n, n), -1)
    for fj, ft, mat in ((jtri.trtri_upper, mt.trtri_upper, u),
                        (jtri.trtri_lower, mt.trtri_lower, u.T.copy())):
        J, T = both(mat)
        assert_same(fj(J), ft(T))


@pytest.mark.parametrize("n", [64, 129, 600])
def test_trsm_ignores_opposite_triangle(rng, n):
    """Junk in the opposite triangle changes nothing (the reference reads
    only the relevant triangle), and below 600 the port equals the JAX
    package on the junk input too."""
    u = unit_upper(rng, n)
    junk = u | np.tril(random_dense(rng, n, n), -1)
    b = random_dense(rng, n, 32)
    for name, mat, dirty in [
            ("trsm_upper_left", u, junk), ("trsm_lower_left", u.T.copy(), junk.T.copy()),
            ("trsm_upper_right", u, junk), ("trsm_lower_right", u.T.copy(), junk.T.copy())]:
        bb = b if name in LEFT else b.T.copy()
        fn = getattr(mt, name)
        B = mt.from_numpy(bb, device="cpu")
        clean = fn(mt.from_numpy(mat, device="cpu"), B)
        noisy = fn(mt.from_numpy(dirty, device="cpu"), B)
        assert torch.equal(clean.data, noisy.data), name
        if n < 600:     # the 600 clean case is in test_trsm_equals_jax
            (Dj, _), (Bj, _) = both(dirty), both(bb)
            assert_same(getattr(jtri, name)(Dj, Bj), noisy, name)
    for ft, mat, dirty in ((mt.trtri_upper, u, junk),
                           (mt.trtri_lower, u.T.copy(), junk.T.copy())):
        assert torch.equal(ft(mt.from_numpy(mat, device="cpu")).data,
                           ft(mt.from_numpy(dirty, device="cpu")).data)


def test_inputs_are_not_written(rng):
    t, b = _operands(rng, "trsm_upper_left", 130, 140, junk=True)
    T, B = mt.from_numpy(t, device="cpu"), mt.from_numpy(b, device="cpu")
    keep_t, keep_b = T.data.clone(), B.data.clone()
    mt.trsm_upper_left(T, B)
    mt.trsm_lower_right(T, mt.from_numpy(b.T.copy(), device="cpu"))
    mt.trtri_upper(T)
    assert torch.equal(T.data, keep_t) and torch.equal(B.data, keep_b)


def test_config_carries_the_trsm_fields():
    from m4ri_tpu.models import triangular as jt
    cfg = tconfig.get_config()
    assert (cfg.trsm_base, cfg.trsm_wide_base) == (jt._BASE, jt._WIDE_BASE)


def test_trsm_is_dd_instrumented(rng, capsys):
    from m4ri_tpu_torch.utils import hashing
    t, b = _operands(rng, "trsm_lower_left", 40, 10)
    T, B = mt.from_numpy(t, device="cpu"), mt.from_numpy(b, device="cpu")
    hashing.debug_dump(True)
    try:
        mt.trsm_lower_left(T, B)
        mt.trtri_upper(mt.from_numpy(t.T.copy(), device="cpu"))
    finally:
        hashing.debug_dump(False)
    out = capsys.readouterr().out
    assert "mzd_trsm_lower_left: 0x" in out and "mzd_trtri_upper: 0x" in out
    assert ttri.trsm_lower_left is not mt.trsm_lower_left

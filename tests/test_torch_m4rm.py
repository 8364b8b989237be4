"""The Gray-table product of the PyTorch/CUDA port against the JAX package
(mirrors test_m4rm.py): ``mul_m4rm`` / ``addmul_m4rm`` take the same numpy
input through both packages on the CPU, and their packed words must be
equal (tolerance 0), for every table width and across giant-step blocks."""

import numpy as np
import pytest

import m4ri_tpu_torch as mt
from m4ri_tpu.ops import m4rm as jm4rm
from m4ri_tpu_torch.ops import m4rm as tm4rm

import oracle
from conftest import random_dense
from torch_port import assert_padding_zero, assert_same, both, with_bit31


@pytest.mark.parametrize("m,k,n", [(7, 9, 11), (64, 64, 64), (65, 97, 129),
                                   (128, 200, 77), (257, 256, 95)])
def test_mul_m4rm_equals_jax(rng, m, k, n):
    a, b = with_bit31(rng, m, k), random_dense(rng, k, n)
    (Aj, At), (Bj, Bt) = both(a), both(b)
    Ct = mt.mul_m4rm(At, Bt)
    assert_same(jm4rm.mul_m4rm(Aj, Bj), Ct)
    assert_padding_zero(Ct)
    np.testing.assert_array_equal(mt.to_numpy(Ct), oracle.mul(a, b))


@pytest.mark.parametrize("kparam", [1, 4, 8, 11])
def test_mul_m4rm_k_values_equal_jax(rng, kparam):
    a, b = with_bit31(rng, 100, 130), random_dense(rng, 130, 64)
    (Aj, At), (Bj, Bt) = both(a), both(b)
    assert_same(jm4rm.mul_m4rm(Aj, Bj, k=kparam),
                mt.mul_m4rm(At, Bt, k=kparam), f"k={kparam}")


def test_m4rm_blocks_cross_a_giant_step(rng, monkeypatch):
    """The port's block budget cut to two slices' tables: its 8 slices of
    k=8 go in four blocks, the JAX package's in one."""
    a, b = with_bit31(rng, 40, 64), random_dense(rng, 64, 70)
    (Aj, At), (Bj, Bt) = both(a), both(b)
    want = jm4rm.mul_m4rm(Aj, Bj, k=8)
    monkeypatch.setattr(tm4rm, "_BLOCK_BYTES", 2 * (1 << 8) * Bt.width * 4)
    assert_same(want, mt.mul_m4rm(At, Bt, k=8))


def test_addmul_m4rm_equals_jax(rng):
    a, b, c = random_dense(rng, 50, 70), random_dense(rng, 70, 90), \
        with_bit31(rng, 50, 90)
    (Aj, At), (Bj, Bt), (Cj, Ct) = both(a), both(b), both(c)
    before = Ct.data.clone()
    Dt = mt.addmul_m4rm(Ct, At, Bt)
    assert_same(jm4rm.addmul_m4rm(Cj, Aj, Bj), Dt)
    assert bool((Ct.data == before).all()), "addmul_m4rm changed its C"
    np.testing.assert_array_equal(mt.to_numpy(Dt), c ^ oracle.mul(a, b))


def test_m4rm_agrees_with_mul(rng):
    a, b = with_bit31(rng, 129, 257), random_dense(rng, 257, 100)
    A, B = mt.from_numpy(a, device="cpu"), mt.from_numpy(b, device="cpu")
    assert bool(mt.equal(mt.mul_m4rm(A, B), mt.mul(A, B)))

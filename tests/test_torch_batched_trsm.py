"""The batched TRSMs and TRTRIs of the PyTorch/CUDA port
(models/batched_solve.py) against ``jax.vmap`` of the JAX package's
``trsm_*`` / ``trtri_*`` on the same numpy inputs, on the CPU, and element by
element against the port's single-matrix calls.  ``trsm_base`` and
``trsm_wide_base`` are shrunk in the port's config (the ``config_fields``
fixture), so the batched recursion runs several levels: substitution to the base
for a narrow B, to the wide base and then the inverse for a wide one.  The
solutions are unique, so the JAX package's own bases give the same words.
Junk lies in the other triangle of every T.  Tolerance 0."""

import numpy as np
import pytest
import torch

import jax

import m4ri_tpu_torch as mt
from m4ri_tpu.core.bitmatrix import BitMatrix as JBitMatrix
from m4ri_tpu.models import triangular as jtri

import oracle
from conftest import random_dense
from test_trsm import unit_upper
from torch_port import (Waits, config_fields, same,  # noqa: F401 (a fixture)
                        stacks, with_bit31)

LEFT = ("trsm_upper_left", "trsm_lower_left")
RIGHT = ("trsm_upper_right", "trsm_lower_right")


@pytest.fixture
def small_bases(config_fields):
    """trsm_base 64 and trsm_wide_base 128 in the port's config."""
    config_fields(trsm_base=64, trsm_wide_base=128)


def triangles(rng, name, B, n):
    """B unit triangular n x n of the variant's kind, junk (with every
    sign bit set) in the other triangle; element 1 is the identity."""
    ts = []
    for i in range(B):
        u = unit_upper(rng, n) if i != 1 else np.eye(n, dtype=np.uint8)
        u = u | np.tril(with_bit31(rng, n, n), -1)
        ts.append(u if "upper" in name else u.T.copy())
    return np.stack(ts)


def clean(t, name):
    return np.triu(t) if "upper" in name else np.tril(t)


@pytest.mark.parametrize("name", LEFT + RIGHT)
@pytest.mark.parametrize("n,other", [(130, 5), (130, 130), (200, 40),
                                     (64, 64)])
def test_trsm_batched_equals_jax_vmap(rng, small_bases, name, n, other):
    B = 3
    ts = triangles(rng, name, B, n)
    shape = (n, other) if name in LEFT else (other, n)
    bs = np.stack([with_bit31(rng, *shape) for _ in range(B)])
    bs[2] = 0                                     # a zero right-hand side
    (jt, tt), (jb, tb) = stacks(ts), stacks(bs)
    bcols = shape[1]
    want = jax.vmap(lambda t, b: getattr(jtri, name)(
        JBitMatrix(t, n), JBitMatrix(b, bcols)).data)(jt, jb)
    got = getattr(mt, f"{name}_batched")(tt, tb, bcols)
    same(want, got, name)
    for i in range(B):
        single = getattr(mt, name)(mt.BitMatrix(tt[i], n),
                                   mt.BitMatrix(tb[i], bcols))
        assert torch.equal(got[i], single.data), (name, i)
        x = mt.to_numpy(mt.BitMatrix(got[i], bcols))
        t = clean(ts[i], name)
        prod = oracle.mul(t, x) if name in LEFT else oracle.mul(x, t)
        np.testing.assert_array_equal(prod, bs[i])


@pytest.mark.parametrize("upper", [True, False])
@pytest.mark.parametrize("n", [64, 150, 300])
def test_trtri_batched_equals_jax_vmap(rng, small_bases, upper, n):
    name = "trtri_upper" if upper else "trtri_lower"
    ts = triangles(rng, "upper" if upper else "lower", 3, n)
    jt, tt = stacks(ts)
    want = jax.vmap(lambda t: getattr(jtri, name)(JBitMatrix(t, n)).data)(jt)
    got = getattr(mt, f"{name}_batched")(tt)
    same(want, got, name)
    for i in range(3):
        assert torch.equal(got[i], getattr(mt, name)(
            mt.BitMatrix(tt[i], n)).data)
        np.testing.assert_array_equal(
            oracle.mul(clean(ts[i], "upper" if upper else "lower"),
                       mt.to_numpy(mt.BitMatrix(got[i], n))),
            np.eye(n, dtype=np.uint8))


def test_trsm_batched_reads_nothing_back(rng, small_bases):
    """The recursion runs on static shapes: no operator that would make the
    host wait for a card."""
    up = stacks(triangles(rng, "upper", 2, 200))[1]
    lo = stacks(triangles(rng, "lower", 2, 200))[1]
    left = stacks(np.stack([random_dense(rng, 200, 40)] * 2))[1]
    right = stacks(np.stack([random_dense(rng, 40, 200)] * 2))[1]
    with Waits() as waits:
        mt.trsm_upper_left_batched(up, left, 40)
        mt.trsm_lower_right_batched(lo, right, 200)
        mt.trtri_lower_batched(lo)
    assert waits.n == 0


def test_trsm_batched_operand_checks():
    t = torch.zeros((2, 40, 2), dtype=torch.int32)
    with pytest.raises(ValueError):          # 40 columns of b want 2 words
        mt.trsm_upper_left_batched(t, torch.zeros((2, 40, 1),
                                                  dtype=torch.int32), 40)
    with pytest.raises(ValueError):          # right: b's columns must be n
        mt.trsm_upper_right_batched(t, torch.zeros((2, 5, 1),
                                                   dtype=torch.int32), 30)
    with pytest.raises(ValueError):          # batches differ
        mt.trsm_lower_left_batched(t, torch.zeros((3, 40, 1),
                                                  dtype=torch.int32), 3)
    with pytest.raises(ValueError):          # not square
        mt.trtri_upper_batched(torch.zeros((2, 40, 1), dtype=torch.int32))

"""DJB linear maps of the PyTorch/CUDA port against the JAX package
(mirrors test_djb.py): ``djb_compile`` must give the JAX package's program
itself (target, source and source type of every instruction, also where a
word has bit 31 set, the sign bit of the port's int32 words), and
``djb_apply`` the same packed words (tolerance 0)."""

import numpy as np
import pytest

import m4ri_tpu_torch as mt
from m4ri_tpu.models import djb as jdjb

import oracle
from conftest import random_dense
from torch_port import assert_padding_zero, assert_same, both, with_bit31


def _program(p):
    return p.nrows, p.ncols, p.target, p.source, p.srctyp


@pytest.mark.parametrize("m,n,bit31", [(8, 8, False), (32, 17, False),
                                       (64, 64, True), (100, 130, False),
                                       (100, 130, True), (1, 40, True),
                                       (40, 1, False)])
def test_djb_program_and_result_equal_jax(rng, m, n, bit31):
    a = with_bit31(rng, m, n) if bit31 else random_dense(rng, m, n)
    v = random_dense(rng, n, 40)
    (Aj, At), (Vj, Vt) = both(a), both(v)
    pj, pt = jdjb.djb_compile(Aj), mt.djb_compile(At)
    assert _program(pj) == _program(pt)
    Wt = mt.djb_apply(pt, Vt)
    assert_same(jdjb.djb_apply(pj, Vj), Wt)
    assert_padding_zero(Wt)
    np.testing.assert_array_equal(mt.to_numpy(Wt), oracle.mul(a, v))


def test_djb_op_count(rng):
    """The whole point: fewer XORs than the dense m*n bound, as many as the
    JAX package's program has."""
    a = random_dense(rng, 128, 128)
    (Aj, At) = both(a)
    prog = mt.djb_compile(At)
    assert prog.length == jdjb.djb_compile(Aj).length
    assert prog.length < int(a.sum()) * 0.75


@pytest.mark.parametrize("kind", ["zero", "identity"])
def test_djb_zero_and_identity_equal_jax(kind):
    n = 6
    a = np.zeros((n, n), np.uint8) if kind == "zero" else np.eye(n, dtype=np.uint8)
    v = np.random.default_rng(0).integers(0, 2, (n, 9)).astype(np.uint8)
    (Aj, At), (Vj, Vt) = both(a), both(v)
    pj, pt = jdjb.djb_compile(Aj), mt.djb_compile(At)
    assert _program(pj) == _program(pt)
    Wt = mt.djb_apply(pt, Vt)
    assert_same(jdjb.djb_apply(pj, Vj), Wt)
    np.testing.assert_array_equal(mt.to_numpy(Wt), a @ v % 2)

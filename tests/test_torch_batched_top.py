"""``top_echelonize_batched`` and ``block_factor_batched(search_window=...)``
of the PyTorch/CUDA port (models/batched_solve.py, models/batched.py)
against ``jax.vmap`` of the JAX package's ``top_echelonize`` and
``block_factor(..., search_window=..., engine="xla")`` on the same numpy
inputs, on the CPU; element by element against the port's single-matrix
calls, the bit-faithful model of ``_mzd_top_echelonize_m4ri``
(tests/ref_top_model.py) and the unique RREF.  The contract inputs are the
echelon forms of tests/test_elimination.py; one batch lies off the contract
(pivots pushed below the window).  Under a search window the sweep reads
nothing back: ``Waits`` and the counter ``readback.block_factor_batched``
count 0.  Equality of packed words, P, Q and ranks: tolerance 0."""

import numpy as np
import pytest
import torch

import m4ri_tpu as mj
import m4ri_tpu_torch as mt
from m4ri_tpu.core.bitmatrix import BitMatrix as JBitMatrix
from m4ri_tpu.models import echelon as jech, ple as jple
from m4ri_tpu_torch.models import batched
from m4ri_tpu_torch.utils.graycode import opt_k
from m4ri_tpu_torch.utils.spans import counts

import oracle
from conftest import random_dense
from ref_top_model import top_echelonize_model
from torch_port import Waits, cpu, jvmap, same, stacks


def _syncs_and_fallbacks():
    now = counts()
    return (now.get("readback.block_factor_batched", 0),
            now.get("fallback.block_factor_batched", 0))


def _ref(rng, m, n, d):
    """A random m x n matrix of density d brought to (unreduced) REF."""
    a = (rng.random((m, n)) < d).astype(np.uint8)
    return mj.to_numpy(jech.echelonize(mj.from_numpy(a), full=False)[0])


def _gaps(rng):
    """Pivot-column gaps far wider than 6k: the reference's kbar == 0 skip,
    round after round (tests/test_elimination.py)."""
    g = np.zeros((8, 120), np.uint8)
    for i, c in enumerate([0, 29, 30, 61, 93, 94, 95, 119]):
        g[i, c] = 1
        g[i, c + 1:] = rng.random(119 - c) < 0.5
    return g


# the contract inputs of tests/test_elimination.py:96, a batch each, with a
# zero element beside them
CONTRACT = {
    "ref_40x60": lambda rng: [_ref(rng, 40, 60, 0.5), _ref(rng, 40, 60, 0.2),
                              np.zeros((40, 60), np.uint8)],
    "ref_70x50": lambda rng: [_ref(rng, 70, 50, 0.2), _ref(rng, 70, 50, 0.5)],
    "ref_64x64": lambda rng: [_ref(rng, 64, 64, 0.05), _ref(rng, 64, 64, 0.5),
                              np.eye(64, dtype=np.uint8)],
    "gaps_8x120": lambda rng: [_gaps(rng), _gaps(rng),
                               np.zeros((8, 120), np.uint8)],
    "deficient_50x40": lambda rng: [_ref(rng, 50, 40, 0.3),
                                    _ref(rng, 50, 40, 0.05)],
}


@pytest.mark.parametrize("k", [0, 1, 2, 4])
@pytest.mark.parametrize("case", list(CONTRACT))
def test_top_echelonize_batched_on_contract_inputs(rng, case, k):
    mats = np.stack(CONTRACT[case](rng))
    _, m, n = mats.shape
    jx, tx = stacks(mats)
    want = jvmap(lambda d: jech.top_echelonize(JBitMatrix(d, n), k=k), jx)
    s0 = counts().get("readback.block_factor_batched", 0)
    with Waits() as waits:
        got = mt.top_echelonize_batched(tx, n, k=k)
    assert waits.n == 0 and counts().get("readback.block_factor_batched", 0) == s0
    same(want[0], got[0], f"{case} k={k}: E")
    same(want[1], got[1], f"{case} k={k}: r")
    assert got[1].dtype == torch.int32 and got[1].shape == (len(mats),)
    kk = k or min(opt_k(m, n), 7)
    for i, a in enumerate(mats):
        e, r = mt.top_echelonize(cpu(a), k=k)
        assert torch.equal(got[0][i], e.data) and int(got[1][i]) == r
        model, rm = top_echelonize_model(a, kk)
        np.testing.assert_array_equal(mt.to_numpy(e), model)
        np.testing.assert_array_equal(model, oracle.rref(a))
        assert r == rm == oracle.rank(a)


def test_top_echelonize_batched_out_of_contract(rng):
    """The 48 x 48 case of tests/test_elimination.py:127 (the early pivots
    pushed below a window of 6) and two like it: the batch keeps the JAX
    package's divergence from the reference model, element by element the
    port's single call, and every rank at least the model's."""
    mats = []
    for band in (20, 12, 30):
        a = (rng.random((48, 48)) < 0.15).astype(np.uint8)
        a[:band, :10] = 0
        mats.append(a)
    mats = np.stack(mats)
    jx, tx = stacks(mats)
    want = jvmap(lambda d: jech.top_echelonize(JBitMatrix(d, 48), k=1), jx)
    with Waits() as waits:
        got = mt.top_echelonize_batched(tx, 48, k=1)
    assert waits.n == 0
    same(want[0], got[0], "E")
    same(want[1], got[1], "r")
    for i, a in enumerate(mats):
        e, r = mt.top_echelonize(cpu(a), k=1)
        assert torch.equal(got[0][i], e.data) and int(got[1][i]) == r
        assert r >= top_echelonize_model(a, 1)[1]


def _sweep_inputs(rng):
    """Five panels of 32 columns: a dense element, a rank-deficient one, a
    zero one and one whose top band is zero (below-window ones that the
    miss check would flag without a search window)."""
    mats = np.stack([random_dense(rng, 100, 150),
                     oracle.mul(random_dense(rng, 100, 30),
                                random_dense(rng, 30, 150)),
                     np.zeros((100, 150), np.uint8),
                     random_dense(rng, 100, 150, 0.3)])
    mats[3, :50, :40] = 0
    return mats


@pytest.mark.parametrize("preserve_l", [False, True])
@pytest.mark.parametrize("search_window", [6, 12, 42])
def test_block_factor_batched_search_window_equals_jax_vmap(rng, search_window,
                                                            preserve_l):
    mats = _sweep_inputs(rng)
    n = mats.shape[2]
    jx, tx = stacks(mats)
    want = jvmap(lambda d: jple.block_factor(
        JBitMatrix(d, n), preserve_l, nb=32, search_window=search_window,
        engine="xla"), jx)
    fn = batched.block_factor_batched
    for engine in ("plain", "hopper"):     # the wrappers' plain versions here
        s0, f0 = _syncs_and_fallbacks()
        with Waits() as waits:
            got = fn(tx, n, preserve_l, nb=32, search_window=search_window,
                     engine=engine)
        assert waits.n == 0
        assert _syncs_and_fallbacks() == (s0, f0)
        for w, g, part in zip(want, got, ("data", "P", "Q", "r")):
            same(w, g, f"sw={search_window} {engine}: {part}")
    for i, a in enumerate(mats):
        single = mt.block_factor(cpu(a), preserve_l, nb=32,
                                 search_window=search_window)
        for g, s in zip(got[:3], single[:3]):
            assert torch.equal(g[i], s)
        assert int(got[3][i]) == single[3]

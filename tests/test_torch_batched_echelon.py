"""``ple_batched`` / ``pluq_batched`` (models/batched.py) and
``echelonize_batched`` by both strategies (models/batched_solve.py) of the
PyTorch/CUDA port against ``jax.vmap`` of the JAX package's ``ple``,
``pluq`` and ``echelonize`` on the same numpy inputs, on the CPU, and
element by element against the port's single-matrix calls and the RREF and
rank of a sequential oracle.  The batches (torch_port.CASES) hold a zero
element and a rank-deficient one, and one case misses its windows (the
full-height fallback).  Equality of packed words, P, Q and ranks:
tolerance 0.  (The solves, kernels and inversions:
test_torch_batched_solve.py; the TRSMs: test_torch_batched_trsm.py.)"""

import numpy as np
import pytest
import torch

import m4ri_tpu_torch as mt
from m4ri_tpu.core.bitmatrix import BitMatrix as JBitMatrix
from m4ri_tpu.models import echelon as jech, ple as jple
from m4ri_tpu_torch.utils.spans import counts

import oracle
from torch_port import CASES, NB, cpu, jvmap, same, stacks


@pytest.mark.parametrize("op", ["ple", "pluq"])
@pytest.mark.parametrize("case", list(CASES))
def test_ple_pluq_batched_equals_jax_vmap(rng, case, op):
    mats = CASES[case](rng)
    n = mats.shape[2]
    jx, tx = stacks(mats)
    nb = NB.get(case)
    want = jvmap(lambda d: getattr(jple, op)(JBitMatrix(d, n), nb=nb), jx)
    f0 = counts().get("fallback.block_factor_batched", 0)
    got = getattr(mt, f"{op}_batched")(tx, n, nb=nb)
    missed = counts().get("fallback.block_factor_batched", 0) > f0
    assert missed == (case == "misses")
    for w, g, part in zip(want, got, ("M", "P", "Q", "r")):
        same(w, g, f"{case} {op}: {part}")
    assert got[3].dtype == torch.int32 and got[3].shape == (len(mats),)
    for i, a in enumerate(mats):
        m, p, q, r = getattr(mt, op)(cpu(a), nb=nb)
        assert torch.equal(got[0][i], m.data) and torch.equal(got[1][i], p)
        assert torch.equal(got[2][i], q) and int(got[3][i]) == r
        assert r == oracle.rank(a)


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("strategy", ["m4ri", "pluq"])
@pytest.mark.parametrize("case", list(CASES))
def test_echelonize_batched_equals_jax_vmap(rng, case, strategy, full):
    mats = CASES[case](rng)
    n = mats.shape[2]
    jx, tx = stacks(mats)
    nb = NB.get(case)
    want = jvmap(lambda d: jech.echelonize(JBitMatrix(d, n), full=full,
                                           nb=nb, strategy=strategy), jx)
    got = mt.echelonize_batched(tx, n, full=full, nb=nb, strategy=strategy)
    same(want[0], got[0], f"{case} {strategy} full={full}: E")
    same(want[1], got[1], "r")
    for i, a in enumerate(mats):
        e, r = mt.echelonize(cpu(a), full=full, nb=nb, strategy=strategy)
        assert torch.equal(got[0][i], e.data) and int(got[1][i]) == r
        if full:
            np.testing.assert_array_equal(mt.to_numpy(e), oracle.rref(a))

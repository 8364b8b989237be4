"""The batched API of the PyTorch/CUDA port (models/batched.py) against the
JAX package's ``jax.vmap`` of the functions tests/test_vmap.py batches:
``mul_packed_data(..., allow_pallas=False)`` and ``block_factor(...,
engine="xla")``, on the same numpy inputs, on the CPU.  Every element also
equals the port's own single-matrix call.  The sweep reads back from the
device once a panel for the whole batch (the counter
``readback.block_factor_batched``).  Equality of packed words, P, Q and rank:
tolerance 0."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import m4ri_tpu as mj
import m4ri_tpu_torch as mt
from m4ri_tpu.core.bitmatrix import BitMatrix as JBitMatrix
from m4ri_tpu.models.ple import block_factor as jblock_factor
from m4ri_tpu.ops.mul import mul_packed_data as jmul_packed_data
from m4ri_tpu_torch.models.batched import (block_factor_batched,
                                           mul_packed_batched, rank_batched)
from m4ri_tpu_torch.ops.mul import mul_packed_data

import oracle
from conftest import random_dense
from m4ri_tpu_torch.utils.spans import counts
from torch_port import words


def _batch(mats):
    """numpy 0/1 [B, m, n] -> (JAX packed stack, port packed stack on the
    CPU)."""
    jx = jnp.stack([mj.from_numpy(x).data for x in mats])
    tx = torch.stack([mt.from_numpy(x, device="cpu").data for x in mats])
    return jx, tx


def _same(want, got, what):
    np.testing.assert_array_equal(np.asarray(want).view(np.uint32)
                                  if np.asarray(want).dtype == np.int32
                                  else np.asarray(want), words(got),
                                  err_msg=what)


@pytest.mark.parametrize("b,m,k,n", [(5, 96, 130, 64),     # test_vmap_mul's
                                     (3, 40, 1100, 50),    # past one KW_MAX
                                     (2, 1, 1, 1)])
def test_mul_batched_equals_jax_vmap(rng, b, m, k, n):
    amats = np.stack([random_dense(rng, m, k) for _ in range(b)])
    bmats = np.stack([random_dense(rng, k, n) for _ in range(b)])
    (ja, ta), (jb, tb) = _batch(amats), _batch(bmats)
    want = jax.vmap(lambda x, y: jmul_packed_data(x, y, allow_pallas=False))(
        ja, jb)
    for allow in (True, False):
        got = mul_packed_batched(ta, tb, allow_kernel=allow)
        assert got.shape == (b, m, -(-n // 32)) and got.dtype == torch.int32
        _same(want, got, f"allow_kernel={allow}")
    for i in range(b):
        assert torch.equal(got[i], mul_packed_data(ta[i], tb[i]))
        np.testing.assert_array_equal(
            mt.to_numpy(mt.BitMatrix(got[i], n)),
            oracle.mul(amats[i], bmats[i]), err_msg=f"element {i}")


def test_torch_vmap_of_the_port_equals_jax_vmap(rng):
    """test_vmap_mul literally: torch.vmap over the port's plain product."""
    b, m, k, n = 5, 96, 130, 64
    amats = np.stack([random_dense(rng, m, k) for _ in range(b)])
    bmats = np.stack([random_dense(rng, k, n) for _ in range(b)])
    (ja, ta), (jb, tb) = _batch(amats), _batch(bmats)
    want = jax.vmap(lambda x, y: jmul_packed_data(x, y, allow_pallas=False))(
        ja, jb)
    got = torch.vmap(lambda x, y: mul_packed_data(x, y, allow_kernel=False))(
        ta, tb)
    _same(want, got, "torch.vmap")
    _same(want, mul_packed_batched(ta, tb), "mul_packed_batched")


def _vmap_rank_case(rng):
    """test_vmap_rank's batch: 4 x 120x90 with a zero matrix."""
    mats = np.stack([random_dense(rng, 120, 90) for _ in range(4)])
    mats[1][:] = 0
    return mats, {}


def _mixed_ranks(rng):
    """Products of known ranks 0..90 side by side, and one full rank."""
    mats = [oracle.mul(random_dense(rng, 100, k), random_dense(rng, k, 80))
            if k else np.zeros((100, 80), np.uint8) for k in (0, 7, 33, 60)]
    mats.append(random_dense(rng, 100, 80))
    return np.stack(mats), {}


def _one_misses(rng):
    """A zeroed band in element 1 only, with a narrow panel and window: its
    window goes deficient and the panel is redone at full height, the
    others' windows do not miss."""
    mats = np.stack([random_dense(rng, 200, 150) for _ in range(3)])
    mats[1, 20:150] = 0
    return mats, {"nb": 64, "window": 70}


CASES = {"vmap_rank": _vmap_rank_case, "mixed_ranks": _mixed_ranks,
         "one_misses": _one_misses}


@pytest.mark.parametrize("preserve_l", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_block_factor_batched_equals_jax_vmap(rng, case, preserve_l):
    mats, kw = CASES[case](rng)
    n = mats.shape[2]
    jx, tx = _batch(mats)
    want = jax.vmap(lambda d: jblock_factor(JBitMatrix(d, n), preserve_l,
                                            engine="xla", **kw))(jx)
    s0 = counts().get("fallback.block_factor_batched", 0)
    for engine in ("plain", "hopper"):     # the wrappers' plain versions here
        got = block_factor_batched(tx, n, preserve_l, engine=engine, **kw)
        for w, g, part in zip(want, got, ("data", "P", "Q", "r")):
            _same(w, g, f"{case} {engine}: {part}")
        assert got[3].dtype == torch.int32 and got[3].shape == (len(mats),)
    for i in range(len(mats)):
        single = mt.block_factor(mt.from_numpy(mats[i], device="cpu"),
                                 preserve_l, **kw)
        assert torch.equal(got[0][i], single[0])
        assert torch.equal(got[1][i], single[1])
        assert torch.equal(got[2][i], single[2])
        assert int(got[3][i]) == single[3] == oracle.rank(mats[i])
    if case == "one_misses":
        assert counts().get("fallback.block_factor_batched", 0) > s0


def test_rank_batched_as_test_vmap_rank(rng):
    mats, _ = _vmap_rank_case(rng)
    ranks = rank_batched(_batch(mats)[1], 90)
    assert ranks.tolist() == [oracle.rank(x) for x in mats]
    assert ranks[1] == 0


def _panels(m, n, nb=None, window=None):
    from m4ri_tpu_torch.models.ple import panel_widths
    return -(-n // panel_widths(m, n, nb, window)[0])


def test_one_read_back_a_panel_without_a_miss(rng):
    """A batch whose windows never miss reads back once a panel, whatever
    the batch size, and redoes nothing."""
    mats = np.stack([random_dense(rng, 100, 200) for _ in range(6)])
    tx = _batch(mats)[1]
    s0, f0 = counts().get("readback.block_factor_batched", 0), counts().get("fallback.block_factor_batched", 0)
    block_factor_batched(tx, 200, True, nb=32)
    assert counts().get("readback.block_factor_batched", 0) - s0 == _panels(100, 200, 32) == 7
    assert counts().get("fallback.block_factor_batched", 0) == f0


def test_a_miss_costs_one_more_read_back(rng):
    """On a panel where some element missed: one more read-back for all of
    them, and each missed element redone once; never more."""
    mats, kw = _one_misses(rng)
    mats = np.concatenate([mats, mats[1:2]])    # two elements miss alike
    tx = _batch(mats)[1]
    s0, f0 = counts().get("readback.block_factor_batched", 0), counts().get("fallback.block_factor_batched", 0)
    block_factor_batched(tx, 150, False, **kw)
    syncs = counts().get("readback.block_factor_batched", 0) - s0
    misses = counts().get("fallback.block_factor_batched", 0) - f0
    panels = _panels(200, 150, **kw)
    assert misses > 0 and misses % 2 == 0
    assert panels < syncs <= panels + misses // 2


def test_errors():
    good = torch.zeros((2, 4, 1), dtype=torch.int32)
    with pytest.raises(TypeError):
        block_factor_batched(good[0], 32, False)
    with pytest.raises(ValueError):
        block_factor_batched(good, 64, False)      # 64 columns want 2 words
    with pytest.raises(ValueError):
        mul_packed_batched(good, torch.zeros((3, 4, 1), dtype=torch.int32))
    with pytest.raises(ValueError):
        mul_packed_batched(good, torch.zeros((2, 40, 1), dtype=torch.int32))
    with pytest.raises(ValueError):
        block_factor_batched(good, 32, False, engine="xla")


def test_empty_batch_and_empty_matrices():
    for shape, n in (((0, 5, 1), 20), ((3, 0, 1), 20), ((2, 5, 0), 0)):
        d, p, q, r = block_factor_batched(
            torch.zeros(shape, dtype=torch.int32), n, True)
        assert d.shape == shape and r.tolist() == [0] * shape[0]
        assert p.shape == shape[:2] and q.shape == (shape[0], n)

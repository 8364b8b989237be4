"""The schedules of the batched kernels 4b and 6b, and the batched plain
version of 6b against ``jax.vmap`` of the JAX package's ``panel_post``.

The kernels run only on the card (``tests/test_torch_cuda.py``); here their
walks, written out in numpy beside the wrappers, are held against a direct
enumeration of the work, and the batched elimination's plain version
against the reference on a batch that mixes elements with and without rows
in range.  GF(2) is exact: tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import m4ri_tpu_torch as mt
from m4ri_tpu.ops.pallas_post import panel_post
from m4ri_tpu_torch.ops import hopper_post, hopper_schur
from m4ri_tpu_torch.ops.hopper_post import (panel_post_batched_plain,
                                            panel_post_hopper_batched,
                                            post_pack_schedule_plain,
                                            post_schedule_batched_plain)

from conftest import random_dense
from torch_port import assert_same

_ROWS = 128     # the MMA tile of the elimination (BM of csrc/gf2_tile.cuh)


def _in_range(m, mvalid, below0):
    """The rows of [below0, mvalid) that exist, enumerated."""
    return [r for r in range(m) if below0 <= r < mvalid]


@settings(max_examples=200, deadline=None)
@given(m=st.integers(1, 1300), mvalid=st.integers(-5, 1400),
       below0s=st.lists(st.integers(-300, 1500), min_size=1, max_size=9),
       blocks=st.integers(1, 40))
def test_post_schedule_takes_every_in_range_tile_once(m, mvalid, below0s,
                                                      blocks):
    """The MMA grid of 6b: each 128-row tile that holds a row in range,
    once, and no other; items dealt round the blocks."""
    runs = post_schedule_batched_plain(m, below0s, mvalid, blocks)
    assert len(runs) == blocks
    taken = [tuple(t) for run in runs for t in run.tolist()]
    assert len(taken) == len(set(taken))
    want = {(e, r // _ROWS) for e, b0 in enumerate(below0s)
            for r in _in_range(m, mvalid, b0)}
    assert set(taken) == want
    sizes = [len(run) for run in runs]
    assert max(sizes) - min(sizes) <= 1


@settings(max_examples=200, deadline=None)
@given(m=st.integers(1, 1300), mvalid=st.integers(-5, 1400),
       below0s=st.lists(st.integers(-300, 1500), min_size=1, max_size=9))
def test_in_range_tile_counts_and_skipped_elements(m, mvalid, below0s):
    """Each element's count of in-range tiles; 0 exactly where no row is in
    range, the elements whose operands the pack never reads."""
    got = hopper_post._in_range_tiles(torch.tensor(below0s), m, mvalid)
    for e, b0 in enumerate(below0s):
        rows = _in_range(m, mvalid, b0)
        assert int(got[e]) == len({r // _ROWS for r in rows})
        assert (int(got[e]) == 0) == (not rows)


@pytest.mark.parametrize("B,nb,warps", [(7, 64, 3), (5, 512, 40), (3, 96, 1),
                                        (40, 32, 17), (2, 1024, 250)])
def test_pack_schedule_packs_each_unit_of_live_elements_once(B, nb, warps):
    """The packing kernel's walk: every (plane, strip, word group) of every
    element with a row in range, once; nothing of the others."""
    m, mvalid = 700, 600
    below0s = [(97 * e) % 800 for e in range(B)]
    below0s[0] = mvalid                      # nothing in range
    runs = post_pack_schedule_plain(B, nb, below0s, m, mvalid, warps)
    assert len(runs) == warps
    taken = [tuple(t) for run in runs for t in run.tolist()]
    assert len(taken) == len(set(taken))
    groups = -(-(nb // 32) // 4)
    want = {(e, z, s, g) for e, b0 in enumerate(below0s)
            if _in_range(m, mvalid, b0)
            for z in (0, 1) for s in range(nb // 32) for g in range(groups)}
    assert set(taken) == want


def test_pack_schedule_of_a_nist_batch_packs_nothing():
    """2^12 panels of 32 x 32 with below0 = mvalid: no unit is packed."""
    runs = post_pack_schedule_plain(1 << 12, 32, [32] * (1 << 12), 256, 32, 64)
    assert sum(len(r) for r in runs) == 0


@pytest.mark.parametrize("m,nb,mvalid,below0s", [
    (512, 64, 500, [0, 192, 130, 499, 500, 511]),   # in range, off the tiles
    (256, 32, 200, [200, 256, 0, 31, 199]),         # some with nothing in range
    (512, 128, 384, [384, 384, 400]),               # none in range
])
def test_batched_post_plain_equals_jax_vmap(rng, m, nb, mvalid, below0s):
    """panel_post_batched_plain and the wrapper on CPU tensors against
    jax.vmap of the JAX package's panel_post in interpret mode; elements
    with and without rows in range in one batch."""
    B = len(below0s)
    x = np.stack([random_dense(rng, m, nb) for _ in range(B)])
    x[:, :, 31::32] = 1
    msm = (rng.random((B, nb, nb)) < 0.5).astype(np.int8)
    wm = (rng.random((B, nb, nb)) < 0.5).astype(np.int8)
    cmb = (rng.random((B, nb)) < 0.3).astype(np.int8)
    xw = np.stack([np.asarray(mt.from_numpy(x[b], device="cpu").data)
                   for b in range(B)])
    b0 = np.asarray(below0s, np.int32)
    want = jax.vmap(lambda xe, me, we, ce, be: panel_post(
        xe, me, we, ce, be, mvalid, interpret=True))(
            jnp.asarray(xw.view(np.uint32)), jnp.asarray(msm), jnp.asarray(wm),
            jnp.asarray(cmb), jnp.asarray(b0))
    args = (torch.from_numpy(xw), torch.from_numpy(msm), torch.from_numpy(wm),
            torch.from_numpy(cmb), torch.from_numpy(b0), mvalid)
    for fn in (panel_post_batched_plain, panel_post_hopper_batched):
        vw, lamw, miss = fn(*args)
        assert_same(want[0], vw, "v")
        assert_same(want[1], lamw, "lam")
        assert miss.tolist() == np.asarray(want[2]).tolist()
        out = b0 >= mvalid
        assert not miss.numpy()[out].any()
        assert not lamw.numpy()[out].any()
        assert np.array_equal(vw.numpy()[out], xw[out])


@pytest.mark.parametrize("m,nw,c0w,r0s", [
    (768, 112, 21, [0, 1, 255, 256, 511, 512, 767, 768, 5000, -3]),
    (300, 37, 9, [0, 257, 300]),
])
def test_batched_schur_prefix_sum_counts_the_active_tiles(m, nw, c0w, r0s):
    """The prefix sum 4b's launch makes on the card, in plain PyTorch: its
    steps are each element's active tiles, enumerated."""
    cum = hopper_schur._batched_cum(m, nw, torch.tensor(r0s), c0w, len(r0s),
                                    "cpu")
    tiles_i = -(-m // 256)
    n_j = -(-nw // 8) - c0w // 8
    steps = np.diff(cum.numpy(), prepend=0)
    for e, r0 in enumerate(r0s):
        # the row tiles not wholly above r0 (under the contract a tile
        # whose rows all lie at or past m changes nothing)
        tiles = [i for i in range(tiles_i) if 256 * (i + 1) > max(r0, 0)]
        assert steps[e] == len(tiles) * n_j

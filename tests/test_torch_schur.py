"""The Schur update's schedule and wrapper on the CPU.

``schur_schedule_plain`` is the persistent kernel's partition of the active
rectangle among its blocks, in numpy: every active tile is taken exactly
once and no finished tile at all, ragged edges included, and with int
bounds the grid the wrapper launches gives every block a tile.  The wrapper
takes its bounds as ints or one-value tensors and splits a deep contraction
into launches; on the CPU it runs the plain version, so the results are
held to a host product.  Tolerance 0: GF(2) is exact.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import m4ri_tpu_torch as mt
from m4ri_tpu_torch.ops import hopper_schur
from m4ri_tpu_torch.ops.hopper_schur import (KW_MAX, TILE_ROWS, TILE_WORDS,
                                             gf2_schur_update_dyn_hopper,
                                             gf2_schur_update_hopper,
                                             grid_blocks, schur_schedule_plain)

import oracle
from conftest import random_dense


def _active(m, nw, r0, c0w, skip):
    """The tiles whose words the kernel may change, by definition: not
    wholly above r0, not wholly left of c0w, not among the skipped ones."""
    tiles_i, tiles_j = -(-m // TILE_ROWS), -(-nw // TILE_WORDS)
    return {(i, j) for i in range(tiles_i) for j in range(tiles_j)
            if (i + 1) * TILE_ROWS > r0 and (j + 1) * TILE_WORDS > c0w
            and j >= skip}


@settings(max_examples=300, deadline=None)
@given(m=st.integers(1, 3000), nw=st.integers(1, 300),
       r0=st.integers(-5, 3100), c0w=st.integers(-5, 320),
       skip=st.integers(0, 40), blocks=st.integers(1, 300))
def test_schedule_takes_every_active_tile_once(m, nw, r0, c0w, skip, blocks):
    tiles_j = -(-nw // TILE_WORDS)
    skip = min(skip, tiles_j - 1, max(c0w, 0) // TILE_WORDS)
    runs = schur_schedule_plain(m, nw, r0, c0w, skip, blocks)
    assert len(runs) == blocks
    taken = [tuple(t) for run in runs for t in run.tolist()]
    assert len(taken) == len(set(taken))                  # at most once
    assert set(taken) == _active(m, nw, r0, c0w, skip)    # all, and no other
    sizes = [len(run) for run in runs]
    assert max(sizes) - min(sizes) <= 1                   # balanced
    for run in runs:                                      # row-major runs
        flat = [i * 10**6 + j for i, j in run.tolist()]
        assert flat == sorted(flat)


@settings(max_examples=200, deadline=None)
@given(m=st.integers(1, 3000), nw=st.integers(1, 300),
       r0=st.integers(0, 3100), c0w=st.integers(0, 320),
       capacity=st.integers(1, 400))
def test_int_bounds_launch_no_block_without_a_tile(m, nw, r0, c0w, capacity):
    blocks = grid_blocks(m, nw, r0, c0w, 0, False, capacity)
    assert blocks <= capacity
    if not _active(m, nw, r0, c0w, 0):
        assert blocks == 0                                # nothing launched
        return
    assert all(len(run) for run in
               schur_schedule_plain(m, nw, r0, c0w, 0, blocks))


@pytest.mark.parametrize("r0,c0w", [(0, 0), (300, 17), (1024, 128), (5000, 9)])
def test_persistent_grid_does_not_depend_on_the_bounds(r0, c0w):
    m, nw = 1024, 128
    assert grid_blocks(m, nw, r0, c0w, 0, True, 10**6) == \
        (m // TILE_ROWS) * (nw // TILE_WORDS)
    # bounds read on the card: the static entry sizes from what it knows
    assert grid_blocks(m, nw, None, c0w, 3, False, 10**6) == \
        (m // TILE_ROWS) * (nw // TILE_WORDS - max(c0w // TILE_WORDS, 3))


def _operands(rng, m, k, n, r0, c0):
    c, lp, up = (random_dense(rng, m, n), random_dense(rng, m, k),
                 random_dense(rng, k, n))
    lp[:r0] = 0
    up[:, :c0] = 0
    return c, lp, up


def _cpu(x):
    return mt.from_numpy(x, device="cpu").data


@pytest.mark.parametrize("kind", ["int", "0-d", "1-element", "int64"])
@pytest.mark.parametrize("entry", ["static", "dyn"])
def test_bounds_as_ints_and_tensors(rng, kind, entry):
    m, k, nw = 2 * TILE_ROWS, 96, 3 * TILE_WORDS
    r0, c0w = 70, 9
    c, lp, up = _operands(rng, m, k, nw * 32, r0, c0w * 32)
    as_bound = {"int": int,
                "0-d": lambda v: torch.tensor(v, dtype=torch.int32),
                "1-element": lambda v: torch.tensor([v], dtype=torch.int32),
                "int64": lambda v: torch.tensor(v)}[kind]
    Tc = _cpu(c)
    if entry == "static":
        gf2_schur_update_hopper(Tc, _cpu(lp), _cpu(up), as_bound(r0),
                                as_bound(c0w), col_tile_skip=1)
    else:
        gf2_schur_update_dyn_hopper(Tc, _cpu(lp), _cpu(up), as_bound(r0),
                                    as_bound(c0w))
    np.testing.assert_array_equal(mt.to_numpy(mt.BitMatrix(Tc, nw * 32)),
                                  c ^ oracle.mul(lp, up))


@pytest.mark.parametrize("k", [1, 150, 1024, 1025, 2048, 2100])
def test_a_deep_contraction_is_split_into_launches(rng, k):
    """The launches' slices of the contraction, each at most KW_MAX words,
    XOR to the whole product."""
    m, n = 40, 70
    kw = -(-k // 32) + 2                                  # lp wider than up
    lp, up = random_dense(rng, m, kw * 32), random_dense(rng, k, n)
    Tl, Tu = _cpu(lp), _cpu(up)
    acc = torch.zeros((m, -(-n // 32)), dtype=torch.int32)
    slices = list(hopper_schur._slices(Tl, Tu))
    assert len(slices) == -(-k // (32 * KW_MAX))
    for lps, ups, ks in slices:
        assert lps.shape[1] <= KW_MAX and ups.shape[0] <= 32 * KW_MAX
        assert ks == -(-ups.shape[0] // 256) and 1 <= ks <= KW_MAX // 8
        assert lps.data_ptr() >= Tl.data_ptr() and ups.is_contiguous()
        acc ^= hopper_schur.gf2_mul_plain(lps.contiguous(), ups)
    np.testing.assert_array_equal(mt.to_numpy(mt.BitMatrix(acc, n)),
                                  oracle.mul(lp[:, :k], up))


def test_col_tile_skip_limits():
    nw = 3 * TILE_WORDS + 5                               # a ragged last tile
    c = torch.zeros((TILE_ROWS, nw), dtype=torch.int32)
    lp = torch.zeros((TILE_ROWS, 1), dtype=torch.int32)
    up = torch.zeros((32, nw), dtype=torch.int32)
    for skip in (0, 1, 3):                                # up to the last tile
        gf2_schur_update_hopper(c, lp, up, 0, skip * TILE_WORDS,
                                col_tile_skip=skip)
    for skip in (-1, 4):
        with pytest.raises(ValueError):
            gf2_schur_update_hopper(c, lp, up, 0, nw, col_tile_skip=skip)
    with pytest.raises(ValueError):                       # past an int c0w
        gf2_schur_update_hopper(c, lp, up, 0, 2 * TILE_WORDS - 1,
                                col_tile_skip=2)


def test_bound_errors():
    c = torch.zeros((TILE_ROWS, TILE_WORDS), dtype=torch.int32)
    lp = torch.zeros((TILE_ROWS, 1), dtype=torch.int32)
    up = torch.zeros((32, TILE_WORDS), dtype=torch.int32)
    with pytest.raises(ValueError):
        hopper_schur._bound(torch.tensor([1, 2]), "r0", c.device)
    assert hopper_schur._bound(torch.tensor([7]), "r0", c.device) == (None, 7)
    assert hopper_schur._bound(9, "c0w", c.device) == (None, 9)
    with pytest.raises(TypeError):                        # lp of another type
        gf2_schur_update_dyn_hopper(c, lp.to(torch.int16), up, 0, 0)
    with pytest.raises(ValueError):                       # up wider than c
        gf2_schur_update_hopper(c, lp, torch.zeros((32, TILE_WORDS + 1),
                                                   dtype=torch.int32), 0, 0)
    with pytest.raises(ValueError):                       # k past lp's words
        gf2_schur_update_hopper(c, lp, torch.zeros((33, TILE_WORDS),
                                                   dtype=torch.int32), 0, 0)


# ---- the batched update ----------------------------------------------------

from m4ri_tpu_torch.ops.hopper_schur import (  # noqa: E402
    gf2_schur_update_batched_hopper, gf2_schur_update_plain,
    schur_schedule_batched_plain)


@settings(max_examples=200, deadline=None)
@given(m=st.integers(1, 2000), nw=st.integers(1, 100),
       r0s=st.lists(st.integers(-5, 2100), min_size=1, max_size=12),
       c0w=st.integers(0, 99), blocks=st.integers(1, 200))
def test_batched_schedule_takes_every_active_tile_once(m, nw, r0s, c0w, blocks):
    """Every element's active tiles once, no other, in balanced runs that
    go element after element, row-major inside an element."""
    c0w = min(c0w, -(-nw // TILE_WORDS) * TILE_WORDS - 1)
    runs = schur_schedule_batched_plain(m, nw, r0s, c0w, blocks)
    assert len(runs) == blocks
    taken = [tuple(t) for run in runs for t in run.tolist()]
    assert len(taken) == len(set(taken))
    want = {(e, i, j) for e, r0 in enumerate(r0s)
            for (i, j) in _active(m, nw, r0, c0w, 0)}
    assert set(taken) == want
    sizes = [len(run) for run in runs]
    assert max(sizes) - min(sizes) <= 1
    flat = [(e * 10**6 + i) * 10**4 + j for e, i, j in taken]
    assert flat == sorted(flat)


@pytest.mark.parametrize("k", [96, 1025, 2100])
@pytest.mark.parametrize("bound", ["int", "tensor"])
def test_batched_plain_equals_single_plain(rng, k, bound):
    """Each element as gf2_schur_update_plain takes it alone, under the
    contract of its own r0 (one of them past every row); a contraction
    deeper than one launch's.  The plain version on the stacks is the
    batched kernel's plain version."""
    B, m, nw, c0w = 4, 300, 2 * TILE_WORDS + 3, 9
    r0s = [0, 70, 300, 257]
    cs, lps, ups = [], [], []
    for r0 in r0s:
        c, lp, up = _operands(rng, m, k, nw * 32, r0, c0w * 32)
        cs.append(_cpu(c)), lps.append(_cpu(lp)), ups.append(_cpu(up))
    C, L, U = torch.stack(cs), torch.stack(lps), torch.stack(ups)
    want = [gf2_schur_update_plain(c.clone(), lp, up)
            for c, lp, up in zip(cs, lps, ups)]
    r0 = 0 if bound == "int" else torch.tensor(r0s, dtype=torch.int32)
    for fn in (gf2_schur_update_batched_hopper,
               lambda c, lp, up, *_: gf2_schur_update_plain(c, lp, up)):
        got = C.clone()
        assert fn(got, L, U, r0, c0w).data_ptr() == got.data_ptr()
        for b in range(B):
            assert torch.equal(got[b], want[b]), b


def test_batched_update_errors():
    c = torch.zeros((2, TILE_ROWS, TILE_WORDS), dtype=torch.int32)
    lp = torch.zeros((2, TILE_ROWS, 1), dtype=torch.int32)
    up = torch.zeros((2, 32, TILE_WORDS), dtype=torch.int32)
    with pytest.raises(TypeError):                        # no batch axis
        gf2_schur_update_batched_hopper(c[0], lp[0], up[0], 0, 0)
    with pytest.raises(ValueError):                       # batches differ
        gf2_schur_update_batched_hopper(c, lp[:1], up, 0, 0)
    with pytest.raises(ValueError):                       # k past lp's words
        gf2_schur_update_batched_hopper(
            c, lp, torch.zeros((2, 33, TILE_WORDS), dtype=torch.int32), 0, 0)
    with pytest.raises(ValueError):                       # one r0 an element
        gf2_schur_update_batched_hopper(c, lp, up, torch.zeros(3), 0)
    with pytest.raises(TypeError):                        # c0w is an int
        gf2_schur_update_batched_hopper(c, lp, up, 0, torch.tensor(0))

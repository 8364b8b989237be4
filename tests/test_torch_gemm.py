"""The GF(2) GEMM's schedule and host path on the CPU.

``gemm_plan`` decides whether a launch splits the contraction across blocks
and how many blocks it gets; ``gemm_schedule_plain`` is the persistent
kernel's walk over the (tile, split) items in numpy.  Every tile of C is
taken exactly once for each of its splits, the splits of a tile cover its
whole contraction with no overlap, and the grid is never larger than the
items.  ``bt_row`` is the column order the B^T pre-pass writes, which gives
each thread whole words of C.  Also here: the float32 products of the plain
paths leave the caller's TF32 setting as they found it.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import m4ri_tpu_torch as mt
from m4ri_tpu_torch.ops.hopper_mul import (STAGE_WORDS, TILE_ROWS, TILE_WORDS,
                                           bt_row, gemm_plan,
                                           gemm_schedule_plain)

from conftest import random_dense


def _items(m, nw, kw, sms, split):
    runs = gemm_schedule_plain(m, nw, kw, sms, split)
    return runs, [tuple(x) for run in runs for x in run.tolist()]


@settings(max_examples=300, deadline=None)
@given(m=st.integers(1, 5000), nw=st.integers(1, 600), kw=st.integers(1, 700),
       sms=st.integers(1, 200), split=st.booleans())
def test_every_tile_taken_once_for_each_split(m, nw, kw, sms, split):
    splits, chunk, grid = gemm_plan(m, nw, kw, sms, split)
    runs, items = _items(m, nw, kw, sms, split)
    tiles_m, tiles_n = -(-m // TILE_ROWS), -(-nw // TILE_WORDS)
    assert len(runs) == grid
    assert len(items) == len(set(items)) == tiles_m * tiles_n * splits
    tiles = {(i, j) for i in range(tiles_m) for j in range(tiles_n)}
    assert {(i, j) for i, j, _, _ in items} == tiles


@settings(max_examples=300, deadline=None)
@given(m=st.integers(1, 5000), nw=st.integers(1, 600), kw=st.integers(1, 700),
       sms=st.integers(1, 200), split=st.booleans())
def test_splits_cover_the_contraction_without_overlap(m, nw, kw, sms, split):
    stages = -(-kw // STAGE_WORDS)
    _, items = _items(m, nw, kw, sms, split)
    by_tile = {}
    for i, j, s0, s1 in items:
        assert 0 <= s0 < s1 <= stages            # never an empty run
        by_tile.setdefault((i, j), []).append((s0, s1))
    for runs in by_tile.values():
        runs.sort()
        assert runs[0][0] == 0 and runs[-1][1] == stages
        for (_, end), (start, _) in zip(runs, runs[1:]):
            assert end == start                  # contiguous, disjoint


@settings(max_examples=300, deadline=None)
@given(m=st.integers(1, 100_000), nw=st.integers(1, 4000),
       kw=st.integers(1, 4000), sms=st.integers(1, 200), split=st.booleans())
def test_grid_never_larger_than_the_items(m, nw, kw, sms, split):
    splits, chunk, grid = gemm_plan(m, nw, kw, sms, split)
    tiles = -(-m // TILE_ROWS) * -(-nw // TILE_WORDS)
    stages = -(-kw // STAGE_WORDS)
    assert 1 <= grid <= min(tiles * splits, sms)
    assert (splits - 1) * chunk < stages <= splits * chunk
    if not split or tiles >= sms or stages == 1:
        assert splits == 1                       # C written once, no atomics
    else:
        assert splits <= -(-sms // tiles)      # no more runs than the card wants


def test_split_only_where_the_tiles_do_not_fill_the_card():
    # mul at n=4096 and Strassen's 8192 base products fill 132 SMs: no split
    assert gemm_plan(4096, 128, 128, 132, True)[0] == 1
    assert gemm_plan(8192, 256, 256, 132, True)[0] == 1
    # the U rows never split (gf2_mul_hopper), and would not need to
    assert gemm_plan(512, 512, 16, 132, False)[0] == 1
    # 15 tiles, 5 stages: every stage its own run
    assert gemm_plan(300, 35, 132, 132, True) == (5, 1, 75)
    assert gemm_plan(300, 35, 132, 132, False) == (1, 5, 15)


def test_walk_is_grouped_by_rows():
    """Blocks running together take tiles from GROUP_M row tiles at a time,
    so that they share rows of A and columns of B^T in L2."""
    for m, nw, groups in [(16384, 512, 1), (4096, 128, 2)]:
        runs, _ = _items(m, nw, nw, 132, False)
        first_wave = [tuple(run[0][:2]) for run in runs]
        assert {i for i, _ in first_wave} <= set(range(8 * groups))
        assert len(set(first_wave)) == 132


def test_bt_row_gives_each_thread_whole_words():
    rows = [bt_row(c) for c in range(256)]
    assert sorted(rows) == list(range(256))           # a permutation
    # thread t of a quad holds MMA columns 8*i + 2*t + e, i = 0..31: word
    # 2*t + e of the tile, bit i
    inverse = {r: c for c, r in enumerate(rows)}
    for t in range(4):
        for e in range(2):
            cols = [inverse[8 * i + 2 * t + e] for i in range(32)]
            assert cols == [32 * (2 * t + e) + i for i in range(32)]


@pytest.mark.parametrize("setting", [True, False])
def test_the_callers_tf32_setting_survives(setting):
    rng = np.random.default_rng(5)
    a, b = random_dense(rng, 70, 90), random_dense(rng, 90, 50)
    A, B = mt.from_numpy(a, device="cpu"), mt.from_numpy(b, device="cpu")
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    flags.allow_tf32 = setting
    try:
        C = mt.mul(A, B)
        assert flags.allow_tf32 is setting
        mt.ple(A, nb=32)
        assert flags.allow_tf32 is setting
    finally:
        flags.allow_tf32 = saved
    want = (a.astype(np.int64) @ b.astype(np.int64)) % 2
    assert (mt.to_numpy(C) == want).all()

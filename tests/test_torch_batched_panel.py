"""The batched pivot loop's small-window kernel (5b: a warp a window), its
walk of the batch and the block kernel's exit for windows with nothing in
range, on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py``).  Here the
warp kernel's schedule, written out in numpy beside the wrapper
(``panel_loop_warp_plain``), is held window by window to the JAX package's
``panel_loop`` in interpret mode and to the batched plain version; the exit's
outputs (``panel_loop_idle_plain``) to ``panel_loop_plain``; the launch's walk
of the batch (``panel_warp_schedule_plain``) to an enumeration.  GF(2) is
exact: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from m4ri_tpu.ops.pallas_panel import panel_loop
from m4ri_tpu_torch.ops.hopper_panel import (WARP_MAX_H, WARP_MAX_NBW,
                                             WARP_WINDOWS,
                                             panel_loop_batched_plain,
                                             panel_loop_hopper_batched,
                                             panel_loop_idle_plain,
                                             panel_loop_plain,
                                             panel_loop_warp_plain,
                                             panel_warp_schedule_plain)

_OUTPUTS = ("AL", "rowperm", "r", "touched", "p", "q")

# h, nb, preserve_l, search_window: one row a lane (h <= 32) and two, the
# warp's edges (31, 32, 33, 63, 64 rows), nb = 32 and the widest the path
# takes (64); each compiles the interpreted JAX kernel once
_WARP_CASES = [(1, 32, False, 0), (5, 32, True, 6), (31, 32, False, 6),
               (32, 32, True, 0), (32, 32, False, 0), (33, 32, True, 0),
               (33, 32, False, 6), (63, 64, True, 6), (63, 64, False, 0),
               (64, 64, True, 0), (64, 64, False, 6), (64, 32, True, 6)]


def _windows(seed, B, h, nb, rank_at):
    """B fused windows drawn from ``seed``, with each one's base, rank at
    entry and m: the rank inside the window, at or past m, or past the
    window's last row; rows past m; a zeroed band, a sparse panel, an L half
    that is zero or random."""
    rng = np.random.default_rng(seed)
    nbw = nb // 32
    x = rng.integers(0, 2**32, (B, h, 2 * nbw), dtype=np.uint64).astype(
        np.uint32)
    x[:, :, :nbw] &= rng.integers(0, 2**32, (B, h, nbw), dtype=np.uint64
                                  ).astype(np.uint32) | np.uint32(
                                      rng.integers(0, 2**32))
    if rng.random() < 0.5:
        x[:, :, nbw:] = 0
    if h > 4 and rng.random() < 0.5:
        lo = int(rng.integers(0, h - 2))
        x[0, lo:lo + int(rng.integers(1, h - lo))] = 0
    base = rng.integers(0, 20, B)
    m = base + h - rng.integers(-3, h + 1, B)
    r0 = base + rng.integers(0, h, B)
    if rank_at == "past_m":
        r0 = np.maximum(m, base) + rng.integers(0, 5, B)
    elif rank_at == "past_window":
        r0 = base + h + rng.integers(0, 5, B)
    ints = (lambda a: torch.from_numpy(np.asarray(a, np.int32)))
    return torch.from_numpy(x.view(np.int32)), ints(r0), ints(base), ints(m)


@pytest.mark.parametrize("h,nb,pres,sw", _WARP_CASES)
@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**32 - 1),
       rank_at=st.sampled_from(["inside", "inside", "past_m", "past_window"]))
def test_warp_schedule_equals_jax_and_batched_plain(h, nb, pres, sw, seed,
                                                    rank_at):
    """Window by window: the warp kernel's schedule against the batched
    plain version, all six outputs, and against the JAX package's Pallas
    panel loop (interpret mode) on every window whose rank stays above its
    last row: the Pallas kernel indexes the rank's row unclamped, and no
    caller lets the rank leave the window (the sweep's window is at least nb
    plus the search deeper than the rank at entry)."""
    B = 3
    al0, r0, base, m = _windows(seed, B, h, nb, rank_at)
    # the batched plain version takes one m: hold it window by window
    for b in range(B):
        one = [t[b:b + 1] for t in (al0, r0, base)]
        want_b = panel_loop_batched_plain(*one, int(m[b]), nb, pres, sw)
        got = panel_loop_warp_plain(al0[b], int(r0[b]), int(base[b]),
                                    int(m[b]), nb, pres, sw)
        jax_out = panel_loop(jnp.asarray(al0[b].numpy().view(np.uint32)),
                             jnp.int32(r0[b]), jnp.int32(base[b]),
                             jnp.int32(m[b]), nb=nb, preserve_l=pres,
                             search_window=sw, interpret=True)
        for g, w, j, what in zip(got, want_b, jax_out, _OUTPUTS):
            assert torch.equal(g, w[0]), (b, what, "batched plain")
            if int(got[2]) - int(base[b]) >= h:
                continue
            j = np.asarray(j)
            if what == "AL":
                j = j.view(np.int32)
            np.testing.assert_array_equal(g.numpy(), j, err_msg=f"{b} {what}")


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**32 - 1),
       h=st.sampled_from([1, 5, 31, 32, 33, 63, 64]),
       nb=st.sampled_from([32, 64]), pres=st.booleans(),
       sw=st.sampled_from([0, 6]),
       rank_at=st.sampled_from(["inside", "past_m", "past_window"]))
def test_warp_schedule_equals_the_batched_wrapper_on_the_cpu(seed, h, nb, pres,
                                                             sw, rank_at):
    """A batch with one m, through the wrapper (on CPU tensors: the batched
    plain version), equals the warp schedule window by window."""
    B = 5
    al0, r0, base, m = _windows(seed, B, h, nb, rank_at)
    mm = int(m[0])
    want = panel_loop_hopper_batched(al0, r0, base, mm, nb, pres, sw)
    for b in range(B):
        got = panel_loop_warp_plain(al0[b], int(r0[b]), int(base[b]), mm, nb,
                                    pres, sw)
        for g, w, what in zip(got, want, _OUTPUTS):
            assert torch.equal(g, w[b]), (b, what)


def test_warp_schedule_refuses_a_window_past_the_warp():
    al0 = torch.zeros((WARP_MAX_H + 1, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        panel_loop_warp_plain(al0, 0, 0, 65, 32, True)
    al0 = torch.zeros((8, 4 * (WARP_MAX_NBW + 1) // 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        panel_loop_warp_plain(al0, 0, 0, 8, 32 * (WARP_MAX_NBW + 1), True)


@settings(max_examples=80, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), h=st.integers(1, 160),
       nb=st.sampled_from([32, 64, 96]), base=st.integers(0, 50),
       sw=st.sampled_from([0, 6, 42]),
       rank_at=st.sampled_from(["past_m", "past_window"]))
def test_idle_outputs_equal_the_plain_loop(seed, h, nb, base, sw, rank_at):
    """A window with no row in range (the rank at or past m, or past the
    window's last row): the block kernel's exit writes what the plain loop
    leaves, whatever the words and the search window."""
    rng = np.random.default_rng(seed)
    al0 = torch.from_numpy(rng.integers(-2**31, 2**31, (h, nb // 16),
                                        dtype=np.int64).astype(np.int32))
    m = base + int(rng.integers(-5, h + 5))
    r0 = (max(m, base) if rank_at == "past_m" else base + h) \
        + int(rng.integers(0, 4))
    got = panel_loop_idle_plain(al0, r0, base, m, nb)
    assert got is not None
    for g, w, what in zip(got, panel_loop_plain(al0, r0, base, m, nb, True,
                                                sw), _OUTPUTS):
        assert torch.equal(g, w), what


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 700), base=st.integers(0, 50),
       offset=st.integers(0, 699), rows_past_m=st.integers(-5, 700))
def test_idle_only_where_no_row_is_in_range(h, base, offset, rows_past_m):
    """The exit is taken exactly where no window row lies at a position in
    [r_in, m): where one does, the wrapper's exit condition does not hold."""
    m = base + h - rows_past_m
    r0 = base + offset
    al0 = torch.zeros((h, 2), dtype=torch.int32)
    in_range = any(r0 <= base + i < m for i in range(h))
    assert (panel_loop_idle_plain(al0, r0, base, m, 32) is None) == in_range


@settings(max_examples=200, deadline=None)
@given(batch=st.integers(1, 5000), windows=st.sampled_from([1, 3, WARP_WINDOWS]))
def test_warp_walk_takes_each_window_once(batch, windows):
    """The warp kernel's grid: block x's warp w takes window x * windows + w;
    every window once, and the idle warps only in the last block's tail."""
    sched = panel_warp_schedule_plain(batch, windows)
    assert sched.shape == (-(-batch // windows), windows)
    taken = sched[sched >= 0]
    assert sorted(taken.tolist()) == list(range(batch))
    for e in range(0, batch, max(1, batch // 50)):
        assert sched[e // windows, e % windows] == e
    idle = np.argwhere(sched < 0)
    assert all(x == sched.shape[0] - 1 for x, _ in idle)
    assert len(idle) == sched.size - batch

"""The plain versions of the port's four factorization kernels against the
Pallas kernels they replace, run in interpret mode at the cases of
test_pallas.py.  On the CPU a wrapper takes its plain version, so calling the
wrappers here tests exactly what the CPU path of the port runs.  Equality of
packed words and of every index array, tolerance 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import m4ri_tpu as mj
import m4ri_tpu_torch as mt
from m4ri_tpu.models import ple as jple
from m4ri_tpu.ops import pallas_panel
from m4ri_tpu.ops.pallas_post import panel_post
from m4ri_tpu.ops.pallas_schur import gf2_schur_update, gf2_schur_update_dyn
from m4ri_tpu_torch.models import ple as tple
from m4ri_tpu_torch.ops import hopper_panel
from m4ri_tpu_torch.ops import hopper_post
from m4ri_tpu_torch.ops.hopper_panel import (panel_loop_grouped_plain,
                                             panel_loop_hopper,
                                             panel_loop_plain)
from m4ri_tpu_torch.ops.hopper_post import panel_post_hopper, panel_post_plain
from m4ri_tpu_torch.ops.hopper_schur import (TILE_ROWS, TILE_WORDS,
                                             gf2_schur_update_dyn_hopper,
                                             gf2_schur_update_hopper,
                                             gf2_schur_update_plain)

import oracle
from conftest import random_dense
from m4ri_tpu_torch.utils.spans import counts
from torch_port import assert_same, both, words


def _schur_operands(rng, m, k, n, r0, c0):
    """c, lp, up under the factorization's contract: lp rows above r0 and up
    columns left of c0 are zero."""
    c, lp, up = (random_dense(rng, m, n), random_dense(rng, m, k),
                 random_dense(rng, k, n))
    lp[:r0] = 0
    up[:, :c0] = 0
    return c, lp, up


@pytest.mark.parametrize("m,k,n,r0,c0,tm,tnw", [
    (256, 128, 4096, 0, 0, 64, 32),          # nothing skipped
    (256, 128, 4096, 64, 1024, 64, 32),      # tile-aligned skip region
    (256, 128, 4096, 96, 1536, 64, 32),      # bounds inside a tile
    (256, 128, 4096, 256, 4096, 64, 32),     # everything skipped
    (512, 256, 2048, 128, 512, 128, 64),     # the production shape class
    (256, 150, 1024, 64, 0, 64, 32),         # contraction off the word
])
def test_plain_equals_pallas_schur(rng, m, k, n, r0, c0, tm, tnw):
    c, lp, up = _schur_operands(rng, m, k, n, r0, c0)
    (Jc, Tc), (Jl, Tl), (Ju, Tu) = both(c), both(lp), both(up)
    want = gf2_schur_update(Jc.data, Jl.data, Ju.data, r0, c0 // 32,
                            tm=tm, tnw=tnw, interpret=True)
    got = gf2_schur_update_hopper(Tc.data, Tl.data, Tu.data, r0, c0 // 32)
    assert got.data_ptr() == Tc.data.data_ptr()       # in place
    assert_same(want, got)
    np.testing.assert_array_equal(mt.to_numpy(Tc), c ^ oracle.mul(lp, up))


def test_plain_equals_pallas_schur_col_tile_skip(rng):
    """col_tile_skip changes nothing when the skipped tiles lie left of the
    zero columns of up; it is counted in the port's TILE_WORDS-word tiles."""
    m, k, n = 256, 128, 8192
    c, lp, up = _schur_operands(rng, m, k, n, 64, 128 * 32)
    (Jc, Tc), (Jl, Tl), (Ju, Tu) = both(c), both(lp), both(up)
    want = gf2_schur_update(Jc.data, Jl.data, Ju.data, 64, 128, tm=64,
                            tnw=128, col_tile_skip=1, interpret=True)
    got = gf2_schur_update_hopper(Tc.data, Tl.data, Tu.data, 64, 128,
                                  col_tile_skip=128 // TILE_WORDS)
    assert_same(want, got)


@pytest.mark.parametrize("r0,c0w", [
    (0, 0), (100, 16), (256, 128), (512, 128), (37, 5), (511, 127),
])
def test_plain_equals_pallas_schur_dyn(rng, r0, c0w):
    m, nw, kw = 512, 128, 8
    c, lp, up = _schur_operands(rng, m, kw * 32, nw * 32, r0, c0w * 32)
    (Jc, Tc), (Jl, Tl), (Ju, Tu) = both(c), both(lp), both(up)
    want = gf2_schur_update_dyn(Jc.data, Jl.data, Ju.data, r0, c0w,
                                tm=256, tnw=128, interpret=True)
    got = gf2_schur_update_dyn_hopper(Tc.data, Tl.data, Tu.data, r0, c0w)
    assert_same(want, got)
    if (r0, c0w) == (512, 128):
        np.testing.assert_array_equal(mt.to_numpy(Tc), c)   # untouched


def test_schur_wrappers_take_views_and_tensor_bounds(rng):
    c, lp, up = _schur_operands(rng, 100, 70, 200, 30, 64)
    parent = mt.from_numpy(random_dense(rng, 140, 320), device="cpu").data
    keep = parent.clone()
    view = parent[20:120, 2:9]
    view.copy_(mt.from_numpy(c, device="cpu").data)
    Tl, Tu = mt.from_numpy(lp, device="cpu"), mt.from_numpy(up, device="cpu")
    gf2_schur_update_hopper(view, Tl.data, Tu.data,
                            torch.tensor(30, dtype=torch.int32), 2)
    want = mt.from_numpy(c ^ oracle.mul(lp, up), device="cpu").data
    keep[20:120, 2:9] = want
    assert torch.equal(parent, keep)


def test_schur_wrappers_raise_on_what_they_do_not_take():
    nw = 2 * TILE_WORDS                                   # two column tiles
    c = torch.zeros((TILE_ROWS, nw), dtype=torch.int32)
    lp = torch.zeros((TILE_ROWS, 2), dtype=torch.int32)
    up = torch.zeros((64, nw), dtype=torch.int32)
    with pytest.raises(ValueError):                       # c of another shape
        gf2_schur_update_hopper(c[:, :7], lp, up, 0, 0)
    with pytest.raises(TypeError):
        gf2_schur_update_hopper(c.to(torch.int64), lp, up, 0, 0)
    with pytest.raises(ValueError):                       # skip past the edge
        gf2_schur_update_hopper(c, lp, up, 0, nw, col_tile_skip=2)
    with pytest.raises(ValueError):                       # skip past c0w
        gf2_schur_update_hopper(c, lp, up, 0, TILE_WORDS - 1, col_tile_skip=1)
    with pytest.raises(ValueError):                       # rows off the tile
        gf2_schur_update_dyn_hopper(c[:100], lp[:100], up, 0, 0)
    with pytest.raises(ValueError):                       # words off the tile
        gf2_schur_update_dyn_hopper(c[:, :6], lp, up[:, :6], 0, 0)


# ---- the panel pivot loop ---------------------------------------------------

def _window(rng, h, nb, zero=None, bit31=False):
    x = random_dense(rng, h, nb)
    if bit31:
        x[:, 31::32] = 1
    if zero:
        x[zero[0]:zero[1]] = 0
    return x


_PANEL_CASES = [
    # h, nb, preserve_l, search_window, zeroed rows, r0, base, m
    (96, 64, False, 0, None, 0, 0, 96),
    (96, 64, True, 0, None, 5, 5, 90),           # rows past m never pivot
    (96, 64, True, 0, (8, 70), 3, 3, 99),        # not-found steps
    (160, 64, False, 32, (10, 60), 4, 4, 164),   # restricted search
    (200, 32, True, 0, None, 17, 0, 190),        # full-height convention
]


_PANEL_OUTPUTS = ["AL", "rowperm", "r", "touched", "p", "q"]


def _jax_panel_loop(Jx, engine, t, h, nb, pres, sw, r0, base, m):
    return jple.run_panel_loop(Jx.data, jnp.int32(r0), jnp.int32(base),
                               jnp.int32(t), jnp.int32(r0), m, nb, pres, sw,
                               engine)


def _assert_panel_outputs(want, got, engine, r0, who):
    """The colstep loop (engine "xla") leaves 0 in the pivot slots it never
    wrote where the kernel path leaves the offsets, so against it p and q are
    compared on the slots of the pivots found, which is all a caller reads."""
    for w, g, what in zip(want, got, _PANEL_OUTPUTS):
        if what == "AL":
            assert_same(w, g, what)
            continue
        w, g = np.asarray(w), g.numpy()
        if engine == "xla" and what in ("p", "q"):
            live = int(want[2]) - r0
            w, g = w[:live], g[:live]
        np.testing.assert_array_equal(w, g, err_msg=f"{who}: {what}")


@pytest.mark.parametrize("engine", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("h,nb,pres,sw,zero,r0,base,m", _PANEL_CASES)
def test_plain_equals_pallas_panel_loop(rng, engine, h, nb, pres, sw, zero,
                                        r0, base, m):
    """Against the interpreted Mosaic kernel and against the colstep loop,
    through both packages' run_panel_loop (which adds base and the panel's
    column offset to p and q)."""
    x = _window(rng, h, nb, zero, bit31=True)
    Jx, Tx = both(x)
    t = 3
    want = _jax_panel_loop(Jx, engine, t, h, nb, pres, sw, r0, base, m)
    for eng in ("plain", "hopper"):
        got = tple.run_panel_loop(Tx.data, r0, base, t, m, nb, pres, sw, eng)
        _assert_panel_outputs(want, got, engine, r0, eng)


@pytest.mark.parametrize("engine", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("h,nb,pres,sw,zero,r0,base,m", _PANEL_CASES)
def test_grouped_plain_equals_pallas_panel_loop(rng, engine, h, nb, pres, sw,
                                                zero, r0, base, m):
    """The plain model of the kernel's schedule (32-column groups, delayed
    update) against the JAX panel loop, as the test above holds the
    step-by-step plain version to it."""
    x = _window(rng, h, nb, zero, bit31=True)
    Jx, Tx = both(x)
    t = 3
    want = _jax_panel_loop(Jx, engine, t, h, nb, pres, sw, r0, base, m)
    al0 = torch.cat([Tx.data, torch.zeros_like(Tx.data)], dim=1)
    got = list(panel_loop_grouped_plain(al0, r0, base, m, nb, pres, sw))
    got[4], got[5] = base + got[4], t * nb + got[5]
    _assert_panel_outputs(want, got, engine, r0, "grouped")


def _fused(x, l_random=None):
    """[panel | L] from dense panel bits; the L half zero or random words."""
    xw = mt.from_numpy(x, device="cpu").data
    lh = torch.zeros_like(xw) if l_random is None else torch.from_numpy(
        l_random.integers(-2**31, 2**31, tuple(xw.shape)).astype(np.int32))
    return torch.cat([xw, lh], dim=1)


def _grouped_case(rng, kind):
    """(al0, r0, base, m, nb, search_window) of one hard case of the schedule."""
    h, nb = 150, 96
    x = random_dense(rng, h, nb)
    r0 = base = 4
    sw = 0
    if kind == "group_without_a_pivot":
        x[:, 32:64] = 0                         # the middle word column
    elif kind == "pivot_in_a_later_slot_row":
        x[:, 0] = 0                             # column 0: only row 20, which
        x[20, 0] = 1                            # is a slot row of the group
    elif kind == "slots_straddle_an_l_word":
        x[:, [3, 17, 18, 40]] = 0               # slots run behind the columns
    elif kind == "rs_equals_ps":
        x[np.arange(nb), np.arange(nb)] = 1     # the pivot is at the slot
    elif kind == "search_window":
        x[6:40] = 0
        sw = 30
    elif kind == "narrow_search_window":
        sw = 3
    elif kind == "zero_band_below_the_slot":
        x[4:100] = 0                            # nothing within 64 rows
    elif kind == "rank_runs_past_the_window":
        h = 60
        x = x[:h]                               # nb > h: the slot leaves it
    elif kind == "rows_past_m":
        return _fused(x, rng), r0, base, 40, nb, sw
    elif kind == "full_height_convention":
        return _fused(x, rng), 30, 0, 140, nb, sw
    return _fused(x, rng), r0, base, base + h - 2, nb, sw


@pytest.mark.parametrize("pres", [False, True])
@pytest.mark.parametrize("kind", [
    "random", "group_without_a_pivot", "pivot_in_a_later_slot_row",
    "slots_straddle_an_l_word", "rs_equals_ps", "search_window",
    "narrow_search_window", "zero_band_below_the_slot",
    "rank_runs_past_the_window", "rows_past_m", "full_height_convention"])
def test_grouped_plain_equals_plain(rng, kind, pres):
    """Every output of the grouped schedule equals the step-by-step loop's,
    on an L half that is not zero on entry."""
    al0, r0, base, m, nb, sw = _grouped_case(rng, kind)
    want = panel_loop_plain(al0, r0, base, m, nb, pres, sw)
    got = panel_loop_grouped_plain(al0, r0, base, m, nb, pres, sw)
    for w, g, what in zip(want, got, _PANEL_OUTPUTS):
        assert w.shape == g.shape and w.dtype == g.dtype, what
        assert torch.equal(w, g), what
    if kind == "group_without_a_pivot":
        assert not (want[5][: int(want[2]) - r0] // 32 == 1).any()
    if kind == "rs_equals_ps":
        t = want[3].reshape(-1, 2)
        assert (t[:, 0] == t[:, 1]).any()


def test_grouped_plain_refuses_a_rank_above_the_window():
    al0 = torch.zeros((8, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        panel_loop_grouped_plain(al0, 2, 3, 8, 32, True)


def test_panel_tables_equal_the_jax_tables():
    for nb, pres in [(32, True), (64, False), (128, True)]:
        jw, jl = pallas_panel._tables(nb, pres)
        tw, tl = hopper_panel._tables(nb, pres)
        np.testing.assert_array_equal(jw, tw.view(np.uint32))
        np.testing.assert_array_equal(jl, tl.view(np.uint32))


def test_panel_loop_takes_the_rank_as_a_tensor(rng):
    al0 = torch.cat([mt.from_numpy(_window(rng, 80, 32), device="cpu").data,
                     torch.zeros((80, 1), dtype=torch.int32)], dim=1)
    a = panel_loop_hopper(al0, 6, 2, 80, 32, True)
    b = panel_loop_plain(al0, torch.tensor(6, dtype=torch.int32), 2, 80, 32,
                         True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a[2].dtype == torch.int32 and a[2].ndim == 0


def test_panel_loop_raises_on_what_it_does_not_take():
    al0 = torch.zeros((40, 4), dtype=torch.int32)
    with pytest.raises(ValueError):                       # width is not 2*nbw
        panel_loop_hopper(al0, 0, 0, 40, 32, True)
    with pytest.raises(ValueError):                       # nb off the word
        panel_loop_hopper(al0, 0, 0, 40, 48, True)
    with pytest.raises(TypeError):
        panel_loop_hopper(al0.to(torch.int64), 0, 0, 40, 64, True)
    with pytest.raises(ValueError):                       # wider than the kernel takes
        panel_loop_hopper(torch.zeros((8, 2 * 65), dtype=torch.int32), 0, 0,
                          8, 65 * 32, True)


# ---- the below-window elimination ------------------------------------------

@pytest.mark.parametrize("m,nb,below0,mvalid,cm_density", [
    (512, 64, 192, 500, 0.2),      # the case of test_pallas.py
    (512, 64, 192, 500, 0.0),      # miss check switched off
    (256, 128, 0, 256, 0.5),       # every row in range
    (256, 32, 256, 256, 0.5),      # no row in range: pure pass-through
])
def test_plain_equals_pallas_post(rng, m, nb, below0, mvalid, cm_density):
    x = random_dense(rng, m, nb)
    x[:, 31::32] = 1
    msm = (rng.random((nb, nb)) < 0.5).astype(np.int8)
    wm = (rng.random((nb, nb)) < 0.5).astype(np.int8)
    cmb = (rng.random(nb) < cm_density).astype(np.int8)
    Jx, Tx = both(x)
    want = panel_post(Jx.data, jnp.asarray(msm), jnp.asarray(wm),
                      jnp.asarray(cmb), below0, mvalid, tm=256,
                      interpret=True)
    args = (torch.from_numpy(msm), torch.from_numpy(wm), torch.from_numpy(cmb),
            below0, mvalid)
    for fn in (panel_post_hopper, panel_post_plain):
        vw, lamw, miss = fn(Tx.data, *args)
        assert_same(want[0], vw, "v")
        assert_same(want[1], lamw, "lam")
        assert bool(miss) == bool(want[2])
        assert miss.dtype == torch.bool and miss.ndim == 0
    # and the definition itself, on the host
    rows = (np.arange(m) >= below0) & (np.arange(m) < mvalid)
    lam = (x.astype(np.int64) @ msm.astype(np.int64)) % 2
    lam[~rows] = 0
    v = x ^ (lam @ wm.astype(np.int64)) % 2
    np.testing.assert_array_equal(mt.to_numpy(mt.BitMatrix(vw, nb)), v)
    assert bool(miss) == bool((v * cmb[None, :])[rows].any())


def test_post_takes_a_strided_view(rng):
    nb, m = 64, 130
    x = random_dense(rng, m, nb)
    parent = mt.from_numpy(random_dense(rng, m, 5 * 32), device="cpu").data
    view = parent[:, 2:4]
    view.copy_(mt.from_numpy(x, device="cpu").data)
    msm, wm = (torch.from_numpy((rng.random((nb, nb)) < 0.5).astype(np.int8))
               for _ in range(2))
    cmb = torch.zeros(nb, dtype=torch.int8)
    a = panel_post_hopper(view, msm, wm, cmb, 40, 120)
    b = panel_post_hopper(view.contiguous(), msm, wm, cmb, 40, 120)
    for x_, y_ in zip(a, b):
        assert torch.equal(x_, y_)


@pytest.mark.parametrize("nb", [32, 96, 256])
def test_post_packing_plain_equals_numpy_packbits(rng, nb):
    """The plain versions of the packing kernel: the transpose packed along
    the contraction with rows padded to 4 words, and the packed mask."""
    bits = (rng.random((nb, nb)) < 0.5).astype(np.int8)
    cmb = (rng.random(nb) < 0.3).astype(np.int8)
    got = hopper_post._packed_transposed(torch.from_numpy(bits))
    nbw = nb // 32
    assert got.shape == (nb, (nbw + 3) // 4 * 4) and got.dtype == torch.int32
    want = np.packbits(bits.T.astype(np.uint8), axis=1, bitorder="little")
    want = np.ascontiguousarray(want).view(np.uint32)
    np.testing.assert_array_equal(words(got)[:, :nbw], want)
    assert not words(got)[:, nbw:].any()
    got_cm = hopper_post._packed_colmask(torch.from_numpy(cmb))
    want_cm = np.packbits(cmb.astype(np.uint8), bitorder="little").view(np.uint32)
    np.testing.assert_array_equal(words(got_cm), want_cm)


def test_post_raises_on_what_it_does_not_take():
    xw = torch.zeros((64, 2), dtype=torch.int32)
    sq = torch.zeros((64, 64), dtype=torch.int8)
    cm = torch.zeros(64, dtype=torch.int8)
    with pytest.raises(TypeError):                        # operands not int8
        panel_post_hopper(xw, sq.to(torch.int32), sq, cm, 0, 64)
    with pytest.raises(TypeError):                        # of another size
        panel_post_hopper(xw, sq[:32], sq, cm, 0, 64)
    with pytest.raises(TypeError):
        panel_post_hopper(xw.to(torch.int64), sq, sq, cm, 0, 64)
    with pytest.raises(TypeError):                        # colmask of another size
        panel_post_hopper(xw, sq, sq, cm[:32], 0, 64)


def test_cpu_tensors_launch_nothing(rng):
    """A launch is counted where a kernel is launched and nowhere else."""
    fns = (gf2_schur_update_hopper, gf2_schur_update_dyn_hopper,
           panel_loop_hopper, panel_post_hopper)
    before = [counts().get(f"launch.{f.__name__}", 0) for f in fns]
    A = mt.from_numpy(random_dense(rng, 150, 130), device="cpu")
    mt.block_factor(A, preserve_l=True, nb=32, engine="hopper")
    c = torch.zeros((TILE_ROWS, TILE_WORDS), dtype=torch.int32)
    gf2_schur_update_dyn_hopper(
        c, torch.zeros((TILE_ROWS, 1), dtype=torch.int32),
        torch.zeros((32, TILE_WORDS), dtype=torch.int32), 0, 0)
    assert [counts().get(f"launch.{f.__name__}", 0) for f in fns] == before


def test_schur_plain_is_in_place(rng):
    c, lp, up = _schur_operands(rng, 40, 33, 70, 0, 0)
    Tc, Tl, Tu = (mt.from_numpy(x, device="cpu") for x in (c, lp, up))
    out = gf2_schur_update_plain(Tc.data, Tl.data, Tu.data)
    assert out is Tc.data
    np.testing.assert_array_equal(words(mj.from_numpy(c ^ oracle.mul(lp, up))),
                                  words(out))


# ---- the batched plain versions, element by element -----------------------

from m4ri_tpu_torch.ops.hopper_panel import (  # noqa: E402
    panel_loop_batched_plain, panel_loop_hopper_batched)
from m4ri_tpu_torch.ops.hopper_post import (  # noqa: E402
    panel_post_batched_plain, panel_post_hopper_batched)


@pytest.mark.parametrize("nb,h,pres,sw", [(64, 80, True, 0), (64, 80, False, 0),
                                          (32, 40, True, 8), (96, 100, True, 0)])
def test_batched_panel_plain_equals_single_plain(rng, nb, h, pres, sw):
    """Each window of the batch as panel_loop_plain takes it alone: its own
    base, its own rank at entry, a window without a 1, a zeroed band, rows
    past m."""
    B, m = 5, 95
    x = np.stack([_window(rng, h, nb, bit31=True) for _ in range(B)])
    x[2, 10:50] = 0
    x[3] = 0
    al0 = torch.stack([torch.cat([mt.from_numpy(w, device="cpu").data,
                                  torch.zeros((h, nb // 32), dtype=torch.int32)],
                                 dim=1) for w in x])
    base = torch.tensor([0, 10, 100, 5, 7], dtype=torch.int32)
    r0 = base + torch.tensor([0, 3, 0, 1, 0], dtype=torch.int32)
    for fn in (panel_loop_batched_plain, panel_loop_hopper_batched):
        got = fn(al0, r0, base, m, nb, pres, sw)
        for b in range(B):
            want = panel_loop_plain(al0[b], int(r0[b]), int(base[b]), m, nb,
                                    pres, sw)
            for g, w in zip(got, want):
                assert torch.equal(g[b], w), (fn.__name__, b)


def test_batched_panel_raises_on_what_it_does_not_take():
    al0 = torch.zeros((2, 40, 2), dtype=torch.int32)
    r = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):                        # one window, no batch
        panel_loop_hopper_batched(al0[0], r, r, 40, 32, True)
    with pytest.raises(TypeError):                        # a rank for each
        panel_loop_hopper_batched(al0, r[:1], r, 40, 32, True)
    with pytest.raises(ValueError):                       # an empty batch
        panel_loop_hopper_batched(al0[:0], r[:0], r[:0], 40, 32, True)


@pytest.mark.parametrize("m,nb,cm_density", [(512, 64, 0.2), (256, 32, 0.5),
                                             (300, 128, 0.0)])
def test_batched_post_plain_equals_single_plain(rng, m, nb, cm_density):
    """Each element as panel_post_plain takes it: its own operands and its
    own row range, from all rows in range to none; flags differ across the
    batch."""
    B = 4
    xs = torch.stack([mt.from_numpy(random_dense(rng, m, nb), device="cpu").data
                      for _ in range(B)])
    msm, wm = (torch.from_numpy((rng.random((B, nb, nb)) < 0.5).astype(np.int8))
               for _ in range(2))
    cmb = torch.from_numpy((rng.random((B, nb)) < cm_density).astype(np.int8))
    cmb[1] = 0
    below0 = torch.tensor([0, 100, m - 3, m], dtype=torch.int32)
    mvalid = m - 2
    for fn in (panel_post_batched_plain, panel_post_hopper_batched):
        vw, lamw, miss = fn(xs, msm, wm, cmb, below0, mvalid)
        assert miss.shape == (B,) and miss.dtype == torch.bool
        for b in range(B):
            want = panel_post_plain(xs[b], msm[b], wm[b], cmb[b],
                                    int(below0[b]), mvalid)
            assert torch.equal(vw[b], want[0]) and torch.equal(lamw[b], want[1])
            assert bool(miss[b]) == bool(want[2])
    assert not miss[1] and not miss[3]


def test_batched_post_takes_a_strided_view(rng):
    B, m, nb = 3, 130, 64
    parent = torch.stack([mt.from_numpy(random_dense(rng, m, 5 * 32),
                                        device="cpu").data for _ in range(B)])
    view = parent[:, :, 2:4]
    msm, wm = (torch.from_numpy((rng.random((B, nb, nb)) < 0.5).astype(np.int8))
               for _ in range(2))
    cmb = torch.ones((B, nb), dtype=torch.int8)
    below0 = torch.tensor([40, 0, 129], dtype=torch.int32)
    a = panel_post_hopper_batched(view, msm, wm, cmb, below0, 120)
    b = panel_post_hopper_batched(view.contiguous(), msm, wm, cmb, below0, 120)
    for x_, y_ in zip(a, b):
        assert torch.equal(x_, y_)

"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU and ``nvcc``; every test here is marked ``cuda`` and
skips with a reason where there is no card.  Run it on a machine with one:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest`` because the suite's conftest imports JAX, which the port
does not need.)  GF(2) is exact: the comparison is equality of packed words.
"""

import numpy as np
import pytest
import torch

from m4ri_tpu_torch.ops.hopper_mul import gf2_mul_hopper, gf2_mul_plain
from m4ri_tpu_torch.ops.hopper_mul2 import gf2_mul_hopper_v2
from m4ri_tpu_torch.utils.spans import counts

pytestmark = pytest.mark.cuda

SHAPES = [(1, 1, 1), (31, 32, 33), (65, 97, 129), (300, 1100, 4200),
          (512, 1000, 4096), (300, 2100, 8200), (2048, 64, 4096)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _packed(seed, rows, cols, dev):
    """Random packed words with the padding bits of the last word zero."""
    rng = np.random.default_rng(seed)
    w = (cols + 31) // 32
    x = rng.integers(0, 2**32, (rows, w), dtype=np.uint64).astype(np.uint32)
    if cols % 32:
        x[:, -1] &= np.uint32((1 << (cols % 32)) - 1)
    return torch.from_numpy(x.view(np.int32)).to(dev)


@pytest.mark.parametrize("kernel", [gf2_mul_hopper, gf2_mul_hopper_v2],
                         ids=["v1", "v2"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_kernel_equals_plain(card, kernel, m, k, n):
    a, b = _packed(1, m, k, card), _packed(2, k, n, card)
    got = kernel(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, gf2_mul_plain(a, b))


@pytest.mark.parametrize("kernel", [gf2_mul_hopper, gf2_mul_hopper_v2],
                         ids=["v1", "v2"])
def test_kernel_strided_views(card, kernel):
    """Quadrant views as inputs and as ``out=``; the rest of the parent of
    ``out`` must stay as it was.  The odd word offset (33) takes the
    4-byte load path, the even one the 16-byte path."""
    for off in (33, 64):
        big_a = _packed(3, 400, 32 * (off + 70), card)
        big_b = _packed(4, 32 * 70 + 500, 32 * (off + 40), card)
        a = big_a[100:350, off:off + 70]
        b = big_b[500:500 + 32 * 70 - 5, off:off + 40]
        parent = _packed(5, 300, 32 * 100, card)
        before = parent.clone()
        out = parent[20:270, 7:47]
        kernel(a, b, out=out)
        torch.cuda.synchronize()
        want = gf2_mul_plain(a.contiguous(), b.contiguous())
        assert torch.equal(out, want)
        before[20:270, 7:47] = want
        assert torch.equal(parent, before)


def test_v2_accumulate(card):
    """One chunk of the contraction, three with a ragged last, four whole."""
    for k in (1000, 4200, 8192):
        a, b = _packed(6, 300, k, card), _packed(7, k, 1100, card)
        c = _packed(8, 300, 1100, card)
        want = c ^ gf2_mul_plain(a, b)
        got = c.clone()
        gf2_mul_hopper_v2(a, b, out=got, accumulate=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want), k


# shapes that reach the corners of the GEMM kernel (csrc/gf2_gemm_hopper.cu):
# m < 64 (one warpgroup's rows, most of them past the edge), k = 1, k not a
# multiple of 256, nw = 1, tiles that do not fill the card with a deep
# contraction (v2 splits it), more tiles than blocks
GEMM_SHAPES = [(50, 3000, 700), (17, 1, 40), (100, 1, 300), (129, 257, 513),
               (200, 4000, 20), (200, 700, 32), (300, 4200, 1100),
               (4096, 4096, 4096), (1000, 12000, 600)]


@pytest.mark.parametrize("kernel", [gf2_mul_hopper, gf2_mul_hopper_v2],
                         ids=["v1", "v2"])
@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_gemm_corners(card, kernel, m, k, n):
    a, b = _packed(21, m, k, card), _packed(22, k, n, card)
    out = _packed(23, m, n, card)          # garbage: every word is written
    kernel(a, b, out=out)
    torch.cuda.synchronize()
    assert torch.equal(out, gf2_mul_plain(a, b))


@pytest.mark.parametrize("kernel", [gf2_mul_hopper, gf2_mul_hopper_v2],
                         ids=["v1", "v2"])
@pytest.mark.parametrize("nb,n", [(512, 16384), (1024, 32768)])
def test_gemm_u_row_shapes(card, kernel, nb, n):
    """The PLE panel's U rows: s [nb, nb] times the panel's rows [nb, n] of
    the padded matrix, a view of a wider parent, into a kept buffer."""
    s = _packed(24, nb, nb, card)
    parent = _packed(25, nb + 40, n + 512, card)
    rows = parent[20:20 + nb, : n // 32]
    out = torch.empty((nb, n // 32), dtype=torch.int32, device=card)
    for _ in range(2):
        kernel(s, rows, out=out)
    torch.cuda.synchronize()
    assert torch.equal(out, gf2_mul_plain(s, rows.contiguous()))


def test_gemm_8192_quadrant_views(card):
    """Strassen's base products at n=16384: quadrant views of 16384
    parents, as plain product, as ``out=`` and with ``accumulate``."""
    a = _packed(26, 16384, 16384, card)
    b = _packed(27, 16384, 16384, card)
    a12, b21 = a[:8192, 256:], b[8192:, :256]
    want = torch.cat([gf2_mul_plain(a12[r:r + 2048], b21)
                      for r in range(0, 8192, 2048)])
    assert torch.equal(gf2_mul_hopper_v2(a12, b21), want)
    c = _packed(28, 16384, 16384, card)
    c22 = c[8192:, 256:]
    before = c22.clone()
    gf2_mul_hopper_v2(a12, b21, out=c22, accumulate=True)
    torch.cuda.synchronize()
    assert torch.equal(c22, before ^ want)
    assert torch.equal(gf2_mul_hopper(a12, b21), want)


@pytest.mark.parametrize("kernel", [gf2_mul_hopper, gf2_mul_hopper_v2],
                         ids=["v1", "v2"])
@pytest.mark.parametrize("offset,stride", [(1, 4096), (4, 4095), (3, 4099)])
def test_gemm_unaligned_a(card, kernel, offset, stride):
    """An A whose base or row stride is not 16-byte aligned (a tensor copy
    cannot read it): copied into aligned scratch by a kernel, then the
    same product."""
    flat = _packed(29, 1, 32 * (offset + 700 * stride), card)[0]
    a = flat[offset:offset + 700 * stride].view(700, stride)[:, :90]
    b = _packed(30, 90 * 32 - 11, 2000, card)
    got = kernel(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, gf2_mul_plain(a.contiguous(), b))


@pytest.mark.parametrize("m,k,n", [(300, 4200, 1100), (2048, 4096, 4096),
                                   (40, 9000, 70)])
def test_v2_accumulate_split_and_not(card, m, k, n):
    """C ^= A*B with the contraction split across blocks (few tiles, deep
    k: atomics into C) and kept in the block (many tiles)."""
    from m4ri_tpu_torch.ops.hopper_mul import gemm_plan
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    a, b = _packed(31, m, k, card), _packed(32, k, n, card)
    c = _packed(33, m, n, card)
    want = c ^ gf2_mul_plain(a, b)
    gf2_mul_hopper_v2(a, b, out=c, accumulate=True)
    torch.cuda.synchronize()
    assert torch.equal(c, want)
    splits = gemm_plan(m, -(-n // 32), -(-k // 32), sms, True)[0]
    assert (splits > 1) == (m * n < 1_000_000), splits


@pytest.mark.parametrize("kernel", [gf2_mul_hopper, gf2_mul_hopper_v2],
                         ids=["v1", "v2"])
def test_gemm_call_does_not_synchronise(card, kernel):
    a, b = _packed(34, 4096, 4096, card), _packed(35, 4096, 4096, card)
    out = torch.empty((4096, 128), dtype=torch.int32, device=card)
    kernel(a, b, out=out)              # scratch and library in place
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kernel(a, b, out=out)
        kernel(a[:100, 1:], b[32:], out=out[:100])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(out[:100], gf2_mul_plain(a[:100, 1:].contiguous(), b[32:]))


def test_wrappers_raise_on_what_they_do_not_take(card):
    a, b = _packed(9, 64, 64, card), _packed(10, 64, 64, card)
    with pytest.raises(TypeError):
        gf2_mul_hopper(a.to(torch.int64), b)
    with pytest.raises(ValueError):
        gf2_mul_hopper(a, _packed(11, 100, 64, card))
    with pytest.raises(ValueError):
        gf2_mul_hopper_v2(a, b, accumulate=True)
    with pytest.raises(ValueError):
        gf2_mul_hopper(a, b.cpu())


# ---- the factorization path's kernels --------------------------------------

from m4ri_tpu_torch.ops import hopper_panel, hopper_post, hopper_schur  # noqa: E402


def _schur_operands(card, m, k, n, r0, c0w, seed=20):
    c, lp, up = (_packed(seed, m, n, card), _packed(seed + 1, m, k, card),
                 _packed(seed + 2, k, n, card))
    lp[:r0] = 0
    up[:, :c0w] = 0
    return c, lp, up


_SCHUR = {"static": hopper_schur.gf2_schur_update_hopper,
          "dyn": hopper_schur.gf2_schur_update_dyn_hopper}
_TW, _TR = hopper_schur.TILE_WORDS, hopper_schur.TILE_ROWS


def _schur_call(card, kernel, c, lp, up, r0, c0w, bounds):
    """One call of an entry point; ``bounds``: "int" or "tensor" (on the
    card).  The static entry skips the column tiles left of c0w."""
    if bounds == "tensor":
        r0, c0w = (torch.tensor(v, dtype=torch.int32, device=card)
                   for v in (r0, c0w))
        skip = 0
    else:
        skip = min(c0w // _TW, -(-c.shape[1] // _TW) - 1)
    if kernel == "dyn":
        return _SCHUR[kernel](c, lp, up, r0, c0w)
    return _SCHUR[kernel](c, lp, up, r0, c0w, col_tile_skip=skip)


@pytest.mark.parametrize("bounds", ["int", "tensor"])
@pytest.mark.parametrize("kernel", ["static", "dyn"])
@pytest.mark.parametrize("r0,c0w", [(0, 0), (100, 16), (256, 128), (512, 128),
                                    (37, 5), (511, 127), (600, 3), (5, 200)])
def test_schur_equals_plain(card, kernel, bounds, r0, c0w):
    """The bounds of the JAX package's dyn test, on the port's tiles: partial
    tiles stay active, (512, 128) skips everything, and so do r0 >= m and
    c0w >= nw."""
    c, lp, up = _schur_operands(card, 512, 256, 128 * 32, r0, c0w)
    want = hopper_schur.gf2_schur_update_plain(c.clone(), lp, up)
    before = c.clone()
    got = _schur_call(card, kernel, c, lp, up, r0, c0w, bounds)
    torch.cuda.synchronize()
    assert got is c and torch.equal(c, want)
    if r0 >= 512 or c0w >= 128:
        assert torch.equal(c, before)


@pytest.mark.parametrize("bounds", ["int", "tensor"])
@pytest.mark.parametrize("kernel", ["static", "dyn"])
@pytest.mark.parametrize("r0,c0w", [(0, 32), (8192, 544), (8200, 547),
                                    (34000, 1000), (34048, 1024)])
def test_schur_at_the_wide_panel(card, kernel, bounds, r0, c0w):
    """The shape the sweep gives the kernel at n=32768: C 34048 x 1024 words,
    k = 1024 (four k-steps, a contraction of one launch)."""
    c, lp, up = _schur_operands(card, 34048, 1024, 1024 * 32, r0, c0w)
    want = hopper_schur.gf2_schur_update_plain(c.clone(), lp, up)
    _schur_call(card, kernel, c, lp, up, r0, c0w, bounds)
    torch.cuda.synchronize()
    assert torch.equal(c, want)


@pytest.mark.parametrize("k", [32, 300, 768, 2048, 2100])
def test_schur_contraction_depths(card, k):
    """One to three k-steps in a launch, and contractions split into
    launches of KW_MAX words."""
    c, lp, up = _schur_operands(card, 700, k, 50 * 32, 130, 9)
    want = hopper_schur.gf2_schur_update_plain(c.clone(), lp, up)
    name = "launch.gf2_schur_update_hopper"
    n = counts().get(name, 0)
    hopper_schur.gf2_schur_update_hopper(c, lp, up, 130, 9, col_tile_skip=1)
    torch.cuda.synchronize()
    assert torch.equal(c, want)
    assert counts().get(name, 0) - n == \
        -(-k // (32 * hopper_schur.KW_MAX))


def test_schur_ragged_and_strided(card):
    """A ragged shape (rows, words and contraction off the tile), operands
    that are views, and bounds given as tensors on the card."""
    c, lp, up = _schur_operands(card, 300, 150, 37 * 32 + 5, 70, 9)
    want = hopper_schur.gf2_schur_update_plain(c.clone(), lp, up)
    parent = _packed(30, 400, 64 * 32, card)
    keep = parent.clone()
    view = parent[50:350, 11:11 + 38]
    view.copy_(c)
    r0 = torch.tensor(70, dtype=torch.int32, device=card)
    lpv = _packed(31, 300, 320, card)[:, 3:3 + lp.shape[1]]
    lpv.copy_(lp)
    hopper_schur.gf2_schur_update_hopper(view, lpv, up, r0, 9, col_tile_skip=1)
    torch.cuda.synchronize()
    keep[50:350, 11:11 + 38] = want
    assert torch.equal(parent, keep)


@pytest.mark.parametrize("kernel", ["static", "dyn"])
def test_schur_skips_whole_tiles_only(card, kernel):
    """With the contract broken on purpose (lp and up dense everywhere) the
    tiles wholly above r0 or left of c0w keep their words and every other
    tile takes the full product: the skip is decided on whole tiles of
    TILE_ROWS x TILE_WORDS."""
    c = _packed(40, 512, 64 * 32, card)
    lp, up = _packed(41, 512, 128, card), _packed(42, 128, 64 * 32, card)
    r0, c0w = 300, 21
    want = c.clone()
    full = c ^ gf2_mul_plain(lp, up)
    row_a, word_a = r0 // _TR * _TR, c0w // _TW * _TW
    want[row_a:, word_a:] = full[row_a:, word_a:]
    _SCHUR[kernel](c, lp, up, r0, c0w)
    torch.cuda.synchronize()
    assert torch.equal(c, want)


@pytest.mark.parametrize("kernel", ["static", "dyn"])
def test_schur_with_int_bounds_does_not_synchronise(card, kernel):
    """Nothing in the wrapper waits for the card: no copy of the bounds, no
    read-back."""
    c, lp, up = _schur_operands(card, 1024, 512, 64 * 32, 300, 16)
    want = hopper_schur.gf2_schur_update_plain(c.clone(), lp, up)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _schur_call(card, kernel, c, lp, up, 300, 16, "int")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(c, want)


def _window(card, seed, h, nb, zero=None, zero_cols=(), l_random=False):
    """A fused [panel | L] window.  ``zero``: a band of zero rows;
    ``zero_cols``: panel columns without any 1 (steps that find nothing, so
    the L slots run behind the columns and straddle words; 32 of them in one
    word make a group without a pivot); ``l_random``: an L half that is not
    zero on entry."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, (h, nb // 32), dtype=np.uint64).astype(np.uint32)
    if zero:
        x[zero[0]:zero[1]] = 0
    for c in zero_cols:
        x[:, c // 32] &= ~np.uint32(1 << (c % 32))
    lh = rng.integers(0, 2**32, x.shape, dtype=np.uint64).astype(np.uint32) \
        if l_random else np.zeros_like(x)
    al0 = np.concatenate([x, lh], axis=1)
    return torch.from_numpy(al0.view(np.int32)).to(card)


_NO_PIVOT_GROUP = tuple(range(64, 96))          # word column 2 all zero
_STRADDLE = (3, 40, 41, 70) + tuple(range(200, 215))


@pytest.mark.parametrize("h,nb,preserve_l,sw,zero,mode,extra", [
    (96, 64, False, 0, None, 0, {}), (96, 64, True, 0, None, 0, {}),
    (576, 512, True, 0, None, 0, {}), (576, 512, False, 0, (40, 300), 0, {}),
    (1088, 1024, True, 0, None, 0, {}), (1088, 1024, False, 0, None, 0, {}),
    (640, 512, False, 64, (10, 200), 0, {}),
    (640, 512, True, 64, (10, 200), 2, {}),
    (576, 512, True, 0, None, 2, {}),            # the grid on a short window
    (1088, 1024, False, 0, (100, 900), 2, {}),
    (3000, 512, True, 0, (5, 2000), 0, {}),
    (5000, 1024, False, 0, (5, 3000), 0, {}),    # too tall for one block
    (17152, 512, True, 0, (100, 9000), 0, {}),
    (576, 512, True, 0, None, 1, dict(zero_cols=_NO_PIVOT_GROUP)),
    (576, 512, False, 0, None, 2, dict(zero_cols=_NO_PIVOT_GROUP)),
    (576, 512, True, 0, None, 1, dict(zero_cols=_STRADDLE)),
    (576, 512, False, 0, None, 2, dict(zero_cols=_STRADDLE)),
    (576, 512, True, 0, None, 0, dict(l_random=True)),
    (2000, 512, False, 0, (3, 900), 2, dict(l_random=True, zero_cols=_STRADDLE)),
    (40, 2048, False, 0, None, 0, {}),           # wider than tall
    (200, 96, True, 5, None, 0, {}),             # a search window of 5 rows
    # the word column in device scratch: forced on short windows, every step
    # of a group on the slow path, then chosen by the kernel at a height whose
    # word column no block holds
    (576, 512, True, 0, (40, 300), 3, {}),
    (1088, 1024, False, 0, (100, 900), 3, dict(zero_cols=_STRADDLE)),
    (2000, 512, True, 64, (3, 900), 3, dict(l_random=True)),
    (3000, 512, False, 0, (5, 2000), 3, dict(zero_cols=_NO_PIVOT_GROUP)),
    (66816, 1024, True, 0, (500, 40000), 0, {}),
    (66816, 1024, False, 0, (0, 30000), 0, dict(zero_cols=_STRADDLE)),
])
def test_panel_loop_equals_plain(card, h, nb, preserve_l, sw, zero, mode, extra):
    al0 = _window(card, 50, h, nb, zero, **extra)
    r0, base, m = 7, 7, h - 3 + 7
    want = hopper_panel.panel_loop_plain(al0, r0, base, m, nb, preserve_l, sw)
    for rank in (r0, torch.tensor(r0, dtype=torch.int32, device=card)):
        got = hopper_panel._launch(al0, rank, base, m, nb, preserve_l, sw,
                                   mode=mode)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want,
                              ["AL", "rowperm", "r", "touched", "p", "q"]):
            assert g.shape == w.shape and torch.equal(g, w), what


def test_panel_loop_full_height_convention(card):
    """base = 0 and a rank well inside the window, as the miss fallback
    calls it; rows at positions >= m never pivot."""
    al0 = _window(card, 52, 4352, 512, (600, 2000))
    want = hopper_panel.panel_loop_plain(al0, 512, 0, 4096, 512, True)
    got = hopper_panel.panel_loop_hopper(al0, 512, 0, 4096, 512, True)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_panel_loop_modes(card):
    assert hopper_panel.window_mode(576, 512) == "shared"
    assert hopper_panel.window_mode(1088, 1024) == "shared"
    assert hopper_panel.window_mode(17152, 512) == "grid"
    assert hopper_panel.window_mode(34048, 1024) == "grid"
    assert hopper_panel.window_mode(66816, 1024) == "tall"
    assert hopper_panel.window_mode(100_000, 512) == "tall"


def test_panel_loop_refuses_a_mode_that_does_not_fit(card):
    al0 = _window(card, 51, 17152, 512)
    with pytest.raises(RuntimeError):             # 1.1 MB of panel in one block
        hopper_panel._launch(al0, 0, 0, 17152, 512, True, 0, mode=1)
    with pytest.raises(RuntimeError):             # a word column of 400 KB
        hopper_panel.window_mode(100_000, 512, mode=2)
    with pytest.raises(ValueError):               # the rank above the window
        hopper_panel._launch(al0, 3, 5, 17152, 512, True, 0)


def test_panel_loop_takes_a_device_rank_above_the_window_as_its_base(card):
    al0 = _window(card, 53, 576, 512, (40, 300))
    want = hopper_panel.panel_loop_plain(al0, 5, 5, 570, 512, True)
    for mode in (1, 2, 3):
        got = hopper_panel._launch(
            al0, torch.tensor(3, dtype=torch.int32, device=card), 5, 570, 512,
            True, 0, mode=mode)
        torch.cuda.synchronize()                  # and the card is still there
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("nb", [32, 96, 512, 1024])
def test_post_packing_equals_plain(card, nb):
    rng = np.random.default_rng(63)
    msm, wm = (torch.from_numpy((rng.random((nb, nb)) < 0.5).astype(np.int8)).to(card)
               for _ in range(2))
    cmb = torch.from_numpy((rng.random(nb) < 0.3).astype(np.int8)).to(card)
    mt, wt, colmask = hopper_post.pack_operands_hopper(msm, wm, cmb)
    torch.cuda.synchronize()
    assert torch.equal(mt, hopper_post._packed_transposed(msm))
    assert torch.equal(wt, hopper_post._packed_transposed(wm))
    assert torch.equal(colmask, hopper_post._packed_colmask(cmb))


@pytest.mark.parametrize("m,nb,below0,mvalid,force", [
    (512, 64, 192, 500, None), (1000, 512, 130, 901, False),
    (1000, 512, 130, 901, True), (700, 1024, 0, 700, None),
    (300, 96, 300, 300, None),
])
def test_panel_post_equals_plain(card, m, nb, below0, mvalid, force):
    rng = np.random.default_rng(60)
    xw = _packed(61, m, nb, card)
    msm, wm = (torch.from_numpy((rng.random((nb, nb)) < 0.5).astype(np.int8)).to(card)
               for _ in range(2))
    cmb = torch.from_numpy((rng.random(nb) < 0.2).astype(np.int8)).to(card)
    if force is False:
        cmb.zero_()
    parent = _packed(62, m, nb + 96, card)       # xw as a strided view
    view = parent[:, 1:1 + nb // 32]
    view.copy_(xw)
    want = hopper_post.panel_post_plain(xw, msm, wm, cmb, below0, mvalid)
    got = hopper_post.panel_post_hopper(view, msm, wm, cmb, below0, mvalid)
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ["v", "lam", "miss"]):
        assert torch.equal(g, w), what
    if force is not None:
        assert bool(got[2]) is force


def test_factorization_equals_plain_engine(card):
    import m4ri_tpu_torch as mt
    a = _packed(70, 1500, 1300, card)
    a[200:900] = 0                                # windows go deficient
    A = mt.from_packed(a, 1300)
    for pres in (False, True):
        want = mt.block_factor(A, preserve_l=pres, nb=256, engine="plain")
        before = counts().get("fallback.block_factor", 0)
        got = mt.block_factor(A, preserve_l=pres, nb=256)
        assert counts().get("fallback.block_factor", 0) > before
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g, w)
        assert got[3] == want[3]


def test_factorization_of_70000_rows_with_a_deficient_window(card):
    """The miss fallback's full-height window is taller than any word column
    a block's shared memory holds."""
    import m4ri_tpu_torch as mt
    a = _packed(71, 70_000, 1024, card)
    a[600:3000] = 0
    A = mt.from_packed(a, 1024)
    want = mt.block_factor(A, preserve_l=True, engine="plain")
    before = counts().get("fallback.block_factor", 0)
    got = mt.block_factor(A, preserve_l=True)
    assert counts().get("fallback.block_factor", 0) > before
    assert hopper_panel.window_mode(70_000, 512) == "tall"
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert got[3] == want[3]


# ---- the solver API on the card, held to the port's result on the CPU ----

def _both_devices(seed, rows, cols, card):
    """The same random matrix on the card and on the host."""
    import m4ri_tpu_torch as mt
    a = _packed(seed, rows, cols, card)
    return mt.from_packed(a, cols), mt.from_packed(a.cpu(), cols, device="cpu")


def _same(got, want):
    """Equal results of one entry point on the card and on the host: bit
    matrices word for word, index arrays, ranks, flags."""
    import m4ri_tpu_torch as mt
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        if isinstance(g, mt.BitMatrix):
            assert g.device.type == "cuda" and g.ncols == w.ncols
            assert torch.equal(g.data.cpu(), w.data)
        elif isinstance(g, torch.Tensor):
            assert g.device.type == "cuda"
            assert torch.equal(g.cpu(), w)
        else:
            assert g == w


def _unit_diagonal(t):
    n = t.shape[0]
    idx = torch.arange(n, device=t.device)
    t[idx, idx // 32] |= torch.ones_like(t[:, 0]) << (idx % 32).to(torch.int32)
    return t


@pytest.mark.parametrize("name", ["trsm_upper_left", "trsm_lower_left",
                                  "trsm_upper_right", "trsm_lower_right"])
@pytest.mark.parametrize("n,bcols", [(4096, 4096), (4096, 100), (2100, 2100)])
def test_trsm_equals_the_cpu_port(card, name, n, bcols):
    """Junk in the other triangle; a square B (wide-B substitution to the
    wide base, then the kernel products) and a narrow one."""
    import m4ri_tpu_torch as mt
    t = _unit_diagonal(_packed(80, n, n, card))
    T, Th = mt.from_packed(t, n), mt.from_packed(t.cpu(), n, device="cpu")
    shape = (n, bcols) if name.endswith("left") else (bcols, n)
    B, Bh = _both_devices(81, *shape, card)
    fn = getattr(mt, name)
    _same(fn(T, B), fn(Th, Bh))


@pytest.mark.parametrize("upper", [True, False])
def test_trtri_equals_the_cpu_port(card, upper):
    import m4ri_tpu_torch as mt
    t = _unit_diagonal(_packed(82, 3000, 3000, card))
    fn = mt.trtri_upper if upper else mt.trtri_lower
    _same(fn(mt.from_packed(t, 3000)),
          fn(mt.from_packed(t.cpu(), 3000, device="cpu")))


@pytest.mark.parametrize("m,n", [(2048, 2048), (1500, 2100), (2100, 1500)])
def test_pluq_equals_the_cpu_port(card, m, n):
    import m4ri_tpu_torch as mt
    A, Ah = _both_devices(83, m, n, card)
    _same(mt.pluq(A), mt.pluq(Ah))


@pytest.mark.parametrize("strategy", ["m4ri", "pluq"])
@pytest.mark.parametrize("full", [True, False])
def test_echelonize_equals_the_cpu_port(card, strategy, full):
    import m4ri_tpu_torch as mt
    A, Ah = _both_devices(84, 2048, 2500, card)
    _same(mt.echelonize(A, full=full, strategy=strategy),
          mt.echelonize(Ah, full=full, strategy=strategy))


def test_top_echelonize_equals_the_cpu_port(card):
    import m4ri_tpu_torch as mt
    A, Ah = _both_devices(85, 2048, 2048, card)
    _same(mt.top_echelonize(A), mt.top_echelonize(Ah))


def test_invert_equals_the_cpu_port(card):
    import m4ri_tpu_torch as mt
    A, Ah = _both_devices(86, 2048, 2048, card)
    _same(mt.invert(A), mt.invert(Ah))


@pytest.mark.parametrize("m,n,bcols", [(2048, 2048, 256), (2500, 2048, 40)])
def test_solve_left_equals_the_cpu_port(card, m, n, bcols):
    import m4ri_tpu_torch as mt
    A, Ah = _both_devices(87, m, n, card)
    B, Bh = _both_devices(88, m, bcols, card)
    X, ok = mt.solve_left(A, B)
    assert ok.device.type == "cuda" and ok.dtype == torch.bool
    _same((X, ok), mt.solve_left(Ah, Bh))


def test_kernel_left_equals_the_cpu_port(card):
    import m4ri_tpu_torch as mt
    lo = _packed(89, 2048, 1500, card)
    hi = _packed(90, 1500, 2048, card)
    A = mt.mul(mt.from_packed(lo, 1500), mt.from_packed(hi, 2048))
    Ah = mt.from_packed(A.data.cpu(), 2048, device="cpu")
    _same(mt.kernel_left(A), mt.kernel_left(Ah))


@pytest.mark.parametrize("m,k,n,kparam", [(2048, 2048, 2048, 0),
                                          (1500, 2100, 1000, 8)])
def test_m4rm_equals_the_cpu_port(card, m, k, n, kparam):
    import m4ri_tpu_torch as mt
    A, Ah = _both_devices(91, m, k, card)
    B, Bh = _both_devices(92, k, n, card)
    C, Ch = _both_devices(93, m, n, card)
    _same(mt.mul_m4rm(A, B, kparam), mt.mul_m4rm(Ah, Bh, kparam))
    _same(mt.addmul_m4rm(C, A, B), mt.addmul_m4rm(Ch, Ah, Bh))


def test_djb_apply_equals_the_cpu_port(card):
    import m4ri_tpu_torch as mt
    A, Ah = _both_devices(94, 256, 256, card)
    V, Vh = _both_devices(95, 256, 2048, card)
    prog = mt.djb_compile(Ah)
    _same(mt.djb_apply(prog, V), mt.djb_apply(prog, Vh))


@pytest.mark.parametrize("fmt", ["npz", "png"])
def test_readers_put_the_matrix_on_the_card(card, tmp_path, fmt):
    import m4ri_tpu_torch as mt
    from m4ri_tpu_torch.utils import io
    A, Ah = _both_devices(96, 1000, 2000, card)
    path = str(tmp_path / f"m.{fmt}")
    write, read = ((io.save_npz, io.load_npz) if fmt == "npz"
                   else (io.write_png, io.read_png))
    write(A, path)
    _same(read(path, device="cuda"), Ah)
    _same(read(path), Ah)   # device=None is the card


@pytest.mark.parametrize("name,args", [
    ("mzd_mul", lambda M: (None, M["a"], M["b"], 0)),
    ("mzd_mul_m4rm", lambda M: (None, M["a"], M["b"], 0)),
    ("mzd_addmul", lambda M: (M["c"], M["a"], M["b"], 0)),
    ("mzd_echelonize", lambda M: (M["a"], True)),
    ("mzd_ple", lambda M: (M["a"],)),
    ("mzd_solve_left", lambda M: (M["a"], M["c"])),
    ("mzd_kernel_left_pluq", lambda M: (M["s"],)),
    ("mzd_transpose", lambda M: (None, M["s"])),
    ("mzd_apply_p_left", lambda M: (M["a"], M["p"])),
    ("mzd_process_rows", lambda M: (
        M["a"], 4, 2048, 0, 4, *M["compat"].mzd_make_table(M["a"], 0, 0, 4))),
])
def test_compat_names_equal_the_cpu_port(card, name, args):
    import m4ri_tpu_torch.compat as c
    mats = {}
    for key, seed, rows, cols in (("a", 97, 2048, 2048), ("b", 98, 2048, 256),
                                  ("c", 99, 2048, 256), ("s", 100, 300, 1000)):
        mats[key] = _both_devices(seed, rows, cols, card)
    p = torch.from_numpy(np.random.default_rng(101).integers(
        np.arange(2048), 2048).astype(np.int32))
    dev = {k: v[0] for k, v in mats.items()} | {"p": p.to(card), "compat": c}
    host = {k: v[1] for k, v in mats.items()} | {"p": p, "compat": c}
    _same(getattr(c, name)(*args(dev)), getattr(c, name)(*args(host)))
    assert c.mzd_init(256, 300).device.type == "cuda"
    assert c.mzp_init(256).device.type == "cuda"


# ---- the batched path: kernels a, b, c and the sweep -----------------------

def _sync_waits(caught):
    """Warnings of the sync debug mode that name a call that waited for the
    card; its one-time notice that the mode is a prototype is not one."""
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def _batched_reads():
    """(read-backs, panels redone at full height) of the batched sweep so
    far."""
    now = counts()
    return (now.get("readback.block_factor_batched", 0),
            now.get("fallback.block_factor_batched", 0))


def _stack(seed, B, rows, cols, dev):
    return torch.stack([_packed(seed + i, rows, cols, dev) for i in range(B)])


def _card_stack(seed, B, rows, cols, dev):
    """B packed rows x cols matrices drawn on the card (large batches)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(-2**31, 2**31, (B, rows, (cols + 31) // 32),
                      dtype=torch.int32, device=dev, generator=g)
    if cols % 32:
        x[:, :, -1] &= (1 << (cols % 32)) - 1
    return x


def _batched_panel_kinds(fn):
    """fn's launches of the batched pivot loop by kind of kernel."""
    key = "launch.panel_batched."
    before = counts()
    fn()
    return {k[len(key):]: n - before.get(k, 0) for k, n in counts().items()
            if k.startswith(key) and n != before.get(k, 0)}


@pytest.mark.parametrize("sw", [0, 6, 42])
@pytest.mark.parametrize("h,nb,B", [(32, 32, 300), (576, 512, 5), (200, 64, 9),
                                    (32, 32, 2**16 + 3), (33, 32, 7),
                                    (64, 64, 1000), (576, 512, 1024)])
@pytest.mark.parametrize("pres", [False, True])
def test_batched_panel_kernel_equals_plain(card, h, nb, B, pres, sw):
    """Kernel a: a warp a window (h <= 64, nb <= 64, a batch not a multiple
    of the eight windows a block) or a block a window (several an SM at B =
    1024), each with its own base and rank (one window with a zeroed band,
    one all zero), with and without a restricted search (``sw`` rows below
    each window's rank); the outputs of the batched plain version, window by
    window."""
    x = (_stack(130, B, h, nb, card) if B <= 300
         else _card_stack(130, B, h, nb, card))
    x[1, 3:h // 2] = 0
    x[2] = 0
    al0 = torch.cat([x, torch.zeros_like(x)], dim=2)
    base = torch.arange(B, dtype=torch.int32, device=card) * 7
    r0 = base + (torch.arange(B, device=card) % 3).to(torch.int32)
    m = int(base[-1]) + h - 5
    got = hopper_panel.panel_loop_hopper_batched(al0, r0, base, m, nb, pres,
                                                 sw)
    want = hopper_panel.panel_loop_batched_plain(al0, r0, base, m, nb, pres,
                                                 sw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("h,nb,B,kind", [
    (32, 32, 2**16 + 3, "panel_warp_kernel"),
    (64, 64, 9, "panel_warp_kernel"),
    (576, 512, 1024, "panel_kernel (several an SM)"),
    (576, 512, 1, "panel_kernel (one an SM)"),
    (1088, 1024, 1, "panel_kernel (one an SM)")])
def test_batched_panel_kernel_by_shape(card, h, nb, B, kind):
    """The kernel each shape takes: NIST's windows a warp each, the
    McEliece batch's several an SM, a batch of one (``batched_one``) the
    single call's block; each against the batched plain version."""
    x = _card_stack(131, B, h, nb, card)
    al0 = torch.cat([x, torch.zeros_like(x)], dim=2)
    base = torch.zeros(B, dtype=torch.int32, device=card)
    r0 = (torch.arange(B, device=card) % 5).to(torch.int32)
    got = {}
    kinds = _batched_panel_kinds(lambda: got.update(out=(
        hopper_panel.panel_loop_hopper_batched(al0, r0, base, h, nb, True))))
    assert kinds == {kind: 1}
    want = hopper_panel.panel_loop_batched_plain(al0, r0, base, h, nb, True)
    torch.cuda.synchronize()
    for g, w in zip(got["out"], want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("sw", [0, 42])
def test_batched_panel_kernel_skips_windows_with_nothing_in_range(card, sw):
    """A McEliece-width batch (576 / 512) in which a third of the windows
    have their rank at or past m, or past their last row: those take no
    step, the rest run; every window equals the batched plain version, and
    the skipped ones the plain outputs of a window without a pivot."""
    B, h, nb, m = 258, 576, 512, 768
    x = _card_stack(132, B, h, nb, card)
    al0 = torch.cat([x, _card_stack(133, B, h, nb, card)], dim=2)
    idx = torch.arange(B, dtype=torch.int32, device=card)
    base = idx % 200
    r0 = torch.where(idx % 3 == 0, torch.where(idx % 2 == 0, m + idx % 7,
                                               base + h + idx % 4),
                     base + idx % 50)
    got = hopper_panel.panel_loop_hopper_batched(al0, r0, base, m, nb, False,
                                                 sw)
    want = hopper_panel.panel_loop_batched_plain(al0, r0, base, m, nb, False,
                                                 sw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    for b in range(0, B, 3):
        idle = hopper_panel.panel_loop_idle_plain(
            al0[b].cpu(), int(r0[b]), int(base[b]), m, nb)
        assert idle is not None
        for g, w in zip(got, idle):
            assert torch.equal(g[b].cpu(), w)


def test_batched_panel_kernel_takes_a_misaligned_stack(card):
    """A stack that starts 4 bytes off a 16-byte boundary (a view) is
    copied before the 16-byte loads of the warp kernel."""
    flat = _card_stack(134, 1, 1, 32 * (4 * 64 * 40 + 1), card).reshape(-1)
    al0 = flat[1:].reshape(40, 64, 4)
    r0 = torch.zeros(40, dtype=torch.int32, device=card)
    got = hopper_panel.panel_loop_hopper_batched(al0, r0, r0, 64, 64, True)
    want = hopper_panel.panel_loop_batched_plain(al0, r0, r0, 64, 64, True)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_batched_panel_kernel_refuses_a_window_past_shared(card):
    al0 = torch.zeros((2, 17152, 32), dtype=torch.int32, device=card)
    r = torch.zeros(2, dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError):
        hopper_panel.panel_loop_hopper_batched(al0, r, r, 17152, 512, True)


@pytest.mark.parametrize("B,m,nb", [(600, 256, 32), (6, 1792, 512),
                                    (3, 4864, 512)])
def test_batched_post_kernel_equals_plain(card, B, m, nb):
    """Kernel b: each element's own operands, row range and flag; a view of
    a wider stack as the sweep hands it over."""
    g = torch.Generator(device="cpu").manual_seed(B)
    wide = _stack(140, B, m, nb + 64, card)
    xw = wide[:, :, 1:1 + nb // 32]
    msm, wm = (torch.randint(0, 2, (B, nb, nb), generator=g,
                             dtype=torch.int8).to(card) for _ in range(2))
    cmb = (torch.rand((B, nb), generator=g) < 0.1).to(torch.int8).to(card)
    below0 = torch.randint(0, m, (B,), generator=g, dtype=torch.int32).to(card)
    got = hopper_post.panel_post_hopper_batched(xw, msm, wm, cmb, below0, m - 3)
    want = hopper_post.panel_post_batched_plain(xw, msm, wm, cmb, below0, m - 3)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got[2].any())


def test_batched_post_mixes_elements_in_and_out_of_range(card):
    """Kernel b at the McEliece width (256 elements of 1792 rows, nb = 512,
    mvalid 768): elements with rows in range (below0 off the 128-row tiles)
    beside elements with none, whose operands are never read; M given as a
    view that is not 16-byte aligned."""
    B, m, nb, mvalid = 256, 1792, 512, 768
    g = torch.Generator(device="cpu").manual_seed(181)
    xw = _stack(180, B, m, nb, card)
    msm_wide, wm = (torch.randint(0, 2, (B, nb, nb + 1 if k else nb),
                                  generator=g, dtype=torch.int8).to(card)
                    for k in (1, 0))
    msm = msm_wide[:, :, 1:]
    cmb = (torch.rand((B, nb), generator=g) < 0.05).to(torch.int8).to(card)
    below0 = torch.randint(0, m + 200, (B,), generator=g,
                           dtype=torch.int32).to(card)
    below0[:4] = torch.tensor([577, 767, 768, 0], dtype=torch.int32)
    got = hopper_post.panel_post_hopper_batched(xw, msm, wm, cmb, below0, mvalid)
    want = hopper_post.panel_post_batched_plain(xw, msm, wm, cmb, below0,
                                                mvalid)
    torch.cuda.synchronize()
    for a, b, what in zip(got, want, ("v", "lam", "miss")):
        assert torch.equal(a, b), what
    out = below0 >= mvalid
    assert bool(out.any()) and bool((~out).any())
    assert not bool(got[2][out].any())


def test_batched_post_with_nothing_in_range_passes_through(card):
    """Kernel b on 2^16 panels of the NIST shape (nb = 32, 256 rows, below0
    = mvalid = 32): v equals X, lam and every miss byte are 0."""
    B, m, nb = 1 << 16, 256, 32
    xw = torch.randint(-2**31, 2**31, (B, m, 1), dtype=torch.int32,
                       device=card)
    msm = torch.ones((B, nb, nb), dtype=torch.int8, device=card)
    cmb = torch.ones((B, nb), dtype=torch.int8, device=card)
    below0 = torch.full((B,), 32, dtype=torch.int32, device=card)
    v, lam, miss = hopper_post.panel_post_hopper_batched(xw, msm, msm, cmb,
                                                         below0, 32)
    torch.cuda.synchronize()
    assert torch.equal(v, xw)
    assert not bool(lam.any()) and not bool(miss.any())


@pytest.mark.parametrize("B,m,k,nw,c0w", [(5, 512, 512, 40, 16),
                                          (1024, 512, 512, 16, 0),
                                          (3, 300, 1100, 37, 9),
                                          (16, 4864, 512, 128, 48)])
@pytest.mark.parametrize("bound", ["int", "tensor"])
def test_batched_schur_kernel_equals_plain(card, B, m, k, nw, c0w, bound):
    """Kernel c: each element under the contract of its own r0 (some past
    every row), a contraction deeper than one launch's, ragged tiles."""
    c = _stack(150, B, m, nw * 32, card)
    lp = _stack(160, B, m, k, card)
    up = _stack(170, B, k, nw * 32, card)
    r0s = (torch.arange(B, device=card) * 97 % (m + 300)).to(torch.int32)
    if bound == "int":
        r0s[:] = 5
    rows = torch.arange(m, device=card)
    lp *= (rows[None, :] >= r0s[:, None]).to(torch.int32)[:, :, None]
    up[:, :, :c0w] = 0
    want = hopper_schur.gf2_schur_update_plain(c.clone(), lp, up)
    r0 = 5 if bound == "int" else r0s
    hopper_schur.gf2_schur_update_batched_hopper(c, lp, up, r0, c0w)
    torch.cuda.synchronize()
    assert torch.equal(c, want)


def test_batched_schur_with_r0_spread_over_the_row_tiles(card):
    """Kernel c at the McEliece width (768 x 112 words, k = 512): each
    element's r0 on, inside, at the end of or past its row tiles, and c0w
    off the 8-word column tiles."""
    B, m, k, nw, c0w = 64, 768, 512, 112, 21
    c = _stack(190, B, m, nw * 32, card)
    lp = _stack(200, B, m, k, card)
    up = _stack(210, B, k, nw * 32, card)
    r0s = torch.tensor([0, 1, 255, 256, 257, 511, 512, 700, 767, 768, 800,
                        5000] * 5 + [-3, 300, 600, 768], dtype=torch.int32,
                       device=card)
    rows = torch.arange(m, device=card)
    lp *= (rows[None, :] >= r0s[:, None]).to(torch.int32)[:, :, None]
    up[:, :, :c0w] = 0
    want = hopper_schur.gf2_schur_update_plain(c.clone(), lp, up)
    hopper_schur.gf2_schur_update_batched_hopper(c, lp, up, r0s, c0w)
    torch.cuda.synchronize()
    assert torch.equal(c, want)


@pytest.mark.parametrize("B,m,n,pres", [(64, 32, 32, False), (4, 768, 3488, True),
                                        (3, 1000, 700, False)])
def test_batched_sweep_equals_single_block_factor(card, B, m, n, pres):
    """block_factor_batched on the card: each element equals the
    single-matrix block_factor on the card, with a zero matrix and a
    deficient one in the batch; the batched kernels launched."""
    import m4ri_tpu_torch as mt
    from m4ri_tpu_torch.models.batched import block_factor_batched
    data = _stack(180, B, m, n, card)
    data[1] = 0
    data[2, 5:m // 2] = 0
    names = ("launch.panel_loop_hopper_batched",
             "launch.panel_post_hopper_batched")
    before = [counts().get(k, 0) for k in names]
    got = block_factor_batched(data, n, pres)
    for i in range(B):
        want = mt.block_factor(mt.BitMatrix(data[i], n), pres)
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g[i], w)
        assert int(got[3][i]) == want[3]
    assert all(counts().get(k, 0) > n for k, n in zip(names, before))


def test_batched_sweep_counts_every_read_back(card):
    """Every call that waits for the card in a batched factorization, as
    PyTorch's sync debug mode sees it, is one the sweep counts in
    ``readback.block_factor_batched``: one a panel, one more on a panel
    where some element
    missed, and none in the full-height fallbacks."""
    import warnings

    from m4ri_tpu_torch.models import batched
    B, m, n = 5, 1000, 700
    data = _stack(181, B, m, n, card)
    data[::2, 100:600] = 0              # three elements miss their windows
    batched.block_factor_batched(data, n, True)       # kernels built
    torch.cuda.synchronize()
    fn = batched.block_factor_batched
    s0, f0 = _batched_reads()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(data, n, True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    waits = _sync_waits(caught)
    panels = -(-n // batched.panel_widths(m, n)[0])
    s1, f1 = _batched_reads()
    assert f1 > f0
    assert waits == s1 - s0
    assert panels < waits <= 2 * panels


# ---- the batched solver API: every element against the single call ---------

def _batched_solver_calls(card):
    """{entry: (batched call, single call of element i, batch size)} on one
    small stack a kind, with a zero element and a deficient one."""
    import m4ri_tpu_torch as mt
    B, m, n = 4, 600, 900
    a = _stack(190, B, m, n, card)
    a[1] = 0
    a[2, 100:] = a[2, :m - 100].clone()
    sq = a[:, :, : (m + 31) // 32].clone()
    sq[:, :, -1] &= (1 << (m % 32)) - 1
    b = _stack(191, B, m, 3, card)
    t = _stack(192, B, m, m, card)
    idx = torch.arange(m, device=card)
    t[:, idx, idx // 32] |= torch.ones_like(idx, dtype=torch.int32) << (
        idx % 32).to(torch.int32)
    t[:, :, -1] &= (1 << (m % 32)) - 1
    bl, br = _stack(193, B, m, 40, card), _stack(194, B, 40, m, card)
    M = lambda x, c: mt.BitMatrix(x, c)     # noqa: E731
    pl = mt.pluq_batched(a, n)
    calls = {
        "ple": (lambda: mt.ple_batched(a, n), lambda i: mt.ple(M(a[i], n))),
        "pluq": (lambda: mt.pluq_batched(a, n), lambda i: mt.pluq(M(a[i], n))),
        "rref_m4ri": (lambda: mt.echelonize_batched(a, n),
                      lambda i: mt.echelonize(M(a[i], n))),
        "ref_pluq": (lambda: mt.echelonize_batched(a, n, full=False,
                                                   strategy="pluq"),
                     lambda i: mt.echelonize(M(a[i], n), full=False,
                                             strategy="pluq")),
        "kernel_left": (lambda: mt.kernel_left_batched(a, n),
                        lambda i: mt.kernel_left(M(a[i], n))),
        "solve_left": (lambda: mt.solve_left_batched(a, n, b, 3),
                       lambda i: mt.solve_left(M(a[i], n), M(b[i], 3))),
        "pluq_solve_left": (
            lambda: mt.pluq_solve_left_batched(pl[0], n, pl[1], pl[2], pl[3],
                                               b, 3),
            lambda i: mt.pluq_solve_left(M(pl[0][i], n), pl[1][i], pl[2][i],
                                         int(pl[3][i]), M(b[i], 3))),
        "invert": (lambda: mt.invert_batched(sq),
                   lambda i: mt.invert(M(sq[i], m))),
        "trtri_upper": (lambda: mt.trtri_upper_batched(t),
                        lambda i: mt.trtri_upper(M(t[i], m))),
        "trsm_lower_left": (lambda: mt.trsm_lower_left_batched(t, bl, 40),
                            lambda i: mt.trsm_lower_left(M(t[i], m),
                                                         M(bl[i], 40))),
        "trsm_upper_right": (lambda: mt.trsm_upper_right_batched(t, br, m),
                             lambda i: mt.trsm_upper_right(M(t[i], m),
                                                           M(br[i], m))),
    }
    return calls, B


BATCHED_SOLVERS = ["ple", "pluq", "rref_m4ri", "ref_pluq", "kernel_left",
                   "solve_left", "pluq_solve_left", "invert", "trtri_upper",
                   "trsm_lower_left", "trsm_upper_right"]


@pytest.mark.parametrize("entry", BATCHED_SOLVERS)
def test_batched_solver_equals_single_on_the_card(card, entry):
    """Each element of a batched call equals the single-matrix call on the
    card, part by part; ranks, flags and counts stay on the card."""
    import warnings

    from m4ri_tpu_torch.core.bitmatrix import BitMatrix
    calls, B = _batched_solver_calls(card)
    batched_fn, single_fn = calls[entry]
    batched_fn()                            # kernels built
    torch.cuda.synchronize()
    s0 = _batched_reads()[0]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = batched_fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    waits = _sync_waits(caught)
    assert waits == _batched_reads()[0] - s0
    got = got if isinstance(got, tuple) else (got,)
    for part in got:
        assert part.device.type == "cuda"
    for i in range(B):
        want = single_fn(i)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            w = w.data if isinstance(w, BitMatrix) else w
            if isinstance(w, torch.Tensor):
                assert torch.equal(g[i], w.to(g.dtype)), (entry, i)
            else:
                assert int(g[i]) == w, (entry, i)


@pytest.mark.parametrize("n", [70, 96, 4100])
def test_masks_are_made_on_the_card_without_waiting(card, n):
    """The padding and triangle masks and a transpose wait for nothing on
    the card (a mask copied from a host table waited for the stream, at
    every level of the TRSM recursion), and equal the CPU port's."""
    import warnings

    from m4ri_tpu_torch.core.bitmatrix import BitMatrix, mask_padding
    from m4ri_tpu_torch.core.bitops import _triangle_mask
    from m4ri_tpu_torch.core.transpose import transpose
    raw = _packed(11, 3 * n, n, "cpu") | -1                 # padding bits set
    x = BitMatrix(raw.to(card).view(3, n, -1), n)
    fns = [lambda x: mask_padding(x).data,
           lambda x: _triangle_mask(n, True, x.device),
           lambda x: _triangle_mask(n, False, x.device),
           lambda x: transpose(mask_padding(BitMatrix(x.data[1], n))).data]
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = [fn(x) for fn in fns]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert _sync_waits(caught) == 0
    host = BitMatrix(raw.view(3, n, -1), n)
    for g, fn in zip(got, fns):
        assert torch.equal(g.cpu(), fn(host))


# ---- top_echelonize and the naive engines over a batch ---------------------

def _top_and_naive_calls(a, sq):
    """{entry: call of a stack [B, 600, w(900)]}; sq is the padding mask of
    600 columns, [600, w(600)], which cuts a square element out of each."""
    import m4ri_tpu_torch as mt
    return {
        "top_echelonize": lambda x: mt.top_echelonize_batched(x, 900),
        "top_echelonize_k1": lambda x: mt.top_echelonize_batched(x, 900, k=1),
        "echelonize_naive": lambda x: mt.echelonize_naive_batched(x, 900),
        "gauss_delayed": lambda x: mt.gauss_delayed_batched(x, 900,
                                                            start_col=300),
        "invert_naive": lambda x: mt.invert_naive_batched(
            x[:, :, : sq.shape[1]] & sq.to(x.device)),
    }


@pytest.mark.parametrize("entry", ["top_echelonize", "top_echelonize_k1",
                                   "echelonize_naive", "gauss_delayed",
                                   "invert_naive"])
def test_batched_top_and_naive_equal_the_cpu_port(card, entry):
    """top_echelonize_batched on REF inputs and the naive engines over a
    batch equal the CPU port word for word and wait for nothing on the card;
    the restricted search launches the three batched kernels."""
    import warnings

    import m4ri_tpu_torch as mt
    B, m, n = 4, 600, 900
    a = _stack(195, B, m, n, card)
    a[1] = 0
    a[2, 100:] = a[2, :m - 100].clone()
    if entry.startswith("top"):
        a = mt.echelonize_batched(a, n, full=False)[0]
    sq = torch.full((m, (m + 31) // 32), -1, dtype=torch.int32, device=card)
    sq[:, -1] = (1 << (m % 32)) - 1                      # the padding mask
    call = _top_and_naive_calls(a, sq)[entry]
    call(a)                                             # kernels built
    torch.cuda.synchronize()
    s0 = _batched_reads()[0]
    launched = counts().get("launch.panel_loop_hopper_batched", 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = call(a)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert _sync_waits(caught) == 0 and _batched_reads()[0] == s0
    if entry.startswith("top"):
        assert counts().get("launch.panel_loop_hopper_batched", 0) > launched
    want = call(a.cpu())
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w)


# ---- the unit-triangular inverse (ops/hopper_trinv.py) ---------------------

from m4ri_tpu_torch.ops import hopper_trinv  # noqa: E402


def _nil_stack(seed, batch, n, card, upper):
    """[batch, n, w(n)] random words with padding bits zero; with three or
    more elements the first is zero and the second the full strict
    triangle."""
    w = (n + 31) // 32
    nil = _packed(seed, batch * n, n, card).view(batch, n, w)
    if batch >= 3:
        i = np.arange(n)
        full = (i[None, :] > i[:, None]) if upper else (i[None, :] < i[:, None])
        nil[0] = 0
        nil[1] = _words_on_card(full)
    return nil


def _words_on_card(bits):
    import m4ri_tpu_torch as mt
    return mt.from_numpy(bits.astype(np.uint8)).data


@pytest.mark.parametrize("upper", [True, False])
@pytest.mark.parametrize("batch,n", [(1024, 512), (1024, 384), (1, 1024),
                                     (2**12, 32), (3, 1024), (5, 100),
                                     (40, 512)])
def test_unit_tri_inv_equals_plain(card, batch, n, upper):
    """The kernel against its plain version on the card, bit for bit, at
    the McEliece T / S and TRSM-base shapes, the single sweep's wide panel,
    NIST's 32, a ragged width and a batch below the SMs (column strips)."""
    nil = _nil_stack(200 + n + batch, batch, n, card, upper)
    before = counts().get("launch.unit_tri_inv_hopper", 0)
    got = hopper_trinv.unit_tri_inv_hopper(nil, upper)
    torch.cuda.synchronize()
    assert counts().get("launch.unit_tri_inv_hopper", 0) == before + 1
    assert torch.equal(got, hopper_trinv.unit_tri_inv_plain(nil, upper))


def test_unit_tri_inv_takes_views(card):
    """A block of a wider matrix (rows further apart than its words), as the
    TRSM recursion hands it over."""
    parent = _packed(210, 4 * 768, 768, card).view(4, 768, 24)
    view = parent[:, 384:, 12:]
    got = hopper_trinv.unit_tri_inv_hopper(view, True)
    assert torch.equal(got, hopper_trinv.unit_tri_inv_plain(view.contiguous(),
                                                           True))


def test_sweeps_through_the_inverse_equal_the_plain_engine(card):
    """A ple 4096^2 and a batched McEliece-shaped sweep take the inverse
    (an L11^{-1} a panel but the last; T is taken inside the operands'
    launch) and equal the plain engine, which takes its plain version."""
    import m4ri_tpu_torch as mt
    from m4ri_tpu_torch.models.batched import block_factor_batched
    A = mt.from_packed(_packed(211, 4096, 4096, card), 4096)
    key = "launch.unit_tri_inv_hopper"
    before = counts().get(key, 0)
    got = mt.block_factor(A, preserve_l=True)
    assert counts().get(key, 0) - before == 8 - 1
    want = mt.block_factor(A, preserve_l=True, engine="plain")
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert got[3] == want[3]
    data = _stack(212, 16, 768, 3488, card)
    for pres in (False, True):
        before = counts().get(key, 0)
        got = block_factor_batched(data, 3488, pres)
        assert counts().get(key, 0) - before == 7 - 1
        want = block_factor_batched(data, 3488, pres, engine="plain")
        for g, w in zip(got, want):
            assert torch.equal(g, w)


# ---- the batched sweep's commit (ops/hopper_commit.py) -----------------------

def _commit_ops(data, n, pres, panel=0, **kw):
    """What the batched sweep hands the commit's wrapper on ``panel``."""
    from m4ri_tpu_torch.benches.split_batched import capture_panel
    name = "panel_commit_hopper_batched"
    return capture_panel(data, n, pres, panel=panel, need=(name,), **kw)[name]


def _committed(fn, ops):
    """A, P, Q and lam after ``fn`` on a copy of ``ops``."""
    a = [x.clone() if isinstance(x, torch.Tensor) else x for x in ops]
    fn(*a)
    torch.cuda.synchronize()
    return [a[k] for k in (0, 1, 2, 4)]


@pytest.mark.parametrize("case", ["nist_65536", "keygen_panel1",
                                  "keygen_panel2", "keygen_panel3",
                                  "misses", "search_window"])
def test_commit_kernel_equals_plain(card, case):
    """The kernel against its plain version word for word on whole buffers
    (the padding rows included) on what the sweep hands it: 65,536 NIST 32^2
    panels (the warp plan), mceliece348864's panels 1-3 at a batch of 64
    (the block plan; panel 3 with every rank at m), a batch where three
    elements miss (left alone by the kernel) and the restricted search.  Two
    calls on copies of the same input agree (no stale buffer)."""
    from m4ri_tpu_torch.ops import hopper_commit
    if case == "nist_65536":
        ops, plan = _commit_ops(_card_stack(220, 65_536, 32, 32, card), 32,
                                False), "warp"
    elif case.startswith("keygen"):
        ops = _commit_ops(_card_stack(221, 64, 768, 3488, card), 3488, False,
                          panel=int(case[-1]) - 1)
        plan = "block"
    elif case == "misses":
        data = _stack(222, 5, 1000, 700, card)
        data[::2, 100:600] = 0
        ops, plan = _commit_ops(data, 700, True, panel=1, nb=64), "block"
        assert 0 < int(ops[11].sum()) < 5
    else:
        ops, plan = _commit_ops(_card_stack(223, 64, 768, 3488, card), 3488,
                                False, search_window=42), "block"
    key = f"launch.panel_commit_hopper_batched.{plan}"
    before = counts().get(key, 0)
    got = _committed(hopper_commit.panel_commit_hopper_batched, ops)
    assert counts().get(key, 0) == before + 1
    again = _committed(hopper_commit.panel_commit_hopper_batched, ops)
    want = _committed(hopper_commit.panel_commit_batched_plain, ops)
    for g, a, w, name in zip(got, again, want, ("A", "P", "Q", "lam")):
        assert torch.equal(g, w), (case, name)
        assert torch.equal(a, g), (case, name)


@pytest.mark.parametrize("B,m,n,panels", [(4096, 32, 32, 1),
                                          (16, 768, 3488, 7)])
def test_commit_one_launch_a_panel_and_no_wait(card, B, m, n, panels):
    """One commit launch a panel of every batched sweep, and the call waits
    for the card only at the sweep's one read-back a panel (PyTorch's sync
    debug mode), as before the commit was a kernel."""
    import warnings

    import m4ri_tpu_torch as mt
    data = _card_stack(224, B, m, n, card)
    mt.rank_batched(data, n)                            # kernels built
    torch.cuda.synchronize()
    key = "launch.panel_commit_hopper_batched"
    before = counts().get(key, 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            mt.rank_batched(data, n)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert counts().get(key, 0) - before == panels
    assert _sync_waits(caught) == panels

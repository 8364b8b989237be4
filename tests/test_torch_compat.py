"""The reference-API surface of the PyTorch/CUDA port against the JAX
package (mirrors test_compat.py).  Every case there runs through both
``compat`` modules on the same numpy input, and every one of the 148 names
is called by some case here with equal results in both packages: equal
packed words, ranks, swap arrays, scalars and printed text (tolerance 0)."""

import io as _stdio

import numpy as np
import pytest
import torch

import m4ri_tpu as mj
import m4ri_tpu.compat as jc
import m4ri_tpu_torch as mt
import m4ri_tpu_torch.compat as tc
from m4ri_tpu_torch.parallel import mesh as tmesh
from m4ri_tpu.utils import io as jio
from m4ri_tpu.utils.rng import GlibcRandom as JGlibcRandom
from m4ri_tpu_torch.utils.rng import GlibcRandom as TGlibcRandom

import jax.numpy as jnp
import oracle
from conftest import random_dense
from torch_port import assert_padding_zero, assert_same, both, with_bit31, \
    words


def test_names_equal_jax():
    assert set(tc.__all__) == set(jc.__all__)
    assert len(tc.__all__) == 148


def _norm(x):
    """A comparable form of a result of either package."""
    if hasattr(x, "ncols") and hasattr(x, "data"):
        return ("matrix", x.ncols, words(x).tolist())
    if hasattr(x, "srctyp"):
        return ("djb", x.nrows, x.ncols, list(x.target), list(x.source),
                list(x.srctyp))
    if isinstance(x, (tuple, list)):
        return tuple(_norm(y) for y in x)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    elif x is not None and not isinstance(x, (bool, int, float, str)):
        x = np.asarray(x)
    if isinstance(x, np.ndarray) and x.ndim == 0:  # ranks, flags, fields
        x = int(x) & 0xFFFFFFFF if x.dtype.kind in "iu" and x.itemsize <= 4 \
            else x.item()
    if isinstance(x, np.ndarray):
        if x.dtype.kind in "iu":  # int32 words hold the uint32 words' bits
            return ("ints", x.shape, (x.astype(np.int64) & 0xFFFFFFFF).tolist())
        if x.dtype.kind == "b":
            return ("bools", x.shape, x.tolist())
        return ("floats", x.shape, x.astype(np.float64).tolist())
    if isinstance(x, int) and not isinstance(x, bool):
        return x & 0xFFFFFFFFFFFFFFFF
    return x


class _Side:
    """One package's inputs: the same numpy matrices and swap arrays."""

    def __init__(self, c, mats, perms, port):
        self.c = c
        for name, a in mats.items():
            setattr(self, name, mt.from_numpy(a, device="cpu") if port
                    else mj.from_numpy(a))
        for name, p in perms.items():
            setattr(self, name, torch.from_numpy(p) if port else jnp.asarray(p))
        self.glibc = TGlibcRandom if port else JGlibcRandom

    def pluq_args(self):
        M, P, Q, r = self.c.mzd_pluq(self.S)
        return M, r, P, Q, self.X


def _swaps(rng, n):
    """A LAPACK-style swap array: v[i] >= i."""
    return np.array([rng.integers(i, n) for i in range(n)], np.int32)


@pytest.fixture(scope="module")
def sides():
    rng = np.random.default_rng(29)
    n = 40
    u = np.triu(random_dense(rng, n, n), 1) ^ np.eye(n, dtype=np.uint8)
    tab = random_dense(rng, 24, 64)
    tab[:4, :4] = np.eye(4, dtype=np.uint8)
    mats = {
        "A": with_bit31(rng, 24, 70), "A2": random_dense(rng, 24, 70),
        "B": random_dense(rng, 70, 40), "C": with_bit31(rng, 24, 40),
        "S": with_bit31(rng, n, n), "U": u, "L": u.T.copy(),
        "X": random_dense(rng, n, 33), "XR": random_dense(rng, 33, n),
        "V": random_dense(rng, 1, 24), "VA": random_dense(rng, 1, 70),
        "T": tab,
    }
    perms = {"p24": _swaps(rng, 24), "p70": _swaps(rng, 70)}
    return _Side(jc, mats, perms, False), _Side(tc, mats, perms, True)


def _table_args(g, n):
    T, L = g.c.mzd_make_table(g.T, 0, 0, 4)
    return (g.T, 4, 24, 0, 4, *([T, L] * n))


def _djb(g):
    return g.c.djb_compile_(g.S)


# (name, args from a _Side, keyword arguments for the port only)
CASES = [
    ("mzd_init", lambda g: (5, 70), {"device": "cpu"}),
    ("mzd_copy", lambda g: (None, g.A)),
    ("mzd_free", lambda g: (g.A,)),
    ("mzd_transpose", lambda g: (None, g.A)),
    ("mzd_stack", lambda g: (None, g.A, g.A2)),
    ("mzd_concat", lambda g: (None, g.A, g.C)),
    ("mzd_submatrix", lambda g: (None, g.A, 2, 3, 20, 60)),
    ("mzd_init_window", lambda g: (g.A, 1, 5, 9, 69)),
    ("mzd_init_window_const", lambda g: (g.A, 0, 33, 24, 70)),
    ("mzd_set_ui", lambda g: (g.S, 1)),
    ("mzd_is_zero", lambda g: (g.A,)),
    ("mzd_equal", lambda g: (g.A, g.A2)),
    ("mzd_density", lambda g: (g.A,)),
    ("mzd_randomize_custom", lambda g: (g.A, g.glibc(17).random_word)),
    ("mzd_read_bit", lambda g: (g.A, 3, 31)),
    ("mzd_write_bit", lambda g: (g.A, 3, 31, 0)),
    ("mzd_read_bits", lambda g: (g.A, 2, 20, 32)),
    ("mzd_read_bits_int", lambda g: (g.A, 2, 5, 61)),
    ("mzd_xor_bits", lambda g: (g.A, 1, 5, 64, 0xDEADBEEFCAFEF00D)),
    ("mzd_and_bits", lambda g: (g.A, 2, 29, 40, 0x8000000180000001)),
    ("mzd_clear_bits", lambda g: (g.A, 3, 33, 30)),
    ("mzd_row_swap", lambda g: (g.A, 1, 5)),
    ("mzd_col_swap", lambda g: (g.A, 3, 63)),
    ("mzd_row_add", lambda g: (g.A, 0, 5)),
    ("mzd_row_add_offset", lambda g: (g.A, 5, 0, 33)),
    ("mzd_extract_u", lambda g: (None, g.A)),
    ("mzd_extract_l", lambda g: (None, g.S)),
    ("mzd_find_pivot", lambda g: (g.A, 2, 3)),
    ("mzd_col_swap_in_rows", lambda g: (g.A, 3, 40, 5, 15)),
    ("mzd_add", lambda g: (None, g.A, g.A2)),
    ("mzd_sub", lambda g: (g.A, g.A2)),
    ("mzd_mul", lambda g: (None, g.A, g.B, 0)),
    ("mzd_addmul", lambda g: (g.C, g.A, g.B, 0)),
    ("mzd_mul_naive", lambda g: (None, g.A, g.B)),
    ("mzd_addmul_naive", lambda g: (g.C, g.A, g.B)),
    ("mzd_mul_m4rm", lambda g: (None, g.A, g.B, 5)),
    ("mzd_addmul_m4rm", lambda g: (g.C, g.A, g.B, 0)),
    ("mzd_echelonize", lambda g: (g.A, True)),
    ("mzd_echelonize_m4ri", lambda g: (g.A, False, 0)),
    ("mzd_echelonize_pluq", lambda g: (g.A, True)),
    ("mzd_echelonize_naive", lambda g: (g.A, False)),
    ("mzd_gauss_delayed", lambda g: (g.A, 3, True)),
    ("mzd_top_echelonize_m4ri", lambda g: (g.S, 0)),
    ("mzd_ple", lambda g: (g.A, None, None, 0)),
    ("mzd_pluq", lambda g: (g.S,)),
    ("mzd_inv_m4ri", lambda g: (None, g.U, 0)),
    ("mzd_invert_naive", lambda g: (None, g.L)),
    ("mzd_solve_left", lambda g: (g.U, g.X, 0, 1)),
    ("mzd_pluq_solve_left", lambda g: g.pluq_args()),
    ("mzd_mul_va", lambda g: (g.VA, g.V, g.A, False)),
    ("mzd_kernel_left_pluq", lambda g: (g.A,)),
    ("mzd_trsm_upper_left", lambda g: (g.U, g.X, 0)),
    ("mzd_trsm_lower_left", lambda g: (g.L, g.X)),
    ("mzd_trsm_upper_right", lambda g: (g.U, g.XR)),
    ("mzd_trsm_lower_right", lambda g: (g.L, g.XR, 0)),
    ("mzd_trtri_upper", lambda g: (g.U,)),
    ("mzd_trtri_upper_russian", lambda g: (g.U,)),
    ("mzp_init", lambda g: (6,), {"device": "cpu"}),
    ("mzp_set_ui", lambda g: (g.p24, 1)),
    ("mzd_apply_p_left", lambda g: (g.A, g.p24)),
    ("mzd_apply_p_left_trans", lambda g: (g.A, g.p24)),
    ("mzd_apply_p_right", lambda g: (g.A, g.p70)),
    ("mzd_apply_p_right_trans", lambda g: (g.A, g.p70)),
    ("mzd_apply_p_right_trans_tri", lambda g: (g.S, g.c.mzd_pluq(g.S)[2])),
    ("mzd_apply_p_right_even_capped", lambda g: (g.A, g.p70, 6, 0)),
    ("mzd_apply_p_right_trans_even_capped", lambda g: (g.A, g.p70, 9, 0)),
    ("mzd_from_str", lambda g: (2, 3, "101010"), {"device": "cpu"}),
    ("mzd_info", lambda g: (g.A, 1)),
    ("mzd_print", lambda g: (g.C,)),
    ("mzd_hash", lambda g: (g.A,)),
    ("djb_compile", lambda g: (g.S,)),
    ("djb_compile_", lambda g: (g.A,)),
    ("djb_apply", lambda g: (_djb(g), g.X)),
    ("djb_apply_mzd", lambda g: (_djb(g), None, g.X)),
    ("m4ri_word_to_str", lambda g: (0x80000001,)),
    ("mzd_cmp", lambda g: (g.A, g.A2)),
    ("mzd_copy_row", lambda g: (g.A, 2, g.A2, 3)),
    ("mzd_row_clear_offset", lambda g: (g.A, 3, 33)),
    ("mzd_first_zero_row", lambda g: (g.A,)),
    ("mzd_fprint_row", lambda g: (g.A, 4)),
    ("m4ri_swap_bits", lambda g: (0x80000003,)),
    ("m4ri_spread_bits", lambda g: (0b1011, [0, 3, 5, 9], 4)),
    ("m4ri_shrink_bits", lambda g: (0b1000101001, [0, 3, 5, 9], 4)),
    ("m4ri_lesser_LSB", lambda g: (12, 10)),
    ("m4ri_parity64", lambda g: (np.arange(64, dtype=np.uint64) * 3,)),
    ("m4ri_parity64_helper", lambda g: (np.arange(40, dtype=np.uint64),)),
    ("m4ri_gray_code", lambda g: (5, 4)),
    ("m4ri_opt_k", lambda g: (4096, 4096, 0)),
    ("m4ri_build_code", lambda g: (4,)),
    ("m4ri_init", lambda g: ()),
    ("m4ri_fini", lambda g: ()),
    ("m4ri_build_all_codes", lambda g: ()),
    ("m4ri_destroy_all_codes", lambda g: ()),
    ("m4ri_mm_malloc", lambda g: (16,)),
    ("m4ri_mm_malloc_aligned", lambda g: (128, 64)),
    ("m4ri_mm_calloc", lambda g: (3, 5)),
    ("m4ri_mm_free", lambda g: (None,)),
    ("m4ri_mmc_malloc", lambda g: (8,)),
    ("m4ri_mmc_calloc", lambda g: (2, 4)),
    ("m4ri_mmc_free", lambda g: (None,)),
    ("m4ri_mmc_cleanup", lambda g: ()),
    ("m4ri_dd_mzd", lambda g: ("f", 7, g.A)),
    ("m4ri_dd_mzp", lambda g: ("f", 8, g.p70)),
    ("m4ri_dd_int", lambda g: ("f", 9, -3)),
    ("m4ri_dd_rci", lambda g: ("f", 10, 5)),
    ("m4ri_dd_rci_array", lambda g: ("f", 11, g.p24, 7)),
    ("m4ri_dd_row", lambda g: ("f", 12, g.A, 3)),
    ("m4ri_dd_rawrow", lambda g: ("f", 13, g.A, 23)),
    ("mzd_row", lambda g: (g.A, 5)),
    ("mzd_row_const", lambda g: (g.A, 0)),
    ("mzd_combine", lambda g: (g.A, 3, 0, g.A, 1, 0, g.A2, 2, 0)),
    ("mzd_combine_even", lambda g: (g.A, 3, 1, g.A2, 1, 1, g.A2, 2, 1)),
    ("mzd_combine_even_in_place", lambda g: (g.A, 0, 2, g.A2, 7, 2)),
    ("mzd_is_windowed", lambda g: (g.A,)),
    ("mzd_is_dangerous_window", lambda g: (g.A,)),
    ("mzd_make_table", lambda g: (g.T, 0, 0, 4)),
    ("mzd_process_rows", lambda g: _table_args(g, 1)),
    ("mzd_process_rows2", lambda g: _table_args(g, 2)),
    ("mzd_process_rows3", lambda g: _table_args(g, 3)),
    ("mzd_process_rows4", lambda g: _table_args(g, 4)),
    ("mzd_process_rows5", lambda g: _table_args(g, 5)),
    ("mzd_process_rows6", lambda g: _table_args(g, 6)),
    ("mzp_copy", lambda g: (None, g.p70)),
    ("mzp_free", lambda g: (g.p24,)),
    ("mzp_init_window", lambda g: (g.p70, 3, 11)),
    ("mzp_init_mzp_t_window", lambda g: (g.p24, 0, 24)),
    ("mzp_free_window", lambda g: (g.p24,)),
    ("mzp_free_mzp_t_window", lambda g: (g.p24,)),
    ("mzp_print", lambda g: (g.p24,)),
    ("mzd_print_row", lambda g: (g.A, 23)),
    ("djb_init", lambda g: (3, 4)),
    ("djb_free", lambda g: (None,)),
    ("djb_info", lambda g: (_djb(g),)),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_name_equals_jax(sides, capsys, case):
    name, args = case[0], case[1]
    port_kw = case[2] if len(case) > 2 else {}
    js, ts = sides
    want = _norm(getattr(jc, name)(*args(js)))
    printed = capsys.readouterr().out
    got = getattr(tc, name)(*args(ts), **port_kw)
    assert _norm(got) == want
    assert capsys.readouterr().out == printed
    for item in got if isinstance(got, tuple) else (got,):
        if isinstance(item, mt.BitMatrix):
            assert_padding_zero(item)
            assert item.device.type == "cpu"


# the names no case of CASES calls, each called by a test below
ELSEWHERE = {"mzd_fprint", "mzd_from_jcf", "mzd_from_png", "mzd_to_png",
             "mzd_randomize", "m4ri_srandom", "m4ri_random_word",
             "m4ri_coin_flip", "m4ri_die", "mzd_mul_mp", "mzd_addmul_mp",
             "djb_push_back", "source_source", "source_target",
             "m4ri_radix"}


def test_every_name_is_held_to_jax():
    assert {c[0] for c in CASES} | ELSEWHERE == set(tc.__all__)


def test_reference_style_program(rng):
    """The canonical reference usage pattern, straight from its README,
    through both packages."""
    out = {}
    for c, port in ((jc, False), (tc, True)):
        kw = {"device": "cpu"} if port else {}
        c.m4ri_srandom(17)
        A = c.mzd_randomize(c.mzd_init(100, 100, **kw))
        B = c.mzd_randomize(c.mzd_init(100, 100, **kw))
        C = c.mzd_mul(None, A, B, 0)
        C2 = c.mzd_mul_naive(None, A, B)
        C3 = c.mzd_mul_m4rm(None, A, B, 0)
        assert bool(c.mzd_equal(C, C2)) and bool(c.mzd_equal(C, C3))
        E, r = c.mzd_echelonize(c.mzd_copy(None, A), full=True)
        M, P, Q, rr = c.mzd_ple(c.mzd_copy(None, A), None, None, 0)
        X, ok = c.mzd_solve_left(A, C, 0, 1)
        assert bool(ok) and int(rr) == int(r)
        inv = c.mzd_inv_m4ri(None, A, 0) if int(r) == 100 else None
        out[port] = [A, B, C, E, int(r), M, P, Q, X, inv]
    for j, t in zip(out[False], out[True]):
        assert _norm(j) == _norm(t)
    A, r, E, X = out[True][0], out[True][4], out[True][3], out[True][8]
    a_np = mt.to_numpy(A)
    assert r == oracle.rank(a_np)
    np.testing.assert_array_equal(mt.to_numpy(E), oracle.rref(a_np))
    np.testing.assert_array_equal(oracle.mul(a_np, mt.to_numpy(X)),
                                  mt.to_numpy(out[True][2]))


def test_compat_randomize_matches_reference_stream():
    for c in (jc, tc):
        c.m4ri_srandom(17)
    A = tc.mzd_randomize(tc.mzd_init(7, 100, device="cpu"))
    assert_same(jc.mzd_randomize(jc.mzd_init(7, 100)), A)
    assert_same(mj.randomize_reference(7, 100, seed=17), A)
    # both streams go on alike
    assert [tc.m4ri_random_word() for _ in range(5)] == \
        [jc.m4ri_random_word() for _ in range(5)]
    assert [tc.m4ri_coin_flip() for _ in range(9)] == \
        [jc.m4ri_coin_flip() for _ in range(9)]


def test_randomize_advances_stream(monkeypatch):
    """Successive un-seeded mzd_randomize calls differ (the reference
    advances its RNG stream on every call) and land on the input's device."""
    monkeypatch.setitem(tc._GLOBAL_RNG, "rng", None)
    a = tc.mzd_init(32, 33, device="cpu")
    m1, m2 = tc.mzd_randomize(a), tc.mzd_randomize(a)
    assert m1.device.type == "cpu" and m1.shape == (32, 33)
    assert_padding_zero(m1)
    assert not torch.equal(m1.data, m2.data)


def test_inv_m4ri_raises_on_singular(rng):
    a = np.zeros((16, 16), np.uint8)
    a[0, 0] = 1  # rank 1
    Aj, At = both(a)
    for c, A in ((jc, Aj), (tc, At)):
        with pytest.raises(ValueError, match="not invertible"):
            c.mzd_inv_m4ri(None, A)
    assert tc.mzd_invert_naive(None, At) is None


@pytest.mark.parametrize("i,j,n", [(0, 0, 64), (1, 17, 64), (2, 31, 33),
                                   (3, 95, 48), (0, 32, 40), (1, 63, 64),
                                   (2, 1, 32), (3, 100, 20)])
def test_bit_fields_64_equal_jax(rng, i, j, n):
    """33..64-bit fields (reference radix-64 semantics, mzd.h:892-901) at
    unaligned offsets, with values of 2**31 or more and 2**63 or more in
    each half."""
    a = with_bit31(rng, 4, 160)
    Aj, At = both(a)

    def field_of(bits):
        return sum(int(bits[i, j + t]) << t for t in range(n))

    got = tc.mzd_read_bits(At, i, j, n)
    assert int(got) & ((1 << n) - 1) == field_of(a)
    assert _norm(got) == _norm(jc.mzd_read_bits(Aj, i, j, n))
    for v in (0xDEADBEEFCAFEF00D, 0x80000000_80000000, 0xFFFFFFFF_FFFFFFFF,
              0x7FFFFFFF_00000001):
        v &= (1 << n) - 1
        for name in ("mzd_xor_bits", "mzd_and_bits"):
            assert_same(getattr(jc, name)(Aj, i, j, n, v),
                        getattr(tc, name)(At, i, j, n, v), f"{name} {v:x}")
    assert_same(jc.mzd_clear_bits(Aj, i, j, n), tc.mzd_clear_bits(At, i, j, n))
    Z = tc.mzd_xor_bits(mt.zeros(2, 128, device="cpu"), 0, 39, 64,
                        0xDEADBEEFCAFEF00D)
    assert tc.mzd_read_bits(Z, 0, 39, 64) == 0xDEADBEEFCAFEF00D


def test_results_never_alias_their_inputs(rng):
    """An in-place op on a result leaves the caller's tensors as they were
    (the JAX package's arrays are immutable, so it may share)."""
    a = with_bit31(rng, 8, 70)
    A = mt.from_numpy(a, device="cpu")
    B = mt.from_numpy(random_dense(rng, 8, 70), device="cpu")
    before_a, before_b = A.data.clone(), B.data.clone()
    p = torch.from_numpy(_swaps(rng, 70))
    p_before = p.clone()
    results = [tc.mzd_copy(None, A), tc.mzd_combine(A, 3, 0, A, 1, 0, B, 2, 0),
               tc.mzd_combine_even_in_place(A, 0, 0, B, 7, 0),
               tc.mzd_apply_p_right_even_capped(A, p, 0, 0),
               tc.mzd_apply_p_right_trans_even_capped(A, p, 8, 0)]
    for R in results:
        R.data.bitwise_not_()
    for q in (tc.mzp_copy(None, p), tc.mzp_init_window(p, 2, 9)):
        q += 1
    assert torch.equal(A.data, before_a) and torch.equal(B.data, before_b)
    assert torch.equal(p, p_before)


def test_compat_make_table_process_rows(rng):
    """mzd_make_table + mzd_process_rows perform a Gray-code elimination
    step: rows reduce to zero in the k pivot columns."""
    k = 4
    a_np = random_dense(rng, 40, 64)
    a_np[:k, :k] = np.eye(k, dtype=np.uint8)
    A = mt.from_numpy(a_np, device="cpu")
    T, L = tc.mzd_make_table(A, 0, 0, k)
    assert T.device.type == L.device.type == "cpu"
    got = mt.to_numpy(tc.mzd_process_rows(A, k, 40, 0, k, T, L))
    assert (got[k:, :k] == 0).all()
    t_np = mt.to_numpy(T)
    for i in (k, 17, 39):
        diff = got[i] ^ a_np[i]
        assert any((diff == t).all() for t in t_np), f"row {i}"


def test_compat_djb_builder():
    """A hand-built program applies like the JAX package's: replay is in
    reverse, so y0 = x1; y1 = x0 ^ y0 (= x0 ^ x1)."""
    assert (tc.source_source, tc.source_target) == (jc.source_source,
                                                    jc.source_target)
    v = np.array([[1], [1]], np.uint8)
    ys = []
    for c, V in zip((jc, tc), both(v)):
        z = c.djb_init(2, 2)
        z = c.djb_push_back(z, 1, 0, c.source_target)
        z = c.djb_push_back(z, 1, 0, c.source_source)
        z = c.djb_push_back(z, 0, 1, c.source_source)
        ys.append(c.djb_apply(z, V))
    assert_same(*ys)
    np.testing.assert_array_equal(mt.to_numpy(ys[1]), [[1], [0]])


def test_compat_misc_long_tail():
    assert tc.m4ri_radix == jc.m4ri_radix == 32
    with pytest.raises(RuntimeError, match="boom 7"):
        tc.m4ri_die("boom %d", 7)
    buf = _stdio.StringIO()
    tc.mzd_fprint(buf, mt.from_numpy(np.eye(3, dtype=np.uint8), device="cpu"))
    want = _stdio.StringIO()
    jc.mzd_fprint(want, mj.from_numpy(np.eye(3, dtype=np.uint8)))
    assert buf.getvalue() == want.getvalue()


def test_compat_files_equal_jax(rng, tmp_path):
    a = with_bit31(rng, 20, 70)
    Aj, At = both(a)
    tc.mzd_to_png(At, str(tmp_path / "t.png"))
    jc.mzd_to_png(Aj, str(tmp_path / "j.png"))
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    assert_same(Aj, tc.mzd_from_png(str(tmp_path / "j.png"), device="cpu"))
    jio.to_jcf(Aj, str(tmp_path / "j.jcf"))
    assert_same(jc.mzd_from_jcf(str(tmp_path / "j.jcf")),
                tc.mzd_from_jcf(str(tmp_path / "j.jcf"), 0, device="cpu"))


@pytest.fixture
def one_rank_group():
    """mzd_mul_mp starts a 1-rank group in this process; end it after."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("m,k,n", [(8, 8, 8), (70, 130, 45)])
def test_mul_mp_equals_jax(rng, one_rank_group, m, k, n):
    """The multi-device product and add-mul through the SUMMA path of
    ``parallel/`` (a 1-rank gloo group started by the call itself, as the
    JAX package's makes a mesh of its devices) equal the JAX package's."""
    import torch.distributed as dist
    (Aj, At), (Bj, Bt), (Cj, Ct) = (both(random_dense(rng, *s))
                                    for s in ((m, k), (k, n), (m, n)))
    assert_same(jc.mzd_mul_mp(None, Aj, Bj), tc.mzd_mul_mp(None, At, Bt))
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert_same(jc.mzd_addmul_mp(Cj, Aj, Bj), tc.mzd_addmul_mp(Ct, At, Bt))
    # the second call took the first one's mesh: no new process groups
    assert tmesh.make_mesh(device="cpu") is tmesh.make_mesh(device="cpu")

"""The bit-field helpers and the Gray-code tables of the PyTorch/CUDA port
against the JAX package (mirrors test_misc.py's bitops part and the
container checks of test_smallops.py that the helpers build on): the same
numpy input through ``m4ri_tpu.core.bitops`` and ``m4ri_tpu_torch.core.bitops``
on the CPU, equality of packed words and of returned values, tolerance 0.
Inputs have bit 31 of every word set where it matters (``with_bit31``): the
sign bit of an int32 word, where an unmasked shift or a signed compare
would go wrong."""

import numpy as np
import pytest
import torch

import m4ri_tpu as mj
import m4ri_tpu_torch as mt
from m4ri_tpu.core import bitops as jb
from m4ri_tpu.utils import graycode as jgray
from m4ri_tpu_torch.core import bitops as tb
from m4ri_tpu_torch.utils import graycode as tgray

from conftest import random_dense
from torch_port import assert_padding_zero, assert_same, both, with_bit31


def _u32(x):
    """The 32 bits of a JAX uint32 scalar or a port int32 tensor."""
    if isinstance(x, torch.Tensor):
        return int(np.int32(int(x)).view(np.uint32))
    return int(np.uint32(x))


@pytest.mark.parametrize("i,j,k", [(0, 0, 5), (1, 30, 8), (2, 31, 32),
                                   (3, 60, 13), (0, 95, 5), (4, 31, 1),
                                   (4, 0, 32), (2, 64, 32), (1, 33, 31)])
def test_read_bits_equals_jax(rng, i, j, k):
    J, T = both(with_bit31(rng, 5, 100))
    got = tb.read_bits(T, i, j, k)
    assert got.dtype == torch.int32
    assert _u32(got) == _u32(jb.read_bits(J, i, j, k))


@pytest.mark.parametrize("op,args", [
    ("xor_bits", (1, 28, 8, 0xFF)), ("xor_bits", (1, 20, 32, 0xDEADBEEF)),
    ("xor_bits", (0, 95, 5, 0b10111)), ("xor_bits", (2, 31, 2, 0b11)),
    ("and_bits", (2, 30, 4, 0b0101)), ("and_bits", (3, 16, 32, 0x80000001)),
    ("clear_bits", (0, 60, 10)), ("clear_bits", (4, 31, 33 - 1)),
])
def test_field_writes_equal_jax(rng, op, args):
    a = with_bit31(rng, 5, 100)
    J, T = both(a)
    keep = T.data.clone()
    got = getattr(tb, op)(T, *args)
    assert_same(getattr(jb, op)(J, *args), got, op)
    assert_padding_zero(got)
    assert torch.equal(T.data, keep), "the input was written to"


def test_field_ops_match_the_bits(rng):
    """test_misc.py's expectations, on the port alone."""
    a = random_dense(rng, 3, 70)
    A = mt.from_numpy(a, device="cpu")
    expect = a.copy()
    expect[1, 28:36] ^= 1
    np.testing.assert_array_equal(mt.to_numpy(tb.xor_bits(A, 1, 28, 8, 0xFF)),
                                  expect)
    expect = a.copy()
    expect[0, 60:70] = 0
    np.testing.assert_array_equal(mt.to_numpy(tb.clear_bits(A, 0, 60, 10)),
                                  expect)
    expect = a.copy()
    expect[2, 30:34] &= np.array([1, 0, 1, 0], np.uint8)
    np.testing.assert_array_equal(
        mt.to_numpy(tb.and_bits(A, 2, 30, 4, 0b0101)), expect)


@pytest.mark.parametrize("offset", [0, 1, 31, 32, 37, 99, 100, 128])
def test_row_offset_ops_equal_jax(rng, offset):
    J, T = both(with_bit31(rng, 5, 100))
    assert_same(jb.row_add_offset(J, 2, 4, offset),
                tb.row_add_offset(T, 2, 4, offset), "row_add_offset")
    assert_same(jb.row_clear_offset(J, 3, offset),
                tb.row_clear_offset(T, 3, offset), "row_clear_offset")


def test_row_ops_equal_jax(rng):
    J, T = both(with_bit31(rng, 8, 70))
    assert_same(jb.row_add(J, 0, 3), tb.row_add(T, 0, 3))
    assert_same(jb.row_add(J, 2, 2), tb.row_add(T, 2, 2))
    assert_same(jb.copy_row(J, 2, J, 5), tb.copy_row(T, 2, T, 5))
    assert_same(jb.row_combine(J, 0, [1, 4, 6]), tb.row_combine(T, 0, [1, 4, 6]))
    assert_same(jb.copy(J), tb.copy(T))
    assert tb.copy(T).data is not T.data


@pytest.mark.parametrize("m,n", [(10, 10), (7, 12), (12, 7), (64, 64),
                                 (70, 33), (33, 97), (1, 1)])
def test_extract_u_l_equal_jax(rng, m, n):
    a = with_bit31(rng, m, n)
    J, T = both(a)
    k = min(m, n)
    for fj, ft, ref in ((jb.extract_u, tb.extract_u, np.triu),
                        (jb.extract_l, tb.extract_l, np.tril)):
        got = ft(T)
        assert_same(fj(J), got)
        assert_padding_zero(got)
        np.testing.assert_array_equal(mt.to_numpy(got), ref(a[:k, :k]))


@pytest.mark.parametrize("k", [1, 31, 32, 33, 64, 100])
@pytest.mark.parametrize("upper", [True, False])
def test_triangle_mask_equals_jax(k, upper):
    got = tb._triangle_mask(k, upper, "cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32), np.asarray(jb._triangle_mask(k, upper)))


def test_find_pivot_equals_jax(rng):
    a = np.zeros((6, 40), np.uint8)
    a[3, 17] = 1
    a[5, 2] = 1
    a[2, 31] = 1
    J, T = both(a)
    for start in [(0, 0), (0, 3), (4, 18), (3, 17), (0, 18), (6, 0), (0, 40)]:
        want = [int(x) for x in jb.find_pivot(J, *start)]
        got = tb.find_pivot(T, *start)
        assert [int(x) for x in got] == want, start
    J2, T2 = both(random_dense(rng, 30, 70, density=0.05))
    assert ([int(x) for x in tb.find_pivot(T2, 4, 9)]
            == [int(x) for x in jb.find_pivot(J2, 4, 9)])


@pytest.mark.parametrize("m,n", [(5, 9), (9, 5), (40, 40), (33, 70)])
def test_set_ui_equals_jax(rng, m, n):
    J, T = both(random_dense(rng, m, n))
    for v in (0, 1, 3):
        got = tb.set_ui(T, v)
        assert_same(jb.set_ui(J, v), got)
        assert_padding_zero(got)


def test_cmp_equals_jax_with_bit31(rng):
    """The words differ in bit 31 as well: a signed compare inverts them."""
    n = 130
    for trial in range(30):
        a = with_bit31(rng, 3, n) if trial % 2 else random_dense(rng, 3, n)
        b = a.copy()
        for _ in range(rng.integers(1, 4)):
            b[rng.integers(3), rng.integers(n)] ^= 1
        if trial % 3 == 0:
            b[rng.integers(3), 31 + 32 * rng.integers(4)] ^= 1
        (Ja, Ta), (Jb, Tb) = both(a), both(b)
        for x, y, jx, jy in ((Ta, Tb, Ja, Jb), (Tb, Ta, Jb, Ja), (Ta, Ta, Ja, Ja)):
            got = tb.cmp(x, y)
            assert got.dtype == torch.int32
            assert int(got) == int(jb.cmp(jx, jy))


def test_first_zero_row_equals_jax(rng):
    z = np.zeros((6, 10), np.uint8)
    z[:4] = random_dense(rng, 4, 10) | np.eye(4, 10, dtype=np.uint8)
    for a in (z, np.zeros((5, 40), np.uint8), with_bit31(rng, 7, 64)):
        J, T = both(a)
        assert int(tb.first_zero_row(T)) == int(jb.first_zero_row(J))


def test_bitops_are_exported_under_the_jax_names():
    names = ("read_bits", "xor_bits", "and_bits", "clear_bits", "row_add",
             "row_add_offset", "extract_u", "extract_l", "find_pivot", "set_ui")
    for name in names:
        assert getattr(mt, name) is getattr(tb, name)
        assert callable(getattr(mj, name))


@pytest.mark.parametrize("k", [1, 2, 5, 8, 16])
def test_graycode_codebook_equals_jax(k):
    for got, want in zip(tgray.codebook(k), jgray.codebook(k)):
        np.testing.assert_array_equal(got, want)
    assert [tgray.gray_code(i, k) for i in range(1 << min(k, 6))] == \
        [jgray.gray_code(i, k) for i in range(1 << min(k, 6))]


def test_graycode_opt_k_equals_jax():
    assert tgray.MAXK == jgray.MAXK == 16
    for a, b in [(1, 1), (2, 3), (64, 100), (1000, 3000), (2**20, 2**21),
                 (0, 5), (65536, 65536)]:
        assert tgray.opt_k(a, b) == jgray.opt_k(a, b), (a, b)

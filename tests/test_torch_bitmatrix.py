"""Container, transpose and RNG of the PyTorch/CUDA port against the JAX
package (mirrors test_smallops.py, test_transpose.py, test_random.py): same
numpy inputs, equality of packed words, and the padding-stays-zero
discipline on every output."""

import numpy as np
import pytest
import torch

import m4ri_tpu as mj
import m4ri_tpu_torch as mt
from m4ri_tpu.core import bitmatrix as jbm
from m4ri_tpu_torch.core import bitmatrix as tbm

from conftest import random_dense
from torch_port import (assert_padding_zero, assert_same, both, with_bit31,
                        words)

SIZES = [(1, 1), (1, 31), (3, 32), (7, 33), (17, 64), (64, 64), (65, 97),
         (128, 130), (200, 67), (63, 257)]


@pytest.mark.parametrize("m,n", SIZES)
def test_pack_roundtrip(rng, m, n):
    a = random_dense(rng, m, n)
    J, T = both(a)
    assert_same(J, T)
    np.testing.assert_array_equal(mt.to_numpy(T), a)
    assert_padding_zero(T)
    assert T.shape == (m, n) and T.width == J.width and T.nrows == m


@pytest.mark.parametrize("m,n", SIZES)
def test_convert_roundtrip(rng, m, n):
    """State carried across: the JAX words, handed over as numpy, are the
    port's words bit for bit, and come back unchanged."""
    a = with_bit31(rng, m, n)
    J = mj.from_numpy(a)
    T = mt.from_reference(np.asarray(J.data), J.ncols, device="cpu")
    np.testing.assert_array_equal(mt.to_numpy(T), a)
    back, ncols = mt.to_reference(T)
    assert ncols == n and back.dtype == np.uint32
    np.testing.assert_array_equal(back, np.asarray(J.data))
    assert_same(J, mt.from_packed(np.asarray(J.data), n, device="cpu"))


@pytest.mark.parametrize("m,n", SIZES)
def test_add_equal_is_zero(rng, m, n):
    a, b = random_dense(rng, m, n), random_dense(rng, m, n)
    (Ja, Ta), (Jb, Tb) = both(a), both(b)
    assert_same(mj.add(Ja, Jb), mt.add(Ta, Tb))
    assert bool(mt.equal(Ta, Ta)) and bool(mt.is_zero(mt.add(Ta, Ta)))
    assert bool(mt.equal(Ta, Tb)) == bool(mj.equal(Ja, Jb))
    assert not bool(mt.equal(Ta, mt.zeros(m, n + 1, device="cpu")))
    assert bool(mt.is_zero(mt.zeros(m, n, device="cpu")))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 67, 128])
def test_identity(n):
    assert_same(mj.identity(n), mt.identity(n, device="cpu"))


@pytest.mark.parametrize("r0,c0,r1,c1", [
    (0, 0, 5, 5), (2, 3, 17, 40), (0, 32, 10, 64), (1, 33, 20, 97),
    (5, 1, 6, 130), (0, 63, 64, 65), (0, 1, 64, 130), (3, 31, 40, 96),
])
def test_submatrix(rng, r0, c0, r1, c1):
    """Column offsets that cross a word, with bit 31 of every word set."""
    a = with_bit31(rng, 64, 130)
    J, T = both(a)
    S = mt.submatrix(T, r0, c0, r1, c1)
    assert_same(mj.submatrix(J, r0, c0, r1, c1), S)
    np.testing.assert_array_equal(mt.to_numpy(S), a[r0:r1, c0:c1])
    assert_padding_zero(S)


@pytest.mark.parametrize("m,n1,n2", [(4, 5, 7), (8, 32, 32), (10, 33, 31),
                                     (16, 65, 97), (3, 1, 128), (5, 31, 33)])
def test_stack_concat(rng, m, n1, n2):
    a, b = with_bit31(rng, m, n1), with_bit31(rng, m, n2)
    (Ja, Ta), (Jb, Tb) = both(a), both(b)
    C = mt.concat(Ta, Tb)
    assert_same(mj.concat(Ja, Jb), C)
    np.testing.assert_array_equal(mt.to_numpy(C), np.concatenate([a, b], 1))
    assert_padding_zero(C)
    d = random_dense(rng, 2 * m, n1)
    Jd, Td = both(d)
    assert_same(mj.stack(Ja, Jd), mt.stack(Ta, Td))


@pytest.mark.parametrize("shift", [0, 1, 31, 32, 33, 70])
def test_shift_columns(rng, shift):
    a = with_bit31(rng, 9, 160)
    J, T = both(a)
    for out_w in (1, 3, 5, 8):
        assert_same(jbm.shift_columns_left(J.data, shift, out_w),
                    tbm.shift_columns_left(T.data, shift, out_w), "left")
        assert_same(jbm.shift_columns_right(J.data, shift, out_w),
                    tbm.shift_columns_right(T.data, shift, out_w), "right")


@pytest.mark.parametrize("n", [5, 32, 33, 64, 100])
def test_colswap(rng, n):
    a = with_bit31(rng, 20, n)
    J, T = both(a)
    for (i, j) in [(0, n - 1), (1, 1), (n // 2, n // 3), (n - 1, 0)]:
        S = mt.col_swap(T, i, j)
        assert_same(mj.col_swap(J, i, j), S)
        assert_padding_zero(S)
    assert_same(J, T)  # the input is left as it was


def test_rowswap_readwrite(rng):
    a = with_bit31(rng, 10, 70)
    J, T = both(a)
    assert_same(mj.row_swap(J, 2, 7), mt.row_swap(T, 2, 7))
    for (i, j) in [(3, 69), (0, 31), (9, 63), (4, 0)]:
        assert int(mt.read_bit(T, i, j)) == a[i, j] == int(mj.read_bit(J, i, j))
        for v in (0, 1):
            W = mt.write_bit(T, i, j, v)
            assert_same(mj.write_bit(J, i, j, v), W)
            assert int(mt.read_bit(W, i, j)) == v
    assert_same(J, T)


def test_density(rng):
    a = with_bit31(rng, 100, 200)
    J, T = both(a)
    assert abs(float(mt.density(T)) - a.mean()) < 1e-6
    assert abs(float(mt.density(T)) - float(mj.density(J))) < 1e-6
    x = torch.tensor([0, -1, 1, -2**31, 0x7FFFFFFF, 0x55555555],
                     dtype=torch.int32)
    assert tbm.popcount32(x).tolist() == [0, 32, 1, 1, 31, 16]


def test_mask_padding_and_from_packed(rng):
    raw = rng.integers(0, 2**32, (7, 3), dtype=np.uint64).astype(np.uint32)
    J = mj.from_packed(raw, 70)
    T = mt.from_packed(raw, 70, device="cpu")
    assert_same(J, T)
    assert_padding_zero(T)
    T2 = mt.from_packed(torch.from_numpy(raw.view(np.int32)), 70, device="cpu")
    assert_same(J, T2)


@pytest.mark.parametrize("ncols", [1, 31, 32, 33, 70, 96, 257])
def test_padding_words_and_stacks(rng, ncols):
    """``padding_words`` (made on the tensor's device) equals the JAX
    package's ``padding_mask``, and ``mask_padding`` of a stack [B, rows,
    words] masks every element as the JAX one masks it alone."""
    want = jbm.padding_mask(ncols).view(np.int32)
    assert np.array_equal(tbm.padding_words(ncols, "cpu").numpy(), want)
    raw = rng.integers(0, 2**32, (3, 5, tbm.width_for(ncols)),
                       dtype=np.uint64).astype(np.uint32)
    got = tbm.mask_padding(tbm.BitMatrix(torch.from_numpy(raw.view(np.int32)),
                                         ncols))
    assert got.nrows == 5 and got.width == raw.shape[2]
    for i in range(3):
        J = jbm.mask_padding(jbm.BitMatrix(raw[i], ncols))
        assert np.array_equal(got.data[i].numpy(),
                              np.asarray(J.data).view(np.int32))

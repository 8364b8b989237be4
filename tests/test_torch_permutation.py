"""Permutations and ``pluq`` of the PyTorch/CUDA port against the JAX package
(mirrors the swap-fold and trans_tri fuzz cases and the ``pluq`` cases of
test_ple.py): the same numpy input and swap arrays through both packages on
the CPU, equality of packed words and index arrays, tolerance 0; and each
vectorised function against its own sequential oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import m4ri_tpu_torch as mt
from m4ri_tpu.core import permutation as jperm
from m4ri_tpu.models import ple as jple
from m4ri_tpu_torch.core import permutation as tperm

import oracle
from conftest import random_dense
from test_ple import _random_lapack, _random_ple_q
from torch_port import assert_padding_zero, assert_same, both, with_bit31


def _t(v):
    return torch.as_tensor(np.asarray(v, np.int32))


def _j(v):
    return jnp.asarray(np.asarray(v, np.int32))


@pytest.mark.parametrize("n", [1, 2, 7, 33, 64, 130])
def test_swaps_to_perm_equals_sequential_and_jax(rng, n):
    for _ in range(4):
        v = _random_lapack(rng, n)
        for asc in (True, False):
            got = tperm.swaps_to_perm(_t(v), asc)
            assert got.dtype == torch.int32
            assert torch.equal(got, tperm.swaps_to_perm_seq(_t(v), asc))
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jperm.swaps_to_perm(_j(v), asc)))


@pytest.mark.parametrize("n", [5, 40])
def test_swaps_to_perm_longest_value_chain(n):
    """Every step targets the last slot."""
    v = np.full((n,), n - 1, np.int32)
    for asc in (True, False):
        assert torch.equal(tperm.swaps_to_perm(_t(v), asc),
                           tperm.swaps_to_perm_seq(_t(v), asc))
        np.testing.assert_array_equal(
            tperm.swaps_to_perm(_t(v), asc).numpy(),
            np.asarray(jperm.swaps_to_perm_seq(_j(v), asc)))


def test_invert_perm_equals_jax(rng):
    p = rng.permutation(77).astype(np.int32)
    np.testing.assert_array_equal(tperm.invert_perm(_t(p)).numpy(),
                                  np.asarray(jperm.invert_perm(_j(p))))


@pytest.mark.parametrize("m,n", [(40, 40), (33, 70), (70, 33), (64, 96)])
def test_apply_p_equals_jax(rng, m, n):
    a = with_bit31(rng, m, n)
    J, T = both(a)
    vr, vc = _random_lapack(rng, m), _random_lapack(rng, n)
    for name, v in (("apply_p_left", vr), ("apply_p_left_trans", vr),
                    ("apply_p_right", vc), ("apply_p_right_trans", vc)):
        got = getattr(tperm, name)(T, _t(v))
        assert_same(getattr(jperm, name)(J, _j(v)), got, name)
        assert_padding_zero(got)
    p = rng.permutation(n).astype(np.int32)
    assert_same(jperm.permute_cols(J, _j(p)), tperm.permute_cols(T, _t(p)))
    p = rng.permutation(m).astype(np.int32)
    assert_same(jperm.permute_rows(J, _j(p)), tperm.permute_rows(T, _t(p)))


def test_left_then_trans_is_identity(rng):
    a = random_dense(rng, 50, 45)
    T = mt.from_numpy(a, device="cpu")
    v = _t(_random_lapack(rng, 50))
    back = tperm.apply_p_left_trans(tperm.apply_p_left(T, v), v)
    np.testing.assert_array_equal(mt.to_numpy(back), a)


@pytest.mark.parametrize("m,n", [(40, 40), (64, 40), (33, 70), (100, 100)])
def test_trans_tri_equals_sequential_and_jax(rng, m, n):
    for _ in range(3):
        a = with_bit31(rng, m, n)
        v = _random_ple_q(rng, n)
        J, T = both(a)
        got = tperm.apply_p_right_trans_tri(T, _t(v))
        assert torch.equal(got.data,
                           tperm.apply_p_right_trans_tri_seq(T, _t(v)).data)
        assert_same(jperm.apply_p_right_trans_tri_seq(J, _j(v)), got)


def test_trans_tri_multi_hop_and_short_swap_arrays(rng):
    # explicit chain: v[0]=5, v[5]=9 (pre(9)=5, pre(5)=0)
    a = random_dense(rng, 12, 12)
    v = np.arange(12, dtype=np.int32)
    v[0], v[5] = 5, 9
    J, T = both(a)
    assert_same(jperm.apply_p_right_trans_tri_seq(J, _j(v)),
                tperm.apply_p_right_trans_tri(T, _t(v)))
    # a swap array shorter than ncols: columns beyond it are targets only
    a = random_dense(rng, 16, 24)
    v = np.arange(10, dtype=np.int32)
    v[2], v[7] = 18, 20
    J, T = both(a)
    got = tperm.apply_p_right_trans_tri(T, _t(v))
    assert_same(jperm.apply_p_right_trans_tri_seq(J, _j(v)), got)
    assert torch.equal(got.data, tperm.apply_p_right_trans_tri_seq(T, _t(v)).data)


def test_trans_tri_seq_takes_any_swap_array(rng):
    """Arbitrary LAPACK arrays (not the PLE-Q contract): the oracles agree."""
    a = with_bit31(rng, 30, 50)
    J, T = both(a)
    v = _random_lapack(rng, 50)
    assert_same(jperm.apply_p_right_trans_tri_seq(J, _j(v)),
                tperm.apply_p_right_trans_tri_seq(T, _t(v)))


def test_trans_tri_in_row_chunks(rng, monkeypatch):
    """The bottom-up row chunks carry the running minimum across seams."""
    monkeypatch.setattr(tperm, "_TRANS_TRI_CHUNK_ELEMS", 64 * 40)   # 64 rows
    a = random_dense(rng, 530, 40)
    v = np.arange(40, dtype=np.int32)
    v[0], v[5], v[12], v[20] = 5, 9, 30, 25
    J, T = both(a)
    got = tperm.apply_p_right_trans_tri(T, _t(v))
    assert_same(jperm.apply_p_right_trans_tri_seq(J, _j(v)), got)
    monkeypatch.setattr(tperm, "_TRANS_TRI_CHUNK_ELEMS", 7 * 100)   # 7 rows
    a = with_bit31(rng, 90, 100)
    v = _random_ple_q(rng, 100, nreal=60)
    J, T = both(a)
    assert_same(jperm.apply_p_right_trans_tri_seq(J, _j(v)),
                tperm.apply_p_right_trans_tri(T, _t(v)))


def _pluq_cases(rng):
    return {"dense": random_dense(rng, 64, 64),
            "tall": random_dense(rng, 96, 64),
            "wide_unaligned": random_dense(rng, 63, 100),
            "bit31": with_bit31(rng, 70, 130),
            "low_rank": oracle.mul(random_dense(rng, 80, 12),
                                   random_dense(rng, 12, 90)).astype(np.uint8)}


@pytest.mark.parametrize("case", ["dense", "tall", "wide_unaligned", "bit31",
                                  "low_rank"])
def test_pluq_equals_jax(rng, case):
    a = _pluq_cases(rng)[case]
    J, T = both(a)
    Mj, Pj, Qj, rj = jple.pluq(J)
    Mt, Pt, Qt, rt = mt.pluq(T)
    assert_same(Mj, Mt, case)
    assert_padding_zero(Mt)
    np.testing.assert_array_equal(np.asarray(Pj), Pt.numpy())
    np.testing.assert_array_equal(np.asarray(Qj), Qt.numpy())
    assert rt == int(rj) == oracle.rank(a)


@pytest.mark.parametrize("m,n", [(64, 64), (96, 64), (63, 100)])
def test_pluq_reconstruction(rng, m, n):
    """test_ple.py's check on the port alone: P A Q^T == L U with L strictly
    below and U on and above the diagonal of the body."""
    a = random_dense(rng, m, n)
    M, P, Q, r = mt.pluq(mt.from_numpy(a, device="cpu"))
    Md = mt.to_numpy(M)
    L = np.zeros((m, max(r, 1)), np.uint8)
    for j in range(r):
        L[j + 1:, j] = Md[j + 1:, j]
        L[j, j] = 1
    U = np.triu(Md)[:r]
    Ac = tperm.apply_p_right_trans(
        tperm.apply_p_left(mt.from_numpy(a, device="cpu"), P), Q)
    np.testing.assert_array_equal(mt.to_numpy(Ac), oracle.mul(L, U) % 2)


def test_pluq_is_dd_instrumented(rng, capsys):
    from m4ri_tpu_torch.utils import hashing
    A = mt.from_numpy(random_dense(rng, 40, 40), device="cpu")
    hashing.debug_dump(True)
    try:
        mt.pluq(A)
    finally:
        hashing.debug_dump(False)
    assert "mzd_pluq[0]: 0x" in capsys.readouterr().out

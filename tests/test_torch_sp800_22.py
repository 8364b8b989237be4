"""NIST SP 800-22 Rev. 1a's binary matrix rank test (§2.5, M = Q = 32) on
the port: ``rank_batched`` against the plain reference ``ref_sp800_22``
on the CPU, and the reference against the test's published numbers."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import m4ri_tpu_torch as mt
import ref_sp800_22 as ref

N = 32


def _pack(bits: np.ndarray) -> torch.Tensor:
    """[B, 32, 32] 0/1 -> int32 [B, 32, 1]: bit c of row r is entry (r, c)."""
    shifts = np.arange(N, dtype=np.uint64)
    words = (bits.astype(np.uint64) << shifts).sum(-1).astype(np.uint32)
    return torch.from_numpy(words.view(np.int32)[..., None].copy())


def _invertible(rng, count: int) -> np.ndarray:
    """L U over GF(2), L and U unit triangular with random entries off the
    diagonal: invertible by construction."""
    eye = np.eye(N, dtype=np.int64)
    r = rng.integers(0, 2, (2, count, N, N))
    low = np.tril(r[0], -1) | eye
    up = np.triu(r[1], 1) | eye
    return (low @ up) % 2


def _built_cases() -> tuple:
    """(bits [B, 32, 32], ranks): zero, identity, a repeated row, and
    invertible matrices cut to rank 31 and 30 by rows that are sums of
    others."""
    rng = np.random.default_rng(22)
    inv = _invertible(rng, 6)
    repeated = inv[0].copy()
    repeated[17] = repeated[3]
    r31 = inv[1:3].copy()
    r31[:, 31] = r31[:, 0] ^ r31[:, 1]
    r30 = inv[3:6].copy()
    r30[:, 30] = r30[:, 0] ^ r30[:, 1]
    r30[:, 31] = r30[:, 2] ^ r30[:, 5] ^ r30[:, 9]
    cases = [np.zeros((1, N, N), np.int64), np.eye(N, dtype=np.int64)[None],
             repeated[None], inv[:1], r31, r30]
    want = [0, 32, 31, 32, 31, 31, 30, 30, 30]
    return np.concatenate(cases), want


def test_rank_batched_equals_the_reference_on_seeded_matrices():
    g = torch.Generator().manual_seed(800_22)
    data = torch.randint(-2**31, 2**31, (2000, N, 1), dtype=torch.int32,
                         generator=g)
    got = mt.rank_batched(data, N)
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), ref.ranks(data))


def test_rank_batched_equals_the_reference_on_built_cases():
    bits, want = _built_cases()
    data = _pack(bits)
    assert ref.ranks(data).tolist() == want
    assert mt.rank_batched(data, N).tolist() == want


def test_statistic_reproduces_the_worked_example():
    """§2.5.4: epsilon = 01011001001010101101, M = Q = 3, two matrices of
    ranks 2 and 3."""
    full, one_less, chi2, p = ref.statistic(torch.tensor([[2, 3]]), M=3)
    assert full.tolist() == [1] and one_less.tolist() == [1]
    assert chi2.item() == pytest.approx(0.596953, abs=5e-7)
    assert p.item() == pytest.approx(0.741948, abs=5e-7)


def test_rank_shares_follow_the_exact_probabilities():
    """10^5 uniform matrices: each share within 5 sigma of p_32 / p_31 /
    p_<=30, whose rounded values are the statistic's constants."""
    exact = ref.exact_shares(N)
    assert [round(p, 4) for p in exact] == [ref.P_FULL, ref.P_ONE_LESS,
                                            ref.P_REST]
    n = 10**5
    g = torch.Generator().manual_seed(2010)
    r = ref.ranks(torch.randint(-2**31, 2**31, (n, N, 1), dtype=torch.int32,
                                generator=g))
    shares = [(r == N).sum(), (r == N - 1).sum(), (r <= N - 2).sum()]
    for count, p in zip(shares, exact):
        assert abs(count.item() / n - p) <= 5 * (p * (1 - p) / n) ** 0.5


def test_reference_imports_only_torch():
    tree = ast.parse((pathlib.Path(__file__).parent
                      / "ref_sp800_22.py").read_text())
    names = {a.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names}
    names |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.level == 0}
    assert names == {"__future__", "torch"}

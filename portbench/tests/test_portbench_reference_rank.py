"""The reference of the cell ``nist_sp800_22.rank`` (``rref.rref``'s rank)
against m4ri_tpu_torch's ``rank_batched`` on the CPU, and its control
(``reference/rank.py``, the rank over the reals) against the reference."""

import pytest
import torch

import m4ri_tpu_torch as port
from portbench.reference import gf2, rank, rref
from test_portbench_imports import FORBIDDEN, loaded_after


def rand(seed, *shape):
    g = torch.Generator().manual_seed(seed)
    return gf2.random_words(shape, 32, g, "cpu")


@pytest.mark.parametrize("b,m,n", [(3000, 32, 32), (200, 20, 32),
                                   (50, 40, 32), (60, 48, 70)])
def test_ranks_equal_the_programs(b, m, n):
    g = torch.Generator().manual_seed(b + m + n)
    words = gf2.random_words((b, m, gf2.words_for(n)), n, g, "cpu")
    want = port.rank_batched(words, n).long()
    assert torch.equal(rref.rref(words, n)[1], want)


def test_ranks_of_sums_of_rows():
    """Each row past the first 20 a sum of two of them: rank at most 20."""
    words = rand(7, 100, 32, 1)
    words[:, 20:] = words[:, :12] ^ words[:, 8:20]
    got = rref.rref(words, 32)[1]
    assert torch.equal(got, port.rank_batched(words, 32).long())
    assert int(got.max()) == 20


def test_control_misses_most_ranks():
    """Over the reals nearly every 0/1 matrix is regular; over GF(2) about
    71 % of the 32 x 32 ones are singular."""
    words = rand(8, 4000, 32, 1)
    want = rref.rref(words, 32)[1]
    ctl = rank.real_ranks(words, 32)
    share = float((ctl != want).double().mean())
    assert 0.66 < share < 0.76
    assert torch.equal(ctl[want == 32], want[want == 32])


def test_control_loads_nothing_of_the_program():
    top = loaded_after("import portbench.reference.rank")
    assert "torch" in top
    assert not top & (FORBIDDEN | {"m4ri_tpu_torch"})

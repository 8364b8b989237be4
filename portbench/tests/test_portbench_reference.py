"""Each plain reference against m4ri_tpu_torch's plain path on the CPU at
small sizes, and each control against the reference where it has to fail.

The program is imported here only to hold the references to it; the
references themselves import nothing of it (test_portbench_imports.py).
"""

import pytest
import torch

import m4ri_tpu_torch as port
from portbench.reference import gf2, ple, rref


def gen(seed):
    return torch.Generator().manual_seed(seed)


def rand(g, *shape_cols):
    *lead, cols = shape_cols
    return gf2.random_words((*lead, gf2.words_for(cols)), cols, g, "cpu")


def deficient(g, m, n, rank):
    """A product of m x rank and rank x n: rank at most ``rank``, with
    columns that are not pivots in the middle of the sweep."""
    return gf2.mul_packed(rand(g, m, rank), rand(g, rank, n), rank, n)


@pytest.mark.parametrize("m,n,panel", [
    (70, 100, 64), (128, 96, 32), (200, 200, 64), (96, 300, 128),
    (33, 65, 32), (300, 40, 32)])
@pytest.mark.parametrize("kind", ["random", "deficient", "zero_columns"])
def test_ple_equals_the_programs(m, n, panel, kind):
    g = gen(m * 1000 + n)
    if kind == "random":
        a = rand(g, m, n)
    elif kind == "deficient":
        a = deficient(g, m, n, min(m, n) // 2)
    else:
        bits = gf2.unpack(rand(g, m, n), n)
        bits[:, 5:n:3] = 0
        bits[m // 2:, : n // 2] = 0
        a = gf2.pack(bits)
    body, p, q, r = port.ple(port.BitMatrix(a, n))
    got = ple.ple(a, n, panel=panel)
    assert got[3] == r
    assert torch.equal(got[0], body.data)
    assert torch.equal(got[1], p)
    assert torch.equal(got[2], q)


def test_ple_control_loses_parities_where_sums_pass_256():
    g = gen(3)
    a = rand(g, 1100, 1400)
    want = ple.ple(a, 1400)
    ctl = ple.ple(a, 1400, dtype=torch.bfloat16)
    assert want[3] == ctl[3] == 1100
    assert (ctl[0] != want[0]).sum() > 1000


@pytest.mark.parametrize("m,k,n", [(100, 2100, 90), (64, 33, 65),
                                   (1, 1, 1), (130, 64, 5000)])
def test_product_equals_the_programs(m, k, n):
    g = gen(m + k + n)
    a, b = rand(g, m, k), rand(g, k, n)
    c = port.mul(port.BitMatrix(a, k), port.BitMatrix(b, n)).data
    assert torch.equal(gf2.mul_packed(a, b, k, n, block_m=64), c)


def test_product_control_loses_parities():
    g = gen(4)
    a, b = rand(g, 64, 2048), rand(g, 2048, 64)
    want = gf2.mul_packed(a, b, 2048, 64)
    assert (gf2.mul_packed(a, b, 2048, 64, dtype=torch.bfloat16)
            != want).sum() > 10


def test_pack_unpack_round_trip():
    g = gen(5)
    a = rand(g, 7, 3, 77)
    assert torch.equal(gf2.pack(gf2.unpack(a, 77)), a)
    assert gf2.unpack(a, 77).shape == (7, 3, 77)


@pytest.mark.parametrize("b,m,n", [(5, 40, 100), (3, 64, 64), (4, 70, 33)])
@pytest.mark.parametrize("kind", ["random", "deficient"])
def test_rref_equals_the_programs(b, m, n, kind):
    g = gen(b * m + n)
    if kind == "random":
        h = rand(g, b, m, n)
    else:
        h = torch.stack([deficient(g, m, n, min(m, n) // 3)
                         for _ in range(b)])
    e, r = port.echelonize_batched(h, n, full=True)
    got, rank, _ = rref.rref(h, n)
    assert torch.equal(got, e)
    assert torch.equal(rank, r.long())


def test_rref_control_is_not_reduced():
    g = gen(6)
    h = rand(g, 4, 48, 160)
    want, rank, _ = rref.rref(h, 160)
    ctl, crank, _ = rref.rref(h, 160, reduce_above=False)
    assert torch.equal(rank, crank)
    assert (ctl != want).sum() > 100


@pytest.mark.parametrize("b,m", [(60, 30), (40, 64), (30, 65)])
def test_solve_equals_the_programs(b, m):
    g = gen(b + m)
    h = torch.stack([rand(g, m, m) if i % 2 else deficient(g, m, m, m - 3)
                     for i in range(b)])
    s = rand(g, b, m, 1)
    s[: b // 4] = gf2.mul_packed(
        h[0], rand(g, m, 1), m, 1).expand(b // 4, m, 1)   # consistent ones
    x, cons = port.solve_left_batched(h, m, s, 1)
    want_x, want_cons = rref.solve_left(h, m, s)
    assert torch.equal(cons, want_cons)
    assert 0 < int(cons.sum()) < b
    assert torch.equal(x[cons], want_x[cons])
    # what consistent means: A X = B
    for i in torch.nonzero(cons).flatten().tolist():
        assert torch.equal(gf2.mul_packed(h[i], x[i], m, 1), s[i])


def test_solve_control_gives_other_solutions():
    g = gen(7)
    h, s = rand(g, 64, 48, 48), rand(g, 64, 48, 1)
    want_x, want_cons = rref.solve_left(h, 48, s)
    ctl_x, ctl_cons = rref.solve_left(h, 48, s, reduce_above=False)
    assert torch.equal(want_cons, ctl_cons)
    assert (ctl_x[want_cons] != want_x[want_cons]).sum() > 0

"""The factorization slice of the PyTorch/CUDA port against the JAX package:
``block_factor`` / ``ple`` / ``rank`` on the same numpy inputs, on the CPU.
The JAX side runs its pure-XLA engine; the port runs its plain engine and,
through the kernel wrappers' plain versions, its "hopper" engine.  Equality
of packed words, P, Q and rank, tolerance 0."""

import json
import pathlib

import numpy as np
import pytest
import torch

import m4ri_tpu as mj
import m4ri_tpu_torch as mt
from m4ri_tpu.models import echelon as jechelon
from m4ri_tpu.models import ple as jple
from m4ri_tpu.utils.config import get_config as jget_config
from m4ri_tpu_torch.models import ple as tple
from m4ri_tpu_torch.ops import hopper_schur
from m4ri_tpu_torch.utils import config as tconfig
from m4ri_tpu_torch.utils.rng import GlibcRandom, reference_random_data
from m4ri_tpu_torch.utils.spans import counts

import oracle
from conftest import random_dense
from test_golden import fnv1a_bits
from torch_port import assert_padding_zero, assert_same, both, with_bit31


def _dense(rng):
    return random_dense(rng, 100, 64)


def _zeroed_band(rng):
    a = random_dense(rng, 160, 96)
    a[10:90] = 0                       # forces the miss fallback at W=32
    return a


def _low_rank(rng):
    return oracle.mul(random_dense(rng, 150, 20), random_dense(rng, 20, 150))


def _odd(rng):
    return random_dense(rng, 257, 255)


def _bit31(rng):
    return with_bit31(rng, 130, 200)


def _sparse(rng):
    return random_dense(rng, 200, 140, density=0.02)


def _search(rng):
    a = random_dense(rng, 400, 256)
    a[50:150] = 0
    return a


_CASES = {
    "dense": (_dense, dict(nb=32, window=32)),
    "zeroed_band": (_zeroed_band, dict(nb=32, window=32)),
    "low_rank": (_low_rank, dict(nb=32)),
    "odd_257x255": (_odd, dict(nb=64)),
    "bit31": (_bit31, dict(nb=64)),
    "sparse": (_sparse, dict(nb=32)),
    "default_nb": (_dense, dict()),
    "search_window": (_search, dict(nb=128, window=256, search_window=128)),
}


def _assert_factor_equal(want, got, what):
    assert_same(want[0], got[0], f"{what}: data")
    for i, name in ((1, "P"), (2, "Q")):
        assert got[i].dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(want[i]), got[i].numpy(),
                                      err_msg=f"{what}: {name}")
    assert isinstance(got[3], int) and got[3] == int(want[3]), what


@pytest.mark.parametrize("engine", ["plain", "hopper"])
@pytest.mark.parametrize("preserve_l", [False, True], ids=["echelon", "keep_l"])
@pytest.mark.parametrize("case", list(_CASES))
def test_block_factor_equals_jax(rng, case, preserve_l, engine):
    make, kw = _CASES[case]
    a = make(rng)
    J, T = both(a)
    keep = T.data.clone()
    want = jple.block_factor(J, preserve_l=preserve_l, engine="xla", **kw)
    misses = counts().get("fallback.block_factor", 0)
    got = mt.block_factor(T, preserve_l=preserve_l, engine=engine, **kw)
    _assert_factor_equal(want, got, f"{case} {engine}")
    assert torch.equal(T.data, keep), "the caller's matrix was written to"
    assert got[3] == oracle.rank(a) or case == "search_window"
    if case == "zeroed_band":
        assert counts().get("fallback.block_factor", 0) > misses
    if case == "search_window":       # the miss check is off there
        assert counts().get("fallback.block_factor", 0) == misses


def test_block_factor_counts_its_read_backs(rng):
    A = mt.from_numpy(_zeroed_band(rng), device="cpu")
    syncs, misses = counts().get("readback.block_factor", 0), counts().get("fallback.block_factor", 0)
    mt.block_factor(A, preserve_l=True, nb=32, window=32)
    panels = 96 // 32
    missed = counts().get("fallback.block_factor", 0) - misses
    assert 0 < missed <= panels
    assert counts().get("readback.block_factor", 0) - syncs == panels + missed


def _factor_single(A, **kw):
    return mt.block_factor(A, preserve_l=True, nb=32, **kw)


def _factor_batched(A, **kw):
    stack = torch.stack([A.data, A.data.flip(0)])
    return mt.block_factor_batched(stack, A.ncols, preserve_l=True, nb=32,
                                   **kw)


@pytest.mark.parametrize("factor", [_factor_single, _factor_batched],
                         ids=["block_factor", "block_factor_batched"])
def test_block_factor_default_engine_and_bad_engine(rng, factor):
    """engine=None on CPU tensors is the plain engine (models/ple.py::
    default_engine), word for word; an engine outside ENGINES raises."""
    A = mt.from_numpy(_dense(rng), device="cpu")
    assert tple.default_engine(A.data) == "plain"
    a = factor(A)
    b = factor(A, engine="plain")
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        factor(A, engine="xla")


def test_single_sweep_takes_the_gridded_schur_update(rng, monkeypatch):
    """The single sweep's engine "hopper" (the wrappers' plain versions on
    the CPU) updates the trailing matrix through the gridded Schur wrapper,
    once a panel but the last; the persistent one is never called; the
    factors are the JAX package's."""
    a = random_dense(rng, 300, 256)
    a[40:170] = 0
    J, T = both(a)
    want = jple.block_factor(J, preserve_l=True, nb=128, engine="xla")
    calls = []
    real = tple.gf2_schur_update_hopper
    monkeypatch.setattr(tple, "gf2_schur_update_hopper",
                        lambda *args, **kw: calls.append("grid")
                        or real(*args, **kw))
    real_dyn = hopper_schur.gf2_schur_update_dyn_hopper
    monkeypatch.setattr(hopper_schur, "gf2_schur_update_dyn_hopper",
                        lambda *args, **kw: calls.append("dyn")
                        or real_dyn(*args, **kw))
    got = mt.block_factor(T, preserve_l=True, nb=128, engine="hopper")
    _assert_factor_equal(want, got, "hopper engine")
    # two panels: one update, none after the last, which leaves no column
    assert calls == ["grid"]


@pytest.mark.parametrize("case", ["dense", "zeroed_band", "low_rank",
                                  "odd_257x255", "bit31"])
def test_ple_equals_jax(rng, case):
    a = _CASES[case][0](rng)
    J, T = both(a)
    Mj, Pj, Qj, rj = jple.ple(J)
    Mt, Pt, Qt, rt = mt.ple(T)
    assert_same(Mj, Mt, case)
    assert_padding_zero(Mt)
    np.testing.assert_array_equal(np.asarray(Pj), Pt.numpy())
    np.testing.assert_array_equal(np.asarray(Qj), Qt.numpy())
    assert rt == int(rj) == oracle.rank(a)


def test_ple_reconstructs_the_input(rng):
    """P L E == A with L unit lower in columns 0..r-1 and E the echelon rows
    in place (the check the reference's test_ple.c makes)."""
    a = _low_rank(rng)
    m, n = a.shape
    M, P, Q, r = mt.ple(mt.from_numpy(a, device="cpu"))
    body = mt.to_numpy(M).astype(np.int64)
    L = np.eye(m, dtype=np.int64)
    L[:, :r] = np.tril(body[:, :r], -1) + np.eye(m, r, dtype=np.int64)
    E = np.zeros((m, n), np.int64)
    Ql = Q.tolist()
    for i in range(r):
        E[i, Ql[i]:] = body[i, Ql[i]:]
    le = (L @ E) % 2
    for i in reversed(range(r)):        # undo the row swaps: A = P (L E)
        le[[i, P[i].item()]] = le[[P[i].item(), i]]
    np.testing.assert_array_equal(le, a)


@pytest.mark.parametrize("case", ["dense", "zeroed_band", "low_rank",
                                  "odd_257x255"])
def test_compress_l_equals_sequential_and_jax(rng, case):
    a = _CASES[case][0](rng)
    m, n = a.shape
    J, T = both(a)
    data, _, q, r = mt.block_factor(T, preserve_l=True, nb=32)
    fast = tple._compress_l_impl(data, q, r, m, n)
    slow = tple._compress_l_seq(data, q, r, m, n)
    assert torch.equal(fast, slow)
    jdata, _, jq, jr = jple.block_factor(J, preserve_l=True, nb=32,
                                         engine="xla")
    assert_same(jple._compress_l_seq(jdata, jq, jr, m, n), slow)


@pytest.mark.parametrize("case", ["dense", "low_rank", "odd_257x255",
                                  "sparse"])
def test_rank_equals_jax(rng, case):
    a = _CASES[case][0](rng)
    J, T = both(a)
    got = mt.rank(T)
    assert isinstance(got, int)
    assert got == int(jechelon.rank(J)) == oracle.rank(a)
    assert mt.rank(T, nb=32) == got


def test_rank_of_edge_shapes():
    z = mt.zeros(40, 70, device="cpu")
    assert mt.rank(z) == 0
    assert mt.rank(mt.identity(65, device="cpu")) == 65
    one = mt.from_numpy(np.ones((1, 1), np.uint8), device="cpu")
    M, P, Q, r = mt.ple(one)
    assert r == 1 and P.tolist() == [0] and Q.tolist() == [0]


@pytest.mark.parametrize("m,n", [(0, 5), (5, 0), (0, 0)])
def test_empty_matrices_factor_to_rank_zero(m, n):
    """The port's behaviour on empty shapes, pinned: rank 0, an empty body
    and identity swap arrays (the JAX package's ple raises TypeError here;
    the docstring of ple says so)."""
    A = mt.zeros(m, n, device="cpu")
    M, P, Q, r = mt.ple(A)
    assert r == 0 and M.shape == (m, n)
    assert P.tolist() == list(range(m)) and Q.tolist() == list(range(n))
    assert mt.rank(A) == 0
    Mq, Pq, Qq, rq = mt.pluq(A)
    assert rq == 0 and Mq.shape == (m, n)
    assert torch.equal(Pq, P) and torch.equal(Qq, Q)
    assert "TypeError" in tple.ple.__doc__


_GOLDEN = [json.loads(l) for l in (pathlib.Path(__file__).parent / "data" /
                                   "golden_reference.jsonl").read_text().splitlines()]
_GOLDEN_PLE = [r for r in _GOLDEN if r["op"] == "ple"]


def _golden_input(rec):
    """The case input, drawn in the reference's order (test_golden.py)."""
    if rec["k"]:
        g = GlibcRandom(17)
        b = reference_random_data(rec["m"], rec["k"], rng=g)
        c = reference_random_data(rec["k"], rec["n"], rng=g)
        return mt.mul(mt.from_reference(b, rec["k"], device="cpu"),
                      mt.from_reference(c, rec["n"], device="cpu"))
    return mt.randomize_reference(rec["m"], rec["n"], seed=17, device="cpu")


def test_eight_golden_ple_records():
    assert len(_GOLDEN_PLE) == 8


@pytest.mark.parametrize(
    "rec", _GOLDEN_PLE,
    ids=[f"{r['kind']}-{r['m']}x{r['n']}" for r in _GOLDEN_PLE])
def test_golden_ple(rec):
    """The reference C library's own rank, P, Q and L|E body."""
    A = _golden_input(rec)
    assert fnv1a_bits(mt.to_numpy(A)) == rec["in_hash"], "RNG stream diverged"
    M, P, Q, r = mt.ple(A)
    assert r == rec["rank"]
    assert P.tolist() == rec["P"]
    assert Q.tolist() == rec["Q"]
    assert fnv1a_bits(mt.to_numpy(M)) == rec["out_hash"]


def test_ple_is_dd_instrumented(rng, capsys):
    from m4ri_tpu_torch.utils import hashing
    A = mt.from_numpy(_dense(rng), device="cpu")
    hashing.debug_dump(True)
    try:
        mt.ple(A)
    finally:
        hashing.debug_dump(False)
    assert "mzd_ple[0]: 0x" in capsys.readouterr().out


def test_config_carries_the_panel_fields():
    cfg = tconfig.get_config()
    assert (cfg.panel_width, cfg.panel_window) == (512, 576)
    assert (cfg.panel_width_big, cfg.panel_window_big,
            cfg.panel_width_big_min) == (1024, 1088, 32768)
    jcfg = jget_config()
    for name in ("panel_width", "panel_window", "panel_width_big",
                 "panel_window_big", "panel_width_big_min"):
        assert getattr(cfg, name) == getattr(jcfg, name), name

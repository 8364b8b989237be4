"""The distributed canonical PLE, inversion, kernel and TRSMs of the
PyTorch/CUDA port against the JAX package's (mirrors test_dist_ple.py).
The port runs in one spawned 4-rank gloo group on the CPU, the JAX
functions on a mesh of the same shape over 4 virtual CPU devices: 4 x 1 for
the factorizations, 2 x 2 for the TRSMs and inversion (rows sharded over
"x", replicated over "y").  Data, P, Q, rank and flags equal JAX's, word
for word (tolerance 0), on every rank."""

import functools

import numpy as np
import pytest

import m4ri_tpu as mj
from m4ri_tpu.parallel.dist_ple import dist_block_factor, dist_ple
from m4ri_tpu.parallel.dist_solve import (dist_invert, dist_kernel_left,
                                          dist_trsm_lower_left,
                                          dist_trsm_lower_right,
                                          dist_trsm_upper_left,
                                          dist_trsm_upper_right)

import oracle
from conftest import random_dense
from torch_port import assert_same, jax_mesh, spawn_calls

PLE = "m4ri_tpu_torch.parallel.dist_ple:"
SOLVE = "m4ri_tpu_torch.parallel.dist_solve:"
CASES = ["random", "zero-top", "low-rank", "wide"]
TRSMS = [("dist_trsm_upper_left", dist_trsm_upper_left),
         ("dist_trsm_lower_left", dist_trsm_lower_left),
         ("dist_trsm_upper_right", dist_trsm_upper_right),
         ("dist_trsm_lower_right", dist_trsm_lower_right)]


def _case(name):
    """The inputs of test_dist_ple.py's _cases, each from its own seed."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "random":
        return random_dense(rng, 180, 96)
    if name == "zero-top":
        z = random_dense(rng, 200, 64)
        z[:100] = 0          # pivots beyond any small window: the slow branch
        return z
    if name == "low-rank":
        return oracle.mul(random_dense(rng, 150, 20),
                          random_dense(rng, 20, 96)).astype(np.uint8)
    return random_dense(rng, 70, 200)


def _trsm_inputs(name):
    rng = np.random.default_rng(40)
    n, cols = 160, 96
    u = np.triu(random_dense(rng, n, n), 1)
    np.fill_diagonal(u, 1)
    b = random_dense(rng, n, cols)
    t = u if "upper" in name else u.T.copy()
    return t, (b if name.endswith("left") else b.T.copy())


def _invertible():
    rng = np.random.default_rng(41)
    n = 96
    lo = np.tril(random_dense(rng, n, n), -1)
    np.fill_diagonal(lo, 1)
    up = np.triu(random_dense(rng, n, n), 1)
    np.fill_diagonal(up, 1)
    singular = oracle.mul(random_dense(rng, n, 10), random_dense(rng, 10, n))
    return oracle.mul(lo, up).astype(np.uint8), singular.astype(np.uint8)


def _kernel_input():
    rng = np.random.default_rng(42)
    return oracle.mul(random_dense(rng, 120, 40),
                      random_dense(rng, 40, 150)).astype(np.uint8)


def _ple_input():
    return random_dense(np.random.default_rng(43), 150, 100)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    calls = []
    for name in CASES:
        for pres in (False, True):
            for engine in ("plain", "hopper"):
                calls.append({
                    "name": f"bf_{name}_{pres}_{engine}",
                    "fn": PLE + "dist_block_factor", "args": [_case(name)],
                    "kwargs": {"preserve_l": pres, "nb": 32, "window": 32,
                               "engine": engine}, "mesh": (4, 1)})
    calls.append({"name": "ple", "fn": PLE + "dist_ple", "args": [_ple_input()],
                  "kwargs": {"nb": 32, "window": 64}, "mesh": (4, 1)})
    for name, _ in TRSMS:
        calls.append({"name": name, "fn": SOLVE + name,
                      "args": list(_trsm_inputs(name)), "mesh": (2, 2)})
    for what, a in zip(("invert", "invert_singular"), _invertible()):
        calls.append({"name": what, "fn": SOLVE + "dist_invert", "args": [a],
                      "kwargs": {"nb": 32, "window": 64}, "mesh": (2, 2)})
    calls.append({"name": "kernel", "fn": SOLVE + "dist_kernel_left",
                  "args": [_kernel_input()], "kwargs": {"nb": 32, "window": 64},
                  "mesh": (4, 1)})
    return spawn_calls(calls, tmp_path_factory.mktemp("dist_ple"))


def _got(port, name):
    out, same = port[name]
    assert same, f"{name}: the ranks got different results"
    return out


@functools.lru_cache(maxsize=None)
def _jax_block_factor(name, preserve_l):
    A = mj.from_numpy(_case(name))
    return dist_block_factor(A, jax_mesh(4, 1), preserve_l=preserve_l, nb=32,
                             window=32, engine="xla")


@pytest.mark.parametrize("engine", ["plain", "hopper"])
@pytest.mark.parametrize("preserve_l", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_dist_block_factor_equals_jax(port, name, preserve_l, engine):
    """On the CPU the "hopper" engine's wrappers run their plain versions;
    both engines give JAX's data, P, Q and rank."""
    want = _jax_block_factor(name, preserve_l)
    got = _got(port, f"bf_{name}_{preserve_l}_{engine}")
    np.testing.assert_array_equal(got[0].view(np.uint32), np.asarray(want[0]),
                                  err_msg="data")
    np.testing.assert_array_equal(got[1], np.asarray(want[1]), err_msg="P")
    np.testing.assert_array_equal(got[2], np.asarray(want[2]), err_msg="Q")
    assert got[3] == int(want[3])


def test_dist_ple_equals_jax(port):
    Mj, Pj, Qj, rj = dist_ple(mj.from_numpy(_ple_input()), jax_mesh(4, 1),
                              nb=32, window=64)
    Mt, Pt, Qt, rt = _got(port, "ple")
    assert rt == int(rj)
    assert_same(Mj, Mt)
    np.testing.assert_array_equal(Pt, np.asarray(Pj))
    np.testing.assert_array_equal(Qt, np.asarray(Qj))


@pytest.mark.parametrize("name,fn", TRSMS, ids=[n for n, _ in TRSMS])
def test_dist_trsm_equals_jax(port, name, fn):
    t, b = _trsm_inputs(name)
    want = fn(mj.from_numpy(t), mj.from_numpy(b), jax_mesh(2, 2))
    assert_same(want, _got(port, name))


def test_dist_invert_equals_jax(port):
    a, singular = _invertible()
    Xj, rj = dist_invert(mj.from_numpy(a), jax_mesh(2, 2), nb=32, window=64)
    Xt, rt = _got(port, "invert")
    assert rt == int(rj) == 96
    assert_same(Xj, Xt)
    assert (oracle.mul(a, mj.to_numpy(Xj)) == np.eye(96)).all()
    _, rsj = dist_invert(mj.from_numpy(singular), jax_mesh(2, 2), nb=32,
                         window=64)
    assert _got(port, "invert_singular")[1] == int(rsj) < 96


def test_dist_kernel_left_equals_jax(port):
    a = _kernel_input()
    Xj, cj = dist_kernel_left(mj.from_numpy(a), jax_mesh(4, 1), nb=32,
                              window=64)
    Xt, ct = _got(port, "kernel")
    assert ct == int(cj)
    assert_same(Xj, Xt)
    assert not oracle.mul(a, mj.to_numpy(Xj)).any()

"""``dist_solve_left`` of the PyTorch/CUDA port against the JAX package's
(mirrors test_dist_ple.py's solve cases) on a 4 x 1 mesh: the port in a
spawned 4-rank gloo group on the CPU, the JAX function on 4 virtual CPU
devices.  X and the consistency flag equal JAX's (tolerance 0), on every
rank, and X solves the system."""

import numpy as np
import pytest

import m4ri_tpu as mj
from m4ri_tpu.parallel.dist_solve import dist_solve_left

import oracle
from conftest import random_dense
from torch_port import assert_same, jax_mesh, spawn_calls

SHAPES = [(140, 140, 40), (160, 96, 32), (96, 160, 32)]
SOLVE = "m4ri_tpu_torch.parallel.dist_solve:dist_solve_left"


def _consistent(i, m, n, cols):
    rng = np.random.default_rng(50 + i)
    a = random_dense(rng, m, n)
    return a, oracle.mul(a, random_dense(rng, n, cols)).astype(np.uint8)


def _inconsistent():
    rng = np.random.default_rng(60)
    a, b = random_dense(rng, 96, 48), random_dense(rng, 96, 8)
    if oracle.rank(np.concatenate([a, b], axis=1)) == oracle.rank(a):
        b[0] ^= 1
    return a, b


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    calls = [{"name": f"solve{s}", "fn": SOLVE, "args": list(_consistent(i, *s)),
              "kwargs": {"nb": 32, "window": 64}, "mesh": (4, 1)}
             for i, s in enumerate(SHAPES)]
    calls.append({"name": "inconsistent", "fn": SOLVE,
                  "args": list(_inconsistent()), "kwargs": {"nb": 32},
                  "mesh": (4, 1)})
    return spawn_calls(calls, tmp_path_factory.mktemp("dist_solve"))


def _got(port, name):
    out, same = port[name]
    assert same, f"{name}: the ranks got different results"
    return out


@pytest.mark.parametrize("i,shape", list(enumerate(SHAPES)), ids=str)
def test_dist_solve_left_equals_jax(port, i, shape):
    a, b = _consistent(i, *shape)
    Xj, okj = dist_solve_left(mj.from_numpy(a), mj.from_numpy(b),
                              jax_mesh(4, 1), nb=32, window=64)
    Xt, okt = _got(port, f"solve{shape}")
    assert bool(okt) and bool(okj)
    assert_same(Xj, Xt)
    np.testing.assert_array_equal(oracle.mul(a, mj.to_numpy(Xj)), b)


def test_dist_solve_inconsistent_equals_jax(port):
    a, b = _inconsistent()
    _, okj = dist_solve_left(mj.from_numpy(a), mj.from_numpy(b),
                             jax_mesh(4, 1), nb=32)
    _, okt = _got(port, "inconsistent")
    assert bool(okt) == bool(okj) is False

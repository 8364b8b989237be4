"""The row-sharded echelonization of the PyTorch/CUDA port against the JAX
package's (mirrors test_dist_echelon.py): ``dist_rank`` and
``dist_echelonize`` on a 4 x 1 mesh, the port in a spawned 4-rank gloo
group on the CPU and the JAX functions on 4 virtual CPU devices.  The
output words and the rank equal JAX's (tolerance 0), on every rank."""

import numpy as np
import pytest

import m4ri_tpu as mj
from m4ri_tpu.parallel.dist_echelon import dist_echelonize, dist_rank

import oracle
from conftest import random_dense
from torch_port import assert_same, jax_mesh, spawn_calls

RANK = [(64, 64), (128, 100), (100, 160), (256, 256)]
ECHELON = [(64, 64), (128, 96), (96, 200)]
DIST = "m4ri_tpu_torch.parallel.dist_echelon:"


def _dense(seed, m, n):
    return random_dense(np.random.default_rng(seed), m, n)


def _low_rank():
    rng = np.random.default_rng(30)
    m, n, k = 96, 120, 20
    return oracle.mul(random_dense(rng, m, k),
                      random_dense(rng, k, n)).astype(np.uint8)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    calls = [{"name": f"rank{s}", "fn": DIST + "dist_rank",
              "args": [_dense(i, *s)], "mesh": (4, 1)}
             for i, s in enumerate(RANK)]
    calls += [{"name": f"echelon{s}", "fn": DIST + "dist_echelonize",
               "args": [_dense(10 + i, *s)], "mesh": (4, 1)}
              for i, s in enumerate(ECHELON)]
    calls.append({"name": "low_rank", "fn": DIST + "dist_rank",
                  "args": [_low_rank()], "mesh": (4, 1)})
    return spawn_calls(calls, tmp_path_factory.mktemp("dist_echelon"))


def _got(port, name):
    out, same = port[name]
    assert same, f"{name}: the ranks got different results"
    return out


@pytest.mark.parametrize("i,shape", list(enumerate(RANK)), ids=str)
def test_dist_rank_equals_jax(port, i, shape):
    a = _dense(i, *shape)
    r = _got(port, f"rank{shape}")
    assert r == int(dist_rank(mj.from_numpy(a), jax_mesh(4, 1)))
    assert r == oracle.rank(a)


@pytest.mark.parametrize("i,shape", list(enumerate(ECHELON)), ids=str)
def test_dist_echelonize_equals_jax(port, i, shape):
    a = _dense(10 + i, *shape)
    Rj, rj = dist_echelonize(mj.from_numpy(a), jax_mesh(4, 1))
    Rt, rt = _got(port, f"echelon{shape}")
    assert rt == int(rj) == oracle.rank(a)
    assert_same(Rj, Rt)


def test_dist_low_rank_equals_jax(port):
    a = _low_rank()
    r = _got(port, "low_rank")
    assert r == int(dist_rank(mj.from_numpy(a), jax_mesh(4, 1))) == 20

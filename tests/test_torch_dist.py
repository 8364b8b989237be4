"""The multi-device products of the PyTorch/CUDA port against the JAX
package's (mirrors test_dist.py).  The port runs in one spawned 4-rank gloo
group on the CPU (one process a rank); the JAX functions run on a mesh of
the same shape over 4 of conftest's virtual CPU devices.  Every rank must
get the whole product back; outputs are compared word for word (GF(2) is
exact: tolerance 0)."""

import functools

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import m4ri_tpu as mj
from m4ri_tpu.parallel.dist_mul import mul_dist, mul_dist_ksplit
from m4ri_tpu.parallel.mesh import xor_allgather_reduce
from m4ri_tpu_torch.parallel._spawn import Shard

from conftest import random_dense
from torch_port import assert_same, jax_mesh, spawn_calls

SUMMA = [(64, 64, 64), (128, 256, 192), (100, 130, 70), (257, 129, 65)]
KSPLIT = [(64, 256, 64), (96, 512, 160)]
DIST = "m4ri_tpu_torch.parallel.dist_mul:"
MESH = "m4ri_tpu_torch.parallel.mesh:"


def _inputs(seed, m, k, n):
    rng = np.random.default_rng(seed)
    return random_dense(rng, m, k), random_dense(rng, k, n)


def _words(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (8, 5), dtype=np.uint64).astype(np.uint32)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    calls = []
    for i, shape in enumerate(SUMMA):
        calls.append({"name": f"summa{shape}", "fn": DIST + "mul_dist",
                      "args": list(_inputs(i, *shape)), "mesh": (2, 2)})
    for i, shape in enumerate(KSPLIT):
        calls.append({"name": f"ksplit{shape}", "fn": DIST + "mul_dist_ksplit",
                      "args": list(_inputs(10 + i, *shape)), "mesh": (2, 2)})
    for axis in ("x", "y"):
        calls.append({"name": f"size_{axis}", "fn": MESH + "axis_size",
                      "args": [], "kwargs": {"axis": axis}, "mesh": None})
        calls.append({"name": f"xor_{axis}", "fn": MESH + "xor_allgather_reduce",
                      "args": [Shard(_words(20), axis)], "kwargs": {"axis": axis},
                      "mesh": (2, 2)})
    return spawn_calls(calls, tmp_path_factory.mktemp("dist"))


def _got(port, name):
    out, same = port[name]
    assert same, f"{name}: the ranks got different results"
    return out


@pytest.mark.parametrize("i,shape", list(enumerate(SUMMA)), ids=str)
def test_mul_dist_summa_equals_jax(port, i, shape):
    a, b = _inputs(i, *shape)
    want = mul_dist(mj.from_numpy(a), mj.from_numpy(b), jax_mesh(2, 2))
    assert_same(want, _got(port, f"summa{shape}"))


@pytest.mark.parametrize("i,shape", list(enumerate(KSPLIT)), ids=str)
def test_mul_dist_ksplit_equals_jax(port, i, shape):
    a, b = _inputs(10 + i, *shape)
    want = mul_dist_ksplit(mj.from_numpy(a), mj.from_numpy(b), jax_mesh(2, 2))
    assert_same(want, _got(port, f"ksplit{shape}"))


def test_mesh_shape(port):
    """make_mesh() over 4 ranks is the squarest: 2 x 2."""
    assert (_got(port, "size_x"), _got(port, "size_y")) == (2, 2)


@pytest.mark.parametrize("axis", ["x", "y"])
def test_xor_allgather_reduce_equals_jax(port, axis):
    """Each rank holds its row block of the words along one axis; the XOR
    of the blocks over that axis, as the JAX collective gives it."""
    words = _words(20)
    mesh = jax_mesh(2, 2)
    spec = P("x", None) if axis == "x" else P("y", None)

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=spec,
                       out_specs=P(None, None), check_vma=False)
    def fold(x):
        return xor_allgather_reduce(x, axis)

    want = np.asarray(fold(words))
    got = _got(port, f"xor_{axis}")
    np.testing.assert_array_equal(got.view(np.uint32), want)

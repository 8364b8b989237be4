"""Helpers shared by the tests of the PyTorch/CUDA port (test_torch_*.py).

The same numpy input goes into the JAX package and into the port (on the
CPU); outputs are compared word for word.  GF(2) is exact: tolerance 0."""

import dataclasses
import os
import pickle
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import m4ri_tpu as mj
import m4ri_tpu_torch as mt
from m4ri_tpu_torch.core.bitmatrix import padding_mask
from m4ri_tpu_torch.utils import config as tconfig

import oracle
from conftest import random_dense

# Under pytest-xdist the workers share the machine's cores: give each its
# share for PyTorch's intra-op threads, not a thread a core, which
# oversubscribes the cores several times over and slows the port's tests two-
# to threefold.  Every worker collects every test module, so this import sets
# it for all of the port's tests in that worker.
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // _WORKERS))


@pytest.fixture
def config_fields(monkeypatch):
    """``config_fields(**fields)``: for the rest of the test the port's
    config is the derived one with these fields replaced (``_derive``
    patched, ``get_config``'s cache cleared now and at teardown).  A test
    module takes it by importing the name."""
    derive = tconfig._derive

    def apply(**fields):
        monkeypatch.setattr(tconfig, "_derive",
                            lambda: dataclasses.replace(derive(), **fields))
        tconfig.get_config.cache_clear()
        cfg = tconfig.get_config()
        assert all(getattr(cfg, k) == v for k, v in fields.items()), cfg
        return cfg

    tconfig.get_config.cache_clear()
    yield apply
    tconfig.get_config.cache_clear()


def both(a_np):
    """Dense 0/1 numpy array -> (JAX BitMatrix, port BitMatrix on the CPU)."""
    return mj.from_numpy(a_np), mt.from_numpy(a_np, device="cpu")


def words(x):
    """uint32 words of a JAX or port BitMatrix, or of a bare data array."""
    data = getattr(x, "data", x)
    if hasattr(data, "detach"):
        return np.ascontiguousarray(data.detach().cpu().numpy()).view(np.uint32)
    return np.asarray(data)


def assert_same(jax_out, torch_out, what=""):
    """The two packages' outputs hold the same packed words."""
    if hasattr(jax_out, "ncols"):
        assert jax_out.ncols == torch_out.ncols, what
    jw, tw = words(jax_out), words(torch_out)
    assert jw.dtype == np.uint32 and tw.dtype == np.uint32
    assert jw.shape == tw.shape, (what, jw.shape, tw.shape)
    np.testing.assert_array_equal(jw, tw, err_msg=what)


def assert_padding_zero(M):
    mask = padding_mask(M.ncols)
    assert M.data.dtype == torch.int32
    assert np.all((words(M) & ~mask[None, :]) == 0)


def with_bit31(rng, m, n):
    """Random dense bits with every column c % 32 == 31 set: the sign bit
    of each int32 word, where an unmasked arithmetic shift would leak."""
    a = random_dense(rng, m, n)
    a[:, 31::32] = 1
    return a


def _same(x, y) -> bool:
    if isinstance(x, dict):
        return x.keys() == y.keys() and all(_same(x[k], y[k]) for k in x)
    if isinstance(x, (tuple, list)):
        return len(x) == len(y) and all(_same(a, b) for a, b in zip(x, y))
    if isinstance(x, np.ndarray):
        return x.dtype == y.dtype and np.array_equal(x, y)
    return x == y


def _matrices(x):
    """Port matrices as written by run_calls -> objects assert_same takes."""
    if isinstance(x, dict) and "words" in x:
        return types.SimpleNamespace(data=x["words"], ncols=x["ncols"])
    if isinstance(x, tuple):
        return tuple(_matrices(v) for v in x)
    return x


def spawn_calls(calls, workdir, world=4, timeout_s=300):
    """Run ``calls`` (m4ri_tpu_torch.parallel._spawn.run_calls) on a
    spawned ``world``-rank gloo group on the CPU.  Returns {name: (rank 0's
    output, whether every rank got the same)}."""
    from m4ri_tpu_torch.parallel._spawn import launch
    calls_path, out = workdir / "calls.pkl", workdir / "out"
    with open(calls_path, "wb") as f:
        pickle.dump(calls, f)
    launch("m4ri_tpu_torch.parallel._spawn:run_calls", world, workdir,
           backend="gloo", device="cpu",
           args=[str(calls_path), str(out), "cpu"], timeout_s=timeout_s)
    ranks = []
    for r in range(world):
        with open(f"{out}.{r}", "rb") as f:
            ranks.append(pickle.load(f))
    return {name: (_matrices(got), all(_same(got, rk[name]) for rk in ranks))
            for name, got in ranks[0].items()}


def jax_mesh(rows, cols):
    """A JAX mesh of the port group's shape over the first virtual devices."""
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:rows * cols]).reshape(rows, cols),
                ("x", "y"))


# ---- batched stacks (test_torch_batched_*.py) --------------------------------

def stacks(mats):
    """numpy 0/1 [B, m, n] -> (JAX packed stack, port packed stack on the
    CPU)."""
    jx = jnp.stack([mj.from_numpy(x).data for x in mats])
    tx = torch.stack([mt.from_numpy(x, device="cpu").data for x in mats])
    return jx, tx


def same(want, got, what):
    want = np.asarray(want)
    got = got.numpy()
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    np.testing.assert_array_equal(want, got, err_msg=what)


def rank_k(rng, m, n, k):
    if k == 0:
        return np.zeros((m, n), np.uint8)
    return oracle.mul(random_dense(rng, m, k), random_dense(rng, k, n))


def _wide(rng):
    return np.stack([random_dense(rng, 70, 130), rank_k(rng, 70, 130, 0),
                     rank_k(rng, 70, 130, 20), random_dense(rng, 70, 130)])


def _tall(rng):
    return np.stack([rank_k(rng, 130, 64, 30), random_dense(rng, 130, 64),
                     rank_k(rng, 130, 64, 0), random_dense(rng, 130, 64)])


def _square(rng):
    return np.stack([random_dense(rng, 96, 96), rank_k(rng, 96, 96, 50),
                     rank_k(rng, 96, 96, 0), random_dense(rng, 96, 96),
                     rank_k(rng, 96, 96, 95)])


def _misses(rng):
    """A zeroed band in element 1 under a narrow panel (NB below): its
    windows go deficient and those panels are redone at full height."""
    mats = np.stack([random_dense(rng, 130, 100) for _ in range(3)])
    mats[1, 20:110] = 0
    return mats


CASES = {"wide": _wide, "tall": _tall, "square": _square, "misses": _misses}
NB = {"misses": 32}     # the panel width a case asks for (else the default)


def data_of(x):
    """The words of a JAX output (a BitMatrix or an array)."""
    return getattr(x, "data", x)


def jvmap(fn, *stacks_):
    return jax.vmap(lambda *a: tuple(data_of(o) for o in fn(*a)))(*stacks_)


def cpu(a):
    return mt.from_numpy(a, device="cpu")


class Waits(TorchDispatchMode):
    """Counts the operators that make the host wait for a CUDA device:
    scalar reads, nonzero and boolean-mask indexing (its size depends on
    the data), torch.equal."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("_local_scalar_dense", "nonzero", "masked_select",
                    "equal", "is_nonzero"):
            self.n += 1
        elif name in ("index", "index_put", "index_put_") and any(
                isinstance(t, torch.Tensor) and t.dtype == torch.bool
                for t in (args[1] if len(args) > 1 else ())
                if t is not None):
            self.n += 1
        return func(*args, **(kwargs or {}))

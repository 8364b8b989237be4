"""The port's copy of the native C++ oracle (mirrors test_native.py): built
by the port's own ``native/build.py`` from its own ``gf2core.cpp``, it must
agree with the JAX package's native library, with the port's engine and
with the numpy oracle, and its glibc stream with the port's Python one.
Skips only where there is no C++ compiler."""

import numpy as np
import pytest

import m4ri_tpu_torch as mt
from m4ri_tpu.native import build as jnative
from m4ri_tpu_torch.native import build as native
from m4ri_tpu_torch.utils.rng import GlibcRandom, reference_random_data

import oracle
from conftest import random_dense
from torch_port import assert_same, both, with_bit31


@pytest.fixture
def lib():
    got = native.load()
    if got is None:
        pytest.skip("no C++ toolchain available")
    return got


def _words(M):
    return M.data.numpy().view(np.uint32)


@pytest.mark.parametrize("m,k,n", [(100, 130, 70), (33, 64, 95)])
def test_native_mul(lib, rng, m, k, n):
    a, b = with_bit31(rng, m, k), random_dense(rng, k, n)
    (Aj, At), (Bj, Bt) = both(a), both(b)
    c = native.native_mul(_words(At), _words(Bt), k, n)
    assert c.dtype == np.uint32
    np.testing.assert_array_equal(mt.to_numpy(mt.from_packed(c, n, device="cpu")),
                                  oracle.mul(a, b))
    assert_same(c, mt.mul(At, Bt))
    # int32 words are the same bits
    np.testing.assert_array_equal(native.native_mul(At.data.numpy(),
                                                    Bt.data.numpy(), k, n), c)
    if jnative.load() is not None:
        np.testing.assert_array_equal(
            jnative.native_mul(np.asarray(Aj.data), np.asarray(Bj.data), k, n), c)


@pytest.mark.parametrize("full", [True, False])
def test_native_echelonize(lib, rng, full):
    a = with_bit31(rng, 60, 90)
    At = mt.from_numpy(a, device="cpu")
    out, r = native.native_echelonize(_words(At), 90, full=full)
    assert r == oracle.rank(a) == mt.rank(At)
    if full:
        np.testing.assert_array_equal(
            mt.to_numpy(mt.from_packed(out, 90, device="cpu")), oracle.rref(a))
        E, re = mt.echelonize(At, full=True)
        assert re == r
        assert_same(out, E)
    assert (_words(At) == mt.from_numpy(a, device="cpu").data.numpy().view(
        np.uint32)).all(), "native_echelonize changed its input"


def test_native_rng_matches_python(lib):
    lib.gf2_srandom(17)
    g = GlibcRandom(17)
    for _ in range(100):
        assert lib.gf2_random_word() == g.random_word()


def test_native_randomize_matches_python(lib):
    data = native.native_randomize(7, 100, seed=17)
    np.testing.assert_array_equal(data, reference_random_data(7, 100, seed=17))
    assert_same(data, mt.randomize_reference(7, 100, seed=17, device="cpu"))

"""The plain versions of the port's two kernels against the Pallas kernels
they replace, run in interpret mode (the shapes of test_pallas.py's mul and
mul2 cases).  On the CPU a wrapper takes its plain version, so calling the
wrappers here tests exactly what the CPU path of the port runs.  Equality
of packed words, tolerance 0."""

import numpy as np
import pytest
import torch

import m4ri_tpu as mj
import m4ri_tpu_torch as mt
from m4ri_tpu.ops.pallas_mul import gf2_mul_pallas
from m4ri_tpu.ops.pallas_mul2 import gf2_mul_pallas_v2
from m4ri_tpu_torch.ops.hopper_mul import gf2_mul_hopper, gf2_mul_plain
from m4ri_tpu_torch.ops.hopper_mul2 import gf2_mul_hopper_v2

import oracle
from conftest import random_dense
from m4ri_tpu_torch.utils.spans import counts
from torch_port import assert_same, both


@pytest.mark.parametrize("m,k,n,tm,tnw", [
    (256, 128, 4096, 256, 128),     # shallow contraction
    (256, 2048, 4096, 256, 32),     # deep contraction
    (300, 1100, 4200, 128, 32),     # ragged edges
])
def test_plain_equals_pallas_mul(rng, m, k, n, tm, tnw):
    a, b = random_dense(rng, m, k), random_dense(rng, k, n)
    (Ja, Ta), (Jb, Tb) = both(a), both(b)
    want = gf2_mul_pallas(Ja.data, Jb.data, tm=tm, tnw=tnw, interpret=True)
    got = gf2_mul_hopper(Ta.data, Tb.data)
    assert_same(want, got)
    assert torch.equal(got, gf2_mul_plain(Ta.data, Tb.data))
    assert got.dtype == torch.int32 and got.shape == (m, (n + 31) // 32)


@pytest.mark.parametrize("m,k,n,tm,tnw", [
    (256, 2048, 4096, 256, 128),
    (128, 2048, 4096, 128, 128),
    (300, 2100, 8200, 128, 128),    # ragged edges + word padding
    (512, 1000, 4096, 256, 128),    # single chunk
])
def test_plain_equals_pallas_mul2(rng, m, k, n, tm, tnw):
    a, b = random_dense(rng, m, k), random_dense(rng, k, n)
    (Ja, Ta), (Jb, Tb) = both(a), both(b)
    want = gf2_mul_pallas_v2(Ja.data, Jb.data, tm=tm, tnw=tnw, interpret=True)
    got = gf2_mul_hopper_v2(Ta.data, Tb.data)
    assert_same(want, got)
    assert torch.equal(got, gf2_mul_plain(Ta.data, Tb.data))


@pytest.mark.parametrize("wrapper", [gf2_mul_hopper, gf2_mul_hopper_v2],
                         ids=["v1", "v2"])
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (31, 32, 33), (65, 97, 129),
                                   (200, 129, 64)])
def test_wrappers_small_shapes(rng, wrapper, m, k, n):
    a, b = random_dense(rng, m, k), random_dense(rng, k, n)
    Ta, Tb = mt.from_numpy(a, device="cpu"), mt.from_numpy(b, device="cpu")
    got = mt.BitMatrix(wrapper(Ta.data, Tb.data), n)
    np.testing.assert_array_equal(mt.to_numpy(got), oracle.mul(a, b))


@pytest.mark.parametrize("wrapper", [gf2_mul_hopper, gf2_mul_hopper_v2],
                         ids=["v1", "v2"])
def test_wrappers_strided_views(rng, wrapper):
    """Quadrant views in, a quadrant view as out=: the result lands in the
    view and the rest of its parent stays as it was."""
    big_a = mt.from_numpy(random_dense(rng, 128, 256), device="cpu").data
    big_b = mt.from_numpy(random_dense(rng, 256, 192), device="cpu").data
    a, b = big_a[64:, 4:], big_b[128:, 3:]        # [64, 4 words] x [128, 3]
    assert not a.is_contiguous() and not b.is_contiguous()
    parent = mt.from_numpy(random_dense(rng, 100, 320), device="cpu").data
    keep = parent.clone()
    out = parent[10:74, 5:8]
    ret = wrapper(a, b, out=out)
    assert ret.data_ptr() == out.data_ptr()
    want = gf2_mul_plain(a.contiguous(), b.contiguous())
    keep[10:74, 5:8] = want
    assert torch.equal(parent, keep)
    want_dense = oracle.mul(
        mt.to_numpy(mt.BitMatrix(a.contiguous(), 128)),
        mt.to_numpy(mt.BitMatrix(b.contiguous(), 96)))
    np.testing.assert_array_equal(
        mt.to_numpy(mt.BitMatrix(out.contiguous(), 96)), want_dense)


@pytest.mark.parametrize("k", [1000, 2100])
def test_v2_accumulate(rng, k):
    """accumulate=True is C ^= A*B, which is what the JAX addmul computes
    (k=1000 is one chunk of the kernel's contraction, k=2100 two, the
    second ragged)."""
    a, b = random_dense(rng, 70, k), random_dense(rng, k, 130)
    c = random_dense(rng, 70, 130)
    (Ja, Ta), (Jb, Tb), (Jc, Tc) = both(a), both(b), both(c)
    got = Tc.data.clone()
    gf2_mul_hopper_v2(Ta.data, Tb.data, out=got, accumulate=True)
    assert_same(mj.addmul(Jc, Ja, Jb), mt.BitMatrix(got, 130))
    # without accumulate the old content of out is overwritten
    gf2_mul_hopper_v2(Ta.data, Tb.data, out=got)
    assert_same(mj.mul(Ja, Jb), mt.BitMatrix(got, 130))


def test_wrappers_raise_on_what_they_do_not_take():
    a = torch.zeros((8, 2), dtype=torch.int32)
    b = torch.zeros((64, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        gf2_mul_hopper(a.to(torch.int64), b)
    with pytest.raises(TypeError):
        gf2_mul_hopper(a[0], b)
    with pytest.raises(ValueError):                      # k > 32 * kw
        gf2_mul_hopper(a, torch.zeros((65, 3), dtype=torch.int32))
    with pytest.raises(ValueError):                      # words not adjacent
        gf2_mul_hopper(torch.zeros((8, 4), dtype=torch.int32)[:, ::2], b)
    with pytest.raises(ValueError):                      # out of another shape
        gf2_mul_hopper(a, b, out=torch.zeros((8, 4), dtype=torch.int32))
    with pytest.raises(ValueError):                      # out of another shape
        gf2_mul_hopper_v2(a, b, out=torch.zeros((8, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        gf2_mul_hopper_v2(a, b, accumulate=True)


def test_cpu_tensors_launch_nothing():
    """A launch is counted where a kernel is launched and nowhere else."""
    a = torch.zeros((8, 2), dtype=torch.int32)
    b = torch.zeros((64, 3), dtype=torch.int32)
    before = counts()
    gf2_mul_hopper(a, b)
    gf2_mul_hopper_v2(a, b)
    for name in ("launch.gf2_mul_hopper", "launch.gf2_mul_hopper_v2"):
        assert counts().get(name, 0) == before.get(name, 0)

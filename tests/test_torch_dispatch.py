"""Dispatch-seam coverage of the PyTorch/CUDA port (mirrors
test_dispatch.py): every branch of mul_packed_data's routing executes under
shrunken Config thresholds, with spies on the two kernel wrappers asserting
*which* engine ran.  The "is on the card" test is patched, so the routing
runs on CPU tensors, where the wrappers take their plain versions."""

import dataclasses

import numpy as np
import pytest

import m4ri_tpu_torch as mt
from m4ri_tpu_torch.ops import hopper_mul, hopper_mul2
from m4ri_tpu_torch.ops import mul as mulmod
from m4ri_tpu_torch.ops import strassen as strmod
from m4ri_tpu_torch.utils import config as cfgmod
from m4ri_tpu_torch.utils.config import Config

from conftest import random_dense


def gf2_product(a, b):
    """Host oracle: float32 BLAS is exact below 2**24 terms, and takes
    seconds where oracle.mul's int64 product takes minutes at these sizes."""
    p = a.astype(np.float32) @ b.astype(np.float32)
    return (p.astype(np.int64) & 1).astype(np.uint8)


@pytest.fixture
def calls(monkeypatch):
    seen = []
    real, real2 = hopper_mul.gf2_mul_hopper, hopper_mul2.gf2_mul_hopper_v2

    def spy(a, b, **kw):
        seen.append(("hopper", tuple(a.shape), tuple(b.shape), kw))
        return real(a, b, **kw)

    def spy2(a, b, **kw):
        seen.append(("hopper_v2", tuple(a.shape), tuple(b.shape), kw))
        return real2(a, b, **kw)

    monkeypatch.setattr(hopper_mul, "gf2_mul_hopper", spy)
    monkeypatch.setattr(hopper_mul2, "gf2_mul_hopper_v2", spy2)
    monkeypatch.setattr(mulmod, "_on_card", lambda t: True)
    return seen


def _product(a_np, b_np, cfg, **kw):
    A = mt.from_numpy(a_np, device="cpu")
    B = mt.from_numpy(b_np, device="cpu")
    out = mulmod.mul_packed_data(A.data, B.data, cfg=cfg, **kw)
    got = mt.to_numpy(mt.BitMatrix(out, b_np.shape[1]))
    np.testing.assert_array_equal(got, gf2_product(a_np, b_np))


def test_dispatch_hopper_shallow_k(rng, calls):
    """kw <= 32, m >= 2048, nw >= 128: the Schur-update shape goes to the
    kernel that writes C once."""
    _product(random_dense(rng, 2048, 64), random_dense(rng, 64, 4096),
             Config(), )
    assert [c[0] for c in calls] == ["hopper"]


def test_dispatch_hopper_big_deep(rng, calls):
    """A contraction of more than 64 words past the big gate goes to the
    split-contraction kernel."""
    cfg = Config(mul_block_threshold=1024, hopper_big_min=1024)
    _product(random_dense(rng, 2048, 2080), random_dense(rng, 2080, 4096), cfg)
    assert [c[0] for c in calls] == ["hopper_v2"]


def test_dispatch_hopper_big_single_chunk(rng, calls):
    """kw = 64 sits exactly at the single-chunk gate: stays on v1."""
    cfg = Config(mul_block_threshold=512, hopper_big_min=1024)
    _product(random_dense(rng, 2048, 2048), random_dense(rng, 2048, 4096), cfg)
    assert [c[0] for c in calls] == ["hopper"]


def test_dispatch_matmul_below_threshold(rng, calls):
    """Small products stay on the single matmul."""
    _product(random_dense(rng, 200, 130), random_dense(rng, 130, 170), Config())
    assert calls == []


def test_dispatch_allow_kernel_false(rng, calls):
    _product(random_dense(rng, 2048, 64), random_dense(rng, 64, 4096),
             Config(), allow_kernel=False)
    assert calls == []


def test_dispatch_not_on_card(rng, calls, monkeypatch):
    """A CPU tensor takes the matmul path whatever the gates say."""
    monkeypatch.setattr(mulmod, "_on_card", lambda t: t.is_cuda)
    _product(random_dense(rng, 2048, 64), random_dense(rng, 64, 4096), Config())
    assert calls == []


def test_dispatch_blocked_matmul(rng, calls):
    """Above-threshold and below the kernels' gates (m < 2048): the
    depth/row blocked matmul path (partial-parity XOR combining)."""
    cfg = Config(mul_block_threshold=64, mul_block_m=64, mul_block_k=64)
    _product(random_dense(rng, 100, 200), random_dense(rng, 200, 90), cfg)
    assert calls == []


@pytest.mark.parametrize("n", [96, 128, 160])
def test_dispatch_threshold_straddle(rng, calls, n):
    """One word below / at / above mul_block_threshold, all bit-exact
    (below the kernels' gates: m < 2048)."""
    cfg = Config(mul_block_threshold=128, mul_block_m=64, mul_block_k=64)
    _product(random_dense(rng, n, n), random_dense(rng, n, n), cfg)
    assert calls == []


def test_addmul_accumulates_inside_the_v2_kernel(rng, calls):
    """On the split-contraction route addmul hands C to the kernel
    (accumulate=True) instead of forming the product first."""
    cfg = Config(mul_block_threshold=1024, hopper_big_min=1024)
    a, b = random_dense(rng, 2048, 2080), random_dense(rng, 2080, 4096)
    c = random_dense(rng, 2048, 4096)
    A, B, C = (mt.from_numpy(x, device="cpu") for x in (a, b, c))
    out = C.data.clone()
    ret = mulmod.addmul_packed_data_(out, A.data, B.data, cfg=cfg)
    assert ret is out
    assert len(calls) == 1 and calls[0][0] == "hopper_v2"
    assert calls[0][3]["accumulate"] is True and calls[0][3]["out"] is out
    np.testing.assert_array_equal(mt.to_numpy(mt.BitMatrix(out, 4096)),
                                  c ^ gf2_product(a, b))


def test_strassen_engagement_seam(rng, monkeypatch):
    """mul() must engage Strassen exactly at 2*cutoff and stay bit-exact
    on both sides of the seam."""
    small = Config(strassen_cutoff=64, strassen_max_levels=2)
    monkeypatch.setattr(mulmod, "get_config", lambda: small)
    monkeypatch.setattr(strmod, "get_config", lambda: small)
    rec_calls = []
    real_rec = strmod._mul_rec

    def spy(a, b, depth):
        rec_calls.append(depth)
        return real_rec(a, b, depth)

    monkeypatch.setattr(strmod, "_mul_rec", spy)
    for n, engaged in [(127, False), (128, True), (256, True)]:
        rec_calls.clear()
        a, b = random_dense(rng, n, n), random_dense(rng, n, n)
        got = mt.to_numpy(mulmod.mul(mt.from_numpy(a, device="cpu"),
                                     mt.from_numpy(b, device="cpu")))
        np.testing.assert_array_equal(got, gf2_product(a, b))
        assert (len(rec_calls) > 0) == engaged, (n, rec_calls)


@pytest.mark.parametrize("field", ["STRASSEN_CUTOFF", "TRSM_BASE",
                                   "PANEL_WIDTH"])
def test_config_ignores_the_environment(monkeypatch, field):
    """No variable of the environment reaches the config: with
    M4RI_TPU_TORCH_<FIELD> set, get_config() is still the config derived
    from the device, field for field."""
    other = getattr(cfgmod._derive(), field.lower()) * 2
    monkeypatch.setenv(f"M4RI_TPU_TORCH_{field}", str(other))
    cfgmod.get_config.cache_clear()
    try:
        cfg = cfgmod.get_config()
    finally:
        cfgmod.get_config.cache_clear()
    assert getattr(cfg, field.lower()) != other
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfgmod._derive())

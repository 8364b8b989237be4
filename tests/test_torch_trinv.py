"""The unit-triangular inverse (m4ri_tpu_torch/ops/hopper_trinv.py) on the
CPU: the plain version, step for step the kernel's blocked
back-substitution, against the nilpotent series the sweeps took before it,
bit for bit; the launch's plan from the shape; the wrapper's checks.  The
kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, marker ``cuda``)."""

import numpy as np
import pytest
import torch

from m4ri_tpu_torch.ops import hopper_trinv
from m4ri_tpu_torch.ops.hopper_trinv import (_unit_upper_inv, series_steps,
                                             trinv_plan, unit_tri_inv_hopper,
                                             unit_tri_inv_plain)
from m4ri_tpu_torch.ops.mul import pack_bits, unpack_bits
from m4ri_tpu_torch.utils import spans


def _series(nil: torch.Tensor, upper: bool) -> torch.Tensor:
    """The sweeps' former inverse: the float32 series on the unpacked strict
    triangle."""
    n = nil.shape[-2]
    i = torch.arange(n)
    strict = (i[None, :] > i[:, None]) if upper else (i[None, :] < i[:, None])
    bits = unpack_bits(nil, torch.int8)[..., :n] * strict
    eye = torch.eye(n, dtype=torch.int8)
    return pack_bits(_unit_upper_inv(bits, eye, series_steps(n)))


def _kinds(rng, n: int, upper: bool) -> torch.Tensor:
    """[3, n, w]: N zero, N the full strict triangle, N random (junk in the
    diagonal and the other triangle, which the inverse ignores)."""
    i = np.arange(n)
    full = (i[None, :] > i[:, None]) if upper else (i[None, :] < i[:, None])
    rand = rng.random((n, n)) < 0.5
    bits = np.stack([np.zeros((n, n), bool), full, rand]).astype(np.int32)
    return pack_bits(torch.from_numpy(bits))


@pytest.mark.parametrize("n", [32, 64, 96, 384, 512, 1024])
@pytest.mark.parametrize("upper", [True, False])
def test_plain_equals_the_series(n, upper):
    rng = np.random.default_rng(n + upper)
    three = _kinds(rng, n, upper)
    got = unit_tri_inv_plain(three, upper)
    assert torch.equal(got, _series(three, upper))
    # zero: the identity; the full triangle: I plus the first off-diagonal
    eye = torch.eye(n, dtype=torch.int32)
    off = torch.diag(torch.ones(n - 1, dtype=torch.int32), 1 if upper else -1)
    assert torch.equal(got[0], pack_bits(eye))
    assert torch.equal(got[1], pack_bits(eye + off))
    one = three[2:]
    assert torch.equal(unit_tri_inv_plain(one, upper), got[2:])


@pytest.mark.parametrize("n", [1, 5, 40, 100])
@pytest.mark.parametrize("upper", [True, False])
def test_plain_at_a_ragged_width(n, upper):
    """Rows short of a whole word: the padding bits stay zero."""
    rng = np.random.default_rng(n)
    bits = (rng.random((2, n, n)) < 0.5).astype(np.int32)
    nil = pack_bits(torch.from_numpy(bits))
    got = unit_tri_inv_plain(nil, upper)
    assert got.shape == nil.shape
    assert torch.equal(got, _series(nil, upper))


def test_wrapper_on_the_cpu_is_the_plain_version_and_takes_views():
    rng = np.random.default_rng(7)
    bits = (rng.random((4, 96, 160)) < 0.5).astype(np.int32)
    parent = pack_bits(torch.from_numpy(bits))          # [4, 96, 5] words
    view = parent[1:3, :, 1:4]                           # rows 5 words apart
    spans.enable()
    got = unit_tri_inv_hopper(view, False)
    spans.enable(None)
    rec = [s for s in spans.take() if s.name == "kernel.unit_tri_inv_hopper"]
    assert [s.attrs for s in rec] == [dict(batch=2, n=96, upper=0)]
    assert got.is_contiguous()
    assert torch.equal(got, unit_tri_inv_plain(view.contiguous(), False))
    # a single matrix and a deeper stack
    assert torch.equal(unit_tri_inv_hopper(view[0], False), got[0])
    assert torch.equal(unit_tri_inv_hopper(parent[:, :, :3].reshape(
        2, 2, 96, 3), True).reshape(4, 96, 3),
        unit_tri_inv_plain(parent[:, :, :3], True))


def test_wrapper_refuses_what_it_does_not_take():
    with pytest.raises(TypeError):
        unit_tri_inv_hopper(torch.zeros((64, 2), dtype=torch.int64), True)
    with pytest.raises(ValueError):
        unit_tri_inv_hopper(torch.zeros((64, 3), dtype=torch.int32), True)
    with pytest.raises(ValueError):
        unit_tri_inv_hopper(torch.zeros((1056, 33), dtype=torch.int32), True)


@pytest.mark.parametrize("batch,n", [(1, 1024), (1, 512), (1, 384), (3, 512),
                                     (8, 512), (131, 512), (132, 512),
                                     (1024, 512), (1024, 384), (1, 32),
                                     (2**20, 32), (200, 64), (1, 64)])
def test_plan_follows_the_shape(batch, n):
    sms = 132
    strips, sw, threads = trinv_plan(batch, n, sms)
    w = -(-n // 32)
    assert threads % 32 == 0 and 32 <= threads <= 1024
    if w == 1:
        assert (strips, sw, threads) == (1, 1, 256)    # a warp an element
        return
    # the strips cover the words once; the last one is not empty
    assert 1 <= sw <= w and (strips - 1) * sw < w <= strips * sw
    if batch >= sms:
        assert (strips, sw, threads) == (1, w, 256)
    else:
        # enough blocks to cover the card, or a strip a word
        assert batch * strips >= sms or sw == 1
        assert threads == min(1024, max(256, n * sw))
    # what the kernel asks of shared memory: n x (sw | 1) words and D
    assert 4 * n * ((sw | 1) + 1) <= 232448


def test_plan_of_the_cells():
    """The launches the cells make: McEliece's 1024 T / S of 512 and TRSM
    bases of 384 take a block an element; the single sweep's 1024 a block a
    word column."""
    assert trinv_plan(1024, 512, 132) == (1, 16, 256)
    assert trinv_plan(1024, 384, 132) == (1, 12, 256)
    assert trinv_plan(1, 1024, 132) == (32, 1, 1024)


def test_no_kernel_is_built_on_the_cpu(monkeypatch):
    def refuse():
        raise AssertionError("the CPU path must not build the kernel")
    monkeypatch.setattr(hopper_trinv, "_fn", refuse)
    nil = torch.zeros((2, 64, 2), dtype=torch.int32)
    assert torch.equal(unit_tri_inv_hopper(nil, True),
                       pack_bits(torch.eye(64, dtype=torch.int32)).expand(
                           2, 64, 2))


def _unpack_ref(words: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(32, dtype=torch.int32)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1).to(torch.int8)


def test_the_operands_byte_unpacking_round_trips():
    """``unpack_bits`` / ``pack_bits``, the byte-wise (un)packing the
    sweeps' operands take around the inverse, against a shift per lane:
    every byte value in every byte of a word, and views."""
    v = torch.arange(256, dtype=torch.int64)
    words = torch.stack([v << (8 * k) for k in range(4)]).reshape(-1, 1)
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    assert torch.equal(unpack_bits(words, torch.int8), _unpack_ref(words))
    assert torch.equal(pack_bits(unpack_bits(words, torch.int8)), words)
    rng = np.random.default_rng(9)
    r = torch.from_numpy(rng.integers(-2**31, 2**31, (3, 7, 16),
                                      dtype=np.int64).astype(np.int32))
    assert torch.equal(unpack_bits(r[..., 3:9], torch.int8),
                       _unpack_ref(r[..., 3:9]))
    assert torch.equal(pack_bits(unpack_bits(r, torch.int8)[..., 64:256]),
                       r[..., 2:8])
    col = r[0, :1, :].t()           # [16, 1], rows one word apart
    assert torch.equal(unpack_bits(col, torch.uint8),
                       _unpack_ref(col).to(torch.uint8))
    assert torch.equal(pack_bits(unpack_bits(col, torch.int8)), col)


@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8, torch.bool,
                                   torch.int32, torch.float32])
def test_unpacking_gives_every_lane_type(dtype):
    """Every lane type the callers ask for holds the same 0/1 lanes, and
    packs back to the words."""
    rng = np.random.default_rng(11)
    r = torch.from_numpy(rng.integers(-2**31, 2**31, (2, 5, 3),
                                      dtype=np.int64).astype(np.int32))
    got = unpack_bits(r, dtype)
    assert got.dtype == dtype and got.shape == (2, 5, 96)
    assert torch.equal(got.to(torch.int8), _unpack_ref(r))
    assert torch.equal(pack_bits(got.to(torch.int32)), r)


@pytest.mark.parametrize("n", [0, 1, 31, 33, 100])
def test_packing_pads_a_ragged_width_with_zeros(n):
    """Columns past n pack as zero bits; a transposed and an unaligned view
    pack as their contiguous copies."""
    rng = np.random.default_rng(n)
    bits = torch.from_numpy(rng.integers(0, 2, (4, n + 3), dtype=np.int8))
    want = _unpack_ref(pack_bits(bits[:, 3:].contiguous()))[:, :n]
    assert torch.equal(want, bits[:, 3:])
    assert torch.equal(pack_bits(bits[:, 3:]), pack_bits(bits[:, 3:].clone()))
    assert torch.equal(pack_bits(bits.t()), pack_bits(bits.t().contiguous()))
    assert torch.equal(pack_bits(bits[1:, :n]),
                       pack_bits(bits[1:, :n].clone()))

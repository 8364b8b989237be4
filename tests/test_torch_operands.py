"""The below-window elimination's operands
(m4ri_tpu_torch/ops/hopper_operands.py).

On the CPU: the plain version and the wrapper (which takes it on CPU tensors)
against a reference built from the definition in numpy (one-hot E, U_piv
inverted by Gauss-Jordan elimination, E^T T, U + E, the mask), at widths
32-512, single and batched, with garbage in the slots that hold no pivot;
the launch's plan; the wrapper's checks.  On the card (marker ``cuda``): the
kernels against the plain version byte for byte at each plan's shapes, and
one wrapper call a panel in both sweeps.  Run there with

    python -m pytest tests/test_torch_operands.py --noconftest -q

The file imports no JAX.
"""

import numpy as np
import pytest
import torch

from m4ri_tpu_torch.ops.hopper_operands import (operands_plan,
                                                post_operands_hopper,
                                                post_operands_plain)
from m4ri_tpu_torch.utils.spans import counts


def _bits(words: np.ndarray) -> np.ndarray:
    """uint32 [..., w] -> 0/1 uint8 [..., 32 w], column c at bit c % 32 of
    word c // 32."""
    return ((words[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1) \
        .reshape(*words.shape[:-1], -1).astype(np.uint8)


def _gj_inverse(a: np.ndarray) -> np.ndarray:
    """The inverse of an invertible 0/1 matrix over GF(2), Gauss-Jordan on
    [A | I]."""
    n = a.shape[0]
    m = np.concatenate([a.astype(bool), np.eye(n, dtype=bool)], axis=1)
    for k in range(n):
        p = k + int(np.argmax(m[k:, k]))
        assert m[p, k], "singular"
        m[[k, p]] = m[[p, k]]
        hit = m[:, k].copy()
        hit[k] = False
        m[hit] ^= m[k]
    return m[:, n:].astype(np.uint8)


def _dot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """0/1 product mod 2, in float32 (exact below 2**24 terms)."""
    p = torch.from_numpy(a.astype(np.float32)) @ \
        torch.from_numpy(b.astype(np.float32))
    return (p.numpy().astype(np.int64) & 1).astype(np.uint8)


def _reference(words, cnt, qloc, col0, n, preserve_l, miss_check):
    """One element from the definition: ``words`` uint32 [nb, 2nb/32]."""
    nb = words.shape[0]
    nbw = nb // 32
    P, L = _bits(words[:, :nbw]), _bits(words[:, nbw:])
    cols = [int(c) for c in qloc[:cnt]]
    E = np.zeros((nb, nb), np.uint8)
    for s, c in enumerate(cols):
        E[s, c] = 1
    U = P.copy()
    U[cnt:] = 0
    if preserve_l:          # L E: L's column j moved to pivot column c_j
        U[:cnt] ^= _dot(L[:cnt], E)
    upiv = _dot(U, E.T)                                       # U E^T
    # I + the strict upper triangle of U_piv: the identity outside the
    # pivot slots' block, so only that block is inverted
    T = np.eye(nb, dtype=np.uint8)
    T[:cnt, :cnt] = _gj_inverse(np.triu(upiv[:cnt, :cnt], 1)
                                ^ np.eye(cnt, dtype=np.uint8))
    m_small = _dot(E.T, T).astype(np.int8)
    wmat = (U ^ E if preserve_l else U).astype(np.int8)
    pivcol = E.any(axis=0)
    cmb = (~pivcol & (col0 + np.arange(nb) < n)) if miss_check \
        else np.zeros(nb, bool)
    return m_small, wmat, cmb.astype(np.int8)


def _case(seed, batch, nb, counts_, qoff):
    """Random slot rows (garbage everywhere: rows past the count, L's
    columns past it), distinct random pivot columns in the live slots and
    garbage in the others; ``batch`` None: a single window."""
    rng = np.random.default_rng(seed)
    B = 1 if batch is None else batch
    nbw = nb // 32
    words = rng.integers(0, 2**32, (B, nb, 2 * nbw), dtype=np.uint64) \
        .astype(np.uint32)
    qloc = np.stack([np.concatenate([rng.permutation(nb)[:c],
                                     rng.integers(-50, 2 * nb, nb - c)])
                     for c in counts_]).astype(np.int32)
    r0 = rng.integers(0, 300, B).astype(np.int32)
    rank = (r0 + np.asarray(counts_)).astype(np.int32)
    Pw = torch.from_numpy(words.view(np.int32))
    q = torch.from_numpy(qloc + qoff)
    if batch is None:
        return (Pw[0], torch.tensor(int(rank[0]), dtype=torch.int32),
                int(r0[0]), q[0]), words, qloc
    return (Pw, torch.from_numpy(rank), torch.from_numpy(r0), q), words, qloc


@pytest.mark.parametrize("miss_check", [True, False], ids=["miss", "nomiss"])
@pytest.mark.parametrize("preserve_l", [True, False], ids=["L", "noL"])
@pytest.mark.parametrize("nb", [32, 64, 96, 512])
def test_plain_and_wrapper_equal_the_definition(nb, preserve_l, miss_check):
    half = nb // 2
    cases = [(None, [c]) for c in (0, 1, half, nb)] + \
        [(3, [0, half, nb]), (3, [1, nb, 0])]
    for i, (batch, cnts) in enumerate(cases):
        qoff = 0 if batch else 64 * i
        col0 = 3 * nb * i
        # the last column's panel runs past the matrix in half the cases
        n = col0 + nb - 5 * (i % 2)
        args, words, qloc = _case(1000 * nb + i, batch, nb, cnts, qoff)
        plain = post_operands_plain(*args, qoff, col0, n, preserve_l,
                                    miss_check)
        wrapped = post_operands_hopper(*args, qoff, col0, n, preserve_l,
                                       miss_check)
        for got, w in zip(plain, wrapped):
            assert got.dtype == torch.int8
            assert torch.equal(got, w)
        want = [_reference(words[b], cnts[b], qloc[b], col0, n, preserve_l,
                           miss_check) for b in range(len(cnts))]
        for got, w in zip(plain, zip(*want)):
            w = np.stack(w)
            if batch is None:
                w = w[0]
            assert np.array_equal(got.numpy(), w), (nb, batch, cnts)


def test_plan_by_shape():
    assert operands_plan(976_000, 32, 132) == ("warp",)
    assert operands_plan(1, 32, 132) == ("warp",)
    assert operands_plan(1024, 512, 132) == ("block", 1, 16, 256)
    plan, strips, sw, threads = operands_plan(1, 1024, 132)
    assert plan == "block" and strips * sw >= 32 and strips > 1
    assert threads <= 1024


def test_wrapper_refuses_bad_operands():
    (Pw, rank, r0, q), _, _ = _case(5, 2, 64, [3, 9], 0)
    call = post_operands_hopper
    with pytest.raises(TypeError):
        call(Pw.long(), rank, r0, q, 0, 0, 64, True)
    with pytest.raises(ValueError):
        call(Pw[:, :, :3], rank, r0, q, 0, 0, 64, True)
    with pytest.raises(ValueError):
        call(Pw[:, :48, :3], rank, r0, q[:, :48], 0, 0, 64, True)
    with pytest.raises(TypeError):
        call(Pw, rank.long(), r0, q, 0, 0, 64, True)
    with pytest.raises(ValueError):
        call(Pw, rank, r0, q[:, :32], 0, 0, 64, True)
    with pytest.raises(TypeError):
        call(Pw, rank, r0.long(), q, 0, 0, 64, True)
    with pytest.raises(TypeError):
        call(Pw, rank, 1.5, q, 0, 0, 64, True)
    with pytest.raises(ValueError):
        call(torch.zeros((2, 2048, 128), dtype=torch.int32),
             rank, r0, torch.zeros((2, 2048), dtype=torch.int32), 0, 0, 64,
             True)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _on_card(seed, batch, nb, dev):
    """A batch of windows on the card with counts over [0, nb] (0, 1, nb
    among them) and the slot rows inside a taller window, as the sweep
    passes them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    nbw = nb // 32
    h = nb + 64
    al = torch.randint(-2**31, 2**31, (batch, h, 2 * nbw), dtype=torch.int32,
                       device=dev, generator=g)
    cnt = torch.randint(0, nb + 1, (batch,), dtype=torch.int32, device=dev,
                        generator=g)
    cnt[: min(batch, 3)] = torch.tensor([0, 1, nb], dtype=torch.int32,
                                        device=dev)[: min(batch, 3)]
    r0 = torch.randint(0, 1000, (batch,), dtype=torch.int32, device=dev,
                       generator=g)
    # distinct pivot columns in the live slots, anything in the others
    perm = torch.rand((batch, nb), device=dev, generator=g).argsort(1)
    junk = torch.randint(-50, 2 * nb, (batch, nb), device=dev, generator=g)
    live = torch.arange(nb, device=dev)[None, :] < cnt[:, None]
    q = torch.where(live, perm, junk).to(torch.int32)
    return al[:, :nb], r0 + cnt, r0, q


@pytest.mark.cuda
@pytest.mark.parametrize("nb,batch", [(32, 1), (32, 7), (32, 4096),
                                      (32, 2**20), (512, 1), (512, 131),
                                      (512, 1024), (1024, 1)])
def test_kernel_equals_plain(card, nb, batch):
    Pw, rank, r0, q = _on_card(nb + batch, batch, nb, card)
    for preserve_l, miss_check in [(True, True), (False, True),
                                   (True, False)]:
        for single in ([False, True] if batch == 1 else [False]):
            args = ((Pw[0], rank[0], int(r0[0]), q[0]) if single
                    else (Pw, rank, r0, q))
            before = counts().get("launch.post_operands_hopper", 0)
            got = post_operands_hopper(*args, 0, 32 * nb, 33 * nb - 7,
                                       preserve_l, miss_check)
            torch.cuda.synchronize()
            assert counts().get("launch.post_operands_hopper", 0) \
                == before + 1
            want = post_operands_plain(*args, 0, 32 * nb, 33 * nb - 7,
                                       preserve_l, miss_check)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (nb, batch, preserve_l, miss_check,
                                           single)


@pytest.mark.cuda
def test_one_wrapper_call_a_panel(card):
    import m4ri_tpu_torch as mt
    from m4ri_tpu_torch.models.batched import block_factor_batched
    g = torch.Generator(device=card).manual_seed(19)
    key = "launch.post_operands_hopper"
    A = mt.from_packed(torch.randint(-2**31, 2**31, (2048, 64),
                                     dtype=torch.int32, device=card,
                                     generator=g), 2048)
    before = counts().get(key, 0)
    mt.block_factor(A, preserve_l=True, nb=512)
    assert counts().get(key, 0) - before == 4
    data = torch.randint(-2**31, 2**31, (16, 768, 109), dtype=torch.int32,
                         device=card, generator=g)
    for pres in (False, True):
        before = counts().get(key, 0)
        block_factor_batched(data, 3488, pres)
        assert counts().get(key, 0) - before == 7

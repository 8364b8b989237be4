"""The batched sweep's commit of a panel (m4ri_tpu_torch/ops/hopper_commit.py
and ``models/batched.py::_commit``), on the CPU.

The reference is the chain of PyTorch operations the batched sweep committed
a panel with before the commit became one kernel a panel, written out here
once: every window row permuted on every word through int64 ``[B, W]``
indices, the panel and L words scattered into the elimination's full-height
buffers and copied over all padded rows, P and Q scattered at the slots
below each rank, the elements that missed redone from their full-height
pivot loop.  Each case runs ``block_factor_batched`` with the plain engine,
records what the sweep hands ``_commit`` on every panel, and holds the plain
version (and the wrapper, which takes it on CPU tensors) to the reference on
whole buffers: A, P, Q and lam including the padding rows, and the rank.
The sweep itself is held to the JAX package's ``block_factor`` element by
element.  The kernel is held to the plain version on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import m4ri_tpu as mj
import m4ri_tpu_torch as mt
from m4ri_tpu.models.ple import block_factor as jblock_factor
from m4ri_tpu_torch.models import batched
from m4ri_tpu_torch.models.batched import _commit, block_factor_batched
from m4ri_tpu_torch.ops.hopper_commit import (commit_plan,
                                              panel_commit_batched_plain,
                                              panel_commit_hopper_batched)
from m4ri_tpu_torch.utils.spans import counts


def _reference(A, P, Q, vw_full, lamw_full, ALw, rpw, p_f, q_f, r_f, r_in,
               miss, fallbacks, t, nb, m):
    """The commit as the sweep's chain of tensor operations had it."""
    B, W = rpw.shape
    nbw = nb // 32
    c0w = t * nbw
    wv = torch.arange(W, dtype=torch.int32)
    slotv = torch.arange(nb, dtype=torch.int32)
    win = (r_in[:, None] + wv[None, :]).long()

    def rows(x, idx):
        return x.gather(1, idx[:, :, None].expand(-1, -1, x.shape[2]))

    def put_rows(x, idx, r):
        x.scatter_(1, idx[:, :, None].expand(-1, -1, x.shape[2]), r)

    rpw = torch.where(miss[:, None], wv[None, :], rpw).long()
    put_rows(A, win, rows(rows(A, win), rpw))
    panel_full, Lpw = vw_full, lamw_full
    put_rows(panel_full, win, ALw[:, :, :nbw])
    put_rows(Lpw, win, ALw[:, :, nbw:])
    p_pan = r_in[:, None] + p_f
    q_pan = t * nb + q_f
    r = r_f.clone() if fallbacks else r_f
    for i, _, (AL, rp, r_s, _, p_i, q_i) in fallbacks:
        A[i] = A[i][rp.long()]
        panel_full[i] = AL[:, :nbw]
        Lpw[i] = AL[:, nbw:]
        p_pan[i] = p_i
        q_pan[i] = q_i
        r[i] = r_s
    keep = slotv[None, :] < (r - r_in)[:, None]
    sl = win[:, :nb]
    P.scatter_(1, sl, torch.where(keep, p_pan, P.gather(1, sl)))
    Q.scatter_(1, sl, torch.where(keep, q_pan, Q.gather(1, sl)))
    A[:, :, c0w : c0w + nbw] = panel_full
    return r


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(y) for y in x)
    return x


def _recorded_commits(monkeypatch, data, n, preserve_l, **kw):
    """Every panel's ``_commit`` arguments (less the commit function),
    cloned as the sweep hands them over, and the sweep's outputs."""
    seen = []

    def rec(commit, *args):
        seen.append(_clone(args))
        return _commit(commit, *args)

    monkeypatch.setattr(batched, "_commit", rec)
    out = block_factor_batched(data, n, preserve_l, engine="plain", **kw)
    return seen, out


def _bits(seed, B, m, n):
    return (np.random.default_rng(seed).random((B, m, n)) < 0.5) \
        .astype(np.uint8)


def _stack(mats):
    return torch.stack([mt.from_numpy(x, device="cpu").data for x in mats])


def _rank_case():
    return _bits(21, 256, 32, 32), {}


def _wide_case():
    return _bits(22, 6, 200, 700), dict(nb=64)


def _miss_case():
    """Elements 1 and 3 have a zeroed band under the window of a 32-column
    panel: their windows go deficient and are redone at full height."""
    mats = _bits(23, 5, 130, 100)
    mats[1, 20:110] = 0
    mats[3, 5:120] = 0
    return mats, dict(nb=32)


def _search_case():
    return _bits(24, 4, 200, 300), dict(nb=32, search_window=12)


CASES = {"rank": _rank_case, "wide": _wide_case, "two_miss": _miss_case,
         "search_window": _search_case}


@pytest.mark.parametrize("preserve_l", [False, True], ids=["noL", "L"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_commit_equals_the_chain(monkeypatch, case, preserve_l):
    mats, kw = CASES[case]()
    n = mats.shape[2]
    seen, _ = _recorded_commits(monkeypatch, _stack(mats), n, preserve_l,
                                **kw)
    missed = set()
    for args in seen:
        missed |= {f[0] for f in args[-4]}
        want = _clone(args)
        r_want = _reference(*want)
        for commit in (panel_commit_batched_plain,
                       panel_commit_hopper_batched):
            got = _clone(args)
            r_got = _commit(commit, *got)
            for k, name in [(0, "A"), (1, "P"), (2, "Q"), (4, "lamw")]:
                assert torch.equal(got[k], want[k]), (case, args[-3], name)
            assert torch.equal(r_got, r_want), (case, args[-3])
    assert missed == ({1, 3} if case == "two_miss" else set())


def test_elements_that_missed_are_left_alone(monkeypatch):
    """The plain version leaves an element with ``miss`` set word for word
    as it was, and moves no slot of P or Q outside ``[r_in, r_f)``."""
    mats, kw = _miss_case()
    seen, _ = _recorded_commits(monkeypatch, _stack(mats), 100, True, **kw)
    args = next(a for a in seen if a[-4])
    got = _clone(args)
    panel_commit_batched_plain(*got[:-4], *got[-3:])
    r_f, r_in, miss = args[9], args[10], args[11]
    for i in miss.nonzero().flatten().tolist():
        for k in (0, 1, 2, 4):                  # A, P, Q, lam
            assert torch.equal(got[k][i], args[k][i])
    for i in (~miss).nonzero().flatten().tolist():
        lo, hi = int(r_in[i]), int(r_f[i])
        for k in (1, 2):
            assert torch.equal(got[k][i, :lo], args[k][i, :lo])
            assert torch.equal(got[k][i, hi:], args[k][i, hi:])


def test_plan_by_shape():
    assert commit_plan(976_000, 32, 1, 1, 32, 132) == ("warp",)
    assert commit_plan(1, 64, 2, 2, 64, 132) == ("warp",)
    # mceliece348864's sweep: 576-row windows, nb = 512 of 3584 columns
    assert commit_plan(1024, 576, 16, 112, 768, 132) == ("block", 8, 128)
    assert commit_plan(1024, 576, 16, 32, 768, 132) == ("block", 8, 128)
    # one tall matrix: the rows below the window in tiles that fill the card
    kind, cw, rows = commit_plan(1, 1088, 32, 32, 70_000, 132)
    assert (kind, cw) == ("block", 8) and rows == 64
    kind, cw, rows = commit_plan(1, 1088, 32, 32, 4_000, 132)
    assert rows == 32
    # a window too tall for a chunk of 8 words in 48 KB
    assert commit_plan(4, 2048, 32, 64, 4096, 132)[1] == 4


def test_wrapper_refuses_bad_operands(monkeypatch):
    mats, kw = _wide_case()
    seen, _ = _recorded_commits(monkeypatch, _stack(mats[:2]), 700, False,
                                **kw)
    args = list(seen[0][:-4]) + list(seen[0][-3:])

    def call(k, x):
        a = list(args)
        a[k] = x
        panel_commit_hopper_batched(*a)

    with pytest.raises(TypeError):
        call(0, args[0].long())
    with pytest.raises(ValueError):
        call(1, args[1][:, :-1])
    with pytest.raises(TypeError):
        call(11, args[11].to(torch.int32))
    with pytest.raises(ValueError):
        call(6, args[6][:, :-1])
    with pytest.raises(ValueError):
        call(0, args[0].transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        call(12, 100)                           # t past the padded width


def test_sweep_equals_jax_block_factor_per_element():
    """block_factor_batched on CPU tensors, with two elements that miss,
    against the JAX package's block_factor of each element; both engines
    (the wrappers' plain versions under "hopper")."""
    mats, kw = _miss_case()
    n = mats.shape[2]
    tx = _stack(mats)
    f0 = counts().get("fallback.block_factor_batched", 0)
    for preserve_l in (False, True):
        for engine in ("plain", "hopper"):
            got = block_factor_batched(tx, n, preserve_l, engine=engine, **kw)
            for i, x in enumerate(mats):
                want = jblock_factor(mj.from_numpy(x), preserve_l,
                                     engine="xla", **kw)
                for w, g in zip(want[:3], got[:3]):
                    w = np.asarray(getattr(w, "data", w))
                    np.testing.assert_array_equal(
                        w.view(np.int32) if w.dtype == np.uint32 else w,
                        g[i].numpy(), err_msg=f"{engine} element {i}")
                assert int(got[3][i]) == int(want[3])
    assert counts().get("fallback.block_factor_batched", 0) > f0

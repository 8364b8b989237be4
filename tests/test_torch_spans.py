"""Spans and counters of the PyTorch/CUDA port (m4ri_tpu_torch/utils/spans.py):
recording off and on, nesting, self time, the entry points' span names on
CPU tensors, and, on the card (marker ``cuda``), that every launch of the
program's own kernels lies inside its ``kernel.*`` span on the profiler's
timeline and that the read-back counters agree with PyTorch's sync debug
mode:

    python -m pytest tests/test_torch_spans.py --noconftest -q -m cuda
"""

import pathlib
import re
import warnings

import numpy as np
import pytest
import torch

import m4ri_tpu_torch as mt
from m4ri_tpu_torch.models import batched
from m4ri_tpu_torch.utils import spans

CSRC = pathlib.Path(__file__).resolve().parent.parent / "m4ri_tpu_torch" / "csrc"
PANEL = {"panel.loop", "panel.operands", "panel.post", "panel.readback",
         "panel.commit", "panel.u_rows", "panel.schur"}
SWEEP = {("sweep", "panel")} | {("panel", p) for p in PANEL}


@pytest.fixture(autouse=True)
def default_state():
    spans.enable(None)
    spans.take()
    yield
    spans.enable(None)
    spans.take()


def _words(seed, rows, cols, batch=None):
    rng = np.random.default_rng(seed)
    shape = (rows, cols) if batch is None else (batch, rows, cols)
    bits = (rng.random(shape) < 0.5).astype(np.uint8)
    if batch is None:
        return mt.from_numpy(bits, device="cpu").data
    return torch.stack([mt.from_numpy(b, device="cpu").data for b in bits])


def _edges(recorded):
    """(parent name, child name) of every nested span, and the roots."""
    by_id = {s.id: s for s in recorded}
    edges = {(by_id[s.parent].name, s.name) for s in recorded
             if s.parent is not None}
    return edges, sorted(s.name for s in recorded if s.parent is None)


def _recorded(call):
    spans.enable()
    call()
    spans.enable(None)
    return spans.take()


def test_off_records_nothing_but_counts():
    a = mt.BitMatrix(_words(1, 150, 130), 130)
    before = spans.counts().get("readback.block_factor", 0)
    mt.ple(a, nb=32)
    assert spans.take() == []
    assert spans.span("x", t=1) is spans.span("y")          # one no-op
    assert spans.counts()["readback.block_factor"] - before == 5


def test_on_records_the_nesting_parents_and_root():
    a = mt.BitMatrix(_words(2, 150, 130), 130)
    got = _recorded(lambda: mt.ple(a, nb=32))
    root = [s for s in got if s.parent is None]
    assert [s.name for s in root] == ["ple"] and root[0].root == root[0].id
    by_id = {s.id: s for s in got}
    for s in got:
        assert s.root == root[0].id
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start <= s.start <= s.end <= p.end
    sweep = [s for s in got if s.name == "sweep"]
    assert [s.attrs for s in sweep] == [
        dict(m=150, n=130, nb=32, window=96, batch=1)]
    assert sorted(s.attrs["t"] for s in got if s.name == "panel") == \
        list(range(5))
    assert len(got) == len({s.id for s in got})


def test_self_time():
    S = spans.Span
    rec = [S("b", 10, 30, 2, 1, 1, 7, {}), S("c", 40, 45, 3, 1, 1, 7, {}),
           S("b", 50, 60, 4, 1, 1, 7, {}), S("a", 0, 100, 1, None, 1, 7, {}),
           S("d", 12, 20, 5, 2, 1, 7, {})]
    assert spans.self_ns(rec) == {"a": 65, "b": 22, "c": 5, "d": 8}


def test_the_profiler_turns_recording_on_for_a_call(monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    a = mt.BitMatrix(_words(3, 64, 64), 64)
    with profile(activities=[ProfilerActivity.CPU]):
        mt.ple(a, nb=32)
    got = spans.take()
    assert {s.name for s in got if s.parent is None} == {"ple"}
    with spans.span("outside"):          # no entry call open: not recorded
        pass
    mt.ple(a, nb=32)
    assert spans.take() == []
    # disable() holds under the profiler too (its flag set by hand here)
    monkeypatch.setattr(spans, "_profiling", lambda: True)
    mt.ple(a, nb=32)
    assert {s.name for s in spans.take() if s.parent is None} == {"ple"}
    spans.disable()
    mt.ple(a, nb=32)
    assert spans.take() == []


def test_counters_reset_by_prefix():
    spans.count("test.a", 2)
    spans.count("test.a")
    spans.count("other.b")
    assert spans.counts()["test.a"] == 3
    spans.reset_counts("test.")
    assert "test.a" not in spans.counts() and "other.b" in spans.counts()
    spans.reset_counts("other.")


def test_entry_points_span_names_on_cpu():
    """ple, mul, echelonize_batched and solve_left_batched on CPU tensors
    yield exactly the span names of PERF.md section 3, in that nesting."""
    a = mt.BitMatrix(_words(4, 150, 130), 130)
    edges, roots = _edges(_recorded(lambda: mt.ple(a, nb=32)))
    assert roots == ["ple"]
    assert edges == {("ple", "sweep"), ("ple", "compress_l")} | SWEEP

    b = mt.BitMatrix(_words(5, 130, 70), 70)
    edges, roots = _edges(_recorded(lambda: mt.mul(a, b)))
    assert roots == ["mul"] and edges == set()

    h = _words(6, 96, 200, batch=3)
    edges, roots = _edges(_recorded(
        lambda: mt.echelonize_batched(h, 200, nb=32)))
    assert roots == ["echelonize_batched"]
    # the TRSM's base blocks go through the inverse's wrapper on any device
    trsm_base = ("trsm", "kernel.unit_tri_inv_hopper")
    assert edges == {("echelonize_batched", "sweep"),
                     ("echelonize_batched", "rref"), ("rref", "trsm"),
                     trsm_base} | SWEEP

    sq, s = _words(7, 96, 96, batch=3), _words(8, 96, 1, batch=3)
    edges, roots = _edges(_recorded(
        lambda: mt.solve_left_batched(sq, 96, s, 1, nb=32)))
    assert roots == ["solve_left_batched"]
    assert edges == {("solve_left_batched", "sweep"),
                     ("solve_left_batched", "solve"), ("solve", "trsm"),
                     trsm_base} | SWEEP


def test_rank_batched_is_a_root_over_one_panel():
    """NIST SP 800-22's 32 x 32 ranks: one panel, so no U rows and no
    trailing update under the root."""
    nist = _words(12, 32, 32, batch=5)
    got = _recorded(lambda: mt.rank_batched(nist, 32))
    edges, roots = _edges(got)
    assert roots == ["rank_batched"]
    one_panel = SWEEP - {("panel", "panel.u_rows"), ("panel", "panel.schur")}
    assert edges == {("rank_batched", "sweep")} | one_panel
    assert sum(s.name == "panel.readback" for s in got) == 1


def test_a_miss_nests_its_read_back_in_the_fallback():
    data = _words(9, 96, 96)
    data[20:60] = 0
    a = mt.BitMatrix(data, 96)
    got = _recorded(lambda: mt.block_factor(a, True, nb=32, window=32))
    edges, roots = _edges(got)
    assert roots == ["sweep"]
    assert {("panel", "panel.fallback"),
            ("panel.fallback", "panel.readback")} <= edges
    fallbacks = sum(s.name == "panel.fallback" for s in got)
    readbacks = sum(s.name == "panel.readback" for s in got)
    assert fallbacks > 0 and readbacks == 3 + fallbacks


@pytest.mark.parametrize("single", [True, False])
def test_kernel_spans_carry_host_operands(single):
    """The wrappers' spans, on their plain versions here, nest under the
    sweep's phases and carry host ints only."""
    if single:
        a = mt.BitMatrix(_words(10, 150, 130), 130)
        got = _recorded(lambda: mt.block_factor(a, True, nb=32,
                                                engine="hopper"))
        want = {("panel.loop", "kernel.panel_loop_hopper"),
                ("panel.operands", "kernel.post_operands_hopper"),
                ("panel.post", "kernel.panel_post_hopper"),
                ("panel.u_rows", "kernel.unit_tri_inv_hopper"),
                ("panel.u_rows", "kernel.gf2_mul_hopper"),
                ("panel.schur", "kernel.gf2_schur_update_hopper")}
    else:
        h = _words(11, 96, 200, batch=3)
        got = _recorded(lambda: batched.block_factor_batched(
            h, 200, True, nb=32, engine="hopper"))
        want = {("panel.loop", "kernel.panel_loop_hopper_batched"),
                ("panel.operands", "kernel.post_operands_hopper"),
                ("panel.post", "kernel.panel_post_hopper_batched"),
                ("panel.commit", "kernel.panel_commit_hopper_batched"),
                ("panel.u_rows", "kernel.unit_tri_inv_hopper"),
                ("panel.u_rows", "kernel.gf2_schur_update_batched_hopper"),
                ("panel.schur", "kernel.gf2_schur_update_batched_hopper")}
    edges, _ = _edges(got)
    assert {e for e in edges if e[1].startswith("kernel.")} == want
    for s in got:
        assert all(v is None or isinstance(v, (int, str))
                   for v in s.attrs.values()), s
    inverses = [s.attrs for s in got
                if s.name == "kernel.unit_tri_inv_hopper"]
    batch = 1 if single else 3
    # T = U_piv^{-1} is taken inside the operands' wrapper: one operands
    # call a panel, and an L11^{-1} (lower) a panel but the last
    operands = [s.attrs for s in got
                if s.name == "kernel.post_operands_hopper"]
    assert operands == [dict(batch=batch, nb=32, preserve_l=1)] * (
        5 if single else 7)
    assert inverses[:2] == [dict(batch=batch, n=32, upper=0)] * 2
    assert sum(a["upper"] for a in inverses) == 0
    assert len(inverses) == (4 if single else 6)
    if single:
        schur = [s.attrs for s in got
                 if s.name == "kernel.gf2_schur_update_hopper"]
        assert schur[0] == dict(m=256, nw=5, k=32, r0=0, c0w=1,
                                col_tile_skip=0)


@pytest.mark.parametrize("kw", [dict(nb=32), dict(nb=32, search_window=12)],
                         ids=["miss_check", "search_window"])
def test_commit_kernel_span_under_every_panel_commit(kw):
    """One ``kernel.panel_commit_hopper_batched`` span inside each
    ``panel.commit`` of the batched sweep, with the batch, the window, the
    padded width and the plan; the last panel's commit included."""
    h = _words(15, 96, 200, batch=3)
    got = _recorded(lambda: batched.block_factor_batched(
        h, 200, True, engine="hopper", **kw))
    by_id = {s.id: s for s in got}
    commits = [s for s in got if s.name == "panel.commit"]
    kernels = [s for s in got if s.name == "kernel.panel_commit_hopper_batched"]
    assert len(commits) == 7 and len(kernels) == 7
    assert sorted(by_id[s.parent].id for s in kernels) == \
        sorted(s.id for s in commits)
    # the window: nb plus the 64-row search margin, 96 rows
    assert {tuple(sorted(s.attrs.items())) for s in kernels} == {
        (("W", 96), ("batch", 3), ("plan", "block"), ("w_pad", 7))}


# ---- on the card ------------------------------------------------------------

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def _own_names():
    return {n for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")
            for n in _GLOBAL.findall(p.read_text())}


def _short(name):
    head = re.sub(r"<[^()]*>", "", name.split("(")[0])
    return head.split()[-1].split("::")[-1] if head.split() else name


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _keygen_stack(dev):
    g = torch.Generator(device=dev).manual_seed(12)
    return torch.randint(-2**31, 2**31, (16, 768, 109), dtype=torch.int32,
                         device=dev, generator=g)


def _calls(dev):
    g = torch.Generator(device=dev).manual_seed(13)
    a = mt.randomize(4096, 4096, g)
    h = _keygen_stack(dev)
    nist = torch.randint(-2**31, 2**31, (976_000, 32, 1), dtype=torch.int32,
                         device=dev, generator=g)
    return {"ple": lambda: mt.ple(a),
            "keygen": lambda: mt.echelonize_batched(h, 3488),
            "rank": lambda: mt.rank_batched(nist, 32)}


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["ple", "keygen", "rank"])
def test_own_launches_lie_in_their_kernel_spans(card, entry):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call = _calls(card)[entry]
    call()                                       # kernels built
    torch.cuda.synchronize()
    spans.take()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    recorded = spans.take()
    kernel_spans = [s for s in recorded if s.name.startswith("kernel.")]
    events = list(prof.profiler.kineto_results.events())
    launch_at = {e.correlation_id(): e.start_ns() for e in events
                 if e.device_type() != DeviceType.CUDA
                 and e.name().startswith("cuda")}
    own = _own_names()
    launches = [e for e in events if e.device_type() == DeviceType.CUDA
                and _short(e.name()) in own]
    assert launches and kernel_spans
    outside = [(_short(e.name()), launch_at.get(e.correlation_id()))
               for e in launches
               if not any(s.start <= launch_at.get(e.correlation_id(), -1)
                          < s.end for s in kernel_spans)]
    assert outside == []


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["ple", "keygen", "rank"])
def test_read_back_counters_equal_the_sync_debug_mode(card, entry):
    call = _calls(card)[entry]
    call()
    torch.cuda.synchronize()
    before = spans.counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    waits = sum("called a synchronizing CUDA operation" in str(w.message)
                for w in caught)
    after = spans.counts()
    counted = sum(n - before.get(k, 0) for k, n in after.items()
                  if k.startswith("readback."))
    assert waits == counted > 0


@pytest.mark.cuda
def test_rank_batched_kernel_spans_nest_in_its_phases(card):
    g = torch.Generator(device=card).manual_seed(14)
    nist = torch.randint(-2**31, 2**31, (4096, 32, 1), dtype=torch.int32,
                         device=card, generator=g)
    mt.rank_batched(nist, 32)                    # kernels built
    torch.cuda.synchronize()
    edges, roots = _edges(_recorded(lambda: mt.rank_batched(nist, 32)))
    assert roots == ["rank_batched"]
    assert {e for e in edges if e[1].startswith("kernel.")} == {
        ("panel.loop", "kernel.panel_loop_hopper_batched"),
        ("panel.operands", "kernel.post_operands_hopper"),
        ("panel.post", "kernel.panel_post_hopper_batched"),
        ("panel.commit", "kernel.panel_commit_hopper_batched")}

"""The traced window put down to the program's spans (``attribution.py``),
the readers of the ``program_span`` metrics and the Schur update's least
time, on synthetic timelines: no torch, no card."""

from collections import namedtuple

import pytest

from portbench import attribution, harness, program_spans, schur_peaks

S = namedtuple("S", "name start end id parent root tid attrs")


def _call(base=0, tid=7, root_id=1):
    """One call: root [0, 100); sweep [10, 60) with a panel [10, 60) whose
    read-back is [40, 50) and whose Schur kernel span is [50, 58); rref
    [60, 90) with a trsm [70, 90)."""
    b, r = base, root_id
    attrs = dict(m=512, k=32, nw=16, r0=0, c0w=1, col_tile_skip=0)
    return [S("ple", b, b + 100, r, None, r, tid, {}),
            S("sweep", b + 10, b + 60, r + 1, r, r, tid, {}),
            S("panel", b + 10, b + 60, r + 2, r + 1, r, tid, {"t": 0}),
            S("panel.readback", b + 40, b + 50, r + 3, r + 2, r, tid, {}),
            S(attribution.SCHUR, b + 50, b + 58, r + 4, r + 2, r, tid,
              attrs),
            S("rref", b + 60, b + 90, r + 5, r, r, tid, {}),
            S("trsm", b + 70, b + 90, r + 6, r + 5, r, tid, {})]


def test_open_at_innermost_and_edges():
    spans = _call()
    got = attribution.open_at(spans, [45, 10, 60, 100, 0, 99, -1, 59])
    assert [s and s.name for s in got] == [
        "panel.readback", "panel", "rref", None, "ple", "ple", None,
        "panel"]


def test_a_launch_at_a_span_edge_belongs_to_the_span_it_opens():
    spans = _call()
    # launched at 40 (the read-back's start) and at 50 (its end, the
    # Schur span's start)
    device = [("k1", 200, 210, 11), ("k2", 210, 220, 12)]
    launches = {11: (40, 7), 12: (50, 7)}
    got = attribution.attribute(device, launches, spans, (0, 300), set())
    assert dict(got["device_by_span"]) == pytest.approx(
        {"panel.readback": 1e-8, attribution.SCHUR: 1e-8})


def test_glue_split_by_sweep_and_solver_and_unmatched_ids():
    spans = _call()
    device = [("gemm", 100, 130, 1),      # launched in the panel
              ("own_kernel", 130, 140, 2),  # in the Schur span
              ("gemm", 140, 150, 3),      # in the trsm: solver API
              ("copy", 150, 155, 4),      # launched outside every span
              ("gemm", 155, 160, 99),     # no runtime call carries id 99
              ("gemm", 400, 500, 5)]      # after the window
    launches = {1: (20, 7), 2: (52, 7), 3: (75, 7), 4: (120, 7),
                5: (30, 7)}
    got = attribution.attribute(device, launches, spans, (0, 300),
                                {"own_kernel"},
                                schur_peaks.span_least_s)
    ns = 1e-9
    assert got["sweep_glue_s"] == pytest.approx(30 * ns)
    assert got["solver_glue_s"] == pytest.approx(10 * ns)
    assert got["glue_s"] == pytest.approx(50 * ns)
    assert got["unmatched"] == 1
    assert got["own_launches"] == 1 and got["own_outside_kernel_spans"] == 0
    assert dict(got["glue_by_span"]) == pytest.approx(
        {"panel": 30 * ns, "trsm": 10 * ns, attribution.NO_SPAN: 5 * ns,
         attribution.NO_LAUNCH: 5 * ns})
    assert got["schur_device_s"] == pytest.approx(10 * ns)
    assert got["schur_least_s"] == schur_peaks.span_least_s(spans[4].attrs)


def test_an_own_kernel_outside_its_span_is_counted():
    spans = _call()
    device = [("own_kernel", 100, 110, 1)]
    got = attribution.attribute(device, {1: (45, 7)}, spans, (0, 300),
                                {"own_kernel"})
    assert got["own_outside_kernel_spans"] == 1


def test_idle_gaps_by_span_and_outside_every_root():
    spans = _call()
    device = [("k", 0, 20, 1), ("k", 45, 55, 2)]
    got = attribution.attribute(device, {}, spans, (0, 150), set())
    # gaps [20, 45) from inside the panel, [55, 150) from inside the
    # Schur span; with the call ended at 100 nothing is open at 100
    assert dict(got["idle_by_span"]) == pytest.approx(
        {"panel": 25e-9, attribution.SCHUR: 95e-9})
    got = attribution.attribute([("k", 0, 100, 1)], {}, spans, (0, 130),
                                set())
    assert dict(got["idle_by_span"]) == pytest.approx(
        {attribution.NO_SPAN: 30e-9})


def test_launches_go_to_their_own_thread():
    spans = _call(tid=7) + _call(base=0, tid=8, root_id=100)
    spans = [s for s in spans if not (s.tid == 8 and s.name != "ple")]
    device = [("gemm", 100, 110, 1), ("gemm", 110, 120, 2),
              ("gemm", 120, 130, 3)]
    launches = {1: (20, 7), 2: (20, 8), 3: (20, None)}
    got = attribution.attribute(device, launches, spans, (0, 300), set())
    # thread 7 is in its panel, thread 8 in its root alone; a launch with
    # no known thread is asked of every span
    by = dict(got["glue_by_span"])
    assert by["panel"] == pytest.approx(20e-9) and by["ple"] == \
        pytest.approx(10e-9)


def test_host_ms_less_the_read_backs():
    spans = _call() + _call(base=1000, root_id=50)
    assert attribution.host_ms(spans, "sweep", less="panel.readback") == \
        pytest.approx(2 * 40 / 1e6)
    assert attribution.host_ms(spans, "panel.readback") == \
        pytest.approx(2 * 10 / 1e6)


def test_readers_of_program_spans(monkeypatch):
    class Program:
        @staticmethod
        def take():
            return _call() + _call(base=1000, root_id=50)

    rec = harness.Records(setup_s=1.0, window_s=1.0, calls=2, matrices=2,
                          call_ms=[1.0, 1.0], peak_bytes=1, work={},
                          trace={}, syncs=2)
    monkeypatch.setitem(__import__("sys").modules,
                        program_spans.PROGRAM_SPANS, Program)
    assert harness.reader("sweep_host_ms.host_paced")(rec) == \
        pytest.approx(40 / 1e6)
    assert harness.reader("readback_wait_ms")(rec) == \
        pytest.approx(10 / 1e6)
    # untraced, or a program without spans: nothing to read
    rec2 = harness.Records(**{**rec.__dict__, "trace": None})
    assert harness.reader("readback_wait_ms")(rec2) is None
    monkeypatch.delitem(__import__("sys").modules,
                        program_spans.PROGRAM_SPANS)
    rec3 = harness.Records(**rec.__dict__)
    assert harness.reader("sweep_host_ms")(rec3) is None


def test_schur_least_time_counts_the_active_rectangle():
    full = schur_peaks.schur_least_s(34048, 1024, 1024, 0, 32)
    assert full == pytest.approx(0.1398e-3, rel=2e-3)    # PERF.md row 3
    assert schur_peaks.schur_least_s(34048, 1024, 1024, 34048, 32) == 0
    assert schur_peaks.span_least_s(dict(m=1, k=1, nw=1, r0=None,
                                         c0w=0)) is None
    skipped = schur_peaks.span_least_s(dict(m=34048, k=1024, nw=1024, r0=0,
                                            c0w=32, col_tile_skip=8))
    assert skipped == schur_peaks.schur_least_s(34048, 1024, 1024, 0, 64)


def test_split_summary_per_call():
    from portbench import split
    spans = _call() + _call(base=1000, root_id=50)
    device = [("gemm", 20, 40, 1), ("own_kernel", 60, 70, 2),
              ("gemm", 1020, 1040, 3)]
    launches = {1: (15, 7), 2: (52, 7), 3: (1075, 7)}
    self_ns = {"ple": 2 * 40}
    got = split.summary({"calls": 2, "syncs": 2, "device": device,
                         "launches": launches, "window": (0, 2000),
                         "spans": spans, "self_ns": self_ns},
                        frozenset({"own_kernel"}))
    assert got["sweep_glue_device_ms"] == pytest.approx(20e-6 / 2)
    assert got["solver_glue_device_ms"] == pytest.approx(20e-6 / 2)
    assert got["glue_device_ms"] == pytest.approx(40e-6 / 2)
    assert got["own_launches_outside_kernel_spans"] == 0
    assert got["readback_spans_per_call"] == 1
    assert got["sweep_host_ms"] == pytest.approx(40e-6)
    assert got["host_self_ms_by_span"] == {"ple": pytest.approx(40e-6)}
    assert 0 < got["schur_roofline"]
    assert got["device_idle_share"] == pytest.approx(100 * (1 - 50 / 2000))

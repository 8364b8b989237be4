"""The benchmark's arithmetic on synthetic windows: rates, percentiles,
idle as a union, the breakdown, the roofline's count and each reader."""

import math
import pathlib

import numpy as np
import pytest

from portbench import harness, kernels, peaks, timeline, trace

from conftest import ROOT


def test_rate_is_all_work_over_all_time():
    assert timeline.rate(230, 30.5) == pytest.approx(230 / 30.5)
    with pytest.raises(ValueError):
        timeline.rate(1, 0)


@pytest.mark.parametrize("n", [2, 7, 20, 233, 1000])
def test_p95_of_every_call_matches_numpy(n):
    values = list(np.random.default_rng(n).gamma(2.0, 60.0, size=n))
    assert timeline.p95(values) == pytest.approx(np.percentile(values, 95))


def test_p95_is_not_a_median_of_chunks():
    # nine fast chunks and one slow: the tail is the slow calls'
    values = [100.0] * 190 + [200.0] * 10
    assert timeline.p95(values) == pytest.approx(
        np.percentile(values, 95))
    assert timeline.p95(values) > 100.0


@pytest.mark.parametrize("intervals,busy", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (5, 15)], 15),               # overlap counted once
    ([(0, 10), (2, 3), (10, 12)], 12),      # nested and touching
    ([(20, 30), (0, 5), (4, 6)], 16),       # unsorted
])
def test_busy_is_the_union(intervals, busy):
    assert timeline.busy(intervals) == busy


def test_gaps_and_idle_share_of_the_window():
    device = [(10, 20), (15, 30), (50, 60), (95, 120)]
    assert timeline.gaps(device, 0, 100) == [(0, 10), (30, 50), (60, 95)]
    busy = timeline.busy(timeline.clip(device, 0, 100))
    assert busy == 20 + 10 + 5
    assert timeline.gaps([], 0, 100) == [(0, 100)]


def test_idle_is_named_by_the_innermost_host_operations():
    host = [(0, 100, "portbench.window"), (5, 40, "portbench.call"),
            (10, 30, "aten::item"), (12, 29, "cudaStreamSynchronize"),
            (60, 70, "portbench.call")]
    idle = [(13, 20), (41, 50), (61, 65), (100, 110)]
    stacks = timeline.host_ops_at(idle, host)
    assert stacks[0] == ["portbench.window", "portbench.call", "aten::item",
                         "cudaStreamSynchronize"]
    assert stacks[1] == ["portbench.window"]
    assert stacks[2] == ["portbench.window", "portbench.call"]
    assert stacks[3] == []
    by = timeline.idle_by_host_op(idle, stacks)
    assert by == {"aten::item > cudaStreamSynchronize": 7e-9,
                  "portbench.window": 9e-9,
                  "portbench.window > portbench.call": 4e-9,
                  "(no host operation)": 10e-9}
    assert timeline.top(by, 2) == [["(no host operation)", 10e-9],
                                   ["portbench.window", 9e-9]]


def test_trace_reduce_on_a_synthetic_window():
    own = frozenset({"gf2_gemm_kernel", "panel_kernel"})
    device = [("void gf2::gemm::gf2_gemm_kernel<3>(Args)", 100, 400),
              ("void gf2::panel_kernel<false, false>(gf2::PanelArgs)",
               500, 600),
              ("void at::native::vectorized_elementwise_kernel<4>(int)",
               550, 700),
              ("Memcpy DtoH (Device -> Pageable)", 900, 950),
              ("void gf2::panel_kernel<true, false>(gf2::PanelArgs)",
               -50, 20)]                       # half before the window
    host = [(0, 1000, "portbench.window"), (700, 890, "aten::item")]
    got = trace.reduce(device, host, (0, 1000), own)
    assert got["window_s"] == pytest.approx(1000e-9)
    assert got["busy_s"] == pytest.approx((20 + 300 + 200 + 50) * 1e-9)
    assert got["own_launches"] == 3
    assert got["own_s"] == pytest.approx((300 + 100 + 20) * 1e-9)
    assert got["glue_s"] == pytest.approx((150 + 50) * 1e-9)
    ops = dict(got["breakdown"]["device_ops"])
    assert ops["gf2_gemm_kernel"] == pytest.approx(300e-9)
    assert ops["panel_kernel"] == pytest.approx(120e-9)
    gaps = dict(got["breakdown"]["idle_gaps"])
    assert gaps["portbench.window > aten::item"] == pytest.approx(200e-9)
    assert sum(gaps.values()) == pytest.approx(1000e-9 - got["busy_s"])


def test_gemm_least_time_and_its_bound():
    n = 32768
    ops = 2 * n ** 3 / peaks.PEAK_B1_OPS_PER_S
    assert peaks.PEAK_B1_OPS_PER_S == 8 * 1979e12
    assert peaks.gemm_least_s(n, n, n) == pytest.approx(ops)
    assert peaks.gemm_least_s(n, n, n) == pytest.approx(4.4447e-3, rel=1e-4)
    # a skinny product is bound by its bytes
    small = peaks.gemm_least_s(65536, 32, 32)
    assert small == pytest.approx(4 * (65536 + 32 + 65536)
                                  / peaks.PEAK_BYTES_PER_S)


def records(**trace_fields):
    rec = harness.Records(setup_s=9.5, window_s=30.0, calls=200,
                          matrices=200, call_ms=[130.0] * 190 + [150.0] * 10,
                          peak_bytes=3 * 2**29, work={})
    if trace_fields:
        rec.trace = dict(window_s=29.0, busy_s=26.1, own_s=4.0, glue_s=22.0,
                         own_launches=32 * 4 * 200, breakdown={})
        rec.trace.update(trace_fields)
        rec.syncs = 6400
    return rec


def test_end_to_end_readers():
    rec = records()
    assert harness.reader("matrices_per_s")(rec) == pytest.approx(200 / 30)
    # a metric of a group of cells is read by its quantity's reader
    assert harness.reader("matrices_per_s.host_paced")(rec) == \
        pytest.approx(200 / 30)
    assert harness.reader("call_ms_p95")(rec) == pytest.approx(
        np.percentile(rec.call_ms, 95))
    assert harness.reader("peak_mem_gib")(rec) == pytest.approx(1.5)
    assert harness.reader("setup_s")(rec) == 9.5


def test_per_layer_readers_and_their_silence_without_a_trace():
    names = ["device_idle_share", "glue_device_ms", "hand_kernel_device_ms",
             "launches_per_call", "host_syncs_per_call", "gemm_roofline"]
    untraced = records()
    for name in names:
        assert harness.reader(name)(untraced) is None
    rec = records(busy_s=26.1)
    assert harness.reader("device_idle_share")(rec) == pytest.approx(10.0)
    assert harness.reader("glue_device_ms")(rec) == pytest.approx(110.0)
    assert harness.reader("hand_kernel_device_ms")(rec) == pytest.approx(20.0)
    assert harness.reader("launches_per_call")(rec) == pytest.approx(128)
    assert harness.reader("host_syncs_per_call")(rec) == pytest.approx(32)
    # no product named by the entry: the roofline finds nothing to read
    assert harness.reader("gemm_roofline")(rec) is None


def test_gemm_roofline_share():
    rec = records(busy_s=200 * 5.3e-3)
    rec.work = {"gemm": [(32768, 32768, 32768)]}
    share = harness.reader("gemm_roofline")(rec)
    assert share == pytest.approx(100 * 4.4447 / 5.3, rel=1e-4)
    rec.trace["own_launches"] = 0       # nothing of the program's ran
    assert harness.reader("hand_kernel_device_ms")(rec) is None
    assert harness.reader("launches_per_call")(rec) is None


def test_own_kernels_are_read_from_the_sources(tmp_path):
    names = kernels.own_kernel_names(ROOT / "m4ri_tpu_torch" / "csrc")
    assert {"gf2_gemm_kernel", "panel_kernel", "panel_warp_kernel",
            "post_pack_kernel", "post_kernel", "schur_kernel",
            "schur_transpose_kernel", "prefix_sum_kernel"} <= names
    (tmp_path / "new.cu").write_text(
        "template <int N>\n__global__ void __launch_bounds__(128, 2)\n"
        "later_kernel(int* out) {}\n__device__ void helper() {}\n")
    assert kernels.own_kernel_names(pathlib.Path(tmp_path)) == {
        "later_kernel"}


@pytest.mark.parametrize("name,short", [
    ("void gf2::gemm::gf2_gemm_kernel<(int)3>(CUtensorMap, Args)",
     "gf2_gemm_kernel"),
    ("void gf2::panel_kernel<false, true>(gf2::PanelArgs)", "panel_kernel"),
    ("void at::native::(anonymous namespace)::fill<{lambda(int)#1}>(int)",
     "fill"),
    ("sm90_xmma_gemm_f16f16_f16f32", "sm90_xmma_gemm_f16f16_f16f32"),
    ("Memcpy DtoH (Device -> Pinned)", "Memcpy DtoH (Device -> Pinned)"),
    ("Memset (Device)", "Memset (Device)"),
])
def test_short_names(name, short):
    assert kernels.short_name(name) == short


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["m4ri_tpu_torch", "m4ri_tpu_torch.ops", "jaxtyping", "jax_x",
             "portbench", "torch"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ["jax", "jaxlib.xla_client",
                                              "flax.linen",
                                              "m4ri_tpu.ops.mul"]) == [
        "flax.linen", "jax", "jaxlib.xla_client", "m4ri_tpu.ops.mul"]


def test_sampler_takes_the_call_running_at_each_drawn_moment():
    """Without a pool, the call that ends first after each moment."""
    s = harness.Sampler(3, 1, 2**31 + 11, 10.0, (np.zeros(2),))
    moments = [t for t, _ in s.pending]
    assert moments == sorted(moments) and all(0 <= t < 9 for t in moments)
    ends = [0.5 * (i + 1) for i in range(20)]
    for i, t in enumerate(ends):
        s.offer(i, t, (i,))
    want = [math.ceil(t / 0.5) - 1 for t in moments]
    assert [i for i, _ in s.samples] == want
    again = harness.Sampler(3, 1, 2**31 + 11, 10.0, (np.zeros(2),))
    assert [t for t, _ in again.pending] == moments   # the same seed


@pytest.mark.parametrize("seed", [1, 2**31 + 3, 2**33 + 7])
def test_sampler_judges_every_input_of_the_pool(seed):
    """Four moments on a pool of four: each input is judged once, by the
    first call on it that ends after its moment, before the window closes."""
    s = harness.Sampler(4, 4, seed, 10.0, (np.zeros(2),))
    ends = [0.13 * (i + 1) for i in range(77)]           # a 10 s window
    for i, t in enumerate(ends):
        s.offer(i, t, (i,))
    assert not s.pending
    got = [i for i, _ in s.samples]
    assert sorted(i % 4 for i in got) == [0, 1, 2, 3]
    for (moment, k), i in zip(sorted(harness.Sampler(
            4, 4, seed, 10.0, (np.zeros(2),)).pending), got):
        assert i % 4 == k and ends[i] >= moment
        assert i < 4 or ends[i - 4] < moment


class _Event:
    """A profiler event as PyTorch before 2.12 gives it (no activity
    type): a name, a device, a start and a length in ns."""

    def __init__(self, name, cuda, start, length):
        from torch.autograd import DeviceType
        self._name, self._start, self._length = name, start, length
        self._dev = DeviceType.CUDA if cuda else DeviceType.CPU

    def name(self):
        return self._name

    def device_type(self):
        return self._dev

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._length


class _Profile:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("R", (), {
            "events": lambda _self: events})()


def test_collect_finds_the_window_and_the_device_work():
    events = [
        _Event("cudaEventRecordWithFlags", False, 100, 2),
        _Event("cudaLaunchKernel", False, 105, 3),
        _Event("void gf2::panel_kernel<false, false>(gf2::PanelArgs)", True,
               110, 40),
        _Event("cudaStreamSynchronize", False, 120, 40),
        _Event("Stream Sync", True, 120, 40),          # not work
        _Event("Memcpy DtoH (Device -> Pageable)", True, 150, 5),
        _Event("cudaDeviceSynchronize", False, 160, 30),
        _Event("cudaEventRecordWithFlags", False, 200, 2),
        _Event("Memset (Device)", True, 210, 10),
        _Event("cudaDeviceSynchronize", False, 215, 20),
    ]
    device, host, window, kinds = trace.collect(_Profile(events))
    assert window == (100, 235)
    assert [d[0][:6] for d in device] == ["void g", "Memcpy", "Memset"]
    assert kinds == {"cpu_op": 6, "kernel": 1, "cuda_sync": 1,
                     "gpu_memcpy": 1, "gpu_memset": 1}
    got = trace.reduce(device, host, window, frozenset({"panel_kernel"}))
    assert got["busy_s"] == pytest.approx(55e-9)
    assert got["window_s"] == pytest.approx(135e-9)
    gaps = dict(got["breakdown"]["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx((210 - 155) * 1e-9)
    assert gaps["cudaDeviceSynchronize"] == pytest.approx((235 - 220) * 1e-9)
    assert gaps["cudaEventRecordWithFlags"] == pytest.approx(10e-9)


class _TypedEvent(_Event):
    """An event as PyTorch 2.13 gives it, with its activity type."""

    def __init__(self, kind, *args):
        super().__init__(*args)
        self._kind = kind

    def activity_type(self):
        return self._kind


def test_collect_reads_activity_types_where_the_profiler_gives_them():
    events = [
        _TypedEvent("cuda_runtime", "cudaEventRecordWithFlags", False, 0, 1),
        _TypedEvent("cuda_driver", "cuLaunchKernelEx", False, 2, 3),
        _TypedEvent("kernel", "gf2_gemm_kernel", True, 5, 50),
        _TypedEvent("cuda_sync", "Stream Sync", True, 55, 20),
        _TypedEvent("gpu_user_annotation", "region", True, 0, 90),
        _TypedEvent("cuda_runtime", "cudaDeviceSynchronize", False, 10, 80),
    ]
    device, host, window, kinds = trace.collect(_Profile(events))
    assert window == (0, 90)
    assert [d[0] for d in device] == ["gf2_gemm_kernel"]
    assert [h[2] for h in host] == ["cudaEventRecordWithFlags",
                                    "cuLaunchKernelEx",
                                    "cudaDeviceSynchronize"]


class _AnnotatedEvent(_Event):
    """An event as PyTorch 2.11 gives it: no activity type, but a flag for
    user annotations."""

    def __init__(self, annotation, *args):
        super().__init__(*args)
        self._annotation = annotation

    def is_user_annotation(self):
        return self._annotation


def test_collect_leaves_out_annotations_without_activity_types():
    """A ``record_function`` range the profiler maps onto the device's rows
    is neither device work nor a host call: a span inside the program moves
    neither the busy time nor the glue."""
    events = [
        _AnnotatedEvent(False, "cudaEventRecordWithFlags", False, 0, 1),
        _AnnotatedEvent(True, "ops/hopper_panel.panel_loop", True, 0, 90),
        _AnnotatedEvent(False, "cudaLaunchKernel", False, 2, 3),
        _AnnotatedEvent(False, "void gf2::panel_kernel<false, false>"
                        "(gf2::PanelArgs)", True, 5, 50),
        _AnnotatedEvent(False, "cudaDeviceSynchronize", False, 10, 80),
    ]
    device, host, window, kinds = trace.collect(_Profile(events))
    assert window == (0, 90)
    assert len(device) == 1 and "panel_kernel" in device[0][0]
    assert kinds["gpu_user_annotation"] == 1
    got = trace.reduce(device, host, window, frozenset({"panel_kernel"}))
    assert got["busy_s"] == pytest.approx(50e-9)
    assert got["glue_s"] == 0 and got["own_launches"] == 1

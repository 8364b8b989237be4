"""The traced window: ``torch.profiler`` (CUPTI) events kept in memory and
reduced to what the per-layer readers and the breakdown need.

Only the device's activity is traced (kernels, copies, memsets, and the
CUDA runtime calls the host makes): recording every PyTorch operator as
well doubles the host's time a call on the sweep's thousands of small
operators, and the idle share would then measure the profiler.  The window
runs from the first ``cudaEventRecord*`` (the harness marks each call's
start with one) to the end of the last ``cudaDeviceSynchronize`` (each call's
end).  The raw events are read from the profiler's result directly,
without PyTorch's per-event post-processing.  No trace file is written.
"""

from __future__ import annotations

from . import timeline
from .kernels import short_name

START, END = "cudaEventRecord", "cudaDeviceSynchronize"
# device activity that is work; the rest on the device's rows of the trace
# (stream and event syncs, annotations) is not
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
# the host's side: operators and the CUDA API calls ("cuda_runtime" and the
# lower-level API), but not the device rows' "cuda_sync"
HOST_PREFIXES = ("cpu_op", "cuda_")
# names CUPTI gives its synchronisation records on the device's rows
SYNC_NAMES = ("Event Sync", "Stream Wait Event", "Stream Sync",
              "Context Sync", "Unknown")


def _kind(ev) -> str:
    """The event's activity type; from its device and name where the
    profiler does not give it (PyTorch 2.11 does not).  A user annotation
    (a ``record_function`` range, also as the profiler maps it onto the
    device's rows) is never work."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    from torch.autograd import DeviceType
    name = ev.name()
    if ev.device_type() != DeviceType.CUDA:
        return "cpu_op"
    if getattr(ev, "is_user_annotation", lambda: False)():
        return "gpu_user_annotation"
    if name in SYNC_NAMES or name.endswith(" Sync"):
        return "cuda_sync"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _span(ev):
    start = ev.start_ns()
    return start, start + ev.duration_ns()


def collect(prof):
    """``(device, host, (lo, hi), kinds)`` from a finished profile: device
    work as ``(name, start, end)``, the host's CUDA calls as ``(start, end,
    name)``, the window's span, and the count of events of each kind."""
    device, host, kinds = [], [], {}
    lo = hi = None
    for ev in prof.profiler.kineto_results.events():
        kind = _kind(ev)
        kinds[kind] = kinds.get(kind, 0) + 1
        if kind in DEVICE_WORK:
            device.append((ev.name(), *_span(ev)))
        elif kind.startswith(HOST_PREFIXES) and kind != "cuda_sync":
            start, end = _span(ev)
            name = ev.name()
            host.append((start, end, name))
            if name.startswith(START) and (lo is None or start < lo):
                lo = start
            elif name == END and (hi is None or end > hi):
                hi = end
    if lo is None or hi is None or hi <= lo:
        raise RuntimeError(f"the trace has no {START} .. {END} window")
    return device, host, (lo, hi), kinds


def reduce(device, host, window, own: frozenset) -> dict:
    """Busy and window seconds, device seconds and launches of the
    program's own kernels and of the rest, and the breakdown: the device
    operations that took most time, and idle time by the CUDA call the host
    was in when it began ("(no host operation)": the host was between CUDA
    calls, in Python or PyTorch's dispatch)."""
    lo, hi = window
    spans, by_op, shorts = [], {}, {}
    own_ns = glue_ns = launches = 0
    for name, s, e in device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        spans.append((s, e))
        short = shorts.get(name)
        if short is None:
            short = shorts[name] = short_name(name)
        by_op[short] = by_op.get(short, 0.0) + (e - s) / 1e9
        if short in own:
            own_ns += e - s
            launches += 1
        else:
            glue_ns += e - s
    idle = timeline.gaps(spans, lo, hi)
    stacks = timeline.host_ops_at(
        idle, [h for h in host if h[1] > lo and h[0] < hi])
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": timeline.busy(spans) / 1e9,
        "own_s": own_ns / 1e9,
        "glue_s": glue_ns / 1e9,
        "own_launches": launches,
        "breakdown": {
            "device_ops": timeline.top(by_op),
            "idle_gaps": timeline.top(timeline.idle_by_host_op(idle, stacks)),
        },
    }

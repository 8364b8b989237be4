"""One cell's traced window put down to the program's spans, on this
machine's card:

    python3 portbench/split.py --workload <cell> --seed <n> --seconds <s>
        [--spans 0|1]

Set-up and the window are the ones of a ``--trace 1`` run of
``portbench/run.py`` (the same inputs, warm-up calls, profiler, sync debug
mode and CUDA events), with the program's spans recorded (``--spans 1``,
the default) or not.  The device's operations keep their correlation ids
and the runtime calls theirs and their threads, so each operation is put
down to the innermost span open at its launch, and each idle gap to the
span open when it began (``attribution.py``).  Prints one JSON object:
calls, idle share, the glue by span, the sweep's glue against the solver
API's, host milliseconds by span (self time), the read-back wait, the
single Schur update's roofline, and the checks that every launch of the
program's own kernels lies in its ``kernel.*`` span and that the
``panel.readback`` spans a call equal the synchronising calls the sync
debug mode saw.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent.parent


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    return p.parse_args(argv)


def collect(prof):
    """``(device, launches, (lo, hi))``: device work as ``(short name,
    start, end, correlation)``, ``{correlation: (start, thread)}`` of the
    host's CUDA calls, and the window as ``trace.collect`` takes it."""
    from portbench.kernels import short_name
    from portbench.trace import DEVICE_WORK, END, HOST_PREFIXES, START, _kind
    device, launches, lo, hi = [], {}, None, None
    for ev in prof.profiler.kineto_results.events():
        kind = _kind(ev)
        start = ev.start_ns()
        if kind in DEVICE_WORK:
            device.append((short_name(ev.name()), start,
                           start + ev.duration_ns(), ev.correlation_id()))
        elif kind.startswith(HOST_PREFIXES) and kind != "cuda_sync":
            launches[ev.correlation_id()] = (start, ev.start_thread_id())
            name = ev.name()
            if name.startswith(START) and (lo is None or start < lo):
                lo = start
            elif name == END and (hi is None or
                                  start + ev.duration_ns() > hi):
                hi = start + ev.duration_ns()
    return device, launches, (lo, hi)


def window(cell, seed: float, seconds: float, record: bool) -> dict:
    """The traced window of ``harness.run`` with the spans recorded or
    not; returns what ``summary`` reads."""
    import importlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness
    port = importlib.import_module("m4ri_tpu_torch")
    spans = importlib.import_module("m4ri_tpu_torch.utils.spans")
    spans.enable(None if record else False)
    inputs = cell.entry.make_inputs(cell.config, cell.traffic, seed,
                                    torch.device("cuda"))
    for i in range(harness.WARM_CALLS):
        cell.entry.call(port, inputs, i)
        torch.cuda.synchronize()
    spans.take()
    prof = profile(activities=[ProfilerActivity.CUDA])
    calls = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        prof.start()
        start = time.perf_counter()
        while True:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            torch.cuda.set_sync_debug_mode("warn")
            out = cell.entry.call(port, inputs, calls)
            torch.cuda.set_sync_debug_mode("default")
            ev[1].record()
            torch.cuda.synchronize()
            del out
            calls += 1
            if time.perf_counter() - start >= seconds:
                break
        prof.stop()
    syncs = sum(harness.SYNC_WARNING in str(w.message) for w in caught)
    device, launches, span_ns = collect(prof)
    recorded = spans.take()
    return {"calls": calls, "syncs": syncs, "device": device,
            "launches": launches, "window": span_ns, "spans": recorded,
            "self_ns": spans.self_ns(recorded)}


def summary(got: dict, own: frozenset) -> dict:
    from portbench import attribution, timeline
    from portbench.schur_peaks import span_least_s
    calls, sp = got["calls"], got["spans"]
    lo, hi = got["window"]
    split = attribution.attribute(got["device"], got["launches"], sp,
                                  got["window"], own, span_least_s)
    busy = timeline.busy(timeline.clip([(s, e) for _, s, e, _ in
                                        got["device"]], lo, hi))
    per = 1e3 / calls

    def per_call(pairs):
        return {name: sec * per for name, sec in pairs}

    out = {"calls": calls, "window_s": (hi - lo) / 1e9,
           "device_idle_share": 100.0 * (1 - busy / (hi - lo)),
           "glue_device_ms": split["glue_s"] * per,
           "sweep_glue_device_ms": split["sweep_glue_s"] * per,
           "solver_glue_device_ms": split["solver_glue_s"] * per,
           "own_launches_per_call": split["own_launches"] / calls,
           "own_launches_outside_kernel_spans":
               split["own_outside_kernel_spans"],
           "device_ops_without_launch": split["unmatched"],
           "synchronising_calls_per_call": got["syncs"] / calls,
           "spans_per_call": len(sp) / calls}
    if sp:
        out.update({
            "sweep_host_ms": attribution.host_ms(
                sp, "sweep", less="panel.readback") / calls,
            "readback_wait_ms": attribution.host_ms(
                sp, "panel.readback") / calls,
            "readback_spans_per_call":
                sum(s.name == "panel.readback" for s in sp) / calls})
        if split["schur_device_s"] > 0:
            out["schur_roofline"] = (100.0 * split["schur_least_s"]
                                     / split["schur_device_s"])
        out["host_self_ms_by_span"] = {
            k: v / 1e6 / calls for k, v in sorted(
                got["self_ns"].items(), key=lambda kv: -kv[1])}
    out["glue_device_ms_by_span"] = per_call(split["glue_by_span"])
    out["device_ms_by_span"] = per_call(split["device_by_span"])
    out["idle_ms_by_span"] = per_call(split["idle_by_span"])
    return out


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness, run
    run.environment()
    import torch
    if not torch.cuda.is_available():
        print("split.py needs a CUDA device", file=sys.stderr)
        return 2
    from portbench.kernels import own_kernel_names
    cell = harness.load_cell(harness.load_json(ROOT / "BENCHMARK.json"),
                             args.workload)
    got = window(cell, args.seed, args.seconds, bool(args.spans))
    out = {"workload": args.workload, "seed": args.seed,
           "spans": bool(args.spans),
           "device": torch.cuda.get_device_name(0),
           "power_limit": harness._power_limit()}
    out.update(summary(got, own_kernel_names(harness.CSRC)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one cell: set-up, the timed window, the check, the result.

Everything that belongs to one configuration, traffic mix or metric is
found by its name in ``BENCHMARK.json``:

- ``configs/<config>.json``: the deployment's sizes and guarantees;
- ``traffic/<mix>.json``: the entry a call drives (``entries/<entry>.py``)
  and its parameters (matrices a call, the pool of inputs, the calls kept
  for the check);
- ``metrics/<metric>.py``: ``read(rec)`` over the window's ``Records``,
  ``None`` where it finds nothing to read.  A metric named
  ``<metric>.<group>`` (the same quantity for a group of cells with a bound
  of its own) is read by ``metrics/<metric>.py`` unless it has a file of
  its own.

An entry module holds what is particular to one entry point of the
program: ``make_inputs(config, traffic, seed, device)``, ``call(port,
inputs, i)`` (the outputs of call i), ``control(port, inputs, i)`` (the
reference with one stated guarantee broken, in the program's place),
``judge(inputs, samples)`` (the checks, each ``(name, value, limit)``) and,
where a metric needs them, ``work(config, traffic)`` (static counts of one
call, such as its products).  A call brings ``traffic["batch"]`` matrices
(1 without it) to the requested form.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
import random
import subprocess
import sys
import time
import traceback
import warnings

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
CSRC = ROOT / "m4ri_tpu_torch" / "csrc"
# top-level module names that may not be loaded when a run ends: JAX and
# the JAX package, compared whole (the program's name begins with the
# JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "m4ri_tpu")
SYNC_WARNING = "called a synchronizing CUDA operation"
# calls in set-up: the first builds and loads the kernels and makes the
# program's lazy state, the second runs as the window's calls do
WARM_CALLS = 2


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    entry: object
    end_to_end: list
    per_layer: list


@dataclasses.dataclass
class Records:
    """What a window leaves for the metric readers."""
    setup_s: float
    window_s: float          # host clock, first call's start to last's end
    calls: int
    matrices: int
    call_ms: list            # each call, on the device's clock (CUDA events)
    peak_bytes: int          # torch.cuda.max_memory_allocated over the window
    work: dict               # the entry's static counts of one call
    trace: dict | None = None   # trace.reduce's result, traced runs only
    syncs: int | None = None    # synchronising calls, traced runs only


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(bench: dict, name: str, root: pathlib.Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")

    def reports(metric):
        return name in metric.get("workloads", [name])

    return Cell(name, w["chips"], load_json(root / cfg["file"]), traffic,
                entry, [m for m in bench["end_to_end"] if reports(m)],
                [m for m in bench["per_layer"] if reports(m)])


def reader(metric_name: str):
    """``metrics/<name>.py``'s ``read``; for ``<metric>.<group>`` without a
    file of its own, ``metrics/<metric>.py``'s."""
    path = HERE / "metrics" / f"{metric_name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric_name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric_name.replace('.', '_')}", path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def differing(got, want) -> int:
    """Entries of ``got`` unlike ``want``'s; all of them when the shapes
    differ."""
    import torch
    got = torch.as_tensor(got).to(want.device)
    if got.shape != want.shape:
        return int(want.numel())
    return int((got != want).sum())


def forbidden_modules(names) -> list:
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


class Sampler:
    """The calls whose outputs the check judges.  ``k`` moments are drawn
    from the seed, uniform over the window's first nine tenths, and moment j
    is given the pool's input ``j % pool`` (in an order drawn from the
    seed): it takes the first call that ends after it on that input, so
    that with ``k >= pool`` every input of the pool is judged once at least.
    Their outputs are copied to host buffers made in set-up, so the device
    holds no more than a user's loop would."""

    def __init__(self, k: int, pool: int, seed: int, seconds: float,
                 example):
        rng = random.Random(seed)
        moments = sorted(rng.random() * 0.9 * seconds for _ in range(k))
        inputs = [j % pool for j in range(k)]
        rng.shuffle(inputs)
        self.pool = pool
        self.pending = list(zip(moments, inputs))
        self.buffers = [[_host_buffer(x) for x in example] for _ in range(k)]
        self.samples = []

    def offer(self, i: int, ended_at: float, outputs) -> None:
        due = [p for p in self.pending
               if ended_at >= p[0] and i % self.pool == p[1]]
        if not due:
            return
        self.pending.remove(due[0])
        buf = self.buffers[len(self.samples)]
        kept = []
        for j, x in enumerate(outputs):
            if hasattr(x, "copy_") and buf[j] is not None \
                    and buf[j].shape == x.shape and buf[j].dtype == x.dtype:
                kept.append(buf[j].copy_(x))
            elif hasattr(x, "cpu"):
                kept.append(x.cpu())
            else:
                kept.append(x)
        self.samples.append((i, tuple(kept)))


def _host_buffer(x):
    if not hasattr(x, "is_cuda"):
        return None
    import torch
    out = torch.empty(x.shape, dtype=x.dtype, device="cpu")
    return out.pin_memory() if x.is_cuda else out


def _power_limit() -> str:
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return got.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run(cell: Cell, seed: int, seconds: float, traced: bool, t0: float,
        device: str = "cuda", call=None) -> dict:
    """One run.  Returns ``{"result": <the result line's object>,
    "checks": [(name, value, limit)], "error": str | None}``.  ``call``,
    with the signature of the entry's, replaces it (the control, or a
    fault in the tests)."""
    import torch
    port = importlib.import_module("m4ri_tpu_torch")
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    entry, config, traffic = cell.entry, cell.config, cell.traffic
    fn = call or entry.call

    def do(i):
        return fn(port, inputs, i)

    # ---- set-up: inputs from the seed, the cell's own shapes warmed up
    marks = [("imports", time.perf_counter())]
    inputs = entry.make_inputs(config, traffic, seed, torch.device(device))
    sync()
    marks.append(("inputs", time.perf_counter()))
    out = None
    for i in range(WARM_CALLS):
        out = do(i)
        sync()
        marks.append((f"warm call {i}", time.perf_counter()))
    sampler = Sampler(traffic["sample"], traffic.get("pool", 1), seed, seconds,
                      out)
    del out
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    setup_s = time.perf_counter() - t0

    # ---- the window: a closed loop of one client
    prof = None
    if traced and on_card:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
    events, error, i = [], None, 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if prof is not None:
            prof.start()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        while True:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
                if on_card else None
            try:
                if ev:
                    ev[0].record()
                if prof is not None:
                    torch.cuda.set_sync_debug_mode("warn")
                    out = do(i)
                    torch.cuda.set_sync_debug_mode("default")
                else:
                    out = do(i)
                if ev:
                    ev[1].record()
                sync()
            except Exception:  # the program failed: no answer for this call
                error = traceback.format_exc()
                break
            ended = time.perf_counter() - start
            events.append(ev)
            sampler.offer(i, ended, out)
            del out
            i += 1
            if ended >= seconds:
                break
        window_s = time.perf_counter() - start
        if prof is not None:
            if torch.cuda.get_sync_debug_mode():
                torch.cuda.set_sync_debug_mode("default")
            prof.stop()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
    calls = len(events)
    rec = Records(
        setup_s=setup_s, window_s=window_s, calls=calls,
        matrices=calls * traffic.get("batch", 1),
        call_ms=[a.elapsed_time(b) for a, b in events] if on_card else [],
        peak_bytes=peak,
        work=entry.work(config, traffic) if hasattr(entry, "work") else {},
        syncs=syncs if prof is not None else None)

    # ---- the check, once the window has closed and its state is freed
    sync()
    if on_card:
        torch.cuda.empty_cache()
    judged = time.perf_counter()
    checks = entry.judge(inputs, sampler.samples) if sampler.samples else []
    judge_s = time.perf_counter() - judged
    correct = (error is None and bool(checks)
               and all(v <= lim for _, v, lim in checks))
    judged_calls = [i for i, _ in sampler.samples]
    del inputs, sampler

    result = {"correct": correct, "attempted": calls + (error is not None),
              "failed": int(error is not None)}
    reduce_s = 0.0
    if prof is not None:
        from .kernels import own_kernel_names
        from .trace import collect, reduce
        reduced = time.perf_counter()
        device_ops, host_ops, span_ns, kinds = collect(prof)
        rec.trace = reduce(device_ops, host_ops, span_ns,
                           own_kernel_names(CSRC))
        rec.trace["kinds"] = kinds
        reduce_s = time.perf_counter() - reduced
        del prof
    specs = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    if calls:
        for spec in specs:
            value = reader(spec["name"])(rec)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    result["metrics"] = metrics
    result["device"] = _device(cell, max(peak, setup_peak), rec, on_card)
    if rec.trace is not None:
        result["breakdown"] = rec.trace["breakdown"]
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    steps = ", ".join(f"{name} {t - t_prev:.3f}" for (name, t), t_prev in
                      zip(marks, [t0] + [t for _, t in marks]))
    notes = (f"set-up s: {steps}; {calls} calls in {window_s:.3f} s; calls "
             f"{judged_calls} judged in {judge_s:.3f} s")
    if rec.trace is not None:
        notes += (f"; trace read in {reduce_s:.3f} s, events by kind "
                  f"{rec.trace['kinds']}")
    return {"result": result, "checks": checks, "error": error,
            "notes": notes}


def _device(cell: Cell, peak: int, rec: Records, on_card: bool) -> dict:
    import torch
    out = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if on_card:
        out["power_limit"] = _power_limit()
    if rec.trace is not None:
        out["busy_s"] = rec.trace["busy_s"]
        out["window_s"] = rec.trace["window_s"]
    return out


def main(args, t0: float) -> int:
    import torch
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = load_cell(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); {have} "
              "available", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = run(cell, args.seed, args.seconds, bool(args.trace), t0)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    if out["error"]:
        print(out["error"], file=sys.stderr)
    print(out["notes"], file=sys.stderr)
    for name, value, limit in out["checks"]:
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    if not out["checks"]:
        print("check: no output was judged", file=sys.stderr)
    print(json.dumps(out["result"]))
    return 0

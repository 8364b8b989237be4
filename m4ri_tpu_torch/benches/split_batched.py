"""Where the time of the batched path goes on the card, by kernel.

For each case this script traces the work with ``torch.profiler`` (device
activity only) and prints the device time of each hand-written kernel by
name (``schur_transpose_kernel``, ``schur_kernel``, ``post_pack_kernel``,
``post_kernel``, ``panel_kernel`` and whatever else the port's CUDA sources
launch), PyTorch's own kernels summed as the glue, the wall time of the
same work untraced (median of a few runs, each ended by a synchronize) and
the share of that wall time in which the card ran nothing.  For a single
wrapper call it also prints the host time of a call (``perf_counter`` over
calls made back to back without a synchronize), the host time of each
PyTorch operator in it, and its CUDA-event time (the idle share is then
taken against the event time).

Cases:

- ``schur_batched_first_panel``, ``post_batched_first_panel``: one call of
  ``gf2_schur_update_batched_hopper`` (the trailing update) and of
  ``panel_post_hopper_batched`` on the operands the batched sweep gives them
  on the first panel of 256 random 768 x 3488 matrices (Classic McEliece
  mceliece348864's parity-check shape, ``chip_smoke.py``'s batch);
- ``post_batched_nothing_in_range``: ``panel_post_hopper_batched`` on that
  sweep's second panel, where no element has a row below its window;
- ``loop_batched_first_panel``, ``loop_batched_third_panel``: one call of
  ``panel_loop_hopper_batched`` (the pivot loop, 5b) on that sweep's first
  panel (256 windows of 576 rows, nb = 512) and on its third, where every
  element's rank has reached m and no row is in range;
- ``loop_batched_top_sw42``: 5b on the first panel of ``top_echelonize``'s
  sweep of the same batch brought to REF (a search window of 42 rows);
- ``loop_batched_isd_first_panel``: 5b on the first panel of
  ``solve_left_batched``'s sweep of 1024 random 768 x 768 matrices (one
  Prange guess an element, L preserved);
- ``loop_batched_nist``: 5b on the one panel of 2^20 random 32 x 32
  matrices (h = nb = 32);
- ``rank_batched_nist``: ``rank_batched`` of 2^20 random 32 x 32 matrices
  (NIST SP 800-22's binary matrix rank test);
- ``ple_batched_mceliece``: ``ple_batched`` of the 256 McEliece matrices.

The first line printed names the card and gives ``ptxas``'s registers,
spills and shared memory for each kernel of ``gf2_panel_hopper.cu``.

Needs the card and ``nvcc``:

    python -m m4ri_tpu_torch.benches.split_batched
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import time

import torch

from ..models import batched as batched_mod

MCELIECE = (256, 768, 3488)
NIST = (1 << 20, 32)
ISD = (1024, 768)               # Prange: the information set H_I, n - k = 768
# call of each wrapper that belongs to panel t: one pivot loop, one post and
# one commit a panel; two Schur calls a panel (the U rows, then the trailing
# update)
_CALLS_A_PANEL = {"panel_loop_hopper_batched": (1, 0),
                  "panel_post_hopper_batched": (1, 0),
                  "panel_commit_hopper_batched": (1, 0),
                  "gf2_schur_update_batched_hopper": (2, 1)}


def stack(seed: int, B: int, rows: int, cols: int) -> torch.Tensor:
    """B packed rows x cols matrices made on the card from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = (cols + 31) // 32
    x = torch.randint(-2**31, 2**31, (B, rows, w), dtype=torch.int32,
                      device="cuda", generator=g)
    if cols % 32:
        x[:, :, -1] &= (1 << (cols % 32)) - 1
    return x


def capture_panel(data, ncols: int, pres: bool, panel: int = 0,
                  need=tuple(_CALLS_A_PANEL), **kw) -> dict:
    """The arguments the batched sweep hands each batched kernel's wrapper
    named in ``need`` on panel ``panel`` (the trailing update's, for the
    Schur kernel), cloned as they are handed over; ``kw`` goes to
    ``block_factor_batched``.  Those wrappers are replaced by recorders in
    ``models/batched.py`` for one sweep.  Raises if the sweep did not reach
    each of them on that panel (a sweep of one panel has no trailing
    update)."""
    seen = {}
    real = {name: getattr(batched_mod, name) for name in need}

    def recorder(name):
        per, off = _CALLS_A_PANEL[name]
        want = per * panel + off

        def rec(*args):
            n = seen.setdefault(name, [0, None])
            if n[0] == want:
                n[1] = [a.clone() if isinstance(a, torch.Tensor) else a
                        for a in args]
            n[0] += 1
            return real[name](*args)
        return rec

    for name in real:
        setattr(batched_mod, name, recorder(name))
    try:
        batched_mod.block_factor_batched(data, ncols, pres, **kw)
        if data.is_cuda:
            torch.cuda.synchronize()
    finally:
        for name, fn in real.items():
            setattr(batched_mod, name, fn)
    missing = [n for n in need if seen.get(n, [0, None])[1] is None]
    if missing:
        raise RuntimeError(f"panel {panel} did not reach {missing}")
    return {n: v[1] for n, v in seen.items() if v[1] is not None}


def kernel_name(key: str) -> str | None:
    """The short name of one of the port's kernels (namespace gf2), else
    None (a PyTorch kernel, a copy or a memset)."""
    if "gf2::" not in key:
        return None
    head = key.split("(")[0].split("<")[0]
    return re.split(r"::", head)[-1].split()[-1]


def trace(fn, calls: int = 1) -> dict:
    """Device ms a call by kernel (the glue summed), from one trace of
    ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by, total = {}, 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if not us:
            continue
        name = kernel_name(ev.key) or "glue (PyTorch kernels, copies, memsets)"
        by[name] = by.get(name, 0.0) + us / 1e3 / calls
        total += us / 1e3 / calls
    return {"device_ms_by_kernel": by, "device_ms": total}


def host_ops(fn, calls: int = 10) -> dict:
    """Host ms a call of each PyTorch operator the call runs (self time, the
    operators ranked), from a trace of the host side alone; what the call
    spends outside them (Python, the one call into the kernel library) is
    its host time less their sum."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            fn()
    ops = {ev.key: ev.self_cpu_time_total / 1e3 / calls
           for ev in prof.key_averages() if ev.self_cpu_time_total}
    torch.cuda.synchronize()
    return dict(sorted(ops.items(), key=lambda kv: -kv[1])[:12])


def wall_ms(fn, runs: int) -> list:
    ts = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return ts


def event_ms(fn, runs: int = 11) -> list:
    ts = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    return ts


def host_ms(fn, calls: int = 20) -> float:
    """perf_counter a call over ``calls`` calls without a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    took = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return took


def split(fn, runs: int, wrapper: bool) -> dict:
    """The case's split: wall time untraced, the trace, the idle share; for
    a wrapper call also its host and event times."""
    for _ in range(2):
        fn()
    walls = wall_ms(fn, runs)
    out = {"wall_ms": statistics.median(walls), "wall_ms_min": min(walls),
           "wall_ms_max": max(walls), "runs": runs}
    calls = 10 if wrapper else 1
    out.update(trace(fn, calls))
    if wrapper:
        ev = event_ms(fn)
        out.update(event_ms=statistics.median(ev), event_ms_min=min(ev),
                   event_ms_max=max(ev), host_ms=host_ms(fn),
                   host_ms_by_operator=host_ops(fn))
        busy_against = out["event_ms"]
    else:
        busy_against = out["wall_ms"]
    out["idle_share"] = max(0.0, 1 - out["device_ms"] / busy_against)
    return out


def loop_operands(data: torch.Tensor, seed: int) -> dict:
    """5b's operands beyond the McEliece first panel: that sweep's third
    panel (nothing in range), top_echelonize's first panel (search window
    42), the first panel of solve_left_batched's sweep of 1024 768^2
    matrices, and the one panel of 2^20 NIST 32^2 matrices."""
    from .. import echelonize_batched
    from ..utils.graycode import opt_k
    _, m, n = MCELIECE
    only = ("panel_loop_hopper_batched",)
    pick = (lambda got: got["panel_loop_hopper_batched"])
    ref = echelonize_batched(data, n, full=False)[0]
    sw = 6 * min(opt_k(m, n), 7)
    out = {"third_panel": pick(capture_panel(data, n, False, panel=2,
                                             need=only)),
           f"top_sw{sw}": pick(capture_panel(ref, n, False, need=only,
                                             search_window=sw))}
    del ref
    isd = stack(seed + 10, ISD[0], ISD[1], ISD[1])
    out["isd_first_panel"] = pick(capture_panel(isd, ISD[1], True, need=only))
    del isd
    Bn, nn = NIST
    nist = stack(seed + 1, Bn, nn, nn)
    out["nist"] = pick(capture_panel(nist, nn, False, need=only))
    return out


def loop_cases(data: torch.Tensor, seed: int):
    from ..ops import hopper_panel
    for label, ops in loop_operands(data, seed).items():
        yield (f"loop_batched_{label}",
               lambda ops=ops: hopper_panel.panel_loop_hopper_batched(*ops),
               11, True)


def ptxas_usage() -> dict:
    """Registers, spills and shared memory of each kernel of the pivot
    loop's source, as ``ptxas -v`` prints them when the source is built
    (empty if it was built already)."""
    from ..ops import _build
    log = _build.build(["gf2_panel_hopper"]).get("gf2_panel_hopper", "")
    keep = ("entry function", "spill", "Used")
    return {"gf2_panel_hopper": [ln.strip() for ln in log.splitlines()
                                 if any(k in ln for k in keep)]}


def cases(seed: int):
    """(name, function, runs, wrapper call or not)."""
    from ..ops import hopper_panel, hopper_post, hopper_schur
    B, m, n = MCELIECE
    data = stack(seed, B, m, n)
    first = capture_panel(data, n, False)
    c, lp, up, r0s, c0w = first["gf2_schur_update_batched_hopper"]
    yield ("schur_batched_first_panel",
           lambda: hopper_schur.gf2_schur_update_batched_hopper(
               c, lp, up, r0s, c0w), 11, True)
    ops = first["panel_post_hopper_batched"]
    yield ("post_batched_first_panel",
           lambda: hopper_post.panel_post_hopper_batched(*ops), 11, True)
    loop = first["panel_loop_hopper_batched"]
    yield ("loop_batched_first_panel",
           lambda: hopper_panel.panel_loop_hopper_batched(*loop), 11, True)
    del first, c, lp, up, ops, loop
    second = capture_panel(data, n, False, panel=1)["panel_post_hopper_batched"]
    yield ("post_batched_nothing_in_range",
           lambda: hopper_post.panel_post_hopper_batched(*second), 11, True)
    del second
    for name, fn, runs, wrapper in loop_cases(data, seed):
        yield name, fn, runs, wrapper
    from .. import ple_batched, rank_batched
    yield "ple_batched_mceliece", lambda: ple_batched(data, n), 3, False
    del data
    Bn, nn = NIST
    nist = stack(seed + 1, Bn, nn, nn)
    yield "rank_batched_nist", lambda: rank_batched(nist, nn), 3, False


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=900)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("split_batched: needs the card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "ptxas": ptxas_usage()}), flush=True)
    for name, fn, runs, wrapper in cases(args.seed):
        print(json.dumps({"case": name, **split(fn, runs, wrapper)}),
              flush=True)


if __name__ == "__main__":
    main()

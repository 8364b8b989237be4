"""Host time against device time of the two GF(2) GEMM wrappers.

A wrapper call is host work (Python, the checks, one ctypes call that
launches the GEMM kernel, whose first phase writes B^T, and where needed a
copy of A) followed by device work on one stream.  CUDA events around a call see the
two mixed.  For each wrapper and shape the main paths use this script
prints:

- ``host_us``: ``perf_counter`` over ``calls`` calls made back to back with
  no synchronisation, after warm-up: what a call costs the host;
- ``device_us``: the device time a call of each kernel by name, from a
  ``torch.profiler`` trace of the same calls;
- ``event_us``: CUDA events around one call on an idle card (median), as
  ``chip_smoke.py`` times a call;
- ``host_us_launch_gemm`` and ``host_us_c_call``: the same host clock over
  the wrapper's launch path without the checks, and over the one call of the
  C library alone (which launches the kernels); ``host_us_one_launch``: a
  PyTorch call that launches one kernel (``zero_`` of a small tensor), for
  scale.

Shapes: 4096³ (``mul`` at n=4096), 8192×512×8192, the PLE panel's U rows
at n=16384 (512×512×16384) and n=32768 (1024×1024×32768), and the 8192³
quadrant views Strassen gives its base case at n=16384.  Needs the card and
``nvcc``:

    python -m m4ri_tpu_torch.benches.split_launch
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch

from ..ops import hopper_mul
from ..ops.hopper_mul import gf2_mul_hopper
from ..ops.hopper_mul2 import gf2_mul_hopper_v2

WRAPPERS = {"gf2_mul_hopper": gf2_mul_hopper,
            "gf2_mul_hopper_v2": gf2_mul_hopper_v2}
SHAPES = [("4096^3", (4096, 4096, 4096)), ("8192x512x8192", (8192, 512, 8192)),
          ("u_rows_16384", (512, 512, 16384)), ("u_rows_32768", (1024, 1024, 32768)),
          ("8192_quadrant_views", (8192, 8192, 8192))]


def operands(name: str, m: int, k: int, n: int):
    """(a, b, out) on the card; the quadrant case cuts views of 2x parents."""
    g = torch.Generator(device="cuda").manual_seed(17)
    lo, hi = -2**31, 2**31

    def words(rows, cols):
        return torch.randint(lo, hi, (rows, cols // 32), dtype=torch.int32,
                             device="cuda", generator=g)
    if name == "8192_quadrant_views":
        pa, pb = words(2 * m, 2 * k), words(2 * k, 2 * n)
        a, b = pa[:m, k // 32:], pb[k:, :n // 32]
    else:
        a, b = words(m, k), words(k, n)
    return a, b, torch.empty((m, n // 32), dtype=torch.int32, device="cuda")


def host_us(call, calls: int = 50) -> float:
    """perf_counter a call over ``calls`` calls without a sync, warm."""
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    took = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return took


def host_parts(fn, a, b, out, calls: int = 50) -> dict:
    """The host time of a call, of its launch path, of the C call alone."""
    split_ok = fn is gf2_mul_hopper_v2
    shape = hopper_mul.check_operands(a, b, out)
    m, kw, k, nw = shape
    device = a.get_device()
    stream = torch._C._cuda_getCurrentRawStream(device)
    splits, chunk, grid = hopper_mul.gemm_plan(
        m, nw, kw, hopper_mul._sms(device), split_ok)
    hopper_mul.launch_gemm(a, b, out, shape, False, split_ok)
    scratch = hopper_mul._SCRATCH[device, stream]
    lda = a.stride(0)
    copy_a = (a.data_ptr() | lda << 2) & 15 != 0
    args = (a.data_ptr(), lda, b.data_ptr(), b.stride(0), scratch.data_ptr(),
            copy_a, out.data_ptr(), out.stride(0), m, kw, k, nw, False,
            splits, chunk, grid, stream)
    c_call = hopper_mul._fn()
    small = torch.empty(16, dtype=torch.int32, device="cuda")
    return {"host_us": host_us(lambda: fn(a, b, out=out), calls),
            "host_us_launch_gemm": host_us(lambda: hopper_mul.launch_gemm(
                a, b, out, shape, False, split_ok), calls),
            "host_us_c_call": host_us(lambda: c_call(*args), calls),
            "host_us_one_launch": host_us(small.zero_, calls)}


def split(fn, a, b, out, calls: int = 50) -> dict:
    parts = host_parts(fn, a, b, out, calls)
    events = []
    for _ in range(11):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(a, b, out=out)
        e1.record()
        e1.synchronize()
        events.append(e0.elapsed_time(e1) * 1e3)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(a, b, out=out)
        torch.cuda.synchronize()
    device = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us:
            device[ev.key] = us / calls
    return {**parts, "event_us": statistics.median(events),
            "device_us": device, "device_us_total": sum(device.values())}


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    rows = []
    for label, (m, k, n) in SHAPES:
        a, b, out = operands(label, m, k, n)
        for name, fn in WRAPPERS.items():
            rows.append({"wrapper": name, "shape": label, "mkn": [m, k, n],
                         **split(fn, a, b, out)})
        del a, b, out
    print(json.dumps({"card": card, "split": rows}))


if __name__ == "__main__":
    main()

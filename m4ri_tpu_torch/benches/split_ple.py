"""Where the time of one PLE factorization goes on the card.

Traces ``block_factor`` and then the L compression of ``ple`` with
``torch.profiler`` and prints, for each, the wall time, the device time by
kernel (the four hand-written kernels by name, PyTorch's own kernels summed
under what they serve), and the share of the wall time in which the card ran
nothing.  Beside the Schur update's device time: the sum of its bounds over
the sweep's calls, each on the exact rectangle the call leaves active
(``peaks.schur_bound``).  Needs the card and ``nvcc``:

    python -m m4ri_tpu_torch.benches.split_ple [n]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..core.bitmatrix import randomize
from ..models import ple as ple_mod
from .peaks import schur_bound

SCHUR = "Schur update (schur_transpose_kernel, schur_kernel)"
# device kernels by substring of their name -> the stage they belong to
STAGES = [("panel_kernel", "panel loop (panel_kernel)"),
          ("post_pack_kernel", "panel post (post_pack_kernel, post_kernel)"),
          ("post_kernel", "panel post (post_pack_kernel, post_kernel)"),
          ("schur_transpose_kernel", SCHUR), ("schur_kernel", SCHUR),
          ("gf2_gemm_kernel", "U rows (gf2_gemm_kernel, with its B^T pre-pass)"),
          ("gemm", "small float32 products (torch.matmul)"),
          ("Memcpy", "copies"), ("Memset", "memsets")]


def _trace(fn):
    """(result, wall ms, {stage: device ms}, device ms in all)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # device activity only: with the CPU side traced as well, an operator and
    # its kernel would both be listed and PyTorch's kernels counted twice
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    stages, total = {}, 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if not us:
            continue
        name = next((label for key, label in STAGES if key in ev.key),
                    "other PyTorch kernels (unpack, pack, masks, gathers)")
        stages[name] = stages.get(name, 0.0) + us / 1e3
        total += us / 1e3
    return out, wall, stages, total


def _schur_sweep_bound(A) -> tuple[float, int]:
    """(sum of the Schur bounds over one block_factor's calls, calls): the
    wrappers are wrapped for one untraced run to record their bounds."""
    calls = []
    names = ("gf2_schur_update_hopper", "gf2_schur_update_dyn_hopper")
    saved = {name: getattr(ple_mod, name) for name in names}

    def recorder(fn):
        def call(c, lp, up, r0, c0w, **kw):
            calls.append((c.shape[0], up.shape[0], c.shape[1], r0, c0w))
            return fn(c, lp, up, r0, c0w, **kw)
        return call

    for name in names:
        setattr(ple_mod, name, recorder(saved[name]))
    try:
        ple_mod.block_factor(A, preserve_l=True)
    finally:
        for name in names:
            setattr(ple_mod, name, saved[name])
    return sum(schur_bound(*call)["bound_ms"] for call in calls), len(calls)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=16384)
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    A = randomize(args.n, args.n, g)
    ple_mod.ple(A)                                   # build and warm up
    # the profiler slows the host down, so the wall time that the idle share
    # is taken against comes from untraced runs
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ple_mod.block_factor(A, preserve_l=True)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_untraced = sorted(walls)[1]
    bound_ms, schur_calls = _schur_sweep_bound(A)
    syncs = ple_mod.block_factor.host_syncs
    (data, p, q, r), wall_f, stages_f, dev_f = _trace(
        lambda: ple_mod.block_factor(A, preserve_l=True))
    syncs = ple_mod.block_factor.host_syncs - syncs
    _, wall_c, stages_c, dev_c = _trace(
        lambda: ple_mod._compress_l_impl(data, q, r, args.n, args.n))
    print(json.dumps({
        "card": card, "n": args.n, "rank": r, "host_syncs": syncs,
        "block_factor": {"wall_ms_untraced": wall_untraced,
                         "wall_ms_traced": wall_f, "device_ms": dev_f,
                         "idle_share": 1 - dev_f / wall_untraced,
                         "device_ms_by_stage": stages_f,
                         "schur_device_ms": stages_f.get(SCHUR, 0.0),
                         "schur_sweep_bound_ms": bound_ms,
                         "schur_calls": schur_calls},
        "compress_l": {"wall_ms": wall_c, "device_ms": dev_c,
                       "idle_share": 1 - dev_c / wall_c,
                       "device_ms_by_stage": stages_c}}))


if __name__ == "__main__":
    main()

"""Where the time of one ``solve_left`` goes on the card.

Runs the stages of ``models/solve.py::solve_left`` one call at a time, in
its order, each under ``torch.profiler``, and prints for each its wall time
and its device time by kernel (the hand-written kernels by name, the float32
products of ``torch.matmul``, PyTorch's other kernels); then the whole
``solve_left`` call traced the same way, with the share of its untraced wall
time in which the card ran nothing.  The stages' result is held equal to
``solve_left``'s.  Needs the card and ``nvcc``:

    python -m m4ri_tpu_torch.benches.split_solve [n] [--bcols 256]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..core.bitmatrix import BitMatrix, mask_padding, randomize, width_for
from ..core.permutation import apply_p_left
from ..models import solve as solve_mod
from ..models.echelon import select_pivot_cols
from ..models.ple import block_factor
from ..models.triangular import trsm_lower_left, trsm_upper_left

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


def _stages(a: BitMatrix, b: BitMatrix):
    """solve_left's stages as (name, thunk) in its order; each thunk leaves
    its result in ``st`` for the next."""
    m, n = a.nrows, a.ncols
    rmax = min(m, n)
    st = {}

    def factor():
        st["data"], st["p"], st["q"], st["r"] = block_factor(a, preserve_l=True)

    def select():
        data, q, r = st["data"], st["q"], st["r"]
        sel = select_pivot_cols(data, q, r, m, n, rmax)
        st["l"] = solve_mod._packed_l(data, q, r, m, rmax, n, True, lcols=sel)
        st["u"] = solve_mod._packed_upiv(data[:rmax], q, r, rmax, n, True,
                                         upiv=sel[:rmax])

    def permute():
        st["bp"] = apply_p_left(b, st["p"])

    def lower():
        st["y"] = trsm_lower_left(st["l"], st["bp"])
        st["ok"] = torch.all(st["y"].data[st["r"]:] == 0)

    def upper():
        ydata = st["y"].data[:rmax].clone()
        ydata[st["r"]:] = 0
        st["z"] = trsm_upper_left(st["u"], BitMatrix(ydata, b.ncols))

    def scatter():
        x = torch.zeros((n, width_for(b.ncols)), dtype=torch.int32,
                        device=a.device)
        x[st["q"][: st["r"]].long()] = st["z"].data[: st["r"]]
        st["x"] = mask_padding(BitMatrix(x, b.ncols))

    return st, [("factorization (block_factor, preserve_l)", factor),
                ("L / U_piv selection (select_pivot_cols, masks)", select),
                ("P applied to B (apply_p_left)", permute),
                ("TRSM lower (trsm_lower_left, L m x m, B m x bcols)", lower),
                ("TRSM upper (trsm_upper_left, U_piv rmax x rmax)", upper),
                ("scatter to the pivot rows", scatter)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=32768)
    ap.add_argument("--bcols", type=int, default=256)
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    A = randomize(args.n, args.n, g)
    B = randomize(args.n, args.bcols, g)
    x_ref, ok_ref = solve_mod.solve_left(A, B)          # build and warm up
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve_mod.solve_left(A, B)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_untraced = sorted(walls)[1]
    st, stages = _stages(A, B)
    split = {}
    for name, thunk in stages:
        _, wall, by_kernel, dev = _trace(thunk)
        split[name] = {"wall_ms_traced": wall, "device_ms": dev,
                       "device_ms_by_kernel": by_kernel}
    same = bool(torch.equal(st["x"].data, x_ref.data)) and \
        bool(st["ok"]) == bool(ok_ref)
    _, wall_t, by_kernel, dev = _trace(lambda: solve_mod.solve_left(A, B))
    print(json.dumps({
        "card": card, "n": args.n, "bcols": args.bcols, "rank": st["r"],
        "consistent": bool(ok_ref), "stages_equal_solve_left": same,
        "solve_left": {"wall_ms_untraced": wall_untraced,
                       "wall_ms_untraced_runs": walls,
                       "wall_ms_traced": wall_t, "device_ms": dev,
                       "idle_share": 1 - dev / wall_untraced,
                       "device_ms_by_kernel": by_kernel},
        "stages": split}))
    if not same:
        raise SystemExit("the stages differ from solve_left")


if __name__ == "__main__":
    main()

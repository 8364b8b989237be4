#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's multiply, factorization and solver paths
once on the GPU.

    python3 chip_smoke.py [--seed N]

Needs one NVIDIA GPU (built for an H100, sm_90a) and ``nvcc``; imports torch
and numpy only.  It builds the CUDA kernels from ``m4ri_tpu_torch/csrc``,
holds each of the six against its plain PyTorch version on the card
(equality of packed words and index arrays: GF(2) is exact, the tolerance is
0), then drives the public entry points: ``mul`` / ``addmul`` / squaring at
n=4096 (the size the JAX package's bench times) and n=16384 (the direct
product by the card's default, and one Strassen level with the cutoff forced); ``ple`` / ``rank`` / ``block_factor`` at n=16384 and n=32768 (the
wide panel), on inputs whose windows go deficient, and on the reference C
library's golden vectors, each held to the plain engine on the card; then
the solver API at the JAX package's driver sizes: ``pluq`` 32768^2, the four
TRSMs at 32768^2, RREF 16384^2 by both strategies, ``invert`` 16384^2,
``solve_left`` 32768^2 with 256 right-hand sides, ``kernel_left`` 4096^2 and
the golden ``pluq`` / ``rref`` vectors, each held to a check that does not
go through the code under test (the plain engine, a sequential oracle, a
float32 product of the unpacked bits, or the C library's hash); then the
M4RI user surface: ``mul_m4rm`` at 4096^3 and 16384^3, ``djb_apply`` of a
512^2 map to 65,536 vectors, npz / PNG / JCF round trips of 16384^2
matrices through the card, the native C++ oracle at 2048, the reference
C API program of tests/test_compat.py at 8192^2 plus every compat name that
returns a matrix at 1024 (card against host), and ``mul`` at 65536^2 held by
Freivalds' check; then the multi-device layer (``parallel/``) twice: on an
NCCL group of one rank in this process, at the sizes of VERIFY_r05.json,
and on a gloo group of 4 processes sharing the card (the cross-rank logic:
2x2, 4x1 and 2-hosts-by-2 meshes, the miss branch), every output word for
word the single-device entry point's; then the batched path
(``models/batched.py``): ``rank_batched`` of 2^20 random 32 x 32 matrices
(the NIST SP 800-22 binary matrix rank test) against a numpy elimination,
``block_factor_batched`` of 256 McEliece-shaped 768 x 3488 matrices and of
16 4096^2 ones with zeroed bands (the miss fallback) against the
single-matrix ``block_factor``, and ``mul_packed_batched`` of 1024 products
512^2 x 512^2 against ``mul_packed_data`` and Freivalds' check; its three
batched kernels are held to their batched plain versions on the McEliece
batch's first panel, the trailing update also with r0 spread over the row
tiles, the below-window elimination also with rows in range for some
elements only and for none (the sweep's second panel, 2^16 NIST panels),
the pivot loop also on the sweep's third panel (no row in range), on 1024
ISD windows and on 2^20 NIST windows (a warp a window);
then the batched solver API at the widths of Classic
McEliece mceliece348864: ``ple_batched`` / ``pluq_batched``, both RREF
strategies and ``kernel_left_batched`` of the 256 McEliece matrices,
``solve_left_batched`` and ``pluq_solve_left_batched`` of 1024 768^2 systems
with one syndrome each (one Prange guess an element), ``invert_batched`` of
those 1024 and the TRTRIs and TRSMs of 256 unit triangular 768^2, every
element equal to the single-matrix call and 8 held to the host's
Gauss-Jordan elimination or a float32 product; then the last of the JAX
package's ``jax.vmap`` surface: ``top_echelonize_batched`` of the 256
McEliece matrices brought to REF (the restricted search, windows 42 and 6)
against their RREF, and of 16 off the contract, and the naive Gauss
engines over a batch (``invert_naive_batched`` of the 1024 768^2,
``echelonize_naive_batched`` and ``gauss_delayed_batched`` of the 256
McEliece matrices) against the batched entry points and the single calls,
none of them reading anything back; the pivot loop and the elimination
below the window are held to their batched plain versions once more on the
restricted search's first panel.  The launch counters show that
the kernels ran, on the distributed and batched paths too.  One JSON object per phase; the
``kernels`` line, the card's name and power limit, and last of all
``{"ok": true, "device": {...}}``.  Any mismatch, build failure or launch
error ends the run with a non-zero exit code and without that last line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: torch.cuda.is_available() is false; "
             "this script runs on the GPU only")

import m4ri_tpu_torch as m4
from m4ri_tpu_torch.benches.peaks import (PEAK_ALU32_OPS_PER_S,
                                          PEAK_B1_OPS_PER_S, PEAK_BYTES_PER_S,
                                          PEAK_SMEM_WORDS_PER_S, schur_bound)
from m4ri_tpu_torch.benches.probe_mma import probe as probe_mma
from m4ri_tpu_torch.benches.split_batched import capture_panel
from m4ri_tpu_torch.benches.split_batched import trace as device_trace
from m4ri_tpu_torch.core import permutation as perm_mod
from m4ri_tpu_torch.core.bitmatrix import BitMatrix, mask_padding
from m4ri_tpu_torch.models import ple as ple_mod
from m4ri_tpu_torch.ops import (_build, hopper_commit, hopper_operands,
                                hopper_panel, hopper_post, hopper_schur,
                                hopper_trinv)
from m4ri_tpu_torch.ops.hopper_mul import gf2_mul_hopper, gf2_mul_plain
from m4ri_tpu_torch.ops.hopper_mul2 import gf2_mul_hopper_v2
from m4ri_tpu_torch.ops.hopper_panel import panel_loop_hopper, panel_loop_plain
from m4ri_tpu_torch.ops.hopper_post import panel_post_hopper, panel_post_plain
from m4ri_tpu_torch.ops.mul import mul_packed_data
from m4ri_tpu_torch.parallel import dist_solve
from m4ri_tpu_torch.parallel import mesh as mesh_mod
from m4ri_tpu_torch.parallel._spawn import launch
from m4ri_tpu_torch.parallel.dist_echelon import dist_echelonize, dist_rank
from m4ri_tpu_torch.parallel.dist_mul import mul_dist, mul_dist_ksplit
from m4ri_tpu_torch.parallel.dist_ple import dist_ple
from m4ri_tpu_torch.ops.hopper_schur import (TILE_ROWS, TILE_WORDS,
                                             gf2_schur_update_dyn_hopper,
                                             gf2_schur_update_hopper,
                                             gf2_schur_update_plain)
from m4ri_tpu_torch.utils import config as config_mod
from m4ri_tpu_torch.utils.config import get_config
from m4ri_tpu_torch.utils.graycode import opt_k
from m4ri_tpu_torch.utils import spans
from m4ri_tpu_torch.utils.rng import GlibcRandom, reference_random_data

HERE = pathlib.Path(__file__).resolve().parent
DEV = torch.device("cuda")

KERNELS = {
    "gf2_mul_hopper": dict(
        fn=gf2_mul_hopper, source="m4ri_tpu_torch/csrc/gf2_gemm_hopper.cu",
        replaces="m4ri_tpu/ops/pallas_mul.py:170", shape=(512, 512, 16384)),
    "gf2_mul_hopper_v2": dict(
        fn=gf2_mul_hopper_v2, source="m4ri_tpu_torch/csrc/gf2_gemm_hopper.cu",
        replaces="m4ri_tpu/ops/pallas_mul2.py:153", shape=(4096, 4096, 4096)),
    "gf2_schur_update_hopper": dict(
        fn=gf2_schur_update_hopper,
        source="m4ri_tpu_torch/csrc/gf2_schur_hopper.cu",
        replaces="m4ri_tpu/ops/pallas_schur.py:93"),
    "gf2_schur_update_dyn_hopper": dict(
        fn=gf2_schur_update_dyn_hopper,
        source="m4ri_tpu_torch/csrc/gf2_schur_hopper.cu",
        replaces="m4ri_tpu/ops/pallas_schur.py:255"),
    "panel_loop_hopper": dict(
        fn=panel_loop_hopper, source="m4ri_tpu_torch/csrc/gf2_panel_hopper.cu",
        replaces="m4ri_tpu/ops/pallas_panel.py:168"),
    "panel_post_hopper": dict(
        fn=panel_post_hopper, source="m4ri_tpu_torch/csrc/gf2_post_hopper.cu",
        replaces="m4ri_tpu/ops/pallas_post.py:99"),
    # the batched path's forms of rows 5, 6 and 4 (the bounds on the card)
    "panel_loop_hopper_batched": dict(
        fn=hopper_panel.panel_loop_hopper_batched,
        source="m4ri_tpu_torch/csrc/gf2_panel_hopper.cu",
        replaces="m4ri_tpu/ops/pallas_panel.py:168"),
    "panel_post_hopper_batched": dict(
        fn=hopper_post.panel_post_hopper_batched,
        source="m4ri_tpu_torch/csrc/gf2_post_hopper.cu",
        replaces="m4ri_tpu/ops/pallas_post.py:99"),
    "gf2_schur_update_batched_hopper": dict(
        fn=hopper_schur.gf2_schur_update_batched_hopper,
        source="m4ri_tpu_torch/csrc/gf2_schur_hopper.cu",
        replaces="m4ri_tpu/ops/pallas_schur.py:255"),
    # the sweeps' U_piv^{-1} and L11^{-1}, the TRSM / TRTRI base blocks
    "unit_tri_inv_hopper": dict(
        fn=hopper_trinv.unit_tri_inv_hopper,
        source="m4ri_tpu_torch/csrc/gf2_trinv_hopper.cu",
        replaces="none: the nilpotent series (m4ri_tpu/models/ple.py:64, "
                 "_unit_upper_inv), no pallas_call"),
    # the below-window elimination's operands, T = U_piv^{-1} among them
    "post_operands_hopper": dict(
        fn=hopper_operands.post_operands_hopper,
        source="m4ri_tpu_torch/csrc/gf2_trinv_hopper.cu",
        replaces="none: the sweep's in-graph operand glue "
                 "(m4ri_tpu/models/ple.py:255-293), no pallas_call"),
    # the batched sweep's commit of a panel
    "panel_commit_hopper_batched": dict(
        fn=hopper_commit.panel_commit_hopper_batched,
        source="m4ri_tpu_torch/csrc/gf2_post_hopper.cu",
        replaces="none: the sweep's dynamic_update_slices "
                 "(m4ri_tpu/models/ple.py, _block_factor_impl), no "
                 "pallas_call"),
}
GEMMS = ("gf2_mul_hopper", "gf2_mul_hopper_v2")
SOURCES = ["gf2_gemm_hopper", "gf2_schur_hopper",
           "gf2_panel_hopper", "gf2_post_hopper", "gf2_trinv_hopper",
           "probe_mma"]
# the PLE panel's U rows at n=16384 (nb=512) and n=32768 (nb=1024): most of
# gf2_mul_hopper's launches
U_ROW_SHAPES = [(512, 512, 16384), (1024, 1024, 32768)]
CHECK_SHAPES = [(1, 1, 1), (31, 32, 33), (65, 97, 129), (300, 1100, 4200),
                (512, 1000, 4096), (300, 2100, 8200), (8192, 512, 8192),
                (4096, 2048, 4096), (4096, 4096, 4096), (50, 9000, 700),
                (100, 1, 300), *U_ROW_SHAPES]
TIMED_SHAPES = {"gf2_mul_hopper": [*U_ROW_SHAPES, (8192, 512, 8192),
                                   (4096, 4096, 4096)],
                "gf2_mul_hopper_v2": [(4096, 4096, 4096), (8192, 512, 8192)]}


class Failed(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise Failed(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def packed(rng, rows: int, cols: int) -> torch.Tensor:
    """Random packed words on the card, padding bits zero."""
    w = (cols + 31) // 32
    x = rng.integers(0, 2**32, (rows, w), dtype=np.uint64).astype(np.uint32)
    if cols % 32:
        x[:, -1] &= np.uint32((1 << (cols % 32)) - 1)
    return torch.from_numpy(x.view(np.int32)).to(DEV)


def dense(words: torch.Tensor, ncols: int) -> np.ndarray:
    return m4.to_numpy(BitMatrix(words, ncols))


def host_product(a_bits: np.ndarray, b_bits: np.ndarray) -> np.ndarray:
    """GF(2) product on the host: float32 BLAS, exact below 2**24 terms."""
    p = a_bits.astype(np.float32) @ b_bits.astype(np.float32)
    return (p.astype(np.int64) & 1).astype(np.uint8)


def time_ms(fn, runs: int = 11, warmup: int = 3) -> dict:
    """CUDA-event time of each of ``runs`` calls after ``warmup``; the
    operands stay in L2 between calls, as for a caller chaining products."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    return {"median": statistics.median(ts), "min": min(ts), "max": max(ts),
            "runs": runs}


def bound(m: int, k: int, n: int) -> dict:
    """Least time the card could take: packed A, B, C moved once, or
    2*m*k*n operations at the 1-bit tensor-core peak, whichever is larger."""
    kw, nw = (k + 31) // 32, (n + 31) // 32
    t_bytes = 4 * (m * kw + k * nw + m * nw) / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * m * k * n / PEAK_B1_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations"}


def counted(name: str) -> int:
    """A counter of the program (m4ri_tpu_torch/utils/spans.py)."""
    return spans.counts().get(name, 0)


def counts(names=None) -> dict:
    return {name: counted(f"launch.{name}") for name in names or KERNELS}


def gemm_counts() -> dict:
    return counts(GEMMS)


def zero_counts() -> None:
    spans.reset_counts("launch.")


def panel_kinds() -> dict:
    """Launches of the batched pivot loop by the kind of kernel taken."""
    key = "launch.panel_batched."
    return {k[len(key):]: n for k, n in spans.counts().items()
            if k.startswith(key)}


def plain_rowblocks(a: torch.Tensor, b: torch.Tensor, rows: int = 1024):
    """The plain version, a block of rows at a time (bounded memory)."""
    return torch.cat([gf2_mul_plain(a[r:r + rows], b)
                      for r in range(0, a.shape[0], rows)])


def with_config(fn, **fields):
    """Run ``fn`` with these Config fields in place of the derived ones (the
    seam of the tests: ``_derive`` swapped, ``get_config``'s cache cleared),
    then restore the derived config."""
    derive = config_mod._derive
    config_mod._derive = lambda: dataclasses.replace(derive(), **fields)
    config_mod.get_config.cache_clear()
    try:
        cfg = get_config()
        check(all(getattr(cfg, k) == v for k, v in fields.items()),
              f"the config did not take {fields}")
        return fn()
    finally:
        config_mod._derive = derive
        config_mod.get_config.cache_clear()


# --------------------------------------------------------------- phases ---

def phase_device() -> str:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.time()
    logs = _build.build(SOURCES)
    build_s = time.time() - t0
    probe = probe_mma()
    check(probe["b1_wgmma_m64n256k256"]["layout_check_equal"],
          "wgmma b1 on known operands differs from numpy: "
          f"{probe['b1_wgmma_m64n256k256']}")
    usage = {name: [ln.strip() for ln in log.splitlines() if "Used" in ln]
             for name, log in logs.items()}
    emit("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], build_seconds=build_s,
         ptxas=usage, mma_sync_probe=probe,
         b1_peak_tera_ops_per_s=PEAK_B1_OPS_PER_S / 1e12,
         config=get_config().derived_from)
    return card


def phase_kernels(rng) -> dict:
    """Each kernel against its plain version, then its time at the shapes
    the main path gives it."""
    report = {}
    for name in GEMMS:
        spec = KERNELS[name]
        fn, bad, checked = spec["fn"], 0, []
        for (m, k, n) in CHECK_SHAPES:
            a, b = packed(rng, m, k), packed(rng, k, n)
            got = fn(a, b)
            torch.cuda.synchronize()
            want = plain_rowblocks(a, b, 4096)
            bad = max(bad, int((got != want).any()))
            checked.append(f"{m}x{k}x{n}")
        # strided quadrant views in, a quadrant view as out=
        pa, pb = packed(rng, 1024, 4096 + 128), packed(rng, 4096, 2048 + 64)
        for (a, b) in [(pa[512:, 64:], pb[2048:, 32:]),      # A by tensor copy
                       (pa[:512, 1:65], pb[:2048, 33:]),     # A copied first
                       (pa[3:500, 5:64], pb[7:1880, 2:63])]:  # ragged
            parent = packed(rng, 1024, 32 * (b.shape[1] + 9))
            keep = parent.clone()
            out = parent[100:100 + a.shape[0], 9:]
            fn(a, b, out=out)
            torch.cuda.synchronize()
            want = gf2_mul_plain(a.contiguous(), b.contiguous())
            keep[100:100 + a.shape[0], 9:] = want
            bad = max(bad, int((parent != keep).any()))
        checked.append("strided views, out=view")
        if fn is gf2_mul_hopper_v2:
            # the contraction in the block (256 tiles), and split across
            # blocks (15 tiles, 5 stages of 32 words)
            for (m, k, n) in [(2048, 8192, 4096), (300, 4200, 1100)]:
                a, b = packed(rng, m, k), packed(rng, k, n)
                c = packed(rng, m, n)
                want = c ^ gf2_mul_plain(a, b)
                fn(a, b, out=c, accumulate=True)
                torch.cuda.synchronize()
                bad = max(bad, int((c != want).any()))
                checked.append(f"accumulate=True {m}x{k}x{n}")
        check(bad == 0, f"{name} disagrees with its plain version")
        shapes = []
        for (m, k, n) in TIMED_SHAPES[name]:
            a, b = packed(rng, m, k), packed(rng, k, n)
            out = torch.empty((m, (n + 31) // 32), dtype=torch.int32, device=DEV)
            t = time_ms(lambda: fn(a, b, out=out))
            tp = time_ms(lambda: gf2_mul_plain(a, b), runs=3, warmup=1)
            shapes.append({"shape": [m, k, n], "ms": t["median"], "ms_min": t["min"],
                           "ms_max": t["max"], "runs": t["runs"],
                           "plain_ms": tp["median"], **bound(m, k, n),
                           "tbitops_per_s": 2 * m * k * n / t["median"] / 1e9})
        main = next(s for s in shapes if tuple(s["shape"]) == spec["shape"])
        report[name] = {
            "name": name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": 0,
            "max_abs_err": bad, "matches_plain": bad == 0,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "timed_at": list(spec["shape"]),
            "checked": checked, "shapes": shapes}
    # Side figure, not a library version of the kernels: torch._int_mm on
    # operands ALREADY unpacked to s8, so without unpack, parity and pack.
    a8 = torch.randint(0, 2, (4096, 4096), dtype=torch.int8, device=DEV)
    b8 = torch.randint(0, 2, (4096, 4096), dtype=torch.int8, device=DEV)
    side = time_ms(lambda: torch._int_mm(a8, b8))["median"]
    emit("kernels", kernels=list(report.values()),
         int_mm_s8_4096_ms_excluding_unpack_parity_pack=side)
    return report


def kernel_entry(name: str, bad: int, main: dict, **more) -> dict:
    """One record of the ``kernels`` line; ``main`` holds ms, plain_ms,
    bound_ms and bound_by at the shape the main path gives the kernel."""
    spec = KERNELS[name]
    return {"name": name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": 0, "max_abs_err": bad,
            "matches_plain": bad == 0, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None, **more}


# the padded shape block_factor gives its kernels at n=16384 (nb=512, W=576)
# and at n=32768 (nb=1024, W=1088)
M_PAD_16K, NB_16K, WIN_16K = 17152, 512, 576
M_PAD_32K, NB_32K, WIN_32K = 34048, 1024, 1088
M_PAD_64K = 66816      # the padded height of a 65536-row input at nb=1024


SCHUR = ("gf2_schur_update_hopper", "gf2_schur_update_dyn_hopper")
# the padded C the sweep updates, its contraction, and the first and the
# middle panel's bounds (r0, c0w) at n=16384 (nb=512) and n=32768 (nb=1024)
SCHUR_SHAPES = [(M_PAD_16K, 16384 // 32, NB_16K, [(0, 16), (8192, 272)]),
                (M_PAD_32K, 32768 // 32, NB_32K, [(0, 32), (16384, 544)])]


def schur_bounds(name: str, nw: int, r0: int, c0w: int, bounds: str):
    """(positional, keyword) arguments after (c, lp, up): ints, with the
    finished column tiles skipped by the gridded entry as the sweep passes
    them, or the same bounds as tensors already on the card."""
    if bounds == "tensor":
        return (torch.tensor(r0, dtype=torch.int32, device=DEV),
                torch.tensor(c0w, dtype=torch.int32, device=DEV)), {}
    if name == "gf2_schur_update_hopper":
        skip = min(c0w // TILE_WORDS, -(-nw // TILE_WORDS) - 1)
        return (r0, c0w), {"col_tile_skip": skip}
    return (r0, c0w), {}


def phase_schur_kernels(rng) -> dict:
    """Both Schur entry points against the plain version at the shapes the
    sweep gives them at n=16384 and n=32768, over the bounds that decide
    which tiles run, with the bounds as ints and as tensors on the card;
    then their times at the first and the middle panel of each sweep."""
    bad = {name: 0 for name in SCHUR}
    checked, shapes = [], {name: [] for name in SCHUR}
    sync_free = None
    for (m, nw, k, timed) in SCHUR_SHAPES:
        c0 = packed(rng, m, nw * 32)
        lp0, up0 = packed(rng, m, k), packed(rng, k, nw * 32)

        def operands(r0, c0w):
            lp, up = lp0.clone(), up0.clone()
            lp[:r0] = 0
            up[:, :c0w] = 0
            return lp, up

        (r1, w1) = timed[1]
        for (r0, c0w) in [(0, 0), *timed, (r1 + 8, w1 + 3), (m, nw),
                          (m + 100, 5), (5, nw + 7), (m - 1, nw - 1)]:
            lp, up = operands(r0, c0w)
            want = gf2_schur_update_plain(c0.clone(), lp, up)
            for name in SCHUR:
                for bounds in ("int", "tensor"):
                    args, kw = schur_bounds(name, nw, r0, c0w, bounds)
                    got = KERNELS[name]["fn"](c0.clone(), lp, up, *args, **kw)
                    torch.cuda.synchronize()
                    bad[name] |= int((got != want).any())
                    if r0 >= m or c0w >= nw:
                        check(torch.equal(got, c0), f"{name}: a full skip changed C")
            checked.append(f"C {m}x{nw} words k={k} r0={r0} c0w={c0w}, "
                           "bounds int and tensor")
        # the skip is decided on whole tiles: with the contract broken on
        # purpose, tiles wholly above r0 or left of c0w keep their words and
        # every other tile takes the full product
        r0, c0w = timed[1][0] + 138, timed[1][1] + 2
        full = c0 ^ gf2_mul_plain(lp0, up0)
        want = c0.clone()
        row_a, word_a = r0 // TILE_ROWS * TILE_ROWS, c0w // TILE_WORDS * TILE_WORDS
        want[row_a:, word_a:] = full[row_a:, word_a:]
        for name in SCHUR:
            got = KERNELS[name]["fn"](c0.clone(), lp0, up0, r0, c0w)
            torch.cuda.synchronize()
            bad[name] |= int((got != want).any())
        checked.append(f"C {m}x{nw} words: whole-tile skip with the contract "
                       f"broken (r0={r0}, c0w={c0w})")
        del full, want
        if sync_free is None:
            # a call as the sweep makes it may not wait for the card
            lp, up = operands(*timed[1])
            c = c0.clone()
            args, kw = schur_bounds(SCHUR[0], nw, *timed[1], "int")
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                gf2_schur_update_hopper(c, lp, up, *args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            check(torch.equal(c, gf2_schur_update_plain(c0.clone(), lp, up)),
                  "the call under sync debug mode differs")
            sync_free = True
        # times
        for (r0, c0w) in timed:
            lp, up = operands(r0, c0w)
            c = c0.clone()
            tp = time_ms(lambda: gf2_schur_update_plain(c, lp, up), runs=3, warmup=1)
            for name in SCHUR:
                for bounds in ("int", "tensor"):
                    args, kw = schur_bounds(name, nw, r0, c0w, bounds)
                    fn = KERNELS[name]["fn"]
                    t = time_ms(lambda: fn(c, lp, up, *args, **kw))
                    shapes[name].append({
                        "shape": [m, k, nw * 32], "r0": r0, "c0w": c0w,
                        "bounds": bounds, "ms": t["median"], "ms_min": t["min"],
                        "ms_max": t["max"], "runs": t["runs"],
                        "plain_ms": tp["median"],
                        **schur_bound(m, k, nw, r0, c0w)})
        del c0, lp0, up0, lp, up, c
    # a ragged small shape, C a strided view (the gridded entry only: the
    # persistent one takes whole tiles and says so)
    cs, ls, us = packed(rng, 300, 38 * 32 - 7), packed(rng, 300, 150), \
        packed(rng, 150, 38 * 32 - 7)
    ls[:70] = 0
    us[:, :9] = 0
    parent = packed(rng, 400, 64 * 32)
    keep = parent.clone()
    view = parent[50:350, 11:49]
    view.copy_(cs)
    gf2_schur_update_hopper(view, ls, us, 70, 9, col_tile_skip=1)
    torch.cuda.synchronize()
    keep[50:350, 11:49] = gf2_schur_update_plain(cs.clone(), ls, us)
    bad["gf2_schur_update_hopper"] |= int((parent != keep).any())
    try:
        gf2_schur_update_dyn_hopper(cs.clone(), ls, us, 70, 9)
    except ValueError:
        pass
    else:
        raise Failed("the persistent Schur entry took a ragged shape")
    checked.append("ragged 300x38 words, k=150, strided C")
    for name in SCHUR:
        check(bad[name] == 0, f"{name} disagrees with its plain version")
    report = {}
    for name in SCHUR:
        main = shapes[name][0]                 # 16384, first panel, int bounds
        report[name] = kernel_entry(
            name, bad[name], main, timed_at=main["shape"] + [0, 16],
            checked=checked, shapes=shapes[name])
    emit("kernels_schur", kernels=list(report.values()),
         int_bounds_call_synchronises=not sync_free,
         tile=[TILE_ROWS, TILE_WORDS])
    return report


def window_words(rng, h: int, nb: int, zero=None, zero_cols=(),
                 l_random: bool = False) -> torch.Tensor:
    """A fused [panel | L] window: random panel words, optionally a band of
    zero rows and columns without any 1; the L half zero or random."""
    x = packed(rng, h, nb)
    if zero:
        x[zero[0]:zero[1]] = 0
    for c in zero_cols:
        x[:, c // 32] &= ~(1 << (c % 32)) if c % 32 < 31 else 0x7FFFFFFF
    lh = packed(rng, h, nb) if l_random else torch.zeros_like(x)
    return torch.cat([x, lh], dim=1)


def phase_panel_kernel(rng) -> dict:
    """The pivot-loop kernel against the plain loop: every output equal."""
    name, bad, checked = "panel_loop_hopper", 0, []
    no_pivot_group = tuple(range(64, 96))      # a word column without a 1
    straddle = (3, 40, 41, 70) + tuple(range(200, 215))   # slots behind columns
    cases = [  # h, nb, preserve_l, search_window, zeroed rows, window options
        (WIN_16K, NB_16K, False, 0, None, {}), (WIN_16K, NB_16K, True, 0, None, {}),
        (WIN_32K, NB_32K, False, 0, None, {}), (WIN_32K, NB_32K, True, 0, None, {}),
        (640, NB_16K, False, 64, (10, 300), {}),      # restricted search
        (WIN_16K, NB_16K, True, 0, (40, 330), {}),    # steps that find nothing
        (WIN_16K, NB_16K, True, 0, None, dict(zero_cols=no_pivot_group)),
        (WIN_16K, NB_16K, False, 0, None,
         dict(zero_cols=straddle, l_random=True)),
        (WIN_32K, NB_32K, True, 0, (1000, 1060), dict(zero_cols=straddle)),
        (M_PAD_16K, NB_16K, True, 0, (100, 9000), {}),   # the cooperative grid
        (M_PAD_16K, NB_16K, False, 0, (1000, 9000), dict(zero_cols=straddle)),
        (M_PAD_32K, NB_32K, False, 0, (0, 20000), {}),
        (M_PAD_32K, NB_32K, True, 0, (1000, 20000), {}),
        # the word column in device scratch: forced on a short window, then
        # at a height whose word column no block's shared memory holds
        (M_PAD_64K, NB_32K, True, 0, (500, 40000), {}),
        (M_PAD_64K, NB_32K, False, 0, (0, 30000), dict(zero_cols=straddle))]
    al0 = window_words(rng, WIN_32K, NB_32K, (100, 900), zero_cols=straddle)
    want = panel_loop_plain(al0, 0, 0, WIN_32K - 5, NB_32K, True, 0)
    got = hopper_panel._launch(al0, 0, 0, WIN_32K - 5, NB_32K, True, 0, mode=3)
    for g, w in zip(got, want):
        bad |= int(g.shape != w.shape or bool((g != w).any()))
    checked.append(f"h={WIN_32K} nb={NB_32K} mode=tall")
    modes = {}
    for (h, nb, pres, sw, zero, opts) in cases:
        al0 = window_words(rng, h, nb, zero, **opts)
        r0, base = 1000, (1000 if h < 8192 else 0)
        m = base + h - 5
        r0_dev = torch.tensor(r0, dtype=torch.int32, device=DEV)
        want = panel_loop_plain(al0, r0, base, m, nb, pres, sw)
        for rank in (r0_dev, r0):
            got = panel_loop_hopper(al0, rank, base, m, nb, pres, sw)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                bad |= int(g.shape != w.shape or bool((g != w).any()))
        modes[f"h={h} nb={nb}"] = hopper_panel.window_mode(h, nb)
        checked.append(f"h={h} nb={nb} preserve_l={pres} search_window={sw} "
                       f"zeroed={zero} {sorted(opts)} found={int(got[2]) - r0}")
    check(bad == 0, f"{name} disagrees with its plain version")
    check(modes[f"h={WIN_16K} nb={NB_16K}"] == "shared"
          and modes[f"h={WIN_32K} nb={NB_32K}"] == "shared"
          and modes[f"h={M_PAD_16K} nb={NB_16K}"] == "grid"
          and modes[f"h={M_PAD_32K} nb={NB_32K}"] == "grid"
          and modes[f"h={M_PAD_64K} nb={NB_32K}"] == "tall"
          and hopper_panel.window_mode(100_000, NB_16K) == "tall",
          f"unexpected window modes {modes}")
    try:   # a mode that does not fit the card's shared memory is refused
        hopper_panel._launch(window_words(rng, M_PAD_16K, NB_16K), 0, 0,
                             M_PAD_16K, NB_16K, True, 0, mode=1)
    except RuntimeError:
        pass
    else:
        raise Failed("a 1.1 MB panel was taken into one block's shared memory")
    try:   # and so is a word column that fits no block's
        hopper_panel.window_mode(100_000, NB_16K, mode=2)
    except RuntimeError:
        pass
    else:
        raise Failed("a word column of 400 KB was taken into shared memory")
    shapes = []
    for (h, nb, zero, r0) in [(WIN_16K, NB_16K, None, 0), (WIN_32K, NB_32K, None, 0),
                              (M_PAD_16K, NB_16K, None, 0),
                              (M_PAD_32K, NB_32K, None, 0),
                              (M_PAD_16K, NB_16K, (600, 2000), 600),
                              (M_PAD_64K, NB_32K, None, 0),
                              (M_PAD_64K, NB_32K, (1100, 3000), 1100)]:
        al0 = window_words(rng, h, nb, zero)
        args = (al0, r0, 0, h, nb, True, 0)
        t = time_ms(lambda: hopper_panel._launch(*args))
        chain = time_ms(lambda: hopper_panel._launch(*args, row_work=False))
        tp = time_ms(lambda: panel_loop_plain(*args), runs=3, warmup=1)
        # the floor of a chain of nb dependent steps, each a shared-memory
        # round trip, a ballot and a barrier, at the kernel's block size: the
        # bound.  Beside it the same chain in one warp (the step of a dense
        # window needs no block-wide barrier)
        threads = hopper_panel.kernel_threads(h)
        floor_block = time_ms(lambda: hopper_panel.chain_floor(nb, threads))
        floor_warp = time_ms(lambda: hopper_panel.chain_floor(nb, 32))
        # bytes: the window read and written once, the index outputs written
        nbytes = 4 * (2 * h * 2 * (nb // 32) + h + 4 * nb + 1)
        shapes.append({"h": h, "nb": nb, "zeroed": zero, "rank_at_entry": r0,
                       "mode": hopper_panel.window_mode(h, nb),
                       "ms": t["median"], "ms_min": t["min"], "ms_max": t["max"],
                       "runs": t["runs"], "plain_ms": tp["median"],
                       "bound_ms": floor_block["median"], "bound_by": "chain",
                       "chain_floor_ms": floor_block["median"],
                       "chain_floor_threads": threads,
                       "warp_chain_floor_ms": floor_warp["median"],
                       "bytes_bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
                       "chain_alone_ms_without_group_ends": chain["median"],
                       "us_per_column": t["median"] / nb * 1e3})
    spans.reset_counts("launch.panel_loop_hopper")
    report = {name: kernel_entry(name, bad, shapes[0],
                                 chain_floor_ms=shapes[0]["chain_floor_ms"],
                                 bytes_bound_ms=shapes[0]["bytes_bound_ms"],
                                 timed_at=[WIN_16K, 2 * NB_16K // 32],
                                 checked=checked, shapes=shapes, modes=modes)}
    emit("kernels_panel", kernels=list(report.values()))
    return report


def phase_post_kernel(rng) -> dict:
    name, bad, checked, shapes = "panel_post_hopper", 0, [], []
    for (m, nb, below0, mvalid) in [(M_PAD_16K, NB_16K, 1000 + WIN_16K, 16390),
                                    (M_PAD_32K, NB_32K, 2500 + WIN_32K, 32770)]:
        xw = packed(rng, m, nb)
        msm, wm = (torch.from_numpy(
            (rng.random((nb, nb)) < 0.5).astype(np.int8)).to(DEV)
            for _ in range(2))
        some = torch.from_numpy((rng.random(nb) < 0.2).astype(np.int8)).to(DEV)
        # the packing launch alone against its plain version
        got_pack = hopper_post.pack_operands_hopper(msm, wm, some)
        torch.cuda.synchronize()
        for g, w in zip(got_pack, (hopper_post._packed_transposed(msm),
                                   hopper_post._packed_transposed(wm),
                                   hopper_post._packed_colmask(some))):
            bad |= int(g.shape != w.shape or bool((g != w).any()))
        checked.append(f"nb={nb} packing kernel")
        for cmb, want_miss in ((some, True), (torch.zeros_like(some), False)):
            want = panel_post_plain(xw, msm, wm, cmb, below0, mvalid)
            got = panel_post_hopper(xw, msm, wm, cmb, below0, mvalid)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                bad |= int(bool((g != w).any()))
            check(bool(got[2]) is want_miss, f"post miss flag, want {want_miss}")
            checked.append(f"m={m} nb={nb} rows [{below0}, {mvalid}) "
                           f"miss={want_miss}")
        # a panel cut from a wider matrix, as the sweep hands it over
        wide = packed(rng, m, nb + 4096)
        view = wide[:, 64:64 + nb // 32]
        view.copy_(xw)
        got = panel_post_hopper(view, msm, wm, some, below0, mvalid)
        want = panel_post_plain(xw, msm, wm, some, below0, mvalid)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            bad |= int(bool((g != w).any()))
        t = time_ms(lambda: panel_post_hopper(view, msm, wm, some, below0, mvalid))
        tp = time_ms(lambda: panel_post_plain(view, msm, wm, some, below0, mvalid),
                     runs=3, warmup=1)
        nbw = nb // 32
        t_bytes = 4 * (3 * m * nbw + 2 * nb * nbw + nbw) / PEAK_BYTES_PER_S * 1e3
        t_ops = 2 * 2 * (mvalid - below0) * nb * nb / PEAK_B1_OPS_PER_S * 1e3
        t_pack = time_ms(lambda: hopper_post.pack_operands_hopper(msm, wm, some))
        t_pack_plain = time_ms(lambda: (hopper_post._packed_transposed(msm),
                                        hopper_post._packed_transposed(wm),
                                        hopper_post._packed_colmask(some)))
        shapes.append({"m": m, "nb": nb, "rows": [below0, mvalid],
                       "packing_kernel_ms": t_pack["median"],
                       "packing_plain_ms": t_pack_plain["median"],
                       "ms": t["median"], "ms_min": t["min"], "ms_max": t["max"],
                       "runs": t["runs"], "plain_ms": tp["median"],
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    check(bad == 0, f"{name} disagrees with its plain version")
    report = {name: kernel_entry(name, bad, shapes[0],
                                 timed_at=[M_PAD_16K, NB_16K // 32],
                                 checked=checked, shapes=shapes)}
    emit("kernels_post", kernels=list(report.values()))
    return report


# (batch, n) of the inverse on the main paths: McEliece's T and L11^{-1}
# (nb = 512, 1024 keys), the TRSM bases of its 768-column solves (384), the
# single sweep's wide panel (nb = 1024)
TRINV_SHAPES = [(1024, 512), (1024, 384), (1, 1024)]


def trinv_bound(batch: int, n: int, chain_floor_ms: float) -> dict:
    """Least time for ``batch`` inverses of n x n, the largest of: N's
    strict triangle read once (the words the kernel reads: 32 (K + 1) rows
    of word K) and S written once; the shared-memory loads of the update, a
    word for each (row, contributing row, word of the row that can be
    nonzero), 1024 nw (nw^2 - 1) / 6 ~ n^3/192 a matrix; the same count of
    32-bit and-XORs; and the chain of n/32 dependent block steps, measured
    by the probe at the launch's grid (``chain_floor_ms``)."""
    nw = n // 32
    terms = {
        "bytes": 4 * batch * (16 * nw * (nw + 1) + n * nw)
        / PEAK_BYTES_PER_S * 1e3,
        "smem_loads": batch * 1024 * nw * (nw * nw - 1) / 6
        / PEAK_SMEM_WORDS_PER_S * 1e3,
        "operations": batch * 1024 * nw * (nw * nw - 1) / 6
        / PEAK_ALU32_OPS_PER_S * 1e3,
        "chain": chain_floor_ms}
    by = max(terms, key=terms.get)
    return {"bound_ms": terms[by], "bound_by": by,
            **{f"{k}_bound_ms": v for k, v in terms.items()}}


def phase_trinv_kernel(rng) -> dict:
    """The unit-triangular inverse against its plain version, upper and
    lower, with N zero, the full strict triangle and random in one batch,
    at the main paths' shapes, 4096 NIST-sized ones and a ragged width;
    then its time at the main paths' shapes beside its bound and the time
    of the float32 series the sweeps took before it.  The kernel's device
    time is compared with the bound; the chain term of the bound is the
    probe's device time, each from the device trace."""
    name, bad, checked, shapes = "unit_tri_inv_hopper", 0, [], []
    fn, plain = hopper_trinv.unit_tri_inv_hopper, hopper_trinv.unit_tri_inv_plain
    for batch, n in [*TRINV_SHAPES, (2 ** 12, 32), (5, 100)]:
        w = (n + 31) // 32
        nil = packed(rng, batch * n, n).view(batch, n, w)
        i = np.arange(n)
        for upper in (True, False):
            if batch >= 3:      # N zero, N the full strict triangle
                full = (i[None, :] > i[:, None]) if upper else \
                    (i[None, :] < i[:, None])
                nil[0] = 0
                nil[1] = m4.from_numpy(full.astype(np.uint8)).data
            got = fn(nil, upper)
            torch.cuda.synchronize()
            want = plain(nil, upper)
            bad |= int(not torch.equal(got, want))
            checked.append(f"{batch} x {n}^2 upper={upper}")
    check(bad == 0, f"{name} disagrees with its plain version")
    for batch, n in TRINV_SHAPES:
        nil = packed(rng, batch * n, n).view(batch, n, n // 32)
        eye = torch.eye(n, dtype=torch.int8, device=DEV)
        for upper in (True, False):
            t = time_ms(lambda: fn(nil, upper))
            # the kernel's own time, without the wrapper's host time
            dev_ms = device_trace(lambda: fn(nil, upper), calls=11)["device_ms"]
            bits = (hopper_trinv.unpack_bits(nil, torch.int8)
                    * hopper_trinv._strict(n, upper, DEV))
            ts = time_ms(lambda: hopper_trinv._unit_upper_inv(
                bits, eye, hopper_trinv.series_steps(n)), runs=3, warmup=1)
            tp = time_ms(lambda: plain(nil, upper), runs=3, warmup=1)
            del bits
            strips, sw, threads = hopper_trinv.trinv_plan(
                batch, n, torch.cuda.get_device_properties(0).multi_processor_count)
            # the chain alone, on the launch's grid
            floor = time_ms(lambda: hopper_trinv.chain_floor(batch, n))
            floor_dev = device_trace(lambda: hopper_trinv.chain_floor(batch, n),
                                     calls=11)["device_ms"]
            shapes.append({"batch": batch, "n": n, "upper": upper,
                           "strips": strips, "strip_words": sw,
                           "threads": threads, "ms": t["median"],
                           "ms_min": t["min"], "ms_max": t["max"],
                           "runs": t["runs"], "device_ms": dev_ms,
                           "series_ms": ts["median"],
                           "plain_ms": tp["median"],
                           "chain_steps": n // 32,
                           "chain_floor_event_ms": floor["median"],
                           **trinv_bound(batch, n, floor_dev)})
    report = {name: kernel_entry(name, bad, shapes[0],
                                 device_ms=shapes[0]["device_ms"],
                                 timed_at=list(TRINV_SHAPES[0]),
                                 checked=checked, shapes=shapes)}
    emit("kernels_trinv", kernels=list(report.values()))
    return report


# (batch, nb, preserve_l) of the four sweep cells: nist_sp800_22.rank,
# mceliece348864.keygen (strategy m4ri), mceliece348864.isd, dense32768.ple
OPERANDS_SHAPES = [(976_000, 32, False), (1024, 512, False),
                   (1024, 512, True), (1, 1024, True)]


def operands_inputs(rng, batch: int, nb: int):
    """A batch of slot rows as the batched sweep passes them (a view of a
    taller window), counts over [0, nb], distinct pivot columns in the live
    slots and garbage elsewhere."""
    nbw = nb // 32
    h = nb + 64
    al = packed(rng, batch * h, 64 * nbw).view(batch, h, 2 * nbw)
    cnt = rng.integers(0, nb + 1, batch)
    cnt[: min(batch, 3)] = [0, 1, nb][: min(batch, 3)]
    r0 = rng.integers(0, 1000, batch)
    live = np.arange(nb)[None, :] < cnt[:, None]
    perm = torch.rand((batch, nb), device=DEV).argsort(1).cpu().numpy()
    q = np.where(live, perm, rng.integers(-50, 2 * nb, (batch, nb)))
    as_card = lambda x: torch.from_numpy(x.astype(np.int32)).to(DEV)
    return al[:, :nb], as_card(r0 + cnt), as_card(r0), as_card(q)


def operands_bound(batch: int, nb: int, chain_floor_ms: float) -> dict:
    """Least time for the operands of ``batch`` windows of nb slots: the
    slot rows read once (nb^2 / 4 bytes an element) and the three outputs
    written once (2 nb^2 + nb bytes), or, for the block plan, the chain of
    the inverse it runs (``chain_floor_ms``, the probe's device time)."""
    nbytes = batch * (nb * nb // 4 + 2 * nb * nb + nb)
    terms = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3, "chain": chain_floor_ms}
    by = max(terms, key=terms.get)
    return {"bound_ms": terms[by], "bound_by": by, "bytes": nbytes,
            **{f"{k}_bound_ms": v for k, v in terms.items()}}


def phase_operands_kernel(rng) -> dict:
    """The operands' kernels against their plain version byte for byte at
    the four sweep cells' shapes and a few small ones, single and batched,
    each plan; then the wrapper's time at the cells' shapes (median of 11
    CUDA-event runs), its device time, the plain chain's time and the
    bound."""
    name, bad, checked, shapes = "post_operands_hopper", 0, [], []
    fn = hopper_operands.post_operands_hopper
    plain = hopper_operands.post_operands_plain
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for batch, nb, pres in [*OPERANDS_SHAPES, (7, 32, True), (131, 512, True),
                            (3, 96, False)]:
        args = operands_inputs(rng, batch, nb)
        for miss in (True, False):
            got = fn(*args, 0, 32 * nb, 33 * nb - 7, pres, miss)
            torch.cuda.synchronize()
            want = plain(*args, 0, 32 * nb, 33 * nb - 7, pres, miss)
            bad |= int(not all(torch.equal(g, w) for g, w in zip(got, want)))
            del got, want
        if batch == 1:          # the single-window form of the same call
            Pw, rank, r0, q = args
            got = fn(Pw[0], rank[0], int(r0[0]), q[0] + 64, 64, 0, nb, pres)
            want = plain(Pw[0], rank[0], int(r0[0]), q[0] + 64, 64, 0, nb,
                         pres)
            bad |= int(not all(torch.equal(g, w) for g, w in zip(got, want)))
        checked.append(f"{batch} x {nb} preserve_l={pres}")
    check(bad == 0, f"{name} disagrees with its plain version")
    for batch, nb, pres in OPERANDS_SHAPES:
        args = operands_inputs(rng, batch, nb)
        call = lambda: fn(*args, 0, 0, 1 << 30, pres, True)
        zero_counts()
        t = time_ms(call)
        launches = counted(f"launch.{name}")
        dev = device_trace(call, calls=11)
        tp = time_ms(lambda: plain(*args, 0, 0, 1 << 30, pres, True), runs=3,
                     warmup=1)
        plan = hopper_operands.operands_plan(batch, nb, sms)
        floor_dev = 0.0
        if plan[0] == "block":
            floor_dev = device_trace(
                lambda: hopper_trinv.chain_floor(batch, nb),
                calls=11)["device_ms"]
        shapes.append({"batch": batch, "nb": nb, "preserve_l": pres,
                       "plan": list(plan), "ms": t["median"],
                       "ms_min": t["min"], "ms_max": t["max"],
                       "runs": t["runs"], "wrapper_calls": launches,
                       "device_ms": dev["device_ms"],
                       "device_ms_by_kernel": dev["device_ms_by_kernel"],
                       "plain_ms": tp["median"],
                       **operands_bound(batch, nb, floor_dev)})
        del args
    report = {name: kernel_entry(name, bad, shapes[0],
                                 device_ms=shapes[0]["device_ms"],
                                 timed_at=list(OPERANDS_SHAPES[0]),
                                 checked=checked, shapes=shapes)}
    emit("kernels_operands", kernels=list(report.values()))
    return report


# (batch, rows, columns, panel) of the commit's timed shapes: one
# nist_sp800_22.rank call and mceliece348864.keygen's panels 1-3
COMMIT_SHAPES = [(976_000, 32, 32, 0), (1024, 768, 3488, 0),
                 (1024, 768, 3488, 1), (1024, 768, 3488, 2)]


def commit_bound(ops) -> dict:
    """Least time for the commit of ``ops`` (what the sweep hands the
    wrapper): every word it must move read once and written once.  For
    each element that did not miss: ALw's window rows below m in (2 nbw
    words a row) and A's and lam's panel words out; v's rows below the
    window in and A's out; the moved window rows' words outside the panel
    in and out; p_f / q_f in and P / Q out at the pivot slots; the window's
    permutation read where a word lies outside the panel."""
    A, vw, rpw, r_f, r_in, miss, m = (ops[0], ops[3], ops[6], ops[9],
                                      ops[10], ops[11], ops[14])
    w_pad, nbw, W = A.shape[2], vw.shape[2], rpw.shape[1]
    hit = ~miss
    below_m = (m - r_in).clamp(min=0)
    win = torch.minimum(below_m, torch.full_like(below_m, W))
    under = (below_m - W).clamp(min=0)
    moved = (rpw != torch.arange(W, device=rpw.device)).sum(1)
    per = (16 * nbw * win + 8 * nbw * under + 16 * (r_f - r_in)
           + 8 * (w_pad - nbw) * moved + 9
           + (4 * W if w_pad > nbw else 0))
    nbytes = int(torch.where(hit, per, 1).sum())
    return {"bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes}


def phase_commit_kernel(seed: int) -> dict:
    """The commit's kernel against its plain version word for word on what
    the sweep hands it at the cells' shapes (one plan each), then the
    wrapper's time there (median of 11 CUDA-event runs on the same buffers:
    each call moves the same rows), its device time, the plain version's
    time and the bytes bound."""
    name, bad, shapes = "panel_commit_hopper_batched", 0, []
    fn = hopper_commit.panel_commit_hopper_batched
    plain = hopper_commit.panel_commit_batched_plain
    for i, (B, m, n, panel) in enumerate(COMMIT_SHAPES):
        data = stack_on_card(seed + 950 + (i > 0), B, m, n)
        ops = capture_panel(data, n, False, panel=panel, need=(name,))[name]
        del data
        outs = []
        for f in (fn, plain):
            a = [x.clone() if isinstance(x, torch.Tensor) else x for x in ops]
            f(*a)
            torch.cuda.synchronize()
            outs.append([a[k] for k in (0, 1, 2, 4)])
            del a
        bad |= int(not all(torch.equal(g, w) for g, w in zip(*outs)))
        del outs
        zero_counts()
        t = time_ms(lambda: fn(*ops))
        plan = [k.rsplit(".", 1)[1] for k in spans.counts()
                if k.startswith(f"launch.{name}.")]
        dev = device_trace(lambda: fn(*ops), calls=11)
        tp = time_ms(lambda: plain(*ops), runs=3, warmup=1)
        shapes.append({"batch": B, "shape": [m, n], "panel": panel + 1,
                       "window": ops[6].shape[1], "plan": plan,
                       "ms": t["median"], "ms_min": t["min"],
                       "ms_max": t["max"], "runs": t["runs"],
                       "device_ms": dev["device_ms"],
                       "device_ms_by_kernel": dev["device_ms_by_kernel"],
                       "plain_ms": tp["median"], **commit_bound(ops)})
        del ops
    check(bad == 0, f"{name} disagrees with its plain version")
    report = {name: kernel_entry(name, bad, shapes[0],
                                 device_ms=shapes[0]["device_ms"],
                                 timed_at=list(COMMIT_SHAPES[0]),
                                 shapes=shapes)}
    emit("kernels_commit", kernels=list(report.values()))
    return report


def phase_mul_4096(seed: int) -> dict:
    n = 4096
    rng = np.random.default_rng(seed)
    A = m4.from_packed(packed(rng, n, n), n)
    B = m4.from_packed(packed(rng, n, n), n)
    zero_counts()
    C = m4.mul(A, B)
    torch.cuda.synchronize()
    got = gemm_counts()
    check(got == {"gf2_mul_hopper": 0, "gf2_mul_hopper_v2": 1},
          f"mul at n=4096 launched {got}, want the v2 kernel exactly once")
    check(torch.equal(C.data, gf2_mul_plain(A.data, B.data)),
          "mul at n=4096 differs from the plain path")
    rows = np.sort(rng.choice(n, 64, replace=False))
    want = host_product(dense(A.data[torch.as_tensor(rows, device=DEV)], n),
                        dense(B.data, n))
    check((m4.to_numpy(C)[rows] == want).all(),
          "mul at n=4096 differs from the host product on sampled rows")
    t = time_ms(lambda: m4.mul(A, B))
    emit("mul_4096", ok=True, launches=got, ms=t,
         tbitops_per_s=2 * n**3 / t["median"] / 1e9, **bound(n, n, n))
    return got


def phase_mul_routes(seed: int) -> dict:
    rng = np.random.default_rng(seed + 1)
    total = {name: 0 for name in GEMMS}
    routes = []
    for (m, k, n), want_counts in [
            ((4096, 2048, 4096), {"gf2_mul_hopper": 1, "gf2_mul_hopper_v2": 0}),
            ((8192, 512, 8192), {"gf2_mul_hopper": 1, "gf2_mul_hopper_v2": 0}),
            ((200, 130, 170), {"gf2_mul_hopper": 0, "gf2_mul_hopper_v2": 0})]:
        A = m4.from_packed(packed(rng, m, k), k)
        B = m4.from_packed(packed(rng, k, n), n)
        zero_counts()
        C = m4.mul(A, B)
        torch.cuda.synchronize()
        got = gemm_counts()
        check(got == want_counts, f"mul {m}x{k}x{n} launched {got}")
        check((m4.to_numpy(C) == host_product(m4.to_numpy(A), m4.to_numpy(B))).all(),
              f"mul {m}x{k}x{n} differs from the host product")
        for name in total:
            total[name] += got[name]
        routes.append({"shape": [m, k, n], "launches": got})
    emit("mul_routes", ok=True, routes=routes)
    return total


def phase_strassen(seed: int) -> dict:
    """mul / addmul / mul(A, A) at n=16384: with the card's defaults the
    direct kernel product (Strassen's level costs time there:
    utils/config.py::_derive), and with the cutoff forced to 8192 one
    Strassen level over 8192 quadrant views, so that the Strassen code stays
    driven on the card.  Both held to the direct product and the plain
    version."""
    n = 16384
    rng = np.random.default_rng(seed + 2)
    A = m4.from_packed(packed(rng, n, n), n)
    B = m4.from_packed(packed(rng, n, n), n)
    C = m4.from_packed(packed(rng, n, n), n)
    total = {name: 0 for name in GEMMS}
    per_op = {}
    outs = {}
    ops = [("mul", lambda: m4.mul(A, B)), ("addmul", lambda: m4.addmul(C, A, B)),
           ("sqr", lambda: m4.mul(A, A))]

    def drive(route):
        for op, run in ops:
            zero_counts()
            outs[f"{op}_{route}"] = run()
            torch.cuda.synchronize()
            per_op[f"{op}_{route}"] = gemm_counts()
            for name in total:
                total[name] += per_op[f"{op}_{route}"][name]

    check(get_config().strassen_cutoff * 2 > n,
          "the card's default engages Strassen at n=16384")
    drive("default")
    with_config(lambda: drive("strassen"), strassen_cutoff=8192)
    for op, _ in ops:
        check(per_op[f"{op}_default"] == {"gf2_mul_hopper": 0, "gf2_mul_hopper_v2": 1},
              f"{op} at n=16384 launched {per_op[f'{op}_default']}, want the "
              "direct product once")
        check(per_op[f"{op}_strassen"] == {"gf2_mul_hopper": 0, "gf2_mul_hopper_v2": 7},
              f"{op} at n=16384, cutoff 8192, launched {per_op[f'{op}_strassen']}, "
              "want 7 base products")
    # the operands the Strassen level gives the kernel: 8192-wide quadrant
    # views of the 16384 parents, held to the plain version on the same views
    h, hw = n // 2, n // 64
    a11, b11 = A.data[:h, :hw], B.data[:h, :hw]
    q = gf2_mul_hopper_v2(a11, b11)
    check(torch.equal(q, plain_rowblocks(a11, b11)),
          "product of 8192 quadrant views differs from the plain version")
    del q
    # the direct kernel product at the same size, itself held to the plain
    # version in row blocks
    ab = gf2_mul_hopper_v2(A.data, B.data)
    check(torch.equal(ab, plain_rowblocks(A.data, B.data)),
          "direct product at n=16384 differs from the plain version")
    aa = gf2_mul_hopper_v2(A.data, A.data)
    check(torch.equal(aa, plain_rowblocks(A.data, A.data)),
          "direct square at n=16384 differs from the plain version")
    for route in ("default", "strassen"):
        check(torch.equal(outs[f"mul_{route}"].data, ab), f"mul ({route}) differs")
        check(torch.equal(outs[f"addmul_{route}"].data, C.data ^ ab),
              f"addmul ({route}) differs")
        check(torch.equal(outs[f"sqr_{route}"].data, aa), f"squaring ({route}) differs")
    del outs, ab, aa
    t = {f"{op}_default": time_ms(run, runs=3, warmup=1) for op, run in ops}
    t.update(with_config(lambda: {f"{op}_strassen": time_ms(run, runs=3, warmup=1)
                                  for op, run in ops}, strassen_cutoff=8192))
    t["direct_v2"] = time_ms(lambda: gf2_mul_hopper_v2(A.data, B.data),
                             runs=3, warmup=1)
    t["base_v2_8192_views"] = time_ms(lambda: gf2_mul_hopper_v2(a11, b11),
                                      runs=3, warmup=1)
    emit("strassen_16384", ok=True, launches=per_op, ms=t,
         mul_tbitops_per_s=2 * n**3 / t["mul_default"]["median"] / 1e9,
         strassen_cutoff=get_config().strassen_cutoff,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         **bound(n, n, n), base_8192_bound_ms=bound(h, h, h)["bound_ms"])
    return total


_FNV_OFF = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)


def fnv1a_bits(bits: np.ndarray) -> str:
    """FNV-1a 64 over row-major bits, one byte per bit: the hash of the
    golden vectors captured from the reference C library."""
    h = _FNV_OFF
    with np.errstate(over="ignore"):
        for b in bits.reshape(-1).astype(np.uint64):
            h = (h ^ b) * _FNV_PRIME
    return f"{int(h):016x}"


def phase_naive_and_golden(seed: int) -> None:
    rng = np.random.default_rng(seed + 3)
    A = m4.from_packed(packed(rng, 512, 500), 500)
    B = m4.from_packed(packed(rng, 500, 520), 520)
    check(bool(m4.equal(m4.mul_naive(A, B), m4.mul(A, B))),
          "mul_naive differs from mul at 512")
    golden = HERE / "tests" / "data" / "golden_reference.jsonl"
    recs = [json.loads(ln) for ln in golden.read_text().splitlines()]
    recs = [r for r in recs if r["op"] == "mul"]
    check(len(recs) == 3, f"want 3 golden mul records, found {len(recs)}")
    for r in recs:
        g = GlibcRandom(17)
        a = reference_random_data(r["m"], r["k"], rng=g)
        b = reference_random_data(r["k"], r["n"], rng=g)
        A, B = m4.from_reference(a, r["k"]), m4.from_reference(b, r["n"])
        check(fnv1a_bits(m4.to_numpy(A)) == r["a_hash"], "golden a_hash")
        check(fnv1a_bits(m4.to_numpy(B)) == r["b_hash"], "golden b_hash")
        check(fnv1a_bits(m4.to_numpy(m4.mul(A, B))) == r["out_hash"],
              f"golden out_hash {r['m']}x{r['k']}x{r['n']}")
    emit("naive_and_golden", ok=True, golden_mul_records=len(recs))


# ------------------------------------------------- the factorization path ---

FACTOR_KERNELS = ("panel_loop_hopper", "panel_post_hopper",
                  "gf2_schur_update_hopper", "gf2_schur_update_dyn_hopper",
                  "gf2_mul_hopper", "unit_tri_inv_hopper",
                  "post_operands_hopper")


def sync_waits(caught) -> int:
    """The warnings of PyTorch's sync debug mode that name a call that
    waited for the card (its one-time notice that the mode is a prototype
    is not one)."""
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def time_host_ms(fn, runs: int, warmup: int = 1) -> dict:
    """Host-clock time of each of ``runs`` calls, each ended by a
    synchronize: a factorization reads back from the device as it goes."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return {"median": statistics.median(ts), "min": min(ts), "max": max(ts),
            "runs": runs}


def same_factors(got, want, what: str) -> None:
    for g, w, part in zip(got[:3], want[:3], ("data", "P", "Q")):
        check(torch.equal(g, w), f"{what}: {part} differs from the plain engine")
    check(got[3] == want[3], f"{what}: rank {got[3]} != {want[3]}")


def factor_counted(A, preserve_l: bool, **kw):
    """block_factor with the default engine and what it launched and read
    back: (result, launches, host syncs, miss fallbacks)."""
    zero_counts()
    syncs, misses = (counted("readback.block_factor"),
                     counted("fallback.block_factor"))
    out = m4.block_factor(A, preserve_l=preserve_l, **kw)
    torch.cuda.synchronize()
    return (out, counts(FACTOR_KERNELS),
            counted("readback.block_factor") - syncs,
            counted("fallback.block_factor") - misses)


def add_counts(total: dict, got: dict) -> None:
    for name, n in got.items():
        total[name] = total.get(name, 0) + n


def valid_swaps(P, Q, r: int, m: int, n: int) -> bool:
    """LAPACK-style swap arrays: P[i] in [i, m) for the r pivots and the
    identity after them; Q strictly increasing on the pivots, inside [0, n)."""
    p, q = P.tolist(), Q.tolist()
    return (len(p) == m and len(q) == n
            and all(i <= p[i] < m for i in range(r))
            and p[r:] == list(range(r, m))
            and all(q[i] < q[i + 1] for i in range(r - 1))
            and all(i <= q[i] < n for i in range(r)))


def phase_ple_16384(seed: int) -> dict:
    n, panels = 16384, 16384 // NB_16K
    rng = np.random.default_rng(seed + 10)
    A = m4.from_packed(packed(rng, n, n), n)
    total = {}
    torch.cuda.reset_peak_memory_stats()
    per_run = {}
    for pres in (False, True):
        got, launched, syncs, misses = factor_counted(A, pres)
        add_counts(total, launched)
        want = m4.block_factor(A, preserve_l=pres, engine="plain")
        same_factors(got, want, f"block_factor 16384 preserve_l={pres}")
        # the last panel leaves no column to update: no U rows, no Schur
        # update; the operands (T among them) a panel and an L11^{-1} a
        # panel but the last
        check(launched == {"panel_loop_hopper": panels + misses,
                           "panel_post_hopper": panels,
                           "gf2_schur_update_hopper": panels - 1,
                           "gf2_schur_update_dyn_hopper": 0,
                           "gf2_mul_hopper": panels - 1,
                           "unit_tri_inv_hopper": panels - 1,
                           "post_operands_hopper": panels},
              f"block_factor 16384 launched {launched} over {panels} panels")
        check(syncs == panels + misses, f"{syncs} read-backs, {panels} panels")
        per_run[f"preserve_l={pres}"] = {"launches": launched, "rank": got[3],
                                         "host_syncs": syncs,
                                         "miss_fallbacks": misses}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # every call that waits for the card, as PyTorch's sync debug mode sees
    # them, beside the read-backs the sweep counts itself
    syncs0 = counted("readback.block_factor")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            m4.block_factor(A, preserve_l=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    per_run["sync_debug_warn"] = {
        "synchronising_calls": sync_waits(caught),
        "host_syncs": counted("readback.block_factor") - syncs0}
    # the entry points a user calls
    zero_counts()
    M, P, Q, r = m4.ple(A)
    rk = m4.rank(A)
    torch.cuda.synchronize()
    add_counts(total, counts(FACTOR_KERNELS))
    check(r == rk == want[3], f"ple rank {r}, rank {rk}, plain engine {want[3]}")
    check(torch.equal(P, want[1]) and torch.equal(Q, want[2]),
          "ple 16384: P or Q differs from the plain engine")
    plain_m = mask_padding(BitMatrix(
        ple_mod._compress_l_impl(want[0], want[2], want[3], n, n), n))
    check(torch.equal(M.data, plain_m.data),
          "ple 16384: the compressed body differs from the plain path's")
    check(valid_swaps(P, Q, r, n, n), "ple 16384: P, Q are not swap arrays")
    del plain_m, got
    t = {"ple": time_host_ms(lambda: m4.ple(A), runs=5),
         "rank": time_host_ms(lambda: m4.rank(A), runs=5),
         "compress_l": time_host_ms(
             lambda: ple_mod._compress_l_impl(want[0], want[2], want[3], n, n),
             runs=5),
         "block_factor_plain_engine": time_host_ms(
             lambda: m4.block_factor(A, preserve_l=True, engine="plain"),
             runs=1, warmup=0)}
    emit("ple_16384", ok=True, rank=r, panels=panels, runs=per_run, ms=t,
         host_syncs_per_factorization=per_run["preserve_l=True"]["host_syncs"],
         peak_memory_gb=peak_gb)
    return total


def phase_ple_deficient(seed: int) -> dict:
    """Inputs whose windows go rank-deficient: a band of zero rows (the
    pivot lies below the window, so the panel is redone at full height by
    the panel kernel in device memory), and a product of known rank."""
    n = 4096
    rng = np.random.default_rng(seed + 11)
    total = {}
    a = packed(rng, n, n)
    a[600:2000] = 0
    A = m4.from_packed(a, n)
    out = {}
    for pres in (False, True):
        got, launched, syncs, misses = factor_counted(A, pres)
        add_counts(total, launched)
        want = m4.block_factor(A, preserve_l=pres, engine="plain")
        same_factors(got, want, f"zeroed band preserve_l={pres}")
        check(misses > 0, "the zeroed band caused no miss fallback")
        check(launched["panel_loop_hopper"] == n // NB_16K + misses,
              f"zeroed band: {launched}, {misses} fallbacks")
        out[f"zeroed_band preserve_l={pres}"] = {
            "rank": got[3], "miss_fallbacks": misses, "host_syncs": syncs,
            "launches": launched}
    # 70,000 rows: the full-height window of a miss is taller than any word
    # column a block's shared memory holds
    mt, nt = 70_000, 2048
    a = packed(rng, mt, nt)
    a[600:3000] = 0
    At = m4.from_packed(a, nt)
    got, launched, syncs, misses = factor_counted(At, True)
    add_counts(total, launched)
    want = m4.block_factor(At, preserve_l=True, engine="plain")
    same_factors(got, want, "zeroed band, 70,000 rows")
    check(misses > 0, "the zeroed band of the tall input caused no miss fallback")
    out["zeroed_band 70000x2048"] = {
        "rank": got[3], "miss_fallbacks": misses, "launches": launched,
        "full_height_mode": hopper_panel.window_mode(mt, NB_16K)}
    check(out["zeroed_band 70000x2048"]["full_height_mode"] == "tall",
          "70,000 rows: the full-height window was not taken in mode tall")
    del a, At, got, want
    k = 1000
    B = m4.from_packed(packed(rng, n, k), k)
    C = m4.from_packed(packed(rng, k, n), n)
    L = m4.mul(B, C)
    zero_counts()
    M, P, Q, r = m4.ple(L)
    rk = m4.rank(L)
    torch.cuda.synchronize()
    add_counts(total, counts(FACTOR_KERNELS))
    check(r == rk == k, f"product of rank {k}: ple says {r}, rank says {rk}")
    want = m4.block_factor(L, preserve_l=True, engine="plain")
    check(torch.equal(P, want[1]) and torch.equal(Q, want[2]) and r == want[3],
          "low-rank product: P, Q or rank differ from the plain engine")
    check(valid_swaps(P, Q, r, n, n), "low-rank product: not swap arrays")
    out["low_rank_product"] = {"rank": r}
    emit("ple_deficient", ok=True, n=n, cases=out)
    return total


def phase_ple_32768(seed: int) -> dict:
    """The wide panel (nb=1024, W=1088) on a product of known rank."""
    n, k = 32768, 30000
    panels = n // NB_32K
    rng = np.random.default_rng(seed + 12)
    B = m4.from_packed(packed(rng, n, k), k)
    C = m4.from_packed(packed(rng, k, n), n)
    A = m4.mul(B, C)
    del B, C
    total = {}
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    syncs, misses = (counted("readback.block_factor"),
                     counted("fallback.block_factor"))
    M, P, Q, r = m4.ple(A)
    torch.cuda.synchronize()
    launched = counts(FACTOR_KERNELS)
    syncs = counted("readback.block_factor") - syncs
    misses = counted("fallback.block_factor") - misses
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rk = m4.rank(A)
    torch.cuda.synchronize()
    add_counts(total, counts(FACTOR_KERNELS))
    check(r == rk == k, f"product of rank {k}: ple says {r}, rank says {rk}")
    check(valid_swaps(P, Q, r, n, n), "ple 32768: P, Q are not swap arrays")
    check(launched["panel_loop_hopper"] == panels + misses
          and launched["panel_post_hopper"] == panels
          and launched["gf2_schur_update_hopper"] == panels - 1
          and launched["gf2_mul_hopper"] == panels - 1
          and launched["unit_tri_inv_hopper"] == panels - 1
          and launched["post_operands_hopper"] == panels,
          f"ple 32768 launched {launched} over {panels} panels")
    t0 = time.perf_counter()
    want = m4.block_factor(A, preserve_l=True, engine="plain")
    plain_m = mask_padding(BitMatrix(
        ple_mod._compress_l_impl(want[0], want[2], want[3], n, n), n))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check(torch.equal(M.data, plain_m.data) and torch.equal(P, want[1])
          and torch.equal(Q, want[2]) and r == want[3],
          "ple 32768 differs from the plain engine")
    del want, plain_m, M
    t = {"ple": time_host_ms(lambda: m4.ple(A), runs=3),
         "rank": time_host_ms(lambda: m4.rank(A), runs=3)}
    emit("ple_32768", ok=True, rank=r, panels=panels, launches=launched,
         host_syncs=syncs, miss_fallbacks=misses, ms=t,
         compared_with_plain_engine=True, plain_engine_seconds=plain_s,
         peak_memory_gb=peak_gb)
    return total


def golden_records(op: str, want: int) -> list:
    golden = HERE / "tests" / "data" / "golden_reference.jsonl"
    recs = [json.loads(ln) for ln in golden.read_text().splitlines()]
    recs = [r for r in recs if r["op"] == op]
    check(len(recs) == want, f"want {want} golden {op} records, found {len(recs)}")
    return recs


def golden_input(rec):
    """The case input, drawn in the reference C library's order."""
    if rec["k"]:
        g = GlibcRandom(17)
        b = reference_random_data(rec["m"], rec["k"], rng=g)
        c = reference_random_data(rec["k"], rec["n"], rng=g)
        A = m4.mul(m4.from_reference(b, rec["k"]),
                   m4.from_reference(c, rec["n"]))
    else:
        A = m4.randomize_reference(rec["m"], rec["n"], seed=17)
    check(fnv1a_bits(m4.to_numpy(A)) == rec["in_hash"],
          f"golden {rec['op']} {rec['kind']}: in_hash")
    return A


def phase_golden_ple() -> dict:
    """The reference C library's own rank, P, Q and L|E body, on the card."""
    recs = golden_records("ple", 8)
    inputs = [golden_input(rec) for rec in recs]
    zero_counts()
    for rec, A in zip(recs, inputs):
        what = f"golden ple {rec['kind']} {rec['m']}x{rec['n']}"
        M, P, Q, r = m4.ple(A)
        check(r == rec["rank"], f"{what}: rank {r}")
        check(P.tolist() == rec["P"], f"{what}: P")
        check(Q.tolist() == rec["Q"], f"{what}: Q")
        check(fnv1a_bits(m4.to_numpy(M)) == rec["out_hash"], f"{what}: out_hash")
    torch.cuda.synchronize()
    got = counts()
    emit("golden_ple", ok=True, records=len(recs), launches=got)
    return got


# ------------------------------------------------------ the solver API ---

# the reference C library on the host CPU, seconds (BASELINE.md)
C_LIBRARY_S = {"pluq_32768": 7.0605, "trsm_lower_right_32768": 24.199,
               "trsm_lower_left_32768": 9.156, "trsm_upper_right_32768": 9.786,
               "trsm_upper_left_32768": 11.002, "rank_rref_16384": 1.2349,
               "invert_16384": 4.6274, "solve_32768_b256": 7.0605}
C_LIBRARY_WHAT = {"pluq_32768": "PLE 32768^2", "solve_32768_b256": "PLE 32768^2",
                  "rank_rref_16384": "M4RI RREF 16384^2",
                  "invert_16384": "inversion 16384^2"}


def unpack_f32(words: torch.Tensor, ncols: int) -> torch.Tensor:
    """0/1 float32 [rows, ncols] of packed words (unpacked here, not by the
    code under test)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :ncols].to(torch.float32)


def pack_parity(p: torch.Tensor) -> torch.Tensor:
    """float32 sums [rows, n] -> packed int32 words of their parities."""
    rows, n = p.shape
    w = (n + 31) // 32
    bits = torch.nn.functional.pad(p.to(torch.int32) & 1, (0, 32 * w - n))
    shifts = torch.arange(32, dtype=torch.int32, device=p.device)
    return (bits.view(rows, w, 32) << shifts).sum(dim=2, dtype=torch.int32)


def f32_product(a: torch.Tensor, k: int, b: torch.Tensor, n: int,
                a_tri: str = "", b_tri: str = "", rows: int = 4096):
    """Packed GF(2) product by a float32 product of the unpacked bits in row
    blocks, TF32 off: exact below 2**24 terms, and independent of the port's
    product paths.  ``a_tri`` / ``b_tri`` ("upper" or "lower") keep only that
    inclusive triangle of a square operand first."""
    bf = unpack_f32(b, n)
    if b_tri:
        bf = bf.triu() if b_tri == "upper" else bf.tril()
    out = []
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for r0 in range(0, a.shape[0], rows):
            af = unpack_f32(a[r0:r0 + rows], k)
            if a_tri:
                af = af.triu(r0) if a_tri == "upper" else af.tril(r0)
            out.append(pack_parity(af @ bf))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return torch.cat(out)


def entry_times(name: str, fn, runs: int = 3) -> dict:
    """Host-clock time of an entry point beside the C library's."""
    t = time_host_ms(fn, runs=runs)
    return {**t, "c_library_ms": C_LIBRARY_S[name] * 1e3,
            "c_library_op": C_LIBRARY_WHAT.get(name, name),
            "speedup_over_c_library": C_LIBRARY_S[name] * 1e3 / t["median"]}


def driven(fn):
    """(result, launches): ``fn`` with every count set to 0 just before."""
    zero_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, counts()


def phase_pluq_32768(seed: int) -> dict:
    """PLUQ of a dense random 32768^2: P, Q and rank are ple's, and the body
    is ple's after the sequential triangular column swaps.  A dense random
    matrix pivots on (nearly) every column, so Q is (nearly) the identity;
    the same input with bands of zero columns moves most pivot columns and
    makes long swap chains, held to the same checks."""
    n = 32768
    rng = np.random.default_rng(seed + 20)
    a = packed(rng, n, n)
    A = m4.from_packed(a, n)
    (M, P, Q, r), launched = driven(lambda: m4.pluq(A))
    w = n // 32
    a[:, w // 25: w // 25 + w // 32] = 0      # columns 1280-2303 at n=32768
    a[:, w // 2] &= 0x0F0F0F0F                # and every other nibble of a word
    Az = m4.from_packed(a, n)
    del a
    outs = {"dense": (A, (M, P, Q, r)), "zeroed_columns": (Az, m4.pluq(Az))}
    cases = {}
    for what, (X, (M, P, Q, r)) in outs.items():
        Me, Pe, Qe, re = m4.ple(X)
        check(r == re and torch.equal(P, Pe) and torch.equal(Q, Qe),
              f"pluq 32768 {what}: P, Q or rank differ from ple's")
        check(valid_swaps(P, Q, r, n, n), f"pluq 32768 {what}: not swap arrays")
        t0 = time.perf_counter()
        want = perm_mod.apply_p_right_trans_tri_seq(Me, Qe)
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
        check(torch.equal(M.data, want.data),
              f"pluq 32768 {what}: the body differs from ple's after the "
              "sequential swaps")
        moved = int((Q != torch.arange(n, dtype=torch.int32, device=DEV)).sum())
        cases[what] = {"rank": r, "pivot_columns_moved": moved,
                       "sequential_oracle_seconds": seq_s}
        del Me, want, M
    check(cases["zeroed_columns"]["pivot_columns_moved"] > n // 2,
          f"the zeroed columns moved few pivots: {cases}")
    t = {"pluq": entry_times("pluq_32768", lambda: m4.pluq(A)),
         "pluq_zeroed_columns": entry_times("pluq_32768", lambda: m4.pluq(Az)),
         "apply_p_right_trans_tri_zeroed_columns": time_host_ms(
             lambda: perm_mod.apply_p_right_trans_tri(Az, outs["zeroed_columns"][1][2]),
             runs=3)}
    emit("pluq_32768", ok=True, launches=launched, cases=cases, ms=t)
    return launched


def phase_pluq_golden() -> dict:
    """The reference C library's own rank, P, Q and L\\U body of mzd_pluq."""
    recs = golden_records("pluq", 8)
    inputs = [golden_input(rec) for rec in recs]
    zero_counts()
    outs = [m4.pluq(A) for A in inputs]
    torch.cuda.synchronize()
    got = counts()
    for rec, (M, P, Q, r) in zip(recs, outs):
        what = f"golden pluq {rec['kind']} {rec['m']}x{rec['n']}"
        check(r == rec["rank"], f"{what}: rank {r}")
        check(P.tolist() == rec["P"] and Q.tolist() == rec["Q"], f"{what}: P, Q")
        check(fnv1a_bits(m4.to_numpy(M)) == rec["out_hash"], f"{what}: out_hash")
    emit("pluq_golden", ok=True, records=len(recs), launches=got)
    return got


def unit_diagonal(words: torch.Tensor) -> torch.Tensor:
    """The square matrix with its diagonal set (the rest kept as junk)."""
    n = words.shape[0]
    idx = torch.arange(n, device=words.device)
    out = words.clone()
    out[idx, idx // 32] |= torch.ones_like(out[:, 0]) << (idx % 32).to(torch.int32)
    return out


def phase_trsm_32768(seed: int) -> dict:
    """The four TRSMs of a random unit triangular T with junk in the other
    triangle and a 32768^2 B: T X == B (left) or X T == B (right) by the
    float32 product."""
    n = 32768
    rng = np.random.default_rng(seed + 21)
    T = m4.from_packed(unit_diagonal(packed(rng, n, n)), n)
    B = m4.from_packed(packed(rng, n, n), n)
    total, report = {}, {}
    for name in ("trsm_upper_left", "trsm_lower_left", "trsm_upper_right",
                 "trsm_lower_right"):
        fn = getattr(m4, name)
        X, launched = driven(lambda: fn(T, B))
        add_counts(total, launched)
        tri = "upper" if "upper" in name else "lower"
        if name.endswith("left"):
            got = f32_product(T.data, n, X.data, n, a_tri=tri)
        else:
            got = f32_product(X.data, n, T.data, n, b_tri=tri)
        check(torch.equal(got, B.data), f"{name} 32768: the product is not B")
        del X, got
        report[name] = {"launches": launched,
                        "ms": entry_times(f"{name}_32768", lambda: fn(T, B))}
    emit("trsm_32768", ok=True, n=n, cases=report,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return total


def same_rref(what: str, E, r: int, ut: torch.Tensor, piv: torch.Tensor):
    """E is the RREF whose rows span those of U_top (``ut``, the r rows of a
    REF of the plain engine, unpacked, pivots ``piv``): rows past the rank
    zero, the pivot columns the identity, and U_rr E == U_top by a float32
    product, TF32 off."""
    ef = unpack_f32(E.data[:r], E.ncols)
    check(not bool(E.data[r:].any()), f"{what}: rows past the rank not zero")
    check(torch.equal(ef[:, piv], torch.eye(r, device=DEV)),
          f"{what}: the pivot columns are not the identity")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        prod = torch.fmod(ut[:, piv] @ ef, 2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    check(torch.equal(prod, ut), f"{what}: U_rr E differs from U_top")


def phase_rank_rref_16384(seed: int) -> dict:
    """RREF of a dense random 16384^2 by both strategies: equal to each
    other, rank(A) pivots, pivot columns the identity, and U_rr E == U_top
    with U_top the REF of the plain engine."""
    n = 16384
    rng = np.random.default_rng(seed + 22)
    A = m4.from_packed(packed(rng, n, n), n)
    total = {}
    (E, r), launched = driven(lambda: m4.echelonize(A, full=True))
    add_counts(total, launched)
    (Ep, rp), launched_p = driven(
        lambda: m4.echelonize(A, full=True, strategy="pluq"))
    add_counts(total, launched_p)
    rk = m4.rank(A)
    check(r == rp == rk, f"rref 16384: ranks {r}, {rp}, rank {rk}")
    check(torch.equal(E.data, Ep.data), "rref 16384: m4ri and pluq differ")
    data, _, q, r_plain = m4.block_factor(A, preserve_l=False, engine="plain")
    check(r_plain == r, f"rref 16384: the plain engine's rank is {r_plain}")
    same_rref("rref 16384", E, r, unpack_f32(data[:r], n), q[:r].long())
    del data, Ep
    t = {"echelonize_m4ri": entry_times(
             "rank_rref_16384", lambda: m4.echelonize(A, full=True)),
         "echelonize_pluq": entry_times(
             "rank_rref_16384",
             lambda: m4.echelonize(A, full=True, strategy="pluq"))}
    emit("rank_rref_16384", ok=True, rank=r, launches={
        "m4ri": launched, "pluq": launched_p}, ms=t)
    return total


def phase_invert_16384(seed: int) -> dict:
    """The inverse of a product of random unit lower and upper factors:
    A A^-1 == I by the float32 product, rank n; a singular 4096^2 gives a
    rank below n."""
    n = 16384
    rng = np.random.default_rng(seed + 23)
    full = unit_diagonal(packed(rng, n, n))
    L = m4.from_packed(full, n)
    U = m4.from_packed(unit_diagonal(packed(rng, n, n)), n)
    A = m4.mul(m4.extract_l(L), m4.extract_u(U))
    del full, L, U
    (Ai, r), launched = driven(lambda: m4.invert(A))
    check(r == n, f"invert 16384: rank {r}")
    eye = m4.identity(n).data
    check(torch.equal(f32_product(A.data, n, Ai.data, n), eye),
          "invert 16384: A A^-1 is not the identity")
    del Ai, eye
    s = 4096
    S = packed(rng, s, s)
    S[5] = S[3]
    (Si, rs), launched_s = driven(lambda: m4.invert(m4.from_packed(S, s)))
    check(rs < s, f"invert: a singular {s}^2 gave rank {rs}")
    total = {}
    add_counts(total, launched)
    add_counts(total, launched_s)
    emit("invert_16384", ok=True, rank=r, singular_4096_rank=rs,
         launches=launched, ms=entry_times("invert_16384", lambda: m4.invert(A)))
    return total


def phase_solve_32768_b256(seed: int) -> dict:
    """A X = B with B = A X0 on a dense random 32768^2: consistent, and
    A X == B by the float32 product; an inconsistent system at 4096 says so."""
    n, bc = 32768, 256
    rng = np.random.default_rng(seed + 24)
    A = m4.from_packed(packed(rng, n, n), n)
    X0 = packed(rng, n, bc)
    B = m4.from_packed(f32_product(A.data, n, X0, bc), bc)
    ((X, ok), launched) = driven(lambda: m4.solve_left(A, B))
    check(bool(ok), "solve 32768: the consistent system was found inconsistent")
    check(torch.equal(f32_product(A.data, n, X.data, bc), B.data),
          "solve 32768: A X differs from B")
    s, k = 4096, 2000
    low = m4.from_packed(f32_product(packed(rng, s, k), k, packed(rng, k, s), s), s)
    b1 = m4.from_packed(packed(rng, s, 1), 1)
    ((_, ok1), launched_1) = driven(lambda: m4.solve_left(low, b1))
    check(not bool(ok1), "solve 4096: a right-hand side outside the column "
          "space of a rank-2000 matrix was found consistent")
    total = {}
    add_counts(total, launched)
    add_counts(total, launched_1)
    emit("solve_32768_b256", ok=True, launches=launched,
         ms=entry_times("solve_32768_b256", lambda: m4.solve_left(A, B)))
    return total


def phase_kernel_left(seed: int) -> dict:
    """The right kernel of a 4096^2 of rank about 3000: A X == 0, n - r
    columns, and each free column's unit diagonal."""
    n, k = 4096, 3000
    rng = np.random.default_rng(seed + 25)
    A = m4.from_packed(f32_product(packed(rng, n, k), k, packed(rng, k, n), n), n)
    ((X, count), launched) = driven(lambda: m4.kernel_left(A))
    r = m4.rank(A)
    check(count == n - r, f"kernel_left: count {count}, rank {r}")
    check(not bool(f32_product(A.data, n, X.data, n).any()),
          "kernel_left: A X is not zero")
    x = m4.to_numpy(X)
    free = np.nonzero(x.any(axis=0))[0]
    check(len(free) == count and all(x[j, j] == 1 for j in free),
          "kernel_left: the free columns do not hold their unit diagonal")
    emit("kernel_left_4096", ok=True, rank=r, count=count, launches=launched,
         ms=time_host_ms(lambda: m4.kernel_left(A), runs=3))
    return launched


def phase_rref_golden() -> dict:
    """The reference C library's RREF hash and rank of mzd_echelonize."""
    recs = golden_records("rref", 8)
    inputs = [golden_input(rec) for rec in recs]
    zero_counts()
    outs = [m4.echelonize(A, full=True) for A in inputs]
    torch.cuda.synchronize()
    got = counts()
    for rec, (E, r) in zip(recs, outs):
        what = f"golden rref {rec['kind']} {rec['m']}x{rec['n']}"
        check(r == rec["rank"], f"{what}: rank {r}")
        check(fnv1a_bits(m4.to_numpy(E)) == rec["out_hash"], f"{what}: out_hash")
    emit("rref_golden", ok=True, records=len(recs), launches=got)
    return got


# ------------------------------------------------ the M4RI user surface ---

def on_card(what: str, *items) -> None:
    """Every matrix (or tensor) a phase got back lies on the card."""
    for x in items:
        t = x.data if isinstance(x, BitMatrix) else x
        check(isinstance(t, torch.Tensor) and t.is_cuda,
              f"{what}: a result is not on the card")


def freivalds(A, B, C, n: int, seed: int, cols: int = 64) -> None:
    """C == A B on 64 random columns X: C X == A (B X), each product a
    float32 product of the unpacked bits in 4096-row blocks, TF32 off."""
    X = packed(np.random.default_rng(seed), n, cols)
    lhs = f32_product(C.data, n, X, cols)
    rhs = f32_product(A.data, n, f32_product(B.data, n, X, cols), cols)
    check(torch.equal(lhs, rhs), f"Freivalds: C X != A (B X) at n={n}")


def phase_m4rm_4096(seed: int) -> dict:
    """mul_m4rm 4096^3 with the table width it picks (9) and with k = 8,
    and addmul_m4rm on a random C: word for word the GEMM kernel's product
    and the float32 product."""
    n = 4096
    rng = np.random.default_rng(seed + 30)
    A, B, C = (m4.from_packed(packed(rng, n, n), n) for _ in range(3))
    k = min(opt_k(n, n, n), 12)
    got, launched = driven(lambda: m4.mul_m4rm(A, B))
    got8 = m4.mul_m4rm(A, B, 8)
    got_add = m4.addmul_m4rm(C, A, B)
    on_card("m4rm 4096", got, got8, got_add)
    zero_counts()
    want = m4.mul(A, B)
    torch.cuda.synchronize()
    check(gemm_counts()["gf2_mul_hopper_v2"] == 1, "mul 4096 took no kernel")
    check(torch.equal(want.data, f32_product(A.data, n, B.data, n)),
          "mul 4096 differs from the float32 product")
    for what, x in ((f"k={k}", got), ("k=8", got8)):
        check(torch.equal(x.data, want.data), f"mul_m4rm 4096 ({what}) differs")
    check(torch.equal(got_add.data, C.data ^ want.data),
          "addmul_m4rm 4096 differs")
    emit("m4rm_4096", ok=True, n=n, k=k, launches=launched,
         ms={"mul_m4rm": time_ms(lambda: m4.mul_m4rm(A, B), runs=5, warmup=1),
             "mul_m4rm_k8": time_ms(lambda: m4.mul_m4rm(A, B, 8), runs=5,
                                    warmup=1),
             "addmul_m4rm": time_ms(lambda: m4.addmul_m4rm(C, A, B), runs=5,
                                    warmup=1),
             "mul": time_ms(lambda: m4.mul(A, B))}, **bound(n, n, n))
    return launched


def phase_m4rm_16384(seed: int) -> dict:
    """mul_m4rm 16384^3 (k = 11): word for word the GEMM kernel's product,
    and Freivalds by the float32 product."""
    n = 16384
    rng = np.random.default_rng(seed + 31)
    A, B = (m4.from_packed(packed(rng, n, n), n) for _ in range(2))
    k = min(opt_k(n, n, n), 12)
    got, launched = driven(lambda: m4.mul_m4rm(A, B))
    on_card("m4rm 16384", got)
    check(torch.equal(got.data, m4.mul(A, B).data),
          "mul_m4rm 16384 differs from mul")
    freivalds(A, B, got, n, seed + 32)
    del got
    emit("m4rm_16384", ok=True, n=n, k=k, launches=launched,
         ms={"mul_m4rm": time_host_ms(lambda: m4.mul_m4rm(A, B), runs=2),
             "mul": time_ms(lambda: m4.mul(A, B), runs=5, warmup=1)},
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         **bound(n, n, n))
    return launched


def phase_djb_512(seed: int) -> dict:
    """The XOR program of a dense random 512^2 (compiled on the host), then
    applied on the card to 65,536 input vectors, the columns of a
    512 x 65536 V: word for word mul(A, V) and the float32 product."""
    n, cols = 512, 65536
    rng = np.random.default_rng(seed + 33)
    A = m4.from_packed(packed(rng, n, n), n)
    V = m4.from_packed(packed(rng, n, cols), cols)
    t0 = time.perf_counter()
    prog = m4.djb_compile(A)
    compile_ms = (time.perf_counter() - t0) * 1e3
    W, launched = driven(lambda: m4.djb_apply(prog, V))
    on_card("djb_apply", W)
    check(torch.equal(W.data, f32_product(A.data, n, V.data, cols)),
          "djb_apply differs from the float32 product")
    check(torch.equal(W.data, m4.mul(A, V).data), "djb_apply differs from mul")
    emit("djb_512", ok=True, n=n, vectors=cols, program_length=prog.length,
         launches=launched, compile_host_ms=compile_ms,
         ms={"djb_apply": time_host_ms(lambda: m4.djb_apply(prog, V), runs=2,
                                       warmup=0),
             "mul": time_ms(lambda: m4.mul(A, V), runs=5, warmup=1)})
    return launched


def png_header(path: str) -> tuple:
    """(width, height, bit depth, colour type) of a PNG, parsed by hand:
    the signature, then the IHDR chunk's length, tag and fields."""
    with open(path, "rb") as fh:
        head = fh.read(26)
    check(head[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: no PNG signature")
    check(int.from_bytes(head[8:12], "big") == 13 and head[12:16] == b"IHDR",
          f"{path}: the first chunk is not a 13-byte IHDR")
    return (int.from_bytes(head[16:20], "big"),
            int.from_bytes(head[20:24], "big"), head[24], head[25])


def phase_io_16384(seed: int) -> dict:
    """npz and PNG round trips of a dense random 16384^2 from the card, JCF
    of a sparse 16384^2 (density 2^-10), and info with the rank; each file
    read back onto the card with equal words.  The files go to a temporary
    directory under the checkout's build directory."""
    from m4ri_tpu_torch.utils import io
    n = 16384
    rng = np.random.default_rng(seed + 34)
    A = m4.from_packed(packed(rng, n, n), n)
    pos = np.unique(rng.integers(0, n * n, n * n >> 10))
    dense_s = np.zeros((n, n), np.uint8)
    dense_s.reshape(-1)[pos] = 1
    S = m4.from_numpy(dense_s)
    del dense_s
    ms, sizes = {}, {}
    build = HERE / "m4ri_tpu_torch" / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        for fmt, M, write, read in (
                ("npz", A, io.save_npz, io.load_npz),
                ("png", A, io.write_png, io.read_png),
                ("jcf", S, io.to_jcf, io.from_jcf)):
            path = os.path.join(tmp, f"m.{fmt}")
            t0 = time.perf_counter()
            write(M, path)
            t1 = time.perf_counter()
            back = read(path)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            on_card(f"read {fmt}", back)
            check(back.ncols == M.ncols and torch.equal(back.data, M.data),
                  f"{fmt} round trip of a 16384^2 changed the words")
            ms[fmt] = {"write": (t1 - t0) * 1e3, "read": (t2 - t1) * 1e3}
            sizes[fmt] = os.path.getsize(path)
            if fmt == "png":
                head = png_header(path)
                check(head == (n, n, 1, 0), f"PNG header {head}")
            del back
    t0 = time.perf_counter()
    text = io.info(A, compute_rank=True)
    ms["info_rank"] = (time.perf_counter() - t0) * 1e3
    r = m4.rank(A)
    check(text.startswith(f"{n} x {n} matrix") and text.endswith(f", rank {r}"),
          f"info says {text!r}, rank {r}")
    emit("io_16384", ok=True, n=n, sparse_ones=len(pos), ms=ms,
         file_bytes=sizes, info=text)
    return {}


def phase_native_2048(seed: int) -> dict:
    """The native C++ oracle, built with g++: its naive product and full
    echelon form of 2048^2 word for word the port's on the card, its glibc
    stream the port's."""
    from m4ri_tpu_torch.native import build as native
    n = 2048
    t0 = time.perf_counter()
    lib = native.load()
    build_s = time.perf_counter() - t0
    check(lib is not None, "the native gf2core library did not build with g++")
    rng = np.random.default_rng(seed + 35)
    A, B = (m4.from_packed(packed(rng, n, n), n) for _ in range(2))
    a_np, b_np = (x.data.cpu().numpy() for x in (A, B))
    t0 = time.perf_counter()
    c = native.native_mul(a_np, b_np, n, n)
    t1 = time.perf_counter()
    e, r = native.native_echelonize(a_np, n, full=True)
    t2 = time.perf_counter()
    (C, (E, rE)), launched = driven(lambda: (m4.mul(A, B),
                                             m4.echelonize(A, full=True)))
    on_card("native_2048", C, E)
    check(torch.equal(C.data, m4.from_packed(c, n).data),
          "mul 2048 differs from the native product")
    check(r == rE, f"native rank {r}, the port's {rE}")
    check(torch.equal(E.data, m4.from_packed(e, n).data),
          "echelonize 2048 differs from the native echelon form")
    d = native.native_randomize(n, n, seed=17)
    check(np.array_equal(d, reference_random_data(n, n, seed=17)),
          "native_randomize differs from the glibc stream of utils/rng.py")
    R = m4.randomize_reference(n, n, seed=17)
    on_card("randomize_reference", R)
    check(torch.equal(R.data, m4.from_packed(d, n).data),
          "randomize_reference differs from native_randomize")
    emit("native_2048", ok=True, n=n, rank=r, build_s=build_s,
         native_ms={"mul": (t1 - t0) * 1e3, "echelonize": (t2 - t1) * 1e3},
         launches=launched)
    return launched


# (compat name, its arguments from a dict of inputs) for every compat name
# that returns a matrix, called once at 1024 on the card and on a host copy
COMPAT_SWEEP = [
    ("mzd_copy", lambda g: (None, g["A"])),
    ("mzd_transpose", lambda g: (None, g["A"])),
    ("mzd_stack", lambda g: (None, g["A"], g["B"])),
    ("mzd_concat", lambda g: (None, g["A"], g["B"])),
    ("mzd_submatrix", lambda g: (None, g["A"], 3, 5, 1000, 1019)),
    ("mzd_init_window", lambda g: (g["A"], 1, 33, 1024, 1000)),
    ("mzd_init_window_const", lambda g: (g["A"], 0, 0, 512, 512)),
    ("mzd_set_ui", lambda g: (g["A"], 1)),
    ("mzd_randomize_custom", lambda g: (g["A"], GlibcRandom(5).random_word)),
    ("mzd_write_bit", lambda g: (g["A"], 3, 31, 1)),
    ("mzd_xor_bits", lambda g: (g["A"], 7, 100, 64, 0xFEDCBA9876543210)),
    ("mzd_and_bits", lambda g: (g["A"], 8, 31, 40, 0x80000000FF)),
    ("mzd_clear_bits", lambda g: (g["A"], 9, 63, 64)),
    ("mzd_row_swap", lambda g: (g["A"], 0, 1023)),
    ("mzd_col_swap", lambda g: (g["A"], 0, 1023)),
    ("mzd_col_swap_in_rows", lambda g: (g["A"], 5, 900, 100, 700)),
    ("mzd_row_add", lambda g: (g["A"], 4, 9)),
    ("mzd_row_add_offset", lambda g: (g["A"], 9, 4, 77)),
    ("mzd_extract_u", lambda g: (None, g["A"])),
    ("mzd_extract_l", lambda g: (None, g["A"])),
    ("mzd_add", lambda g: (None, g["A"], g["B"])),
    ("mzd_sub", lambda g: (g["A"], g["B"])),
    ("mzd_mul", lambda g: (None, g["A"], g["B"], 0)),
    ("mzd_addmul", lambda g: (g["C"], g["A"], g["B"], 0)),
    ("mzd_mul_naive", lambda g: (None, g["A"], g["X"])),
    ("mzd_addmul_naive", lambda g: (g["Y"], g["A"], g["X"])),
    ("mzd_mul_m4rm", lambda g: (None, g["A"], g["B"], 0)),
    ("mzd_addmul_m4rm", lambda g: (g["C"], g["A"], g["B"], 0)),
    ("mzd_mul_va", lambda g: (g["v"], g["v"], g["A"], False)),
    ("mzd_echelonize", lambda g: (g["A"], True)),
    ("mzd_echelonize_m4ri", lambda g: (g["A"], False)),
    ("mzd_echelonize_pluq", lambda g: (g["A"], True)),
    ("mzd_echelonize_naive", lambda g: (g["A"], True)),
    ("mzd_gauss_delayed", lambda g: (g["A"], 100, False)),
    ("mzd_top_echelonize_m4ri", lambda g: (g["A"], 0)),
    ("mzd_ple", lambda g: (g["A"],)),
    ("mzd_pluq", lambda g: (g["A"],)),
    ("mzd_inv_m4ri", lambda g: (None, g["U"], 0)),
    ("mzd_invert_naive", lambda g: (None, g["U"])),
    ("mzd_solve_left", lambda g: (g["A"], g["X"])),
    ("mzd_pluq_solve_left", lambda g: (g["pluq"][0], g["pluq"][3],
                                       g["pluq"][1], g["pluq"][2], g["X"])),
    ("mzd_kernel_left_pluq", lambda g: (g["A"],)),
    ("mzd_trsm_upper_left", lambda g: (g["U"], g["X"])),
    ("mzd_trsm_lower_left", lambda g: (g["L"], g["X"])),
    ("mzd_trsm_upper_right", lambda g: (g["U"], g["XT"])),
    ("mzd_trsm_lower_right", lambda g: (g["L"], g["XT"])),
    ("mzd_trtri_upper", lambda g: (g["U"],)),
    ("mzd_trtri_upper_russian", lambda g: (g["U"],)),
    ("mzd_apply_p_left", lambda g: (g["A"], g["p"])),
    ("mzd_apply_p_left_trans", lambda g: (g["A"], g["p"])),
    ("mzd_apply_p_right", lambda g: (g["A"], g["p"])),
    ("mzd_apply_p_right_trans", lambda g: (g["A"], g["p"])),
    ("mzd_apply_p_right_trans_tri", lambda g: (g["A"], g["pluq"][2])),
    ("mzd_apply_p_right_even_capped", lambda g: (g["A"], g["p"], 300, 0)),
    ("mzd_apply_p_right_trans_even_capped", lambda g: (g["A"], g["p"], 700, 0)),
    ("mzd_copy_row", lambda g: (g["A"], 5, g["B"], 6)),
    ("mzd_row_clear_offset", lambda g: (g["A"], 5, 300)),
    ("mzd_combine", lambda g: (g["A"], 3, 0, g["A"], 1, 0, g["B"], 2, 0)),
    ("mzd_combine_even", lambda g: (g["A"], 3, 4, g["B"], 1, 4, g["C"], 2, 4)),
    ("mzd_combine_even_in_place", lambda g: (g["A"], 0, 1, g["B"], 7, 1)),
    ("mzd_make_table", lambda g: (g["A"], 0, 0, 8)),
    ("mzd_process_rows", lambda g: (g["A"], 8, 1024, 0, 8, *g["table"])),
    ("mzd_process_rows2", lambda g: (g["A"], 16, 1024, 0, 8, *g["table"] * 2)),
    ("mzd_process_rows3", lambda g: (g["A"], 24, 1024, 0, 8, *g["table"] * 3)),
    ("mzd_process_rows4", lambda g: (g["A"], 32, 1024, 0, 8, *g["table"] * 4)),
    ("mzd_process_rows5", lambda g: (g["A"], 40, 1024, 0, 8, *g["table"] * 5)),
    ("mzd_process_rows6", lambda g: (g["A"], 48, 1024, 0, 8, *g["table"] * 6)),
    ("djb_apply", lambda g: (g["prog"], g["W"])),
    ("djb_apply_mzd", lambda g: (g["prog"], None, g["W"])),
]


def compat_inputs(rng, n: int) -> tuple[dict, dict]:
    """The sweep's inputs on the card, and the same on the host."""
    from m4ri_tpu_torch import compat
    words = {"A": packed(rng, n, n), "B": packed(rng, n, n),
             "C": packed(rng, n, n), "X": packed(rng, n, 256),
             "Y": packed(rng, n, 256), "XT": packed(rng, 256, n),
             "v": packed(rng, 1, n), "W": packed(rng, 128, 4096)}
    ncols = {"X": 256, "Y": 256, "W": 4096}
    up = unit_diagonal(packed(rng, n, n))
    p = torch.from_numpy(rng.integers(np.arange(n), n).astype(np.int32))
    prog = m4.djb_compile(m4.from_packed(packed(rng, 128, 128), 128))
    sides = []
    for dev in (DEV, torch.device("cpu")):
        g = {k: m4.from_packed(w.to(dev), ncols.get(k, n), device=dev)
             for k, w in words.items()}
        U = m4.extract_u(m4.from_packed(up.to(dev), n, device=dev))
        g.update(U=U, L=m4.transpose(U), p=p.to(dev), prog=prog,
                 pluq=compat.mzd_pluq(g["A"]),
                 table=compat.mzd_make_table(g["A"], 0, 0, 8))
        sides.append(g)
    return sides[0], sides[1]


def same_on_card_and_host(what: str, got, want) -> None:
    """A result on the card equals the host's, item for item."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    check(len(got) == len(want), f"{what}: {len(got)} results, {len(want)} on the host")
    for g, w in zip(got, want):
        if isinstance(g, (BitMatrix, torch.Tensor)):
            on_card(what, g)
            gd, wd = (x.data if isinstance(x, BitMatrix) else x for x in (g, w))
            check(getattr(g, "ncols", 0) == getattr(w, "ncols", 0)
                  and torch.equal(gd.cpu(), wd), f"{what}: card and host differ")
        else:
            check(g == w, f"{what}: {g} on the card, {w} on the host")


def phase_compat_program(seed: int) -> dict:
    """tests/test_compat.py::test_reference_style_program at 8192^2 through
    the compat names, held to the port's own entry points word for word
    and to checks outside them: the glibc stream to the native library,
    the products by Freivalds, the echelon form and the PLE factors to the
    plain engine, the solve and the inverse to the float32 product; then
    every compat name that returns a matrix once at 1024, on the card and
    on a host copy.  Only the compat calls are counted."""
    from m4ri_tpu_torch import compat as c
    from m4ri_tpu_torch.native import build as native
    n = 8192
    ms, launched = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        add_counts(launched, counts())
        return out

    c.m4ri_srandom(17)
    A = timed("mzd_randomize", lambda: c.mzd_randomize(c.mzd_init(n, n)))
    B = timed("mzd_randomize_b", lambda: c.mzd_randomize(c.mzd_init(n, n)))
    C = timed("mzd_mul", lambda: c.mzd_mul(None, A, B, 0))
    C3 = timed("mzd_mul_m4rm", lambda: c.mzd_mul_m4rm(None, A, B, 0))
    E, r = timed("mzd_echelonize",
                 lambda: c.mzd_echelonize(c.mzd_copy(None, A), full=True))
    M, P, Q, rr = timed("mzd_ple", lambda: c.mzd_ple(c.mzd_copy(None, A)))
    X, ok = timed("mzd_solve_left", lambda: c.mzd_solve_left(A, C, 0, 1))
    U = m4.extract_u(m4.from_packed(
        unit_diagonal(packed(np.random.default_rng(seed + 36), n, n)), n))
    T = m4.mul(m4.transpose(U), U)
    inv = timed("mzd_inv_m4ri", lambda: c.mzd_inv_m4ri(None, T, 0))
    on_card("compat program", A, B, C, C3, E, M, P, Q, X, ok, inv)
    stream = native.native_randomize(2 * n, n, seed=17)
    check(stream is not None and torch.equal(
        torch.cat([A.data, B.data]), m4.from_packed(stream, n).data),
        "mzd_randomize after m4ri_srandom(17) is not the glibc stream")
    check(torch.equal(C.data, m4.mul(A, B).data), "mzd_mul differs from mul")
    check(torch.equal(C3.data, C.data), "mzd_mul_m4rm differs from mzd_mul")
    freivalds(A, B, C, n, seed + 40)
    E2, r2 = m4.echelonize(A, full=True, strategy="heuristic")
    check(r == r2 == m4.rank(A) and torch.equal(E.data, E2.data),
          "mzd_echelonize differs from echelonize")
    want = m4.ple(A)
    check(rr == r and torch.equal(M.data, want[0].data)
          and torch.equal(P, want[1]) and torch.equal(Q, want[2]),
          "mzd_ple differs from ple")
    # the plain engine's factors with L kept: its REF rows are those rows
    # with L (below the diagonal of the pivot columns) cleared
    data, Pp, Qp, r_plain = m4.block_factor(A, preserve_l=True, engine="plain")
    check(r_plain == r, f"compat 8192: the plain engine's rank is {r_plain}")
    check(torch.equal(P, Pp) and torch.equal(Q, Qp),
          "mzd_ple: P or Q differs from the plain engine")
    check(valid_swaps(P, Q, r, n, n), "mzd_ple: P, Q are not swap arrays")
    plain_m = mask_padding(BitMatrix(
        ple_mod._compress_l_impl(data, Qp, r_plain, n, n), n))
    check(torch.equal(M.data, plain_m.data),
          "mzd_ple: the compressed body differs from the plain engine's")
    piv = Qp[:r].long()
    ut = unpack_f32(data[:r], n)
    ut[:, piv] = ut[:, piv].triu()
    same_rref("mzd_echelonize 8192", E, r, ut, piv)
    del data, plain_m, ut
    check(bool(ok), "mzd_solve_left: A X = A B was found inconsistent")
    check(torch.equal(f32_product(A.data, n, X.data, n), C.data),
          "mzd_solve_left: A X differs from C")
    check(torch.equal(f32_product(T.data, n, inv.data, n), m4.identity(n).data),
          "mzd_inv_m4ri: T T^-1 is not the identity")
    del A, B, C, C3, E, E2, M, P, Q, X, U, T, inv, want
    t0 = time.perf_counter()
    card, host = compat_inputs(np.random.default_rng(seed + 37), 1024)
    for name, args in COMPAT_SWEEP:
        same_on_card_and_host(name, getattr(c, name)(*args(card)),
                              getattr(c, name)(*args(host)))
    c.m4ri_srandom(5)
    R = c.mzd_randomize(card["A"])
    c.m4ri_srandom(5)
    same_on_card_and_host("mzd_randomize", R, c.mzd_randomize(host["A"]))
    for name, args in (("mzd_init", (300, 1000)), ("mzp_init", (1000,)),
                       ("mzd_from_str", (2, 3, "101010"))):
        on_card(name, getattr(c, name)(*args))
    emit("compat_program", ok=True, n=n, rank=r, launches=launched, ms=ms,
         sweep_names=len(COMPAT_SWEEP) + 4, sweep_n=1024,
         sweep_s=time.perf_counter() - t0)
    return launched


def phase_mul_65536(seed: int) -> dict:
    """mul of two dense random 65536^2 (one Strassen level over 32768
    bases, the card's default): Freivalds on 64 random columns by the
    float32 product in 4096-row blocks, TF32 off (exact: 65536 < 2^24
    terms)."""
    n = 65536
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 38)
    A, B = (m4.randomize(n, n, gen) for _ in range(2))
    C, launched = driven(lambda: m4.mul(A, B))
    on_card("mul 65536", C)
    check(launched["gf2_mul_hopper_v2"] == 7,
          f"mul 65536 launched {launched}, want one Strassen level of 7")
    freivalds(A, B, C, n, seed + 39)
    del C
    t = time_ms(lambda: m4.mul(A, B), runs=5, warmup=1)
    emit("mul_65536", ok=True, n=n, launches=launched, ms=t,
         tbitops_per_s=2 * n**3 / t["median"] / 1e9,
         strassen_cutoff=get_config().strassen_cutoff,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         **bound(n, n, n))
    return launched


# ------------------------------------------------ the multi-device layer ---

# the kernels the distributed path runs: rows 1, 2 and 5 of PERF.md's table
DIST_KERNELS = ("gf2_mul_hopper", "gf2_mul_hopper_v2", "panel_loop_hopper")
TRSMS = ("trsm_upper_left", "trsm_lower_left", "trsm_upper_right",
         "trsm_lower_right")


def lead_columns(words: torch.Tensor) -> torch.Tensor:
    """The column of each (nonzero) row's first set bit."""
    w = (words != 0).to(torch.uint8).argmax(dim=1)
    x = words.gather(1, w[:, None])[:, 0]
    low = x & -x                                     # the lowest set bit
    one = torch.ones(32, dtype=torch.int32, device=words.device)
    bit = (low[:, None] == one << torch.arange(32, dtype=torch.int32,
                                               device=words.device))
    return w.long() * 32 + bit.to(torch.uint8).argmax(dim=1)


def same_echelon(what: str, E, r: int, A) -> None:
    """E is a REF of A of rank r: rows past r zero, the leading columns of
    the others increasing, and its RREF is the single-device RREF of A."""
    check(not bool(E.data[r:].any()), f"{what}: rows past the rank not zero")
    check(bool((E.data[:r] != 0).any(dim=1).all()), f"{what}: a zero row")
    lead = lead_columns(E.data[:r])
    check(bool((lead[1:] > lead[:-1]).all()),
          f"{what}: leading columns do not increase")
    (Re, re), (Ra, ra) = m4.echelonize(E, full=True), m4.echelonize(A, full=True)
    check(re == ra == r and torch.equal(Re.data, Ra.data),
          f"{what}: its RREF is not the RREF of the input")


def same_words(what: str, got, want) -> None:
    """Word for word: matrices, index arrays, ranks and flags."""
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(g, BitMatrix):
            g, w = g.data, w.data
        if isinstance(g, torch.Tensor):
            ok = g.shape == w.shape and torch.equal(g, w.to(g.device))
        else:
            ok = g == w
        check(ok, f"{what}: output {i} differs from the single-device entry "
              "point's")


def dist_case(name: str, cases: dict, total: dict, dist_fn, single_fn,
              runs: int, **more):
    """Run the distributed call with the counts set to 0 just before, then
    the single-device entry point; both outputs are returned.  Both are
    timed (host clock ended by a synchronize): ``runs`` calls after these
    first ones, or with ``runs=1`` these first calls themselves (the slow
    host-bound ones)."""
    misses = counted("fallback.dist_block_factor")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, launched = driven(dist_fn)
    t1 = time.perf_counter()
    add_counts(total, launched)
    misses = counted("fallback.dist_block_factor") - misses
    want = single_fn()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if runs == 1:
        ms = [{"median": t * 1e3, "min": t * 1e3, "max": t * 1e3, "runs": 1,
               "first_call": True} for t in (t1 - t0, t2 - t1)]
    else:
        ms = [time_host_ms(fn, runs, warmup=0) for fn in (dist_fn, single_fn)]
    cases[name] = {"launches": launched, "miss_fallbacks": misses,
                   "dist_ms": ms[0], "single_device_ms": ms[1], **more}
    return got, want


def phase_dist_nccl_1rank(seed: int) -> dict:
    """The distributed path on an NCCL group of one rank in this process:
    make_mesh() starts it (mesh 1 x 1, degenerate collectives through a real
    communicator).  At the sizes of VERIFY_r05.json, on the inputs of the
    phases above, each output word for word the single-device entry
    point's, and both timed: what the distributed path costs over the
    single-device one."""
    check(not dist.is_initialized(), "a process group is already running")
    mesh = mesh_mod.make_mesh()
    try:
        check(dist.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1),
              f"make_mesh() gave {mesh} on {dist.get_backend()}")
        return _dist_nccl_cases(seed, mesh)
    finally:
        dist.destroy_process_group()


def _dist_nccl_cases(seed: int, mesh) -> dict:
    total, cases = {}, {}
    staged = counted("host_staged_collectives")
    n = 16384
    rng = np.random.default_rng(seed + 40)
    A = m4.from_packed(packed(rng, n, n), n)
    B = m4.from_packed(packed(rng, n, n), n)
    for name, fn in (("mul_dist", mul_dist), ("mul_dist_ksplit", mul_dist_ksplit)):
        got, want = dist_case(f"{name}_16384", cases, total,
                              lambda: fn(A, B, mesh), lambda: m4.mul(A, B), 5)
        same_words(f"{name} 16384", [got], [want])
    del A, B, got, want

    # the ple_32768 input: a product of rank 30000, at ple's panel width
    n, k = 32768, 30000
    rng = np.random.default_rng(seed + 12)
    B = m4.from_packed(packed(rng, n, k), k)
    C = m4.from_packed(packed(rng, k, n), n)
    A = m4.mul(B, C)
    del B, C
    got, want = dist_case("dist_ple_32768", cases, total,
                          lambda: dist_ple(A, mesh, nb=1024, window=1088),
                          lambda: m4.ple(A), 3, rank=k)
    check(got[3] == k, f"dist_ple 32768: rank {got[3]}")
    same_words("dist_ple 32768", got, want)
    del A, got, want

    # the rank_rref_16384 input: dense random
    n = 16384
    A = m4.from_packed(packed(np.random.default_rng(seed + 22), n, n), n)
    r, rk = dist_case("dist_rank_16384", cases, total,
                      lambda: dist_rank(A, mesh), lambda: m4.rank(A), 1)
    check(r == rk, f"dist_rank 16384: {r}, rank {rk}")
    (E, re), _ = dist_case("dist_echelonize_16384", cases, total,
                           lambda: dist_echelonize(A, mesh),
                           lambda: m4.echelonize(A, full=False), 1)
    check(re == r, f"dist_echelonize 16384: rank {re}, dist_rank {r}")
    same_echelon("dist_echelonize 16384", E, r, A)
    cases["dist_rank_16384"]["rank"] = r
    del A, E

    # the four TRSMs: a random unit triangular T with junk in the other
    # triangle, and a 16384^2 B
    rng = np.random.default_rng(seed + 21)
    T = m4.from_packed(unit_diagonal(packed(rng, n, n)), n)
    B = m4.from_packed(packed(rng, n, n), n)
    for name in TRSMS:
        dist_fn, fn = getattr(dist_solve, "dist_" + name), getattr(m4, name)
        got, want = dist_case(f"dist_{name}_16384", cases, total,
                              lambda: dist_fn(T, B, mesh), lambda: fn(T, B), 3)
        same_words(f"dist_{name} 16384", [got], [want])
    del T, B, got, want

    # the solve_32768_b256 input: B = A X0, at solve_left's panel width
    n, bc = 32768, 256
    rng = np.random.default_rng(seed + 24)
    A = m4.from_packed(packed(rng, n, n), n)
    B = m4.from_packed(f32_product(A.data, n, packed(rng, n, bc), bc), bc)
    got, want = dist_case(
        "dist_solve_left_32768_b256", cases, total,
        lambda: dist_solve.dist_solve_left(A, B, mesh, nb=1024, window=1088),
        lambda: m4.solve_left(A, B), 1)
    check(bool(got[1]) and bool(want[1]), "dist_solve_left 32768: inconsistent")
    same_words("dist_solve_left 32768", [got[0]], [want[0]])
    del A, B, got, want

    # the invert_16384 input: unit lower times unit upper
    n = 16384
    rng = np.random.default_rng(seed + 23)
    L = m4.from_packed(unit_diagonal(packed(rng, n, n)), n)
    U = m4.from_packed(unit_diagonal(packed(rng, n, n)), n)
    A = m4.mul(m4.extract_l(L), m4.extract_u(U))
    del L, U
    got, want = dist_case(
        "dist_invert_16384", cases, total,
        lambda: dist_solve.dist_invert(A, mesh, nb=512, window=576),
        lambda: m4.invert(A), 1)
    check(got[1] == n, f"dist_invert 16384: rank {got[1]}")
    same_words("dist_invert 16384", got, want)
    del A, got, want

    # the kernel_left input: 4096^2 of rank 3000
    n, k = 4096, 3000
    rng = np.random.default_rng(seed + 25)
    A = m4.from_packed(f32_product(packed(rng, n, k), k, packed(rng, k, n), n), n)
    got, want = dist_case(
        "dist_kernel_left_4096", cases, total,
        lambda: dist_solve.dist_kernel_left(A, mesh, nb=512, window=576),
        lambda: m4.kernel_left(A), 3)
    same_words("dist_kernel_left 4096", got, want)
    for name in DIST_KERNELS:
        check(total.get(name, 0) > 0, f"the 1-rank distributed path never "
              f"launched {name}")
    emit("dist_nccl_1rank", ok=True, backend="nccl", world=1, mesh=[1, 1],
         cases=cases, launches=total,
         host_staged_collectives=counted("host_staged_collectives") - staged,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return total


def gloo_input(seed: int, name: str):
    """The inputs of phase dist_gloo_4rank, drawn alike by every rank and by
    this process."""
    rng = np.random.default_rng(seed + 50 + sorted(GLOO_SIZES).index(name))
    n = GLOO_SIZES[name]
    square = lambda: m4.from_packed(packed(rng, n, n), n)   # noqa: E731
    if name in ("mul", "host"):
        return square(), square()
    if name == "deficient":                  # the ple_deficient input
        a = packed(np.random.default_rng(seed + 11), n, n)
        a[600:2000] = 0
        return m4.from_packed(a, n)
    if name == "trsm":
        return m4.from_packed(unit_diagonal(packed(rng, n, n)), n), square()
    if name == "solve":
        A = square()
        return A, m4.from_packed(f32_product(A.data, n, packed(rng, n, 256),
                                             256), 256)
    if name == "invert":
        L, U = square(), square()
        return m4.mul(m4.extract_l(BitMatrix(unit_diagonal(L.data), n)),
                      m4.extract_u(BitMatrix(unit_diagonal(U.data), n)))
    if name == "kernel":                     # the kernel_left input
        k, rng = 3000, np.random.default_rng(seed + 25)
        return m4.from_packed(f32_product(packed(rng, n, k), k,
                                          packed(rng, k, n), n), n)
    return square()                          # "ple", "echelon"


GLOO_SIZES = {"mul": 16384, "ple": 16384, "deficient": 4096, "echelon": 8192,
              "trsm": 8192, "solve": 16384, "invert": 8192, "kernel": 4096,
              "host": 8192}


def _gloo_rank(seed: int, work: str) -> None:
    """One rank of phase dist_gloo_4rank (started by launch(): a gloo group
    of 4 on the one card).  Every rank draws the same global inputs and
    runs the distributed calls; rank 0 saves the outputs, every rank its
    launch counts."""
    rank = dist.get_rank()
    sq = mesh_mod.make_mesh(shape=(2, 2))
    col = mesh_mod.make_mesh(shape=(4, 1))
    hosts = mesh_mod.make_multihost_mesh(local_world_size=2)
    check(tuple(hosts.shape) == (2, 2) and mesh_mod.axis_index(hosts, "x")
          == rank // 2, f"make_multihost_mesh gave {hosts}")
    out, ms, misses = {}, {}, {}
    zero_counts()

    def run(name, fn):
        m0 = counted("fallback.dist_block_factor")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        misses[name] = counted("fallback.dist_block_factor") - m0

    A, B = gloo_input(seed, "mul")
    run("mul_dist", lambda: mul_dist(A, B, sq))
    run("mul_dist_ksplit", lambda: mul_dist_ksplit(A, B, sq))
    A = gloo_input(seed, "ple")
    run("dist_ple", lambda: dist_ple(A, col, nb=512, window=576))
    A = gloo_input(seed, "deficient")
    run("dist_ple_deficient", lambda: dist_ple(A, col, nb=512, window=576))
    A = gloo_input(seed, "echelon")
    run("dist_rank", lambda: dist_rank(A, col))
    run("dist_echelonize", lambda: dist_echelonize(A, col))
    T, B = gloo_input(seed, "trsm")
    for name in TRSMS:
        fn = getattr(dist_solve, "dist_" + name)
        run("dist_" + name, lambda: fn(T, B, sq))
    A, B = gloo_input(seed, "solve")
    run("dist_solve_left", lambda: dist_solve.dist_solve_left(
        A, B, col, nb=512, window=576))
    A = gloo_input(seed, "invert")
    run("dist_invert", lambda: dist_solve.dist_invert(A, sq, nb=512, window=576))
    A = gloo_input(seed, "kernel")
    run("dist_kernel_left", lambda: dist_solve.dist_kernel_left(
        A, col, nb=512, window=576))
    A, B = gloo_input(seed, "host")
    run("host_mul_dist", lambda: mul_dist(A, B, hosts))
    run("host_dist_ple", lambda: dist_ple(A, hosts, nb=512, window=576))
    launched = counts()
    if rank == 0:
        torch.save({k: tuple(v) if isinstance(v, tuple) else (v,)
                    for k, v in out.items()}, f"{work}/outputs.pt")
    pathlib.Path(f"{work}/rank{rank}.json").write_text(json.dumps({
        "launches": launched, "ms": ms, "miss_fallbacks": misses,
        "host_staged_collectives": counted("host_staged_collectives")}))


def phase_dist_gloo_4rank(seed: int) -> dict:
    """The cross-rank logic on the card: a gloo group of 4 processes on the
    one GPU (NCCL takes one rank a card), card tensors, collectives staged
    through host memory.  Uneven pivots across shards, pivots owned by other
    ranks and the miss branch, with every output word for word the
    single-device entry point's on the card, computed here from the same
    inputs."""
    torch.cuda.empty_cache()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as work:
        launch("chip_smoke:_gloo_rank", 4, work, backend="gloo", device="cuda",
               args=[seed, work], timeout_s=600)
        group_s = time.time() - t0
        got = torch.load(f"{work}/outputs.pt", weights_only=False)
        ranks = [json.loads(pathlib.Path(f"{work}/rank{r}.json").read_text())
                 for r in range(4)]
    total = {}
    for rk in ranks:
        add_counts(total, rk["launches"])
    for name in DIST_KERNELS:
        check(all(rk["launches"][name] > 0 for rk in ranks),
              f"a rank of the 4-rank group never launched {name}: "
              f"{[rk['launches'] for rk in ranks]}")
    check(all(rk["host_staged_collectives"] > 0 for rk in ranks),
          "the gloo group staged no collective through host memory")

    t1 = time.time()
    A, B = gloo_input(seed, "mul")
    want = m4.mul(A, B)
    same_words("mul_dist 4 ranks", got["mul_dist"], [want])
    same_words("mul_dist_ksplit 4 ranks", got["mul_dist_ksplit"], [want])
    A = gloo_input(seed, "ple")
    same_words("dist_ple 4 ranks", got["dist_ple"], m4.ple(A, nb=512))
    A = gloo_input(seed, "deficient")
    same_words("dist_ple zeroed band 4 ranks", got["dist_ple_deficient"],
               m4.ple(A, nb=512))
    check(ranks[0]["miss_fallbacks"]["dist_ple_deficient"] > 0,
          "the zeroed band took no miss branch on 4 ranks")
    A = gloo_input(seed, "echelon")
    (r,), (E, re) = got["dist_rank"], got["dist_echelonize"]
    check(r == re == m4.rank(A), f"dist_rank 4 ranks: {r}, {re}")
    same_echelon("dist_echelonize 4 ranks", E, r, A)
    T, B = gloo_input(seed, "trsm")
    for name in TRSMS:
        same_words(f"dist_{name} 4 ranks", got["dist_" + name],
                   [getattr(m4, name)(T, B)])
    A, B = gloo_input(seed, "solve")
    X, ok = m4.solve_left(A, B)
    check(bool(got["dist_solve_left"][1]) and bool(ok), "solve: inconsistent")
    same_words("dist_solve_left 4 ranks", got["dist_solve_left"][:1], [X])
    A = gloo_input(seed, "invert")
    same_words("dist_invert 4 ranks", got["dist_invert"], m4.invert(A))
    A = gloo_input(seed, "kernel")
    same_words("dist_kernel_left 4 ranks", got["dist_kernel_left"],
               m4.kernel_left(A))
    A, B = gloo_input(seed, "host")
    same_words("mul_dist on 2 hosts x 2", got["host_mul_dist"], [m4.mul(A, B)])
    same_words("dist_ple on 2 hosts x 2", got["host_dist_ple"],
               m4.ple(A, nb=512))
    torch.cuda.synchronize()
    emit("dist_gloo_4rank", ok=True, backend="gloo", world=4,
         meshes={"2x2": "products, TRSMs, invert", "4x1": "PLE, rank, "
                 "echelon, solve, kernel", "2 hosts x 2": "make_multihost_mesh"},
         sizes=GLOO_SIZES, group_seconds=group_s,
         checks_seconds=time.time() - t1, rank0_ms=ranks[0]["ms"],
         miss_fallbacks=ranks[0]["miss_fallbacks"], launches=total,
         launches_by_rank=[rk["launches"] for rk in ranks],
         host_staged_collectives=[rk["host_staged_collectives"] for rk in ranks])
    return total


# ------------------------------------------------------ the batched path ---

BATCHED = ("panel_loop_hopper_batched", "panel_post_hopper_batched",
           "gf2_schur_update_batched_hopper", "panel_commit_hopper_batched")
# no single PyTorch call computes a packed GF(2) product, a masked in-place
# update, a pivot loop or the fused elimination
NO_LIBRARY = ("no PyTorch call computes this function: a packed GF(2) "
              "product / masked in-place update, a pivot loop, or the fused "
              "below-window elimination")
# Classic McEliece mceliece348864: n = 3488, n - k = m*t = 12*64 = 768
MCELIECE = (256, 768, 3488)
NIST = (1 << 20, 32)           # SP 800-22 section 2.5: M = Q = 32, 2^30 bits
NIST_SHARES = {"32": 0.2888, "31": 0.5776, "<=30": 0.1336}


def stack_on_card(seed: int, B: int, rows: int, cols: int) -> torch.Tensor:
    """B packed rows x cols matrices made on the card from ``seed``, the
    padding bits zero."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    w = (cols + 31) // 32
    x = torch.randint(-2**31, 2**31, (B, rows, w), dtype=torch.int32,
                      device=DEV, generator=g)
    if cols % 32:
        x[:, :, -1] &= (1 << (cols % 32)) - 1
    return x


def batch_counts() -> dict:
    return counts(BATCHED)


def batched_stats(fn):
    """(result, launches, host syncs, miss fallbacks, peak GB) of ``fn``,
    every count set to 0 just before."""
    zero_counts()
    s0, f0 = (counted("readback.block_factor_batched"),
              counted("fallback.block_factor_batched"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return (out, counts(), counted("readback.block_factor_batched") - s0,
            counted("fallback.block_factor_batched") - f0,
            torch.cuda.max_memory_allocated() / 1e9)


def same_as_single(got, data, ncols: int, pres: bool, what: str) -> None:
    """Each element of a batched factorization equals the single-matrix
    block_factor on the card: body, P, Q and rank."""
    for i in range(data.shape[0]):
        want = m4.block_factor(BitMatrix(data[i], ncols), preserve_l=pres)
        for g, w, part in zip(got[:3], want[:3], ("data", "P", "Q")):
            check(torch.equal(g[i], w), f"{what}: element {i}'s {part} differs "
                  "from the single-matrix block_factor")
        check(int(got[3][i]) == want[3], f"{what}: element {i}'s rank")


def roofline(nbytes: float, b1_ops: float = 0.0, alu_ops: float = 0.0) -> dict:
    """The larger of bytes over the memory rate and operations over their
    peak: 1-bit tensor-core operations, or 32-bit operations outside the
    tensor cores (an XOR of a word is one)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (b1_ops / PEAK_B1_OPS_PER_S + alu_ops / PEAK_ALU32_OPS_PER_S) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def batched_schur_bound(m: int, k: int, nw: int, r0s, c0w: int) -> dict:
    """schur_bound summed over the elements: bytes and operations of each
    element's exact active rectangle."""
    t_bytes = t_ops = 0.0
    kw = (k + 31) // 32
    for r0 in r0s:
        rows, words = max(0, m - max(r0, 0)), max(0, nw - max(c0w, 0))
        t_bytes += 4 * (2 * rows * words + rows * kw + k * words)
        t_ops += 2 * rows * k * words * 32
    t_bytes /= PEAK_BYTES_PER_S / 1e3
    t_ops /= PEAK_B1_OPS_PER_S / 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# the restricted search of top_echelonize at 768 x 3488: the default k,
# min(opt_k(768, 3488), 7) = 7, searches 6k = 42 rows below the rank
TOP_WINDOW = 6 * min(opt_k(768, 3488), 7)
# the record of a kernel's second operand set, nested in its kernels entry
SUB_KEYS = ("max_abs_err", "matches_plain", "ms", "plain_ms", "bound_ms",
            "bound_by", "ms_min", "ms_max", "runs", "timed_at", "eliminations",
            "elements_in_range", "kernel_kinds", "chain_floor_ms",
            "bytes_bound_ms")
# the nested records of kernels_batched: 5b and 6b on top_echelonize's first
# panel; 5b on the McEliece batch's third panel (nothing in range), on the
# first panel of 1024 ISD matrices and on the one panel of 2^20 NIST
# matrices (a warp a window); 6b with rows in range for some elements only,
# with none (the McEliece batch's second panel, 2^16 NIST panels); 4b with
# r0 spread over the row tiles and c0w off the 8-word tiles
NIST_POST = 1 << 16
SPREAD_C0W = 21
SUBS = (f"search_window_{TOP_WINDOW}", "miss_check_off", "rows_in_range_mixed",
        "nothing_in_range", f"nist_{NIST_POST}_nothing_in_range",
        f"r0_spread_c0w_{SPREAD_C0W}", "third_panel_nothing_in_range",
        "isd_first_panel_1024", f"nist_{NIST[0]}")


def phase_batched_kernels(seed: int) -> dict:
    """Kernels a, b and c against their batched plain versions on the card,
    on the operands the McEliece batch's first panel gives them (the whole
    batch), and their times there beside their bounds; c again with each
    element's r0 spread over its row tiles (some at or past m) and c0w off
    the 8-word tiles; a again on the sweep's third panel (every rank at m:
    no step taken), on the first panel of 1024 ISD matrices (a block a
    window, several an SM, as on the first panel) and on the one panel of
    2^20 NIST 32 x 32 matrices (a warp a window), each checked to take that
    kernel; b again with rows in range for two thirds of the
    elements only (below0 off the 128-row tiles), and with none: the
    sweep's second panel, and the one panel of 2^16 NIST 32 x 32 matrices
    (v must equal X, lam and every miss byte 0); then a and b on the first
    panel of top_echelonize_batched's sweep of that batch brought to REF: a
    with the search window of 42 rows, b with the miss check off (a zero
    column mask: the miss byte must stay 0)."""
    B, m, n = MCELIECE
    data = stack_on_card(seed + 900, B, m, n)
    ops = capture_panel(data, n, False)
    report, bad = {}, {}

    def entry(name, fn, plain, timed, timed_plain, bnd, sub=None, **more):
        what = name if sub is None else f"{name} ({sub})"
        got, want = fn(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        bad[what] = max(int(g.shape != w.shape or bool((g != w).any()))
                        for g, w in zip(got, want))
        check(bad[what] == 0, f"{what} disagrees with its batched plain version")
        t = time_ms(timed)
        tp = time_ms(timed_plain, runs=3, warmup=1)
        rec = kernel_entry(
            name, 0, {"ms": t["median"], "plain_ms": tp["median"], **bnd},
            ms_min=t["min"], ms_max=t["max"], runs=t["runs"],
            library_note=NO_LIBRARY, batch=B, **more)
        if sub is None:
            report[name] = rec
        else:
            report[name][sub] = {k: rec[k] for k in SUB_KEYS if k in rec}
        return got

    def loop_entry(ops_a, sub=None):
        """a: the pivot loop on a batch of windows (256 of 576 rows, nb =
        512, on the McEliece panels).  The bound is the largest of the bytes
        (each window read and written once, the index outputs written), the
        eliminations' XORs at the 32-bit peak, and the chain of nb
        dependent steps in one warp (``chain_floor``), which no window can
        go below; bound_by says "bytes", or "operations" for the other
        two."""
        al0, r0, base, mm, nb, pres, sw = ops_a
        Bw, h, w2 = al0.shape
        la = (lambda: hopper_panel.panel_loop_hopper_batched(
            al0, r0, base, mm, nb, pres, sw))
        lp_ = (lambda: hopper_panel.panel_loop_batched_plain(
            al0, r0, base, mm, nb, pres, sw))
        before = panel_kinds()
        got = la()
        kinds = {k: n - before.get(k, 0) for k, n in panel_kinds().items()
                 if n != before.get(k, 0)}
        # each elimination XORs the pivot row's nb/32 panel words into a row
        # and sets one multiplier bit: the L half of the output minus the
        # input's counts them
        elims = int(popcount32(got[0][:, :, w2 // 2:]
                               ^ al0[:, :, w2 // 2:]).sum())
        nbytes = 4 * Bw * (2 * h * w2 + h + 4 * nb + 1)
        bnd = roofline(nbytes, alu_ops=elims * (w2 // 2))
        chain = time_ms(lambda: hopper_panel.chain_floor(nb, 32))["median"]
        # the chain binds only where some window has a row in range: a
        # window without one takes no step
        r_in = torch.maximum(r0, base)
        steps = bool((r_in < torch.minimum(base + h, torch.full_like(
            base, mm))).any())
        if steps and chain > bnd["bound_ms"]:
            bnd = {"bound_ms": chain, "bound_by": "operations"}
        entry("panel_loop_hopper_batched", lambda: got, lp_, la, lp_, bnd,
              sub=sub, timed_at=[Bw, h, w2], eliminations=elims,
              search_window=sw, kernel_kinds=kinds, chain_floor_ms=chain,
              bytes_bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3)
        return kinds

    def post_entry(ops_b, sub=None):
        """b: the elimination below each window (1792 rows a McEliece
        panel).  The bound counts X read and v, lam written for every
        element, M, W and the column mask read for the elements with a row
        in range only: the others pass through, their operands unread."""
        xw, msm, wm, cmb, below0, mvalid = ops_b
        nb = 32 * xw.shape[2]
        span = (min(mvalid, xw.shape[1]) - below0.clamp(min=0)).clamp(min=0)
        live = int((span > 0).sum())
        return entry("panel_post_hopper_batched",
                     lambda: hopper_post.panel_post_hopper_batched(*ops_b),
                     lambda: hopper_post.panel_post_batched_plain(*ops_b),
                     lambda: hopper_post.panel_post_hopper_batched(*ops_b),
                     lambda: hopper_post.panel_post_batched_plain(*ops_b),
                     roofline(xw.shape[0] * (4 * 3 * xw.shape[1] * nb // 32 + 1)
                              + live * (2 * nb * nb + nb),
                              b1_ops=2 * 2 * int(span.sum()) * nb * nb),
                     sub=sub, timed_at=list(xw.shape), elements_in_range=live)

    def schur_entry(c, lp, up, r0s, c0w, sub=None):
        """c: the trailing update, timed in place on one C (the work does
        not depend on the words)."""
        cc = c.clone()
        entry("gf2_schur_update_batched_hopper",
              lambda: hopper_schur.gf2_schur_update_batched_hopper(
                  c.clone(), lp, up, r0s, c0w),
              lambda: hopper_schur.gf2_schur_update_plain(c.clone(), lp, up),
              lambda: hopper_schur.gf2_schur_update_batched_hopper(
                  cc, lp, up, r0s, c0w),
              lambda: hopper_schur.gf2_schur_update_plain(cc, lp, up),
              batched_schur_bound(c.shape[1], up.shape[1], c.shape[2],
                                  r0s.tolist(), c0w),
              sub=sub, timed_at=list(c.shape) + [up.shape[1]], c0w=c0w)

    kinds = loop_entry(ops["panel_loop_hopper_batched"])
    check(kinds == {"panel_kernel (several an SM)": 1},
          f"5b took {kinds} on 256 McEliece windows")
    post_entry(ops["panel_post_hopper_batched"])
    # c: the trailing update, C 768 x 112 words (the real rows: the sweep
    # hands the kernel no padding row), k = 512, c0w = 16
    c, lp, up, r0s, c0w = ops["gf2_schur_update_batched_hopper"]
    schur_entry(c, lp, up, r0s, c0w)
    # c again, each element's r0 on, inside, at the end of or past its row
    # tiles, c0w off the 8-word tiles; Lp and Up cut to the contract
    spread = torch.tensor([0, 1, 255, 256, 257, 511, 512, 700, 767, 768, 800,
                           5000], dtype=torch.int32, device=DEV).repeat(
                               -(-B // 12))[:B]
    rows = torch.arange(m, device=DEV)
    lp_s = lp * (rows[None, :] >= spread[:, None]).to(torch.int32)[:, :, None]
    up_s = up.clone()
    up_s[:, :, :SPREAD_C0W] = 0
    schur_entry(c, lp_s, up_s, spread, SPREAD_C0W,
                f"r0_spread_c0w_{SPREAD_C0W}")
    # b with rows in range for some elements only: below0 off the 128-row
    # tiles for two thirds, at or past mvalid for the rest
    xw, msm, wm, cmb, below0, mvalid = ops["panel_post_hopper_batched"]
    idx = torch.arange(B, dtype=torch.int32, device=DEV)
    mixed = torch.where(idx % 3 == 0, mvalid + idx % 5, 513 + idx * 37 % 250)
    got = post_entry((xw, msm, wm, cmb, mixed, mvalid), "rows_in_range_mixed")
    out = mixed >= mvalid
    check(not bool(got[1][out].any()) and torch.equal(got[0][out], xw[out]),
          "6b changed an element with no row in range")
    del ops, c, lp, up, lp_s, up_s, xw, msm, wm, cmb

    # a with nothing in range: the McEliece sweep's third panel, every rank
    # at m; no step taken, the window passed through
    only = ("panel_loop_hopper_batched",)
    third = capture_panel(data, n, False, panel=2,
                          need=only)["panel_loop_hopper_batched"]
    check(bool((third[1] >= m).all()), "5b (third panel): a rank below m")
    got = loop_entry(third, "third_panel_nothing_in_range")
    # a on the first panel of solve_left_batched's sweep of 1024 ISD
    # matrices (L preserved): a block a window, several an SM
    isd = stack_on_card(seed + 903, ISD[0], ISD[1], ISD[1])
    got = loop_entry(capture_panel(isd, ISD[1], True, need=only)[
        "panel_loop_hopper_batched"], f"isd_first_panel_{ISD[0]}")
    check(got == {"panel_kernel (several an SM)": 1}, f"5b (ISD) took {got}")
    del isd, third
    # a on the one panel of 2^20 NIST 32 x 32 matrices: a warp a window
    nist_all = stack_on_card(seed + 904, *NIST, NIST[1])
    got = loop_entry(capture_panel(nist_all, NIST[1], False, need=only)[
        "panel_loop_hopper_batched"], f"nist_{NIST[0]}")
    check(got == {"panel_warp_kernel": 1}, f"5b (NIST) took {got}")
    del nist_all

    # b with nothing in range: the McEliece sweep's second panel, and the
    # one panel of 2^16 NIST 32 x 32 matrices; v = X, lam and miss 0
    second = capture_panel(data, n, False, panel=1)["panel_post_hopper_batched"]
    nist = stack_on_card(seed + 901, NIST_POST, 32, 32)
    first_nist = capture_panel(nist, 32, False, need=(
        "panel_post_hopper_batched",))["panel_post_hopper_batched"]
    for ops_b, sub in ((second, "nothing_in_range"),
                       (first_nist, f"nist_{NIST_POST}_nothing_in_range")):
        check(bool((ops_b[4] >= ops_b[5]).all()),
              f"6b ({sub}): some element has a row in range")
        got = post_entry(ops_b, sub)
        check(torch.equal(got[0], ops_b[0]) and not bool(got[1].any())
              and not bool(got[2].any()), f"6b ({sub}) did not pass X through")
    del second, nist, first_nist

    # a and b on the restricted search: top_echelonize_batched's first panel
    ref = m4.echelonize_batched(data, n, full=False)[0]
    top = capture_panel(ref, n, False, search_window=TOP_WINDOW)
    check(top["panel_loop_hopper_batched"][-1] == TOP_WINDOW,
          "the sweep did not hand the pivot loop its search window")
    check(not bool(top["panel_post_hopper_batched"][3].any()),
          "the sweep handed the post kernel a column mask under a search "
          "window")
    loop_entry(top["panel_loop_hopper_batched"], f"search_window_{TOP_WINDOW}")
    got = post_entry(top["panel_post_hopper_batched"], "miss_check_off")
    check(not bool(got[2].any()), "the post kernel flagged a miss with the "
          "miss check off")
    emit("kernels_batched", kernels=list(report.values()))
    return report


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (masked shifts: no sign copies)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    n = torch.zeros_like(x)
    for s in range(32):
        n += (x >> s) & 1
    return n


def nist_ranks_numpy(words: np.ndarray) -> np.ndarray:
    """Ranks of [B, 32] uint32 rows (row r of element b: bit c = column c),
    by Gauss-Jordan elimination vectorised over the batch: 32 column steps,
    each the first unused row with the bit as pivot, XORed into every other
    row with the bit.  Independent of the port; threads over the batch."""
    from concurrent.futures import ThreadPoolExecutor

    def ranks(rows):
        rows = rows.copy()
        B = rows.shape[0]
        used = np.zeros(rows.shape, bool)
        r = np.zeros(B, np.int64)
        ar = np.arange(B)
        idx = np.arange(32)[None, :]
        for c in range(32):
            bit = ((rows >> np.uint32(c)) & 1).astype(bool)
            cand = bit & ~used
            has = cand.any(axis=1)
            piv = cand.argmax(axis=1)
            prow = rows[ar, piv]
            hit = bit & (idx != piv[:, None]) & has[:, None]
            rows ^= np.where(hit, prow[:, None], np.uint32(0))
            used[ar[has], piv[has]] = True
            r += has
        return r

    chunks = np.array_split(words, 16)
    with ThreadPoolExecutor(8) as ex:
        return np.concatenate(list(ex.map(ranks, chunks)))


def phase_batched_rank_nist(seed: int) -> dict:
    """rank_batched of 2^20 random 32 x 32 matrices, one 2^30-bit sequence
    of the NIST SP 800-22 binary matrix rank test; every rank equal to a
    numpy elimination on the host."""
    B, n = NIST
    data = stack_on_card(seed + 901, B, n, n)
    ranks, launched, syncs, misses, peak = batched_stats(
        lambda: m4.rank_batched(data, n))
    t0 = time.perf_counter()
    want = nist_ranks_numpy(data[:, :, 0].cpu().numpy().view(np.uint32))
    host_s = time.perf_counter() - t0
    got = ranks.cpu().numpy()
    check(np.array_equal(got, want),
          f"NIST ranks: {int((got != want).sum())} of {B} differ from numpy")
    check(launched["panel_loop_hopper_batched"] == 1
          and launched["panel_post_hopper_batched"] == 1
          and launched["gf2_schur_update_batched_hopper"] == 0
          and launched["unit_tri_inv_hopper"] == 0       # T in the operands
          and launched["post_operands_hopper"] == 1      # a warp a matrix
          and launched["panel_commit_hopper_batched"] == 1,
          f"rank_batched 32x32 launched {batch_counts()}")
    check(syncs == 1 and misses == 0, f"{syncs} read-backs, {misses} fallbacks")
    kinds = panel_kinds()
    check(kinds == {"panel_warp_kernel": 1},
          f"rank_batched 32x32 took the pivot loop's {kinds}")
    t = time_host_ms(lambda: m4.rank_batched(data, n), runs=3)
    some = 64
    same_as_single(m4.block_factor_batched(data[:some], n, False), data[:some],
                   n, False, "NIST 32x32")
    loop = time_host_ms(lambda: [m4.rank(BitMatrix(data[i], n))
                                 for i in range(some)], runs=1)
    shares = {"32": float((got == 32).mean()), "31": float((got == 31).mean()),
              "<=30": float((got <= 30).mean())}
    emit("batched_rank_nist", ok=True, batch=B, shape=[n, n], ms=t,
         calls_per_s=B / t["median"] * 1e3,
         loop_of_single_rank_ms_per_matrix=loop["median"] / some,
         host_numpy_seconds=host_s, host_syncs=syncs, miss_fallbacks=misses,
         launches=launched, pivot_loop_kernels=kinds, peak_memory_gb=peak,
         rank_shares=shares, expected_shares=NIST_SHARES)
    return launched


def phase_batched_factor_mceliece(seed: int) -> dict:
    """block_factor_batched of 256 dense random 768 x 3488 matrices, the
    parity-check shape of Classic McEliece mceliece348864, with and without
    L; every element equal to the single-matrix block_factor on the card
    (with L: the first 32, the whole batch being pinned by ple_batched of
    the same draw, held to the single ple element by element in
    batched_ple_pluq_mceliece).  The loop of single calls without L is timed
    with its comparisons."""
    B, m, n = MCELIECE
    data = stack_on_card(seed + 900, B, m, n)
    total, per = {}, {}
    for pres in (False, True):
        got, launched, syncs, misses, peak = batched_stats(
            lambda: m4.block_factor_batched(data, n, pres))
        kinds = panel_kinds()
        add_counts(total, launched)
        check(all(launched[k] > 0 for k in BATCHED),
              f"McEliece preserve_l={pres} launched {launched}")
        check(set(kinds) == {"panel_kernel (several an SM)"},
              f"McEliece preserve_l={pres}: the pivot loop took {kinds}")
        some = LOOP_SLICE if pres else B
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        same_as_single(tuple(x[:some] for x in got), data[:some], n, pres,
                       f"McEliece preserve_l={pres}")
        if not pres:
            loop_ms = (time.perf_counter() - t0) * 1e3
        per[f"preserve_l={pres}"] = {
            "host_syncs": syncs, "miss_fallbacks": misses, "launches": launched,
            "peak_memory_gb": peak, "ranks": sorted(set(got[3].tolist())),
            "single_calls": some, "pivot_loop_kernels": kinds}
    t = time_host_ms(lambda: m4.block_factor_batched(data, n, False), runs=3)
    emit("batched_factor_mceliece", ok=True, batch=B, shape=[m, n],
         ms=t, calls_per_s=B / t["median"] * 1e3,
         loop_of_single_block_factor_ms=loop_ms,
         batched_over_loop=loop_ms / t["median"], runs=per)
    return total


def phase_batched_miss_4096(seed: int) -> dict:
    """block_factor_batched of 16 4096^2 matrices, every fourth with rows
    600-1999 zeroed (phase_ple_deficient's pattern): those elements take the
    full-height fallback, ranks differ across the batch, and each element
    equals the single-matrix result."""
    B, n = 16, 4096
    data = stack_on_card(seed + 902, B, n, n)
    data[::4, 600:2000] = 0
    panels = n // NB_16K
    got, launched, syncs, misses, peak = batched_stats(
        lambda: m4.block_factor_batched(data, n, True))
    same_as_single(got, data, n, True, "batched miss 4096")
    ranks = got[3].tolist()
    check(misses > 0 and len(set(ranks)) > 1,
          f"no miss fallback or equal ranks: {misses}, {ranks}")
    # one read-back a panel, one more on a panel with a miss (at most one
    # such panel per fallback), none in the fallbacks themselves
    check(panels < syncs <= panels + min(misses, panels),
          f"{syncs} read-backs over {panels} panels, {misses} fallbacks")
    check(launched["panel_loop_hopper"] == misses,
          f"the fallbacks launched {launched['panel_loop_hopper']} single loops")
    # every call that waits for the card, as PyTorch's sync debug mode sees
    # them, is one the sweep counts
    s0 = counted("readback.block_factor_batched")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            m4.block_factor_batched(data, n, True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    waits = sync_waits(caught)
    check(waits == counted("readback.block_factor_batched") - s0 == syncs,
          f"{waits} synchronising calls, {syncs} counted read-backs")
    t = time_host_ms(lambda: m4.block_factor_batched(data, n, True), runs=3)
    loop = time_host_ms(lambda: [m4.block_factor(BitMatrix(data[i], n), True)
                                 for i in range(B)], runs=1)
    emit("batched_miss_4096", ok=True, batch=B, n=n, ranks=ranks, ms=t,
         calls_per_s=B / t["median"] * 1e3,
         loop_of_single_block_factor_ms=loop["median"],
         batched_over_loop=loop["median"] / t["median"], host_syncs=syncs,
         synchronising_calls=waits, miss_fallbacks=misses, panels=panels,
         launches=launched,
         peak_memory_gb=peak)
    return launched


def phase_batched_one(seed: int) -> dict:
    """A batch of one through the batched sweep beside the single-matrix
    block_factor (preserve_l=True) at 16384^2 and 32768^2, dense random:
    the results equal, both timed in turns on the host clock.  What running
    the single path through the batched sweep would cost."""
    total, out = {}, {}
    for n in (16384, 32768):
        data = packed(np.random.default_rng(seed + 906 + n // 16384), n, n)
        A = m4.from_packed(data, n)
        got, launched, syncs, misses, peak = batched_stats(
            lambda: m4.block_factor_batched(data[None], n, True))
        add_counts(total, launched)
        want = m4.block_factor(A, preserve_l=True)
        for g, w, part in zip(got[:3], want[:3], ("data", "P", "Q")):
            check(torch.equal(g[0], w), f"batch of one {n}: {part} differs")
        check(int(got[3][0]) == want[3], f"batch of one {n}: rank")
        del got, want
        single, batched = [], []
        for _ in range(3):
            for fn, ts in ((lambda: m4.block_factor(A, preserve_l=True),
                            single),
                           (lambda: m4.block_factor_batched(data[None], n,
                                                            True), batched)):
                ts.append(time_host_ms(fn, runs=1, warmup=0)["median"])
        out[str(n)] = {"block_factor_ms": single, "batched_ms": batched,
                       "batched_over_single": statistics.median(batched)
                       / statistics.median(single),
                       "host_syncs": syncs, "miss_fallbacks": misses,
                       "peak_memory_gb": peak}
        del A, data
    emit("batched_one", ok=True, preserve_l=True, runs=out)
    return total


def phase_batched_mul_512(seed: int) -> dict:
    """mul_packed_batched of 1024 products 512^2 x 512^2: each element equal
    to mul_packed_data on the card, the whole batch held by Freivalds'
    check (float32 products of the unpacked bits, TF32 off)."""
    B, n = 1024, 512
    a = stack_on_card(seed + 903, B, n, n)
    b = stack_on_card(seed + 904, B, n, n)
    c, launched, _, _, peak = batched_stats(lambda: m4.mul_packed_batched(a, b))
    check(launched["gf2_schur_update_batched_hopper"] == 1,
          f"mul_packed_batched launched {batch_counts()}")
    single = torch.stack([mul_packed_data(a[i], b[i]) for i in range(B)])
    check(torch.equal(c, single), "mul_packed_batched differs from "
          "mul_packed_data element by element")
    x = stack_on_card(seed + 905, B, n, 64)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        def prod(p, q):   # packed [B, n, w] x packed [B, n, w'] -> packed
            pf = unpack_f32(p.reshape(B * n, -1), n).reshape(B, n, n)
            qf = unpack_f32(q.reshape(B * n, -1), q.shape[2] * 32)
            return pack_parity(torch.bmm(pf, qf.reshape(B, n, -1)).reshape(
                B * n, -1)).reshape(B, n, -1)
        check(torch.equal(prod(c, x), prod(a, prod(b, x))),
              "Freivalds: C X != A (B X) for the batch")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    t = time_ms(lambda: m4.mul_packed_batched(a, b))
    tp = time_ms(lambda: m4.mul_packed_batched(a, b, allow_kernel=False),
                 runs=3, warmup=1)
    loop = time_ms(lambda: [mul_packed_data(a[i], b[i]) for i in range(B)],
                   runs=3, warmup=1)
    emit("batched_mul_512", ok=True, batch=B, shape=[n, n, n], ms=t,
         plain_ms=tp["median"], calls_per_s=B / t["median"] * 1e3,
         loop_of_mul_packed_data_ms=loop["median"],
         batched_over_loop=loop["median"] / t["median"],
         **roofline(4 * B * 3 * n * (n // 32), b1_ops=2 * B * n ** 3),
         launches=launched, peak_memory_gb=peak)
    return launched


# ------------------------------------------- the batched solver API ---

ISD = (1024, 768)              # Prange: the information set H_I, 768 = n - k
TRSM_BATCH = 256
SAMPLE = 8                     # elements checked outside the code under test
LOOP_SLICE = 32                # single calls of an entry pinned to another


def host_rref(words: np.ndarray, ncols: int) -> tuple[np.ndarray, int]:
    """RREF and rank of one packed matrix (uint32 words [m, w]) by
    Gauss-Jordan elimination on the host, one column a step, the pivot the
    first row at or below the rank: the sequential oracle, independent of
    the port."""
    rows = np.ascontiguousarray(words, dtype=np.uint32).copy()
    m, r = rows.shape[0], 0
    for c in range(ncols):
        w, b = divmod(c, 32)
        bit = ((rows[:, w] >> np.uint32(b)) & 1).astype(bool)
        below = np.flatnonzero(bit[r:])
        if below.size == 0:
            continue
        p = r + below[0]
        if p != r:
            rows[[r, p]] = rows[[p, r]]
            bit[[r, p]] = bit[[p, r]]
        bit[r] = False
        rows[bit] ^= rows[r]
        r += 1
        if r == m:
            break
    return rows, r


def host_words(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def batched_call(fn):
    """One call of ``fn`` with every count set to 0 just before, under
    PyTorch's sync debug mode: (result, launches, counted read-backs,
    synchronising calls, miss fallbacks, peak GB, ms on the host clock
    ended by a synchronize)."""
    zero_counts()
    s0, f0 = (counted("readback.block_factor_batched"),
              counted("fallback.block_factor_batched"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    waits = sync_waits(caught)
    return (out, counts(), counted("readback.block_factor_batched") - s0,
            waits, counted("fallback.block_factor_batched") - f0,
            torch.cuda.max_memory_allocated() / 1e9, ms)


def as_tensor(x) -> torch.Tensor:
    if isinstance(x, BitMatrix):
        return x.data
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(x, device=DEV)


def same_elements(what: str, got: tuple, singles: list) -> None:
    """Every part of every element of a batched result equals the
    single-matrix call's."""
    for j, part in enumerate(got):
        want = torch.stack([as_tensor(s[j]).to(part.dtype) for s in singles])
        if not torch.equal(part, want):
            bad = [i for i in range(len(singles))
                   if not torch.equal(part[i], want[i])]
            check(False, f"{what}: part {j} of elements {bad[:10]} differs "
                  "from the single-matrix call on the card")


def batched_entry(what: str, batched_fn, single_fn, B: int, report: dict,
                  total: dict, kernels=BATCHED, loop: int | None = None):
    """The batched call counted and timed (median of 3: the counted call
    and two more), the loop of single calls on the same input once (timed;
    its results are what every element is held to), and the read-backs
    pinned: the sweep's count equals PyTorch's count of synchronising
    calls.  ``loop`` < B runs the single calls on the first ``loop``
    elements only: for an entry whose whole batch the caller holds to
    another batched result that is itself held to the single call element
    by element (``loop`` = 0: no single call).  Returns the batched
    result."""
    out, launched, syncs, waits, misses, peak, ms0 = batched_call(batched_fn)
    add_counts(total, launched)
    check(all(launched[k] > 0 for k in kernels),
          f"{what}: launched {counts(BATCHED)}")
    check(waits == syncs, f"{what}: {waits} synchronising calls, {syncs} "
          "counted read-backs")
    ts = [ms0] + [time_host_ms(batched_fn, runs=1, warmup=0)["median"]
                  for _ in range(2)]
    loop = B if loop is None else loop
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    singles = [single_fn(i) for i in range(loop)]
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3 if loop else None
    parts = out if isinstance(out, tuple) else (out,)
    if loop:
        same_elements(what, tuple(x[:loop] for x in parts),
                      [s if isinstance(s, tuple) else (s,) for s in singles])
    ms = statistics.median(ts)
    report[what] = {"ms": ms, "runs_ms": ts, "calls_per_s": B / ms * 1e3,
                    "loop_of_single_calls_ms": loop_ms, "loop_elements": loop,
                    "batched_over_loop": (loop_ms / loop * B / ms if loop
                                          else None),
                    "host_syncs": syncs, "synchronising_calls": waits,
                    "miss_fallbacks": misses, "peak_memory_gb": peak,
                    "launches": {k: launched[k] for k in BATCHED}}
    del singles
    return out


def phase_batched_ple_pluq_mceliece(seed: int) -> dict:
    """ple_batched and pluq_batched of the McEliece stack (256 x 768 x
    3488): every element equal to the single-matrix call on the card, and
    the rank of 8 of them equal to the host's sequential elimination."""
    B, m, n = MCELIECE
    data = stack_on_card(seed + 900, B, m, n)
    report, total = {}, {}
    ranks = [host_rref(host_words(data[i]), n)[1] for i in range(SAMPLE)]
    for name in ("ple", "pluq"):
        got = batched_entry(
            name, lambda: getattr(m4, f"{name}_batched")(data, n),
            lambda i: getattr(m4, name)(BitMatrix(data[i], n)), B, report,
            total)
        for i, rk in enumerate(ranks):
            check(int(got[3][i]) == rk, f"{name}: element {i}'s rank "
                  f"{int(got[3][i])}, the host's elimination {rk}")
        del got
    emit("batched_ple_pluq_mceliece", ok=True, batch=B, shape=[m, n],
         runs=report)
    return total


def phase_batched_rref_mceliece(seed: int) -> dict:
    """echelonize_batched(full=True) by both strategies and
    kernel_left_batched of the McEliece stack: every element equal to the
    single-matrix call (the pluq strategy's RREF: the whole batch equal to
    the m4ri one's, the RREF being unique, and its single calls run on the
    first 32 elements); on 8 elements the RREF equal to the host's
    Gauss-Jordan elimination word for word, and H K = 0 with n - r kernel
    columns by a float32 product of the unpacked bits."""
    B, m, n = MCELIECE
    data = stack_on_card(seed + 900, B, m, n)
    report, total = {}, {}
    oracle = [host_rref(host_words(data[i]), n) for i in range(SAMPLE)]
    rref = None
    for strategy in ("m4ri", "pluq"):
        # the RREF is unique: the pluq strategy's whole batch is held to the
        # m4ri one's, which is held to the single call element by element
        E, r = batched_entry(
            f"echelonize_{strategy}",
            lambda: m4.echelonize_batched(data, n, strategy=strategy),
            lambda i: m4.echelonize(BitMatrix(data[i], n), strategy=strategy),
            B, report, total, loop=None if rref is None else LOOP_SLICE)
        for i, (want, rk) in enumerate(oracle):
            check(int(r[i]) == rk and np.array_equal(host_words(E[i]), want),
                  f"echelonize {strategy}: element {i} differs from the "
                  "host's RREF")
        if rref is None:
            rref = E, r
        else:
            check(torch.equal(E, rref[0]) and torch.equal(r, rref[1]),
                  "echelonize: the pluq strategy's RREF differs from m4ri's")
        del E, r
    del rref
    K, count = batched_entry(
        "kernel_left", lambda: m4.kernel_left_batched(data, n),
        lambda i: m4.kernel_left(BitMatrix(data[i], n)), B, report, total)
    for i, (_, rk) in enumerate(oracle):
        check(int(count[i]) == n - rk, f"kernel_left: element {i}'s count")
        check(not bool(f32_product(data[i], n, K[i], n).any()),
              f"kernel_left: H K is not zero for element {i}")
    emit("batched_rref_mceliece", ok=True, batch=B, shape=[m, n],
         ranks=sorted(set(count.neg().add(n).tolist())), runs=report)
    return total


def isd_stack(seed: int):
    """1024 random 768^2 matrices (the information set H_I of a Prange
    guess each) and a random 768 x 1 syndrome each."""
    B, n = ISD
    return stack_on_card(seed + 910, B, n, n), stack_on_card(seed + 911, B, n, 1)


def check_solutions(what: str, A, S, X, ok) -> None:
    """On 8 elements, 4 consistent and 4 not where the batch has them: the
    flag equals rank(A) == rank([A | s]) by the host's elimination, and
    A X = s by a float32 product where consistent."""
    n = A.shape[1]
    flags = ok.tolist()
    pick = ([i for i, f in enumerate(flags) if f][:SAMPLE // 2]
            + [i for i, f in enumerate(flags) if not f][:SAMPLE // 2])
    check(len(pick) == SAMPLE, f"{what}: {sum(flags)} consistent of "
          f"{len(flags)}: not both kinds")
    for i in pick:
        a = host_words(A[i])
        _, ra = host_rref(a, n)
        _, rab = host_rref(np.concatenate([a, host_words(S[i])], axis=1), n + 1)
        check(flags[i] == (ra == rab), f"{what}: element {i}'s flag")
        if flags[i]:
            check(torch.equal(f32_product(A[i], n, X[i], 1), S[i]),
                  f"{what}: A X != s for element {i}")


def phase_batched_solve_isd(seed: int) -> dict:
    """solve_left_batched of 1024 768^2 systems with one syndrome each,
    then pluq_solve_left_batched on pluq_batched's factors of them: every
    element equal to the single call on the card (pluq_solve_left's: the
    whole batch equal to solve_left's, and its single calls run on the
    first 32 elements); the flags and A X = s
    checked on 8 elements outside the code under test."""
    B, n = ISD
    A, S = isd_stack(seed)
    report, total = {}, {}
    X, ok = batched_entry(
        "solve_left", lambda: m4.solve_left_batched(A, n, S, 1),
        lambda i: m4.solve_left(BitMatrix(A[i], n), BitMatrix(S[i], 1)), B,
        report, total)
    check_solutions("solve_left", A, S, X, ok)
    M, P, Q, r = m4.pluq_batched(A, n)
    X2, ok2 = batched_entry(
        "pluq_solve_left",
        lambda: m4.pluq_solve_left_batched(M, n, P, Q, r, S, 1),
        lambda i: m4.pluq_solve_left(BitMatrix(M[i], n), P[i], Q[i],
                                     int(r[i]), BitMatrix(S[i], 1)),
        B, report, total, kernels=("gf2_schur_update_batched_hopper",),
        loop=LOOP_SLICE)
    # the whole batch held to solve_left's, held to the single call above
    check(torch.equal(ok, ok2) and torch.equal(X, X2),
          "pluq_solve_left differs from solve_left on the same systems")
    ranks = torch.bincount(r, minlength=n + 1)
    emit("batched_solve_isd", ok=True, batch=B, n=n, bcols=1,
         consistent=int(ok.sum()), full_rank=int(ranks[n]),
         rank_n_minus_1=int(ranks[n - 1]), runs=report)
    return total


def unit_triangles(seed: int, B: int, n: int) -> torch.Tensor:
    """B random n x n words with the diagonal set: unit upper in one
    triangle, junk in the other, and the other way round."""
    t = stack_on_card(seed, B, n, n)
    idx = torch.arange(n, device=DEV)
    t[:, idx, idx // 32] |= torch.ones_like(idx, dtype=torch.int32) << (
        idx % 32).to(torch.int32)
    return t


def phase_batched_invert_trsm(seed: int) -> dict:
    """invert_batched of the ISD stack (A A^-1 = I where r_a = n, and r_a
    the host's rank, on 8 elements), then trtri_*_batched and the four
    trsm_*_batched of 256 unit triangular 768^2 with junk in the other
    triangle, against a 768^2 B (the inverse, then one product) and a
    768 x 64 B (64 x 768 on the right: block substitution): every element
    equal to the single call (a TRSM's: the whole batch equal to the TRTRI
    times B, the solution being unique, and its single calls run on the
    first 32 elements); T X = B and T T^-1 = I on 8 elements by the float32
    product."""
    B, n = ISD
    A, _ = isd_stack(seed)
    report, total = {}, {}
    Ai, r_a = batched_entry(
        "invert", lambda: m4.invert_batched(A),
        lambda i: m4.invert(BitMatrix(A[i], n)), B, report, total)
    eye = m4.identity(n, device=DEV).data
    for i in range(SAMPLE):
        _, rk = host_rref(host_words(A[i]), n)
        check(int(r_a[i]) == rk, f"invert: element {i}'s rank")
        if rk == n:
            check(torch.equal(f32_product(A[i], n, Ai[i], n), eye),
                  f"invert: A A^-1 != I for element {i}")
    full_rank = int((r_a == n).sum())
    del A, Ai
    Bt = TRSM_BATCH
    T = unit_triangles(seed + 920, Bt, n)
    rhs = {"square": stack_on_card(seed + 921, Bt, n, n),
           "narrow_left": stack_on_card(seed + 922, Bt, n, 64),
           "narrow_right": stack_on_card(seed + 923, Bt, 64, n)}
    gemm = ("gf2_schur_update_batched_hopper",)
    inverse = {}
    for tri in ("upper", "lower"):
        name = f"trtri_{tri}"
        Ti = batched_entry(
            name, lambda: getattr(m4, f"{name}_batched")(T),
            lambda i: getattr(m4, name)(BitMatrix(T[i], n)), Bt, report,
            total, kernels=gemm)
        for i in range(SAMPLE):
            check(torch.equal(f32_product(T[i], n, Ti[i], n, a_tri=tri), eye),
                  f"{name}: T T^-1 != I for element {i}")
        inverse[tri] = Ti
    for name in ("trsm_upper_left", "trsm_lower_left", "trsm_upper_right",
                 "trsm_lower_right"):
        left = name.endswith("left")
        tri = "upper" if "upper" in name else "lower"
        for shape in ("square", "narrow_left" if left else "narrow_right"):
            b = rhs[shape]
            bcols = 64 if shape == "narrow_left" else n
            X = batched_entry(
                f"{name}_{shape}",
                lambda: getattr(m4, f"{name}_batched")(T, b, bcols),
                lambda i: getattr(m4, name)(BitMatrix(T[i], n),
                                            BitMatrix(b[i], bcols)),
                Bt, report, total, kernels=gemm, loop=LOOP_SLICE)
            # the solution is unique: the whole batch held to the product
            # of B and the TRTRI above, which is held to the single call
            ti = inverse[tri]
            check(torch.equal(X, m4.mul_packed_batched(ti, b) if left
                              else m4.mul_packed_batched(b, ti)),
                  f"{name} {shape}: X differs from the TRTRI times B")
            for i in range(SAMPLE):
                got = (f32_product(T[i], n, X[i], bcols, a_tri=tri) if left
                       else f32_product(X[i], n, T[i], n, b_tri=tri))
                check(torch.equal(got, b[i]),
                      f"{name} {shape}: T X != B for element {i}")
            del X
    emit("batched_invert_trsm", ok=True, invert_batch=B, trsm_batch=Bt, n=n,
         invertible=full_rank, runs=report)
    return total


def no_read_back(what: str, report: dict) -> None:
    """The entries of a phase read nothing back: the sweep counts no
    read-back and PyTorch's sync debug mode sees no synchronising call."""
    for name, run in report.items():
        check(run["host_syncs"] == 0 == run["synchronising_calls"],
              f"{what} {name}: {run['host_syncs']} read-backs counted, "
              f"{run['synchronising_calls']} synchronising calls")


def phase_batched_top_echelonize_mceliece(seed: int) -> dict:
    """top_echelonize_batched of the McEliece stack brought to REF (the
    reference's contract, brilliantrussian.h:229-232) at the default k
    (window 42) and at k = 1 (window 6): the whole batch equal to the RREF
    of the original matrices by echelonize_batched (the RREF is unique),
    ranks too; 32 elements equal to the single top_echelonize on the card;
    4 to the host's Gauss-Jordan elimination.  Then 16 matrices off the
    contract (a zeroed top band pushes the first pivots below the window),
    each equal to the single call.  No call reads anything back."""
    B, m, n = MCELIECE
    data = stack_on_card(seed + 900, B, m, n)
    rref, rank = m4.echelonize_batched(data, n)
    ref = m4.echelonize_batched(data, n, full=False)[0]
    oracle = [host_rref(host_words(data[i]), n) for i in range(SAMPLE // 2)]
    del data
    report, total = {}, {}
    for k in (0, 1):
        E, r = batched_entry(
            f"top_echelonize_k{k}",
            lambda: m4.top_echelonize_batched(ref, n, k=k),
            lambda i: m4.top_echelonize(BitMatrix(ref[i], n), k=k), B, report,
            total, loop=LOOP_SLICE)
        check(torch.equal(E, rref) and torch.equal(r, rank),
              f"top_echelonize k={k}: the batch differs from its RREF")
        for i, (want, rk) in enumerate(oracle):
            check(int(r[i]) == rk and np.array_equal(host_words(E[i]), want),
                  f"top_echelonize k={k}: element {i} differs from the "
                  "host's RREF")
        del E, r
    off_b = 16
    off = stack_on_card(seed + 930, off_b, m, n)
    off[:, :200, :8] = 0          # rows 0-199 zero in columns 0-255
    E, r = batched_entry(
        "top_echelonize_off_contract",
        lambda: m4.top_echelonize_batched(off, n),
        lambda i: m4.top_echelonize(BitMatrix(off[i], n)), off_b, report,
        total)
    no_read_back("batched_top_echelonize_mceliece", report)
    emit("batched_top_echelonize_mceliece", ok=True, batch=B, shape=[m, n],
         search_window={"k0": TOP_WINDOW, "k1": 6},
         ranks=sorted(set(rank.tolist())),
         off_contract={"batch": off_b, "ranks": sorted(set(r.tolist()))},
         runs=report)
    return total


def phase_batched_naive_isd(seed: int) -> dict:
    """The naive Gauss engines over a batch: invert_naive_batched of the
    1024 ISD matrices held to invert_batched (ok where r_a = n, the same
    inverses there); echelonize_naive_batched of the McEliece stack held to
    echelonize_batched; gauss_delayed_batched from column 2720 = k of it
    (the last n - k = 768 columns), 16 elements equal to the single
    gauss_delayed on the card and 4 ranks to the host's elimination of
    those columns.  No call reads anything back."""
    B, n = ISD
    A, _ = isd_stack(seed)
    report, total = {}, {}
    Ai, ok = batched_entry("invert_naive", lambda: m4.invert_naive_batched(A),
                           None, B, report, total, kernels=(), loop=0)
    Aj, r_a = m4.invert_batched(A)
    keep = ok[:, None, None].to(torch.int32)
    check(torch.equal(ok, r_a == n) and torch.equal(Ai * keep, Aj * keep),
          "invert_naive differs from invert_batched")
    invertible = int(ok.sum())
    del A, Ai, Aj
    Bm, m, nn = MCELIECE
    data = stack_on_card(seed + 900, Bm, m, nn)
    E, r = batched_entry(
        "echelonize_naive", lambda: m4.echelonize_naive_batched(data, nn),
        None, Bm, report, total, kernels=(), loop=0)
    E2, r2 = m4.echelonize_batched(data, nn)
    check(torch.equal(E, E2) and torch.equal(r, r2),
          "echelonize_naive differs from echelonize_batched")
    del E, E2
    k = nn - m
    G, rg = batched_entry(
        "gauss_delayed", lambda: m4.gauss_delayed_batched(data, nn,
                                                          start_col=k),
        lambda i: m4.gauss_delayed(BitMatrix(data[i], nn), start_col=k), Bm,
        report, total, kernels=(), loop=16)
    for i in range(SAMPLE // 2):
        _, rk = host_rref(host_words(data[i])[:, k // 32:], m)
        check(int(rg[i]) == rk, f"gauss_delayed: element {i}'s rank "
              f"{int(rg[i])}, the host's {rk}")
    no_read_back("batched_naive_isd", report)
    emit("batched_naive_isd", ok=True, invert_batch=B, n=n,
         invertible=invertible, echelon_batch=Bm, shape=[m, nn],
         start_col=k, runs=report)
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=17)
    seed = ap.parse_args().seed
    t0 = time.time()
    try:
        card = phase_device()
        rng = np.random.default_rng(seed + 100)
        report = phase_kernels(rng)
        report.update(phase_schur_kernels(rng))
        report.update(phase_panel_kernel(rng))
        report.update(phase_post_kernel(rng))
        report.update(phase_trinv_kernel(rng))
        report.update(phase_operands_kernel(rng))
        report.update(phase_commit_kernel(seed))
        report.update(phase_batched_kernels(seed))
        launches = {name: 0 for name in KERNELS}
        for got in (phase_mul_4096(seed), phase_mul_routes(seed),
                    phase_strassen(seed), phase_ple_16384(seed),
                    phase_ple_deficient(seed), phase_ple_32768(seed),
                    phase_golden_ple(), phase_pluq_32768(seed),
                    phase_pluq_golden(), phase_trsm_32768(seed),
                    phase_rank_rref_16384(seed), phase_invert_16384(seed),
                    phase_solve_32768_b256(seed), phase_kernel_left(seed),
                    phase_rref_golden()):
            add_counts(launches, got)
        surface = {}
        for phase in (phase_m4rm_4096, phase_m4rm_16384, phase_djb_512,
                      phase_io_16384, phase_native_2048, phase_compat_program,
                      phase_mul_65536):
            t = time.time()
            add_counts(launches, phase(seed))
            surface[phase.__name__.removeprefix("phase_")] = time.time() - t
        emit("user_surface", seconds=surface, total_seconds=sum(surface.values()))
        dist_total, dist_s = {}, {}
        for phase in (phase_dist_nccl_1rank, phase_dist_gloo_4rank):
            t = time.time()
            add_counts(dist_total, phase(seed))
            dist_s[phase.__name__.removeprefix("phase_")] = time.time() - t
        add_counts(launches, dist_total)
        for name in DIST_KERNELS:
            report[name]["dist_launches"] = dist_total[name]
        emit("multi_device", seconds=dist_s, total_seconds=sum(dist_s.values()),
             launches=dist_total)
        batch_s = {}
        for phase in (phase_batched_rank_nist, phase_batched_factor_mceliece,
                      phase_batched_miss_4096, phase_batched_mul_512,
                      phase_batched_one, phase_batched_ple_pluq_mceliece,
                      phase_batched_rref_mceliece, phase_batched_solve_isd,
                      phase_batched_invert_trsm,
                      phase_batched_top_echelonize_mceliece,
                      phase_batched_naive_isd):
            t = time.time()
            add_counts(launches, phase(seed))
            batch_s[phase.__name__.removeprefix("phase_")] = time.time() - t
        emit("batched", seconds=batch_s, total_seconds=sum(batch_s.values()))
        phase_naive_and_golden(seed)
        for name, n in launches.items():
            # the persistent Schur entry has no caller in the program: its
            # own phase (phase_schur_kernels) holds it to the plain version
            check(n > 0 or name == "gf2_schur_update_dyn_hopper",
                  f"the main path never launched {name}")
            report[name]["launches"] = n
    except Failed as e:
        emit("failed", ok=False, error=str(e))
        return 1
    torch.cuda.synchronize()
    emit("done", seconds=time.time() - t0,
         host_syncs=counted("readback.block_factor"),
         miss_fallbacks=counted("fallback.block_factor"))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # what bounds the pivot loop is its chain of steps; bytes go beside it
    more = ("chain_floor_ms", "bytes_bound_ms", "dist_launches", "library_note",
            *SUBS)
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys}, **{k: r[k] for k in more if k in r}}
        for r in report.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The GF(2) GEMMs, the Schur update and the factorization of two trees,
timed in turns on one card.

    python -m m4ri_tpu_torch.benches.old_new --parent DIR [--quick | --solver |
                                                           --batched]

DIR holds a checkout of another commit of this repository (unpack one with
``git archive <commit> | tar -x -C DIR``); its ``m4ri_tpu_torch`` is loaded
under another name beside this one, both build their kernels, and every
measurement is made parent, this tree, this tree, parent inside this one
process, so that the card, its clocks and its power limit are the same for
both.  Outputs are checked equal before anything is timed.  Timed: both
GEMM wrappers at the shapes of ``split_launch.py`` (4096³, 8192×512×8192,
the U rows at n=16384 and n=32768, the 8192³ quadrant views), ``mul`` at
n=4096 and n=16384 (each tree's default route); both
Schur entry points at the first and the middle panel of the sweeps at
n=16384 (nb=512) and n=32768 (nb=1024), called as the sweep calls them (int
bounds, finished column tiles skipped in each tree's own tiles), and
``ple`` / ``rank`` at 16384² and 32768² (``--quick``: the kernels only).
``--solver`` times the single-matrix solver entry points instead: at the
sizes of ``chip_smoke.py`` (``ple`` 16384², the four TRSMs 32768², RREF and
``invert`` 16384², ``solve_left`` 32768² x 256 with its narrow TRSMs,
``kernel_left`` 4096²) and at the McEliece sizes of its batched phases
(``ple`` 768 x 3488, ``solve_left`` 768² x 1, ``invert`` 768², a 768² TRSM
with a 768 x 64 B), each on the host clock ended by a synchronize.
``--batched`` times the batched launches instead: the trailing update
(4b) and the below-window elimination (6b) on the operands the batched
sweep gives them on the first panel of 256 McEliece matrices (and 6b on its
second panel, where no row is in range), the pivot loop (5b) on that first
panel, on its third (no row in range), on the first panel of
``top_echelonize``'s sweep (a search window of 42), on the first panel of
1024 ISD matrices and on the one panel of 2^20 NIST matrices; then the
single Schur entry points at the four panels above, the single elimination
at 17152 / 34048 rows and the single pivot loop at 576 / 512 and 1088 /
1024, whose kernels share the batched launches' code, each as ``pairs``
pairs of CUDA-event medians (the order flipped from pair to pair); then
``rank_batched`` of 2^20 32 x 32 matrices, ``ple_batched`` of the 256
McEliece matrices, ``invert_batched`` of 1024 768² ones,
``top_echelonize_batched`` of the 256 in REF and a batch of one 16384² and
32768² (``block_factor_batched``, L preserved), on the host clock ended by a
synchronize, in pairs as well.
One JSON object a line.  Needs the card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import m4ri_tpu_torch as new_pkg
from m4ri_tpu_torch.benches.split_launch import SHAPES as GEMM_SHAPES
from m4ri_tpu_torch.benches.split_launch import operands as gemm_operands


def load_parent(root: str):
    """The other tree's package, under the name m4ri_tpu_torch_parent."""
    init = pathlib.Path(root) / "m4ri_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        "m4ri_tpu_torch_parent", init,
        submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["m4ri_tpu_torch_parent"] = mod
    spec.loader.exec_module(mod)
    return mod


def sub(pkg, name: str):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def emit(what: str, **fields) -> None:
    print(json.dumps({"what": what, **fields}), flush=True)


def event_ms(fn, runs: int = 11, warmup: int = 3) -> list:
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
    return ts


def host_ms(fn, runs: int, warmup: int = 1) -> list:
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return ts


def summary(ts: list) -> dict:
    return {"median": statistics.median(ts), "min": min(ts), "max": max(ts),
            "runs": len(ts)}


def in_turns(old_fn, new_fn, timer, **kw) -> dict:
    """parent, this tree, this tree, parent."""
    o1, n1, n2, o2 = (timer(f, **kw) for f in (old_fn, new_fn, new_fn, old_fn))
    return {"parent_ms": summary(o1 + o2), "this_ms": summary(n1 + n2)}


def in_pairs(old_fn, new_fn, timer, pairs: int = 10, **kw) -> dict:
    """``pairs`` pairs of runs, parent first in even pairs and this tree
    first in odd ones; each run the median of ``timer``'s times; the
    summary is over the runs' medians."""
    old, new = [], []
    for i in range(pairs):
        order = ((old_fn, old), (new_fn, new))
        for fn, out in (order if i % 2 == 0 else order[::-1]):
            out.append(statistics.median(timer(fn, **kw)))
    return {"parent_ms": summary(old), "this_ms": summary(new),
            "pairs": pairs}


def packed(rng, rows: int, cols: int) -> torch.Tensor:
    x = rng.integers(0, 2**32, (rows, cols // 32), dtype=np.uint64)
    return torch.from_numpy(x.astype(np.uint32).view(np.int32)).cuda()


def schur_calls(pkg, c, lp, up, r0: int, c0w: int) -> dict:
    """Both entry points of a tree, called as its sweep calls them."""
    mod = sub(pkg, "ops.hopper_schur")
    tiles_j = -(-c.shape[1] // mod.TILE_WORDS)
    skip = min(c0w // mod.TILE_WORDS, tiles_j - 1)
    return {
        "gf2_schur_update_hopper": lambda: mod.gf2_schur_update_hopper(
            c, lp, up, r0, c0w, col_tile_skip=skip),
        "gf2_schur_update_dyn_hopper": lambda: mod.gf2_schur_update_dyn_hopper(
            c, lp, up, r0, c0w)}


def unit_diagonal(words: torch.Tensor) -> torch.Tensor:
    """The words of a square matrix with its diagonal set: unit upper in
    one triangle, junk in the other, and the other way round."""
    idx = torch.arange(words.shape[0], device=words.device)
    out = words.clone()
    out[idx, idx // 32] |= torch.ones_like(out[idx, 0]) << (idx % 32).to(
        torch.int32)
    return out


def solver_cases(rng):
    """(label, entry point, operands as (words, ncols), runs); from_packed
    clears the padding bits."""
    t32 = unit_diagonal(packed(rng, 32768, 32768))
    b32 = packed(rng, 32768, 32768)
    yield "ple 16384", "ple", [(packed(rng, 16384, 16384), 16384)], 5
    for name in ("trsm_upper_left", "trsm_lower_left", "trsm_upper_right",
                 "trsm_lower_right"):
        yield f"{name} 32768", name, [(t32, 32768), (b32, 32768)], 3
    del t32, b32
    a16 = packed(rng, 16384, 16384)
    yield "echelonize 16384", "echelonize", [(a16, 16384)], 5
    yield "invert 16384", "invert", [(a16, 16384)], 5
    yield ("solve_left 32768 x 256", "solve_left",
           [(packed(rng, 32768, 32768), 32768),
            (packed(rng, 32768, 256), 256)], 3)
    yield ("kernel_left 4096", "kernel_left",
           [(packed(rng, 4096, 4096), 4096)], 5)
    yield "ple 768 x 3488", "ple", [(packed(rng, 768, 3488), 3488)], 11
    a768 = packed(rng, 768, 768)
    yield ("solve_left 768 x 1", "solve_left",
           [(a768, 768), (packed(rng, 768, 32), 1)], 11)
    yield "invert 768", "invert", [(a768, 768)], 11
    yield ("trsm_upper_left 768 x 64", "trsm_upper_left",
           [(unit_diagonal(a768), 768), (packed(rng, 768, 64), 64)], 11)


def flat(out) -> list:
    """The tensors and ints of an entry point's result, in order."""
    parts = out if isinstance(out, tuple) else (out,)
    return [getattr(x, "data", x) for x in parts]


def same_output(a, b) -> bool:
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(flat(a), flat(b)))


def solver_in_turns(old_pkg, rng) -> None:
    for label, name, operands, runs in solver_cases(rng):
        args_n = [new_pkg.from_packed(w, n) for w, n in operands]
        args_o = [old_pkg.from_packed(w, n) for w, n in operands]
        fn_n, fn_o = getattr(new_pkg, name), getattr(old_pkg, name)
        same = same_output(fn_o(*args_o), fn_n(*args_n))
        t = in_turns(lambda: fn_o(*args_o), lambda: fn_n(*args_n), host_ms,
                     runs=runs)
        emit("single_solver", entry=label, equal=same, **t)
        del args_n, args_o


def same_all(a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def schur_in_turns(old_pkg, rng, timer=in_turns) -> None:
    """Both single Schur entry points of both trees at the first and the
    middle panel of the sweeps at n=16384 (nb=512) and n=32768 (nb=1024)."""
    plain = sub(new_pkg, "ops.hopper_schur").gf2_schur_update_plain
    for (m, nw, k, panels) in [(17152, 512, 512, [(0, 16), (8192, 272)]),
                               (34048, 1024, 1024, [(0, 32), (16384, 544)])]:
        c0 = packed(rng, m, nw * 32)
        lp0, up0 = packed(rng, m, k), packed(rng, k, nw * 32)
        for (r0, c0w) in panels:
            lp, up = lp0.clone(), up0.clone()
            lp[:r0] = 0
            up[:, :c0w] = 0
            want = plain(c0.clone(), lp, up)
            c_old, c_new = c0.clone(), c0.clone()
            old, new = (schur_calls(old_pkg, c_old, lp, up, r0, c0w),
                        schur_calls(new_pkg, c_new, lp, up, r0, c0w))
            for name in old:
                c_old.copy_(c0)
                c_new.copy_(c0)
                old[name]()
                new[name]()
                torch.cuda.synchronize()
                same = torch.equal(c_old, want) and torch.equal(c_new, want)
                t = timer(old[name], new[name], event_ms)
                emit("schur", kernel=name, c_words=[m, nw], k=k, r0=r0,
                     c0w=c0w, equal=same, **t)
            del want, c_old, c_new
        del c0, lp0, up0


def batched_in_turns(old_pkg, seed: int) -> None:
    """4b, 6b and 5b of both trees on the batched sweep's operands, the
    single Schur, elimination and pivot-loop launches, then the batched
    entry points."""
    from m4ri_tpu_torch.benches.split_batched import (MCELIECE, NIST,
                                                      capture_panel,
                                                      loop_operands, stack)
    B, m, n = MCELIECE
    data = stack(seed, B, m, n)
    first = capture_panel(data, n, False)
    second = capture_panel(data, n, False, panel=1)
    mods = {t: (sub(pkg, "ops.hopper_schur"), sub(pkg, "ops.hopper_post"),
                sub(pkg, "ops.hopper_panel"))
            for t, pkg in (("old", old_pkg), ("new", new_pkg))}
    c, lp, up, r0s, c0w = first["gf2_schur_update_batched_hopper"]
    outs = {}
    for t, (sch, *_) in mods.items():
        outs[t] = sch.gf2_schur_update_batched_hopper(c.clone(), lp, up, r0s,
                                                      c0w)
    torch.cuda.synchronize()
    cc = {t: c.clone() for t in mods}
    fns = {t: (lambda t=t: mods[t][0].gf2_schur_update_batched_hopper(
        cc[t], lp, up, r0s, c0w)) for t in mods}
    emit("batched_kernel", kernel="gf2_schur_update_batched_hopper",
         operands="McEliece first panel", shape=list(c.shape) + [up.shape[1]],
         equal=same_all(outs["old"], outs["new"]),
         **in_pairs(fns["old"], fns["new"], event_ms, runs=5, warmup=1))
    del c, lp, up, cc, outs
    for label, ops in (("McEliece first panel",
                        first["panel_post_hopper_batched"]),
                       ("McEliece second panel (no row in range)",
                        second["panel_post_hopper_batched"])):
        fns = {t: (lambda t=t: mods[t][1].panel_post_hopper_batched(*ops))
               for t in mods}
        same = same_all(fns["old"](), fns["new"]())
        emit("batched_kernel", kernel="panel_post_hopper_batched",
             operands=label, shape=list(ops[0].shape), equal=same,
             **in_pairs(fns["old"], fns["new"], event_ms, runs=5, warmup=1))
    loops = {"McEliece first panel": first["panel_loop_hopper_batched"]}
    del first, second, fns
    loops.update(loop_operands(data, seed))
    for label, ops in loops.items():
        fns = {t: (lambda t=t: mods[t][2].panel_loop_hopper_batched(*ops))
               for t in mods}
        same = same_all(fns["old"](), fns["new"]())
        emit("batched_kernel", kernel="panel_loop_hopper_batched",
             operands=label, shape=list(ops[0].shape), search_window=ops[6],
             equal=same,
             **in_pairs(fns["old"], fns["new"], event_ms, runs=5, warmup=1))
    del loops, fns

    # the single launches whose kernels share the batched ones' code
    rng = np.random.default_rng(seed)
    schur_in_turns(old_pkg, rng, timer=in_pairs)
    for m_pad, nb, below0, mvalid in ((17152, 512, 576, 16384),
                                      (34048, 1024, 1088, 32768)):
        xw = packed(rng, m_pad, nb)
        msm, wm = (torch.from_numpy((rng.random((nb, nb)) < 0.5)
                                    .astype(np.int8)).cuda() for _ in range(2))
        cmb = torch.from_numpy((rng.random(nb) < 0.2).astype(np.int8)).cuda()
        fns = {t: (lambda t=t: mods[t][1].panel_post_hopper(
            xw, msm, wm, cmb, below0, mvalid)) for t in mods}
        same = same_all(fns["old"](), fns["new"]())
        emit("single_post", rows=m_pad, nb=nb, below0=below0, mvalid=mvalid,
             equal=same, **in_pairs(fns["old"], fns["new"], event_ms))
        del xw, msm, wm, cmb
    for h, nb in ((576, 512), (1088, 1024)):
        al0 = torch.cat([packed(rng, h, nb), packed(rng, h, nb) * 0], dim=1)
        fns = {t: (lambda t=t: mods[t][2].panel_loop_hopper(
            al0, 0, 0, h, nb, True)) for t in mods}
        same = same_all(fns["old"](), fns["new"]())
        emit("single_loop", h=h, nb=nb, equal=same,
             **in_pairs(fns["old"], fns["new"], event_ms))
        del al0

    # end to end
    Bn, nn = NIST
    isd = stack(seed + 10, 1024, 768, 768)
    nist = stack(seed + 1, Bn, nn, nn)
    ref = new_pkg.echelonize_batched(data, n, full=False)[0]
    one16, one32 = (packed(rng, k, k)[None] for k in (16384, 32768))
    for label, name, args, pairs in (
            ("ple_batched 256 x 768x3488", "ple_batched", (data, n), 10),
            ("invert_batched 1024 x 768^2", "invert_batched", (isd,), 10),
            ("rank_batched 2^20 x 32^2", "rank_batched", (nist, nn), 10),
            ("top_echelonize_batched 256 x 768x3488 in REF",
             "top_echelonize_batched", (ref, n), 10),
            ("batched_one 16384^2", "block_factor_batched",
             (one16, 16384, True), 10),
            ("batched_one 32768^2", "block_factor_batched",
             (one32, 32768, True), 10)):
        fn_o, fn_n = getattr(old_pkg, name), getattr(new_pkg, name)
        same = same_all(fn_o(*args), fn_n(*args))
        emit("batched_entry", entry=label, equal=same,
             **in_pairs(lambda: fn_o(*args), lambda: fn_n(*args), host_ms,
                        runs=1))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--quick", action="store_true",
                    help="kernels only, no factorizations")
    ap.add_argument("--solver", action="store_true",
                    help="the single-matrix solver entry points only")
    ap.add_argument("--batched", action="store_true",
                    help="the batched launches 4b / 6b / 5b, the single "
                         "launches that share their code, the batched entry "
                         "points")
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("old_new: needs the card")
    old_pkg = load_parent(args.parent)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    emit("card", card=card, torch=torch.__version__)
    rng = np.random.default_rng(args.seed)
    if args.solver:
        solver_in_turns(old_pkg, rng)
        return
    if args.batched:
        batched_in_turns(old_pkg, 900)
        return

    # ---- the GEMM wrappers, then the products a user calls
    for label, (m, k, n) in GEMM_SHAPES:
        a, b, _ = gemm_operands(label, m, k, n)
        for mod, name in (("ops.hopper_mul", "gf2_mul_hopper"),
                          ("ops.hopper_mul2", "gf2_mul_hopper_v2")):
            old_fn = getattr(sub(old_pkg, mod), name)
            new_fn = getattr(sub(new_pkg, mod), name)
            out_o = torch.empty((m, n // 32), dtype=torch.int32, device="cuda")
            out_n = torch.empty_like(out_o)
            old_fn(a, b, out=out_o)
            new_fn(a, b, out=out_n)
            torch.cuda.synchronize()
            t = in_turns(lambda: old_fn(a, b, out=out_o),
                         lambda: new_fn(a, b, out=out_n), event_ms)
            emit("gemm", wrapper=name, shape=label, mkn=[m, k, n],
                 equal=torch.equal(out_o, out_n), **t)
        del a, b, out_o, out_n
    for n, runs in ((4096, 11), (16384, 3)):
        A = new_pkg.from_packed(packed(rng, n, n), n)
        B = new_pkg.from_packed(packed(rng, n, n), n)
        Ao, Bo = (old_pkg.from_packed(x.data, n) for x in (A, B))
        same = torch.equal(old_pkg.mul(Ao, Bo).data, new_pkg.mul(A, B).data)
        t = in_turns(lambda: old_pkg.mul(Ao, Bo), lambda: new_pkg.mul(A, B),
                     event_ms, runs=runs)
        emit("mul", n=n, equal=same, **t)
        del A, B, Ao, Bo

    # ---- the Schur update: C, k and the first and the middle panel
    schur_in_turns(old_pkg, rng)
    if args.quick:
        return

    # ---- end to end
    def factor_inputs():
        n = 16384
        yield "16384 dense random", new_pkg.from_packed(packed(rng, n, n), n), 5
        n, k = 32768, 30016
        B = new_pkg.from_packed(packed(rng, n, k), k)
        C = new_pkg.from_packed(packed(rng, k, n), n)
        yield "32768 product of rank 30016", new_pkg.mul(B, C), 3

    for name, A, runs in factor_inputs():
        # the two trees' containers are different classes of the same layout
        Ao = old_pkg.from_packed(A.data, A.ncols)
        got_o, got_n = old_pkg.ple(Ao), new_pkg.ple(A)
        same = (torch.equal(got_o[0].data, got_n[0].data)
                and torch.equal(got_o[1], got_n[1])
                and torch.equal(got_o[2], got_n[2]) and got_o[3] == got_n[3])
        same_rank = old_pkg.rank(Ao) == new_pkg.rank(A) == got_n[3]
        del got_o, got_n
        t_ple = in_turns(lambda: old_pkg.ple(Ao), lambda: new_pkg.ple(A),
                         host_ms, runs=runs)
        t_rank = in_turns(lambda: old_pkg.rank(Ao), lambda: new_pkg.rank(A),
                          host_ms, runs=runs)
        emit("end_to_end", input=name, equal=same and same_rank, ple=t_ple,
             rank=t_rank)


if __name__ == "__main__":
    main()

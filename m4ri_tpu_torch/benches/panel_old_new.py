"""The panel loop and the panel post of two trees, timed in turns on one card.

    python -m m4ri_tpu_torch.benches.panel_old_new --parent DIR [--quick]

DIR holds a checkout of another commit of this repository (unpack one with
``git archive <commit> | tar -x -C DIR``); its ``m4ri_tpu_torch`` is loaded
under another name beside this one, both build their kernels, and every
measurement is made parent, this tree, this tree, parent inside this one
process, so that the card, its clocks and its power limit are the same for
both.  Outputs are checked equal before anything is timed.  Also: the chain
alone (``row_work=False``), the chain floor probe, and ``ple`` / ``rank``
end to end.  One JSON
object a line.  Needs the card and ``nvcc``.
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


def packed(rng, rows: int, cols: int) -> torch.Tensor:
    x = rng.integers(0, 2**32, (rows, cols // 32), dtype=np.uint64)
    return torch.from_numpy(x.astype(np.uint32).view(np.int32)).cuda()


def window(rng, h: int, nb: int, zero=None) -> torch.Tensor:
    x = packed(rng, h, nb)
    if zero:
        x[zero[0]:zero[1]] = 0
    return torch.cat([x, torch.zeros_like(x)], dim=1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--quick", action="store_true",
                    help="kernels only, no factorizations")
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("panel_old_new: needs the card")
    old_pkg = load_parent(args.parent)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    emit("card", card=card, torch=torch.__version__)
    rng = np.random.default_rng(args.seed)
    o_panel, n_panel = sub(old_pkg, "ops.hopper_panel"), sub(new_pkg, "ops.hopper_panel")
    o_post, n_post = sub(old_pkg, "ops.hopper_post"), sub(new_pkg, "ops.hopper_post")

    # ---- the panel loop
    for (h, nb, zero) in [(576, 512, None), (1088, 1024, None),
                          (17152, 512, None), (34048, 1024, None),
                          (4352, 512, (600, 2000))]:
        for pres in (True, False):
            al0 = window(rng, h, nb, zero)
            a = (al0, 0, 0, h, nb, pres, 0)
            got_o, got_n = o_panel._launch(*a), n_panel._launch(*a)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(got_o, got_n))
            slow = h > 8192                      # the parent takes 65-260 ms
            t = in_turns(lambda: o_panel._launch(*a), lambda: n_panel._launch(*a),
                         event_ms, runs=3 if slow else 11, warmup=1 if slow else 3)
            chain = summary(event_ms(
                lambda: n_panel._launch(*a, row_work=False), runs=5, warmup=1))
            old_chain = summary(event_ms(
                lambda: o_panel._launch(*a, row_work=False), runs=3, warmup=1))
            threads = n_panel.kernel_threads(h)
            floor = summary(event_ms(lambda: n_panel.chain_floor(nb, threads)))
            emit("panel_loop", h=h, nb=nb, preserve_l=pres, zeroed=zero,
                 equal=same, rank=int(got_n[2]),
                 mode_parent=o_panel.window_mode(h, nb),
                 mode_this=n_panel.window_mode(h, nb), **t,
                 this_chain_alone_ms=chain, parent_without_row_work_ms=old_chain,
                 chain_floor_ms=floor, threads=threads)
    # ---- the panel post
    for (m, nb, below0, mvalid) in [(17152, 512, 1576, 16390),
                                    (34048, 1024, 3588, 32770)]:
        wide = packed(rng, m, nb + 4096)
        xw = wide[:, 64:64 + nb // 32]
        msm, wm = (torch.from_numpy(
            (rng.random((nb, nb)) < 0.5).astype(np.int8)).cuda() for _ in range(2))
        cmb = torch.from_numpy((rng.random(nb) < 0.2).astype(np.int8)).cuda()
        a = (xw, msm, wm, cmb, below0, mvalid)
        got_o, got_n = o_post.panel_post_hopper(*a), n_post.panel_post_hopper(*a)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got_o, got_n))
        t = in_turns(lambda: o_post.panel_post_hopper(*a),
                     lambda: n_post.panel_post_hopper(*a), event_ms)
        pack = summary(event_ms(
            lambda: n_post.pack_operands_hopper(msm, wm, cmb)))
        pack_plain = summary(event_ms(
            lambda: (n_post._packed_transposed(msm), n_post._packed_transposed(wm),
                     n_post._packed_colmask(cmb))))
        emit("panel_post", m=m, nb=nb, rows=[below0, mvalid], equal=same, **t,
             packing_kernel_ms=pack, packing_plain_ms=pack_plain)
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
        n = 4096
        a = packed(rng, n, n)
        a[600:2000] = 0
        yield "4096 with rows 600-1999 zeroed", new_pkg.from_packed(a, n), 5

    for name, A, runs in factor_inputs():
        # the two trees' containers are different classes of the same layout
        Ao = old_pkg.from_packed(A.data, A.ncols)
        got_o, got_n = old_pkg.ple(Ao), new_pkg.ple(A)
        same = (torch.equal(got_o[0].data, got_n[0].data)
                and torch.equal(got_o[1], got_n[1])
                and torch.equal(got_o[2], got_n[2]) and got_o[3] == got_n[3])
        before = new_pkg.block_factor.miss_fallbacks
        new_pkg.ple(A)
        misses = new_pkg.block_factor.miss_fallbacks - before
        del got_o, got_n
        t_ple = in_turns(lambda: old_pkg.ple(Ao), lambda: new_pkg.ple(A),
                         host_ms, runs=runs)
        t_rank = in_turns(lambda: old_pkg.rank(Ao), lambda: new_pkg.rank(A),
                          host_ms, runs=runs)
        emit("end_to_end", input=name, equal=same, miss_fallbacks=misses,
             ple=t_ple, rank=t_rank)
    # one measured line on the wide panel at 32768, no default changed
    n = 32768
    A = new_pkg.from_packed(packed(rng, n, n), n)
    for nb, win in ((512, 576), (1024, 1088)):
        f = lambda: new_pkg.block_factor(A, preserve_l=True, nb=nb, window=win)
        emit("block_factor_32768_dense", nb=nb, window=win, rank=f()[3],
             ms=summary(host_ms(f, runs=3)))


if __name__ == "__main__":
    main()

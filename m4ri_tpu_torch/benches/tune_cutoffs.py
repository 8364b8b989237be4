"""The measurements two of the card's defaults rest on.

1. ``mul`` at n = 16384, 32768 and 65536: the direct kernel product against
   one and two Strassen-Winograd levels over it (``strassen_mul_data`` with
   the depth forced), CUDA events.  This sets ``strassen_cutoff`` and
   ``strassen_depth3_min`` in ``utils/config.py``.
2. ``trsm_upper_left`` and ``trsm_lower_right`` at 32768 (T 32768 x 32768,
   B 32768 x 32768) with ``trsm_wide_base`` in {2048, 4096, 8192}, under
   Strassen cutoffs 8192 and 65536 (a level over the 16384 products, or
   none): host clock around calls that end in a synchronize.

Every route's result is held equal to the first one's (GF(2) is exact, so
the bits do not depend on the route).  Needs the card and ``nvcc``:

    python -m m4ri_tpu_torch.benches.tune_cutoffs [--runs 3]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from ..core.bitmatrix import randomize
from ..models import triangular
from ..ops.strassen import strassen_mul_data
from ..utils import config as config_mod
from .old_new import event_ms, host_ms, summary

MUL_SIZES = (16384, 32768, 65536)
WIDE_BASES = (2048, 4096, 8192)
TRSM_N = 32768
# the largest products of a TRSM at 32768 have a smallest side of 16384:
# cutoff 8192 takes them through one Strassen level, 65536 directly
TRSM_CUTOFFS = (8192, 65536)


def _times(timer, fn, runs: int) -> dict:
    ts = timer(fn, runs=runs, warmup=1)
    return {**summary(ts), "all": ts}


def _with_env(values: dict, fn):
    """Run ``fn`` with Config fields overridden as a user would set them."""
    keys = {f"M4RI_TPU_TORCH_{k.upper()}": str(v) for k, v in values.items()}
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(keys)
    config_mod.get_config.cache_clear()
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
        config_mod.get_config.cache_clear()


def strassen_table(g, runs: int) -> list:
    rows = []
    for n in MUL_SIZES:
        a, b = randomize(n, n, g), randomize(n, n, g)
        ref = None
        for levels in (0, 1, 2):
            def run():
                return strassen_mul_data(a.data, b.data, n, n, n,
                                         cutoff=1024, max_levels=levels)
            out = run()
            if ref is None:
                ref = out
            elif not torch.equal(out, ref):
                raise SystemExit(f"mul {n}: {levels} levels differ from direct")
            del out
            t = _times(event_ms, run, runs)
            rows.append({"n": n, "strassen_levels": levels, "ms": t,
                         "tbitops_per_s": 2 * n**3 / t["median"] / 1e9})
        del a, b, ref
        torch.cuda.empty_cache()
    return rows


def trsm_table(g, runs: int) -> list:
    n = TRSM_N
    t = randomize(n, n, g)
    b = randomize(n, n, g)
    # a unit diagonal; the other triangle holds junk, as the solvers hand it
    idx = torch.arange(n, device=t.device)
    t.data[idx, idx // 32] |= torch.ones_like(idx, dtype=torch.int32) << (
        idx % 32).to(torch.int32)
    rows = []
    for name in ("trsm_upper_left", "trsm_lower_right"):
        fn = getattr(triangular, name)
        ref = None
        for cutoff in TRSM_CUTOFFS:
            for base in WIDE_BASES:
                env = {"trsm_wide_base": base, "strassen_cutoff": cutoff}
                out = _with_env(env, lambda: fn(t, b))
                if ref is None:
                    ref = out.data
                elif not torch.equal(out.data, ref):
                    raise SystemExit(f"{name}: {env} differs")
                del out
                ms = _with_env(env, lambda: _times(host_ms, lambda: fn(t, b), runs))
                rows.append({"op": name, "n": n, "trsm_wide_base": base,
                             "strassen_cutoff": cutoff, "ms": ms})
        del ref
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    default = config_mod.get_config()
    out = {"card": card, "config": default.derived_from,
           "default_strassen_cutoff": default.strassen_cutoff,
           "default_strassen_depth3_min": default.strassen_depth3_min,
           "default_trsm_wide_base": default.trsm_wide_base,
           "mul": strassen_table(g, args.runs),
           "trsm": trsm_table(g, args.runs)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()

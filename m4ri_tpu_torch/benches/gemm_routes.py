"""The two routes of a large product, timed in turns on one card: the data
behind ``ops/mul.py``'s gate between ``gf2_mul_hopper`` (the contraction
never split) and ``gf2_mul_hopper_v2`` (split where the tiles of C do not
fill the card, ``hopper_mul.gemm_plan``).

    python -m m4ri_tpu_torch.benches.gemm_routes

For 4096³, 8192³, 16384³ and 8192×512×8192 it checks both routes' words
equal, then times them v1, v2, v2, v1, each turn 11 CUDA-event runs after
warm-up, and prints one JSON object a shape: each route's median over its
22 runs, the median of each of its two turns (their distance is the
spread), the plan each route launches (splits, stages a run, grid) and the
route ``_route`` picks today.  Needs the card and ``nvcc``.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import numpy as np
import torch

from ..ops import hopper_mul
from ..ops.hopper_mul import gf2_mul_hopper
from ..ops.hopper_mul2 import gf2_mul_hopper_v2
from ..ops.mul import _route
from ..utils.config import get_config
from .old_new import event_ms, packed

SHAPES = [(4096, 4096, 4096), (8192, 8192, 8192), (16384, 16384, 16384),
          (8192, 512, 8192)]
RUNS = 11


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gemm_routes: needs the card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(17)
    for m, k, n in SHAPES:
        a, b = packed(rng, m, k), packed(rng, k, n)
        v1 = lambda: gf2_mul_hopper(a, b)       # noqa: E731
        v2 = lambda: gf2_mul_hopper_v2(a, b)    # noqa: E731
        if not torch.equal(v1(), v2()):
            raise SystemExit(f"gemm_routes: v1 and v2 differ at {m}x{k}x{n}")
        turns = [event_ms(f, runs=RUNS) for f in (v1, v2, v2, v1)]
        per = {"v1": turns[0] + turns[3], "v2": turns[1] + turns[2]}
        kw, nw = k // 32, n // 32
        print(json.dumps({
            "shape": [m, k, n], "card": card, "sms": sms,
            "route_today": _route(m, kw, nw, get_config()),
            "v1_ms": statistics.median(per["v1"]),
            "v2_ms": statistics.median(per["v2"]),
            "v1_turn_ms": [statistics.median(turns[0]), statistics.median(turns[3])],
            "v2_turn_ms": [statistics.median(turns[1]), statistics.median(turns[2])],
            "v1_plan": hopper_mul.gemm_plan(m, nw, kw, sms, split=False),
            "v2_plan": hopper_mul.gemm_plan(m, nw, kw, sms, split=True),
            "runs": RUNS}), flush=True)
        del a, b


if __name__ == "__main__":
    main()

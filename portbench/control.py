"""The control of a cell: its reference with one stated guarantee broken,
put in the program's place, through the rest of a run at the cell's own
size.  Every seed has to come out not correct.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--seconds 1]

Prints one JSON line a seed (``correct`` and the checks beside their
limits) and exits with 0 only if no seed came out correct.  The window is
short: the control is slow, and one judged call shows what it gives.  Needs
a CUDA device, as a run does.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness, run
    run.environment()
    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device; none is available",
              file=sys.stderr)
        return 2
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.load_cell(bench, args.workload)
    caught = 0
    for seed in args.seeds:
        out = harness.run(cell, seed, args.seconds, False, time.perf_counter(),
                          call=cell.entry.control)
        res = out["result"]
        caught += not res["correct"]
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": res["correct"], "checks": res["checks"],
                          "notes": out["notes"]}), flush=True)
    return 0 if caught == len(args.seeds) else 1


if __name__ == "__main__":
    sys.exit(main())

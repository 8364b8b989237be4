"""Run one cell of the benchmark of m4ri_tpu_torch once, on this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON object as its last line (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last) and the checks beside their limits as the last lines of
standard error.  Needs a CUDA device; exits with another code than 0, and
prints no result, without one or when JAX or the JAX package is loaded.
"""

import time

T0 = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / ".cache"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def environment() -> None:
    """Caches at fixed paths inside the checkout, and the program on its own
    defaults: no ``M4RI_TPU_TORCH_*`` override reaches it.  (The program
    builds its kernels into ``m4ri_tpu_torch/build/``, inside the checkout
    too.)"""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    for key in [k for k in os.environ if k.startswith("M4RI_TPU_TORCH_")]:
        del os.environ[key]


def main(argv=None) -> int:
    args = parse(argv)
    environment()
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())

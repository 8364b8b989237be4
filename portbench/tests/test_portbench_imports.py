"""What the benchmark loads: never JAX or the JAX package (compared by the
whole top-level name: ``m4ri_tpu_torch`` begins with ``m4ri_tpu``), the
reference nothing of the program, and a run reads none of the JAX
package's benchmark records."""

import json
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "m4ri_tpu"}


def loaded_after(code: str) -> set:
    """Top-level names in ``sys.modules`` after ``code`` runs in a fresh
    interpreter at the repository's root."""
    script = (code + "\nimport sys, json\n"
              "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    got = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr
    return {n.split(".")[0] for n in json.loads(got.stdout.splitlines()[-1])}


def test_harness_loads_no_jax():
    top = loaded_after(
        "import portbench.harness, portbench.run, portbench.control, "
        "portbench.trace\n"
        "import portbench.entries.ple, portbench.entries.mul\n"
        "import portbench.entries.echelonize_batched\n"
        "import portbench.entries.solve_left_batched\n"
        "import m4ri_tpu_torch\n"
        "from portbench import harness\n"
        "import pathlib\n"
        "for p in pathlib.Path('portbench/metrics').glob('*.py'):\n"
        "    harness.reader(p.stem)\n")
    assert "m4ri_tpu_torch" in top and "portbench" in top
    assert not top & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    top = loaded_after("import portbench.reference.gf2, "
                       "portbench.reference.ple, portbench.reference.rref")
    assert "torch" in top
    assert not top & (FORBIDDEN | {"m4ri_tpu_torch"})


def test_a_run_reads_no_record_of_the_jax_package():
    """A whole run on the CPU under an audit hook: no file opened is
    ``bench.py``, under ``benches/`` or a ``BENCH_*.json`` at the root."""
    script = (
        "import sys, time\n"
        "opened = []\n"
        "sys.addaudithook(lambda ev, args: opened.append(str(args[0])) "
        "if ev == 'open' else None)\n"
        "from portbench import harness\n"
        "bench = harness.load_json(harness.ROOT / 'BENCHMARK.json')\n"
        "for name in [w['name'] for w in bench['workloads']]:\n"
        "    cell = harness.load_cell(bench, name)\n"
        "    cell.config.update(rows=64, cols=96)\n"
        "    cell.traffic['batch'] = 3\n"
        "    out = harness.run(cell, 9, 0.05, False, time.perf_counter(),"
        " device='cpu')\n"
        "    assert out['result']['correct'], name\n"
        "import json\n"
        "print(json.dumps(opened))\n")
    got = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr
    opened = [os.path.abspath(os.path.join(ROOT, p))
              for p in json.loads(got.stdout.splitlines()[-1])]
    jax_records = [p for p in opened
                   if p == str(ROOT / "bench.py")
                   or p.startswith(str(ROOT / "benches") + os.sep)
                   or (os.path.dirname(p) == str(ROOT)
                       and os.path.basename(p).startswith("BENCH_"))]
    assert jax_records == []
    assert str(ROOT / "BENCHMARK.json") in opened

"""On the card: each cell once through ``run.py`` (a short window), and its
control through ``control.py``.  Skipped without a CUDA device.

    python3 -m pytest portbench/tests -m cuda
"""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = ["dense32768.ple", "mceliece348864.keygen", "dense32768.mul",
         "mceliece348864.isd"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_correct(card, name, traced):
    got = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(2**31 + 101), "--seconds", "3", "--trace", str(traced)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-4000:]
    res = json.loads(got.stdout.splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if traced:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_caught(card, name):
    got = subprocess.run(
        [sys.executable, "portbench/control.py", "--workload", name,
         "--seeds", "1", "2", "3"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert got.returncode == 0, got.stdout + got.stderr[-4000:]

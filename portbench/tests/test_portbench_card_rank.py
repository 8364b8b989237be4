"""On the card: the cell ``nist_sp800_22.rank`` once through ``run.py`` (a
short window, untraced and traced) and its control through ``control.py``,
as ``test_portbench_card.py`` runs the other cells.  Skipped without a CUDA
device.

    python3 -m pytest portbench/tests -m cuda
"""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELL = "nist_sp800_22.rank"


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [0, 1])
def test_rank_cell_runs_correct(card, traced):
    got = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         str(2**31 + 103), "--seconds", "3", "--trace", str(traced)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-4000:]
    res = json.loads(got.stdout.splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["checks"]["ranks_differing"]["value"] == 0
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if traced:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        # the root span makes the sweep's span metrics readable
        assert {"sweep_host_ms", "readback_wait_ms"} <= set(res["metrics"])
        assert res["metrics"]["host_syncs_per_call"]["value"] == 1


@pytest.mark.cuda
def test_rank_control_is_caught(card):
    got = subprocess.run(
        [sys.executable, "portbench/control.py", "--workload", CELL,
         "--seeds", "1", "2", "3"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert got.returncode == 0, got.stdout + got.stderr[-4000:]

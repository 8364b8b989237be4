"""BENCHMARK.json against the benchmark's contract, and every part of a
cell found by its name, a new one too."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE_KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes(bench):
    assert set(bench) == LINE_KEYS["top"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert bench["command"][1:] == ["portbench/run.py"]
    assert 1 <= len(bench["command"]) <= 32
    assert all(one_line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[key]:
            extra = {"workloads"} if key in ("end_to_end", "per_layer") \
                else set()
            assert LINE_KEYS[key] <= set(entry) <= LINE_KEYS[key] | extra


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end",
                                 "per_layer"])
def test_names_unique_and_well_formed(bench, key):
    names = [e["name"] for e in bench[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    assert 1 <= len(bench["configs"]) <= 24
    for c in bench["configs"]:
        assert c["name"] in used
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        for key in ("source", "deployment", "guarantees", "assumed"):
            assert cfg[key]


def test_workloads(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert 1 <= len(pairs) <= 24
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(pairs) // 4)
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and one_line(w["why"])
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        # <metric>.<group> is read by metrics/<metric>.py
        assert any((ROOT / "portbench" / "metrics" / f"{n}.py").is_file()
                   for n in (m["name"], m["name"].split(".")[0]))
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert one_line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reports = lambda m: cell in m.get("workloads", [cell])  # noqa: E731
        names = [m["name"] for m in bench["end_to_end"] if reports(m)]
        assert "setup_s" in names and len(names) >= 2
        assert any(reports(m) for m in bench["per_layer"])


def test_every_metric_moves_what_its_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m.get("workloads", cells)) <= set(moved)


def test_cells_found_by_name(bench):
    from portbench import harness
    for w in bench["workloads"]:
        cell = harness.load_cell(bench, w["name"])
        assert cell.entry.__name__.endswith(cell.traffic["entry"])
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.reader(m["name"]))
    with pytest.raises(KeyError):
        harness.load_cell(bench, "no.such.cell")


def test_a_new_config_mix_and_metric_are_files_of_their_own(tmp_path):
    """A later change adds a configuration, a traffic mix and a per-layer
    metric as new files and entries; the harness runs the new cell (here on
    the CPU, at a small size) without an edit to any file it has."""
    copy = tmp_path / "repo"
    shutil.copytree(ROOT / "portbench", copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "a test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.rref", "config": "tiny",
                               "traffic": "tiny_rref", "chips": 1,
                               "why": "a test"})
    rate = {m["name"]: m for m in bench["end_to_end"]}["matrices_per_s"]
    rate["workloads"].append("tiny.rref")
    bench["per_layer"].append({"name": "calls_seen", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "matrices_per_s",
                               "workloads": ["tiny.rref"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    (copy / "portbench/configs/tiny.json").write_text(json.dumps(
        {"rows": 24, "cols": 70}))
    (copy / "portbench/traffic/tiny_rref.json").write_text(json.dumps(
        {"entry": "echelonize_batched", "batch": 3, "pool": 2, "sample": 2}))
    (copy / "portbench/metrics/calls_seen.py").write_text(
        "def read(rec):\n    return rec.calls\n")
    script = (
        "import json, sys, time\n"
        "from portbench import harness\n"
        "assert harness.HERE.parent.samefile(sys.argv[1])\n"
        "bench = harness.load_json(harness.ROOT / 'BENCHMARK.json')\n"
        "cell = harness.load_cell(bench, 'tiny.rref')\n"
        "out = harness.run(cell, 11, 0.2, False, time.perf_counter(),"
        " device='cpu')\n"
        "rec = harness.Records(1.0, 1.0, 5, 15, [], 0, {})\n"
        "print(json.dumps([out['result']['correct'],"
        " [m['name'] for m in cell.per_layer], out['result']['metrics'],"
        " harness.reader('calls_seen')(rec)]))\n")
    env = dict(os.environ, PYTHONPATH=f"{copy}{os.pathsep}{ROOT}")
    got = subprocess.run([sys.executable, "-c", script, str(copy)],
                         capture_output=True, text=True, env=env, cwd=copy,
                         timeout=300)
    assert got.returncode == 0, got.stderr
    correct, layer, metrics, seen = json.loads(
        got.stdout.strip().splitlines()[-1])
    assert correct
    assert "calls_seen" in layer and seen == 5
    assert set(metrics) == {"matrices_per_s", "setup_s"}   # no peak on a CPU


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    """With only BENCHMARK.json and ``portbench/`` there is no program to
    run: the run fails before it prints a result line."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    script = (
        "import sys, time\n"
        "sys.path.insert(0, '.')\n"
        "from portbench import harness\n"
        "bench = harness.load_json(harness.ROOT / 'BENCHMARK.json')\n"
        "cell = harness.load_cell(bench, 'dense32768.mul')\n"
        "print(harness.run(cell, 1, 0.1, False, time.perf_counter(),"
        " device='cpu'))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    got = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert got.returncode != 0
    assert "m4ri_tpu_torch" in got.stderr and got.stdout == ""
    run = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "dense32768.mul", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode != 0 and run.stdout == ""

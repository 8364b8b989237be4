"""The rest of a run without the look for a card: each cell at a small size
on the CPU, with the program's plain path, comes out correct; with the
timed path broken underneath, or the control in its place, it does not.

Faults, each where the cell can have it: a call that returns its state
unchanged (the input as the answer), half of the batch left out, and an
answer altered where it is produced.  (No cell exchanges data between
cards.)
"""

import time

import pytest
import torch

from portbench import harness

SMALL = {"dense32768": {"rows": 96, "cols": 130},
         "mceliece348864": {"rows": 40, "cols": 150}}
# where the bfloat16 control has to fail, the contraction passes 256
CONTROL = {"dense32768": {"rows": 1100, "cols": 1400},
           "mceliece348864": {"rows": 40, "cols": 150}}


def cell_at(bench, name, sizes):
    cell = harness.load_cell(bench, name)
    cell.config.update(sizes[cell.config["name"]])
    if "batch" in cell.traffic:
        cell.traffic["batch"] = 6
    return cell


def run(cell, call=None, seconds=0.3, seed=2**31 + 5):
    return harness.run(cell, seed, seconds, False, time.perf_counter(),
                       device="cpu", call=call)


CELLS = ["dense32768.ple", "mceliece348864.keygen", "dense32768.mul",
         "mceliece348864.isd"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(bench, name):
    out = run(cell_at(bench, name, SMALL))
    res = out["result"]
    assert out["error"] is None
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in res["checks"].values())
    assert "setup_s" in res["metrics"]
    assert any(m.split(".")[0] == "matrices_per_s" for m in res["metrics"])


def unchanged(port, inputs, i):
    """The input handed back as if it were the answer."""
    if "pool" in inputs and inputs["pool"].dim() == 3:      # ple
        a = inputs["pool"][i % len(inputs["pool"])]
        m, n = a.shape[0], inputs["n"]
        return (a.clone(), torch.arange(m, dtype=torch.int32),
                torch.arange(n, dtype=torch.int32), min(m, n))
    if "pool" in inputs:                                     # RREF
        h = inputs["pool"][i % len(inputs["pool"])]
        return h.clone(), torch.full((h.shape[0],), h.shape[1],
                                     dtype=torch.int32)
    if "h" in inputs:                                        # solve
        k = i % len(inputs["h"])
        s = inputs["s"][k]
        return s.clone(), torch.ones(s.shape[0], dtype=torch.bool)
    return (inputs["a"].clone(),)                            # product


def half_batch(entry):
    """The call on the first half of the batch; the second half left as
    it came in."""
    def call(port, inputs, i):
        key = "pool" if "pool" in inputs else "h"
        full = inputs[key]
        half = {**inputs, key: full[:, : full.shape[1] // 2]}
        if key == "h":
            half["s"] = inputs["s"][:, : full.shape[1] // 2]
        got = entry.call(port, half, i)
        rest = unchanged(port, {**inputs, key: full[:, full.shape[1] // 2:],
                                **({"s": inputs["s"][:, full.shape[1] // 2:]}
                                   if key == "h" else {})}, i)
        return tuple(torch.cat([a, b]) for a, b in zip(got, rest))
    return call


def altered(entry):
    """One bit of the first output flipped where the call produces it."""
    def call(port, inputs, i):
        out = list(entry.call(port, inputs, i))
        first = out[0].clone()
        first.view(-1)[first.numel() // 2] ^= 1
        out[0] = first
        return tuple(out)
    return call


@pytest.mark.parametrize("name", CELLS)
def test_state_unchanged_is_not_correct(bench, name):
    assert not run(cell_at(bench, name, SMALL), unchanged)["result"]["correct"]


@pytest.mark.parametrize("name", ["mceliece348864.keygen",
                                  "mceliece348864.isd"])
def test_half_the_batch_left_out_is_not_correct(bench, name):
    cell = cell_at(bench, name, SMALL)
    assert not run(cell, half_batch(cell.entry))["result"]["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_an_altered_answer_is_not_correct(bench, name):
    cell = cell_at(bench, name, SMALL)
    if name == "mceliece348864.isd":
        # X is judged where the system is consistent: alter all of X
        def call(port, inputs, i):
            x, cons = cell.entry.call(port, inputs, i)
            return x ^ 1, cons
    else:
        call = altered(cell.entry)
    assert not run(cell, call)["result"]["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(bench, name):
    cell = cell_at(bench, name, CONTROL)
    out = run(cell, cell.entry.control, seconds=0.01)
    assert out["error"] is None
    assert not out["result"]["correct"]
    assert any(c["value"] > c["limit"]
               for c in out["result"]["checks"].values())


def test_a_call_that_raises_is_a_failure(bench):
    made = []

    def broken(port, inputs, i):
        made.append(i)
        if len(made) > harness.WARM_CALLS + 1:   # the window's second call
            raise RuntimeError("the kernel failed")
        return cell.entry.call(port, inputs, i)
    cell = cell_at(bench, "dense32768.mul", SMALL)
    out = run(cell, broken)
    assert out["result"]["failed"] == 1 and not out["result"]["correct"]
    assert "the kernel failed" in out["error"]

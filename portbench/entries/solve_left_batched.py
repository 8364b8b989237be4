"""``m4ri_tpu_torch.solve_left_batched(H, rows, s, 1)`` of a stack of
square systems a call, one right-hand column each: one Prange guess of
information-set decoding a system (the columns of an information set and a
syndrome).

Inputs: a pool of ``traffic["pool"]`` stacks of ``traffic["batch"]``
uniformly random ``rows x rows`` matrices with a uniformly random syndrome
each, made on the device from the seed; call i solves stack ``i % pool``.
The check compares ``consistent`` for every system, and X, the solution
with free variables zero, for every system the reference finds consistent
(elsewhere X means nothing).
"""

from __future__ import annotations

import torch

from portbench.harness import differing
from portbench.reference import gf2
from portbench.reference import rref as reference


def make_inputs(config, traffic, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    m, P, B = config["rows"], traffic["pool"], traffic["batch"]
    h = gf2.random_words((P, B, m, gf2.words_for(m)), m, g, device)
    s = gf2.random_words((P, B, m, 1), 1, g, device)
    return {"h": h, "s": s, "m": m}


def call(port, inputs, i):
    k = i % len(inputs["h"])
    return port.solve_left_batched(inputs["h"][k], inputs["m"],
                                   inputs["s"][k], 1)


def control(port, inputs, i):
    """The reference solving from a row echelon form that is not reduced:
    the solution broken where it is defined."""
    k = i % len(inputs["h"])
    return reference.solve_left(inputs["h"][k], inputs["m"], inputs["s"][k],
                                reduce_above=False)


def judge(inputs, samples):
    """One number: the flags ``consistent`` and the words of X (where the
    reference finds the system consistent) that differ from the
    reference's, over the judged calls."""
    bad, refs = 0, {}
    for i, (x, cons) in samples:
        k = i % len(inputs["h"])
        if k not in refs:
            refs[k] = reference.solve_left(inputs["h"][k], inputs["m"],
                                           inputs["s"][k])
        want_x, want_cons = refs[k]
        bad += differing(torch.as_tensor(cons).bool(), want_cons)
        got = torch.as_tensor(x).to(want_x.device)
        if got.shape != want_x.shape:
            bad += int(want_x[want_cons].numel())
        else:
            bad += differing(got[want_cons], want_x[want_cons])
    return [("solve_entries_differing", bad, 0)]

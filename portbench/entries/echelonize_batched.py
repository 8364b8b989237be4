"""``m4ri_tpu_torch.echelonize_batched(H, cols, full=True)`` of a stack of
matrices a call: each brought to its reduced row echelon form, the
systematic form [I | T] of a parity-check matrix when it has full rank.

Inputs: a pool of ``traffic["pool"]`` stacks of ``traffic["batch"]``
uniformly random ``rows x cols`` matrices made on the device from the seed;
call i reduces stack ``i % pool``.  The check compares every element's
RREF words and rank with the plain reference's (unique, so word for word).
"""

from __future__ import annotations

import torch

from portbench.harness import differing
from portbench.reference import gf2
from portbench.reference import rref as reference


def make_inputs(config, traffic, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    m, n = config["rows"], config["cols"]
    pool = gf2.random_words(
        (traffic["pool"], traffic["batch"], m, gf2.words_for(n)), n, g,
        device)
    return {"pool": pool, "n": n}


def call(port, inputs, i):
    pool = inputs["pool"]
    return port.echelonize_batched(pool[i % len(pool)], inputs["n"],
                                   full=True)


def control(port, inputs, i):
    """The reference without the eliminations above each pivot (a row
    echelon form that is not reduced): the reduced form broken."""
    pool = inputs["pool"]
    r, rank, _ = reference.rref(pool[i % len(pool)], inputs["n"],
                                reduce_above=False)
    return r, rank.to(torch.int32)


def judge(inputs, samples):
    """One number: the RREF words and the ranks that differ from the
    reference's, over the judged calls."""
    pool, n = inputs["pool"], inputs["n"]
    bad, refs = 0, {}
    for i, (e, r) in samples:
        k = i % len(pool)
        if k not in refs:
            refs[k] = reference.rref(pool[k], n)[:2]
        want, rank = refs[k]
        bad += differing(e, want) + differing(torch.as_tensor(r).long(), rank)
    return [("rref_entries_differing", bad, 0)]

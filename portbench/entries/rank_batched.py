"""``m4ri_tpu_torch.rank_batched(data, cols)`` of a stack of matrices a
call: the GF(2) rank of each, as NIST SP 800-22's binary matrix rank test
asks of every 32 x 32 matrix of every sequence of a sample.

Inputs: a pool of ``traffic["pool"]`` samples, each ``traffic["batch"]``
uniformly random ``rows x cols`` matrices made on the device from the seed;
call i ranks sample ``i % pool``.  The check compares every rank with the
plain reference's (``rref.rref``'s rank, column by column over the whole
stack).
"""

from __future__ import annotations

import torch

from portbench.harness import differing
from portbench.reference import gf2, rank, rref


def make_inputs(config, traffic, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    m, n = config["rows"], config["cols"]
    pool = gf2.random_words(
        (traffic["pool"], traffic["batch"], m, gf2.words_for(n)), n, g,
        device)
    return {"pool": pool, "n": n}


def call(port, inputs, i):
    pool = inputs["pool"]
    return (port.rank_batched(pool[i % len(pool)], inputs["n"]),)


def control(port, inputs, i):
    """The rank over the reals of the 0/1 entries: exactness over GF(2)
    broken."""
    pool = inputs["pool"]
    return (rank.real_ranks(pool[i % len(pool)], inputs["n"]),)


def judge(inputs, samples):
    """One number: the ranks that differ from the reference's, over the
    judged calls."""
    pool = inputs["pool"]
    bad, refs = 0, {}
    for i, (r,) in samples:
        k = i % len(pool)
        if k not in refs:
            refs[k] = rref.rref(pool[k], inputs["n"])[1]
        bad += differing(torch.as_tensor(r).long(), refs[k])
    return [("ranks_differing", bad, 0)]

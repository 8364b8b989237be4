"""``m4ri_tpu_torch.ple`` of one dense matrix a call.

Inputs: a pool of ``traffic["pool"]`` uniformly random ``rows x cols``
matrices made on the device from the seed (``mzd_randomize``'s
distribution); call i factors element ``i % pool``.  ``ple`` copies its
input into a padded buffer of its own and leaves it as it was, so no copy is
taken a call.  The check compares the body, P, Q and the rank with the
plain reference's PLE, word for word, and counts what differs.
"""

from __future__ import annotations

import torch

from portbench.harness import differing
from portbench.reference import gf2
from portbench.reference import ple as reference


def make_inputs(config, traffic, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    m, n = config["rows"], config["cols"]
    pool = gf2.random_words((traffic["pool"], m, gf2.words_for(n)), n, g,
                            device)
    return {"pool": pool, "n": n}


def call(port, inputs, i):
    pool = inputs["pool"]
    body, p, q, r = port.ple(port.BitMatrix(pool[i % len(pool)], inputs["n"]))
    return body.data, p, q, r


def control(port, inputs, i):
    """The reference with its block products in bfloat16 (sums above 256
    lose their parity): exactness broken."""
    pool = inputs["pool"]
    return reference.ple(pool[i % len(pool)], inputs["n"],
                         dtype=torch.bfloat16)


def judge(inputs, samples):
    """One number: the body's words, P's and Q's entries and the rank that
    differ from the reference's, over the judged calls."""
    pool, n = inputs["pool"], inputs["n"]
    bad, refs = 0, {}
    for i, (body, p, q, r) in samples:
        k = i % len(pool)
        if k not in refs:
            refs[k] = reference.ple(pool[k], n)
        want = refs[k]
        bad += (differing(body, want[0]) + differing(p, want[1])
                + differing(q, want[2]) + abs(int(r) - want[3]))
    return [("ple_entries_differing", bad, 0)]

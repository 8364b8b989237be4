"""``m4ri_tpu_torch.mul`` of two dense matrices a call.

Inputs: A (``rows x cols``) and B (``cols x cols``), uniformly random, made
on the device from the seed; every call multiplies the same two.  The check
compares the product's words with the plain reference's product (float16
products of the unpacked bits, exact in blocks of 1024).
"""

from __future__ import annotations

import torch

from portbench.harness import differing
from portbench.reference import gf2


def make_inputs(config, traffic, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    m, k = config["rows"], config["cols"]
    a = gf2.random_words((m, gf2.words_for(k)), k, g, device)
    b = gf2.random_words((k, gf2.words_for(k)), k, g, device)
    return {"a": a, "b": b, "k": k}


def work(config, traffic) -> dict:
    """The one GF(2) product of a call, for its roofline."""
    return {"gemm": [(config["rows"], config["cols"], config["cols"])]}


def call(port, inputs, i):
    k = inputs["k"]
    a, b = port.BitMatrix(inputs["a"], k), port.BitMatrix(inputs["b"], k)
    c = port.mul(a, b)
    return (c.data,)


def control(port, inputs, i):
    """The reference product in bfloat16: exactness broken."""
    k = inputs["k"]
    return (gf2.mul_packed(inputs["a"], inputs["b"], k, k,
                           dtype=torch.bfloat16),)


def judge(inputs, samples):
    k = inputs["k"]
    want = gf2.mul_packed(inputs["a"], inputs["b"], k, k)
    bad = sum(differing(c, want) for _, (c,) in samples)
    return [("product_words_differing", bad, 0)]

"""Golden vectors of the reference C library, through the PyTorch/CUDA port
(mirrors test_golden.py's mul, pluq and rref records; the ple records are in
test_torch_ple.py): the glibc RNG stream copy must rebuild the inputs bit
for bit, ``mul`` must hash to the library's product, ``pluq`` must give its
rank, P, Q and body, and ``echelonize`` its RREF."""

import json
import pathlib

import numpy as np
import pytest

import m4ri_tpu_torch as mt
from m4ri_tpu_torch.utils.rng import GlibcRandom, reference_random_data

from test_golden import fnv1a_bits

DATA = pathlib.Path(__file__).parent / "data" / "golden_reference.jsonl"
_RECS = [json.loads(l) for l in DATA.read_text().splitlines()]
_MUL = [r for r in _RECS if r["op"] == "mul"]
_IN = [r for r in _RECS if r["op"] in ("ple", "rref") and not r["k"]][:4]


def test_three_mul_records():
    assert sorted((r["m"], r["k"], r["n"]) for r in _MUL) == [
        (100, 1000, 100), (128, 100, 160), (256, 256, 256)]


@pytest.mark.parametrize(
    "rec", _MUL, ids=[f"{r['m']}x{r['k']}x{r['n']}" for r in _MUL])
def test_golden_mul(rec):
    rng = GlibcRandom(17)
    a = reference_random_data(rec["m"], rec["k"], rng=rng)
    b = reference_random_data(rec["k"], rec["n"], rng=rng)
    A = mt.from_reference(a, rec["k"], device="cpu")
    B = mt.from_reference(b, rec["n"], device="cpu")
    assert fnv1a_bits(mt.to_numpy(A)) == rec["a_hash"]
    assert fnv1a_bits(mt.to_numpy(B)) == rec["b_hash"]
    assert fnv1a_bits(mt.to_numpy(mt.mul(A, B))) == rec["out_hash"]
    assert fnv1a_bits(mt.to_numpy(mt.mul_naive(A, B))) == rec["out_hash"]


@pytest.mark.parametrize(
    "rec", _IN, ids=[f"{r['op']}-{r['kind']}-{r['m']}x{r['n']}" for r in _IN])
def test_golden_input_stream(rec):
    """randomize_reference under srandom(17) rebuilds the library's inputs."""
    A = mt.randomize_reference(rec["m"], rec["n"], seed=17, device="cpu")
    assert fnv1a_bits(mt.to_numpy(A)) == rec["in_hash"]


_PLUQ = [r for r in _RECS if r["op"] == "pluq"]
_RREF = [r for r in _RECS if r["op"] == "rref"]


def _golden_input(rec):
    """The case input, drawn in the reference's order (test_golden.py)."""
    if rec["k"]:
        g = GlibcRandom(17)
        b = reference_random_data(rec["m"], rec["k"], rng=g)
        c = reference_random_data(rec["k"], rec["n"], rng=g)
        return mt.mul(mt.from_reference(b, rec["k"], device="cpu"),
                      mt.from_reference(c, rec["n"], device="cpu"))
    return mt.randomize_reference(rec["m"], rec["n"], seed=17, device="cpu")


def test_eight_pluq_and_eight_rref_records():
    assert len(_PLUQ) == len(_RREF) == 8


@pytest.mark.parametrize(
    "rec", _PLUQ, ids=[f"{r['kind']}-{r['m']}x{r['n']}" for r in _PLUQ])
def test_golden_pluq(rec):
    """The reference C library's own rank, P, Q and L\\U body of mzd_pluq."""
    A = _golden_input(rec)
    assert fnv1a_bits(mt.to_numpy(A)) == rec["in_hash"], "RNG stream diverged"
    M, P, Q, r = mt.pluq(A)
    assert r == rec["rank"]
    assert P.tolist() == rec["P"]
    assert Q.tolist() == rec["Q"]
    assert fnv1a_bits(mt.to_numpy(M)) == rec["out_hash"], "L\\U in-place body"


@pytest.mark.parametrize(
    "rec", _RREF, ids=[f"{r['kind']}-{r['m']}x{r['n']}" for r in _RREF])
def test_golden_rref(rec):
    """The reference C library's RREF hash and rank of mzd_echelonize
    (the pluq strategy on the smaller records too)."""
    A = _golden_input(rec)
    assert fnv1a_bits(mt.to_numpy(A)) == rec["in_hash"], "RNG stream diverged"
    for strategy in ("m4ri", "pluq")[: 1 if rec["m"] > 256 else 2]:
        E, r = mt.echelonize(A, full=True, strategy=strategy)
        assert r == rec["rank"]
        assert fnv1a_bits(mt.to_numpy(E)) == rec["out_hash"], strategy

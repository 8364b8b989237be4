"""Probe of the inner-product routes of the GF(2) GEMM.

Times ``mma.sync`` from registers alone (csrc/probe_mma.cu), with no memory
traffic, for the 1-bit AND/popcount instruction (m16n8k256) and for the s8
instruction (m16n8k32), and the warpgroup instruction ``wgmma`` m64n256k256
b1 with both operands resident in shared memory; prints what each gives in
contraction bit-operations a second.  It also runs one ``wgmma`` b1
contraction of known operands and compares it with numpy, which checks the
operand and accumulator layouts the GEMM kernel relies on.  Needs the card
and ``nvcc``:

    python -m m4ri_tpu_torch.benches.probe_mma
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

OPS = {"b1_m16n8k256": 2 * 16 * 8 * 256, "s8_m16n8k32": 2 * 16 * 8 * 32}
WGMMA_OPS = 2 * 64 * 256 * 256   # wgmma m64n256k256 b1


def _hash(i: np.ndarray, w: np.ndarray) -> np.ndarray:
    """probe_hash of csrc/probe_mma.cu, in uint32 arithmetic."""
    with np.errstate(over="ignore"):
        x = ((i * np.uint32(2654435761)) ^ (w * np.uint32(2246822519))
             ^ np.uint32(0x5BD1E995)) * np.uint32(3266489917)
    return x ^ (x >> np.uint32(15))


def wgmma_check_want() -> np.ndarray:
    """What wgmma_check_kernel must write: popcount(A[r] & B[n]) over 32
    words, A rows 0..127 and B rows 1000..1255 of the hash."""
    w = np.arange(32, dtype=np.uint32)[None, :]
    a = _hash(np.arange(128, dtype=np.uint32)[:, None], w)
    b = _hash(np.arange(1000, 1256, dtype=np.uint32)[:, None], w)
    both = a[:, None, :] & b[None, :, :]
    bits = np.unpackbits(both.view(np.uint8), axis=-1)
    return bits.sum(axis=-1, dtype=np.int64).astype(np.int32)


def probe(blocks: int = 132 * 8, threads: int = 256, iters: int = 4096,
          repeats: int = 5) -> dict:
    from ..ops._build import load
    fn = load("probe_mma").probe_mma
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_float)]
    fn.restype = ctypes.c_int
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    res = {}
    for which, name in enumerate(OPS):
        times = []
        for _ in range(repeats + 1):  # the first run warms up
            ms = ctypes.c_float()
            err = fn(which, blocks, threads, iters, out.data_ptr(),
                     ctypes.byref(ms))
            if err:
                raise RuntimeError(f"probe_mma: CUDA error {err}")
            times.append(ms.value)
        best = min(times[1:])
        n_mma = blocks * (threads // 32) * iters * 8
        res[name] = {"ms": best, "mma_instructions": n_mma,
                     "tera_ops_per_s": n_mma * OPS[name] / (best * 1e-3) / 1e12}
    res.update(probe_wgmma(iters=iters // 4, repeats=repeats))
    return res


def probe_wgmma(iters: int = 1024, repeats: int = 5) -> dict:
    """wgmma b1 from shared memory, one block an SM: rate, and the layout
    check."""
    from ..ops._build import load
    lib = load("probe_mma")
    rate, check = lib.probe_wgmma, lib.probe_wgmma_check
    rate.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                     ctypes.POINTER(ctypes.c_float)]
    check.argtypes = [ctypes.c_void_p]
    rate.restype = check.restype = ctypes.c_int
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    got = torch.zeros(128 * 256, dtype=torch.int32, device="cuda")
    err = check(got.data_ptr())
    if err:
        raise RuntimeError(f"probe_wgmma_check: CUDA error {err}")
    want = wgmma_check_want().reshape(-1)
    diff = np.flatnonzero(got.cpu().numpy() != want)
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    times = []
    for _ in range(repeats + 1):
        ms = ctypes.c_float()
        err = rate(blocks, iters, out.data_ptr(), ctypes.byref(ms))
        if err:
            raise RuntimeError(f"probe_wgmma: CUDA error {err}")
        times.append(ms.value)
    best = min(times[1:])
    n_mma = blocks * 2 * iters * 4
    return {"b1_wgmma_m64n256k256": {
        "ms": best, "mma_instructions": n_mma, "blocks": blocks,
        "tera_ops_per_s": n_mma * WGMMA_OPS / (best * 1e-3) / 1e12,
        "layout_check_equal": diff.size == 0,
        "layout_check_first_differences": diff[:8].tolist()}}


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "probe": probe()}))


if __name__ == "__main__":
    main()

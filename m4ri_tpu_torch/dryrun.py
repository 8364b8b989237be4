"""Dry runs of the multi-device layer on a process group started on this
host, at the shapes and with the checks of the JAX package's
``__graft_entry__.py``.

- ``dryrun_multichip(n)``: n ranks, a 2-D mesh for the SUMMA and k-split
  products (checked against a numpy product, and a distributed add-mul that
  cancels), then a 1-D (n x 1) mesh for the row-sharded rank, PLE (the same
  words as the single-device ``ple``, and P L E rebuilds A), TRSM and
  ``solve_left`` (the same words as the single-device solve).
- ``dryrun_multihost()``: 4 ranks as 2 hosts of 2 (``LOCAL_WORLD_SIZE``),
  the mesh from ``make_multihost_mesh`` (host-major: the hosts are the "x"
  rows), then ``mul_dist`` / ``mul_dist_ksplit`` / ``dist_ple`` across it.

Both run on the card unless ``device="cpu"``.  On the card each rank takes
``cuda:(local_rank % device_count())``; NCCL needs a card a rank, so with
fewer cards than ranks the group is gloo on the card.  Every rank checks
its own results; a rank that fails, or a group that passes ``timeout_s``,
raises here.

    python -m m4ri_tpu_torch.dryrun [n] [--cpu]
"""

from __future__ import annotations

import sys
import tempfile

import numpy as np
import torch

__all__ = ["dryrun_multichip", "dryrun_multihost"]


def _check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dry run: {what}")


def _backend(device: str, ranks: int) -> str:
    if device == "cuda" and ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _device(device) -> str:
    from .core.bitmatrix import resolve_device
    return resolve_device(device).type


def _product(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a.astype(np.int64) @ b.astype(np.int64)) % 2


def _multichip_rank(n_devices: int, device: str) -> None:
    import torch.distributed as dist

    from . import (add, from_numpy, is_zero, ple, rank, solve_left,
                   to_numpy)
    from .core.permutation import (apply_p_left, apply_p_right_trans,
                                   apply_p_right_trans_tri)
    from .parallel.dist_echelon import dist_rank
    from .parallel.dist_mul import mul_dist, mul_dist_ksplit
    from .parallel.dist_ple import dist_ple
    from .parallel.dist_solve import dist_solve_left, dist_trsm_lower_left
    from .parallel.mesh import make_mesh

    mesh = make_mesh(n_devices)
    say = print if dist.get_rank() == 0 else (lambda *a: None)
    say(f"dryrun mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
        f"{device}, {dist.get_backend()}")

    rng = np.random.default_rng(17)
    m, k, n = 256, 320, 192
    a_np = (rng.random((m, k)) < 0.5).astype(np.uint8)
    b_np = (rng.random((k, n)) < 0.5).astype(np.uint8)
    A, B = from_numpy(a_np, device=device), from_numpy(b_np, device=device)
    c1 = mul_dist(A, B, mesh)
    c2 = mul_dist_ksplit(A, B, mesh)
    expect = _product(a_np, b_np)
    _check((to_numpy(c1) == expect).all(), "SUMMA mul mismatch")
    _check((to_numpy(c2) == expect).all(), "k-split mul mismatch")
    # distributed addmul self-cancels
    _check(bool(is_zero(add(mul_dist(A, B, mesh), c1))), "addmul mismatch")

    # row-sharded elimination on a 1-D mesh over all ranks
    mesh1d = make_mesh(shape=(n_devices, 1))
    r = dist_rank(A, mesh1d)
    _check(r == rank(A), f"distributed rank {r} != local rank")

    # canonical PLE: the single-device words, and P L E rebuilds A
    sq = (rng.random((160, 96)) < 0.5).astype(np.uint8)
    SQ = from_numpy(sq, device=device)
    Mg, Pg, Qg, rg = dist_ple(SQ, mesh1d, nb=32, window=64)
    Mw, Pw, Qw, rw = ple(SQ, nb=32)
    _check(rg == rw, "dist PLE rank mismatch")
    _check(torch.equal(Mg.data, Mw.data), "dist PLE data")
    _check(torch.equal(Pg, Pw) and torch.equal(Qg, Qw), "dist PLE P/Q")
    Md = to_numpy(apply_p_right_trans_tri(Mg, Qg)).astype(np.int64)
    L = np.eye(160, dtype=np.int64)
    E = np.zeros((160, 96), np.int64)
    for i in range(rg):
        L[i, :i] = Md[i, :i]
        E[i, i:] = Md[i, i:]
    L[rg:, :rg] = Md[rg:, :rg]
    lhs = to_numpy(apply_p_right_trans(apply_p_left(SQ, Pg), Qg))
    _check((lhs == (L @ E) % 2).all(), "dist PLE reconstruction")

    # TRSM and solve, held to the local engines
    u = np.triu((rng.random((96, 96)) < 0.5).astype(np.uint8), 1)
    np.fill_diagonal(u, 1)
    rhs = (rng.random((96, 32)) < 0.5).astype(np.uint8)
    xg = dist_trsm_lower_left(from_numpy(u.T.copy(), device=device),
                              from_numpy(rhs, device=device), mesh1d)
    _check((_product(u.T, to_numpy(xg)) == rhs).all(), "dist TRSM mismatch")
    x0 = (rng.random((96, 16)) < 0.5).astype(np.uint8)
    a2 = (rng.random((120, 96)) < 0.5).astype(np.uint8)
    b2 = _product(a2, x0).astype(np.uint8)
    A2, B2 = from_numpy(a2, device=device), from_numpy(b2, device=device)
    xs, ok = dist_solve_left(A2, B2, mesh1d, nb=32, window=64)
    xl, okl = solve_left(A2, B2, nb=32)
    _check(bool(ok) and bool(okl), "dist solve inconsistent flag")
    _check(torch.equal(xs.data, xl.data), "dist solve mismatch")
    say(f"dryrun_multichip OK: {n_devices} ranks - SUMMA/ksplit mul, "
        f"dist rank {r}, dist PLE+TRSM+solve bit-identical")


def dryrun_multichip(n_devices: int, device=None, timeout_s: float = 600) -> str:
    """Run the distributed step on ``n_devices`` ranks; returns rank 0's
    report (also printed)."""
    from .parallel._spawn import launch
    dev = _device(device)
    with tempfile.TemporaryDirectory() as work:
        logs = launch("m4ri_tpu_torch.dryrun:_multichip_rank", n_devices,
                      work, backend=_backend(dev, n_devices), device=dev,
                      args=[n_devices, dev], timeout_s=timeout_s)
    _check("dryrun_multichip OK" in logs[0], "rank 0 did not report")
    print(logs[0], end="")
    return logs[0]


def _multihost_rank(init_method: str, world: int, rank: int, device: str,
                    per_host: int) -> None:
    import torch.distributed as dist

    from . import from_numpy, ple
    from .parallel.dist_mul import mul_dist, mul_dist_ksplit
    from .parallel.dist_ple import dist_ple
    from .parallel.mesh import axis_index, make_multihost_mesh

    mesh = make_multihost_mesh(coordinator=init_method, num_processes=world,
                               process_id=rank,
                               backend=_backend(device, world), device=device)
    _check(dist.get_world_size() == world, "world size")
    n_hosts = world // per_host
    _check(tuple(mesh.shape) == (n_hosts, per_host), f"mesh {mesh.shape}")
    # host-major: the hosts are the rows, each host's ranks its columns
    _check(torch.equal(mesh.mesh, torch.arange(world).reshape(n_hosts, per_host)),
           "mesh rows are not host-major")
    _check(axis_index(mesh, "x") == rank // per_host
           and axis_index(mesh, "y") == rank % per_host, "coordinates")

    rng = np.random.default_rng(42)          # the same seed on every rank
    a_np = (rng.random((192, 160)) < 0.5).astype(np.uint8)
    b_np = (rng.random((160, 136)) < 0.5).astype(np.uint8)
    A, B = from_numpy(a_np, device=device), from_numpy(b_np, device=device)
    want = from_numpy(_product(a_np, b_np), device=device).data
    _check(torch.equal(mul_dist(A, B, mesh).data, want), "mul_dist")
    _check(torch.equal(mul_dist_ksplit(A, B, mesh).data, want),
           "mul_dist_ksplit")

    # dist_ple across the hosts against the single-device engine; the zero
    # rows push pivots past the first window (the slow branch)
    p_np = (np.random.default_rng(7).random((180, 96)) < 0.5).astype(np.uint8)
    p_np[:40] = 0
    Pm = from_numpy(p_np, device=device)
    M_ref, P_ref, Q_ref, r_ref = ple(Pm)
    Md, Pd, Qd, rd = dist_ple(Pm, mesh)
    _check(rd == r_ref, f"dist_ple rank {rd} != {r_ref}")
    _check(torch.equal(Pd, P_ref) and torch.equal(Qd, Q_ref), "dist_ple P/Q")
    _check(torch.equal(Md.data, M_ref.data), "dist_ple body")
    print(f"MULTIHOST_OK rank={rank} host={rank // per_host}", flush=True)


def dryrun_multihost(device=None, timeout_s: float = 600) -> str:
    """4 ranks as 2 hosts of 2: make_multihost_mesh's host-major mesh, then
    mul_dist / mul_dist_ksplit / dist_ple over it, each the same words as
    the single-process engines.  Returns the ranks' logs."""
    from .parallel._spawn import launch
    dev = _device(device)
    world, per_host = 4, 2
    with tempfile.TemporaryDirectory() as work:
        logs = launch("m4ri_tpu_torch.dryrun:_multihost_rank", world, work,
                      backend=_backend(dev, world), device=dev,
                      args=[dev, per_host], timeout_s=timeout_s,
                      local_world_size=per_host, init=False)
    for r, log in enumerate(logs):
        _check(f"MULTIHOST_OK rank={r}" in log, f"rank {r} did not report")
    print(f"dryrun_multihost OK: {world // per_host} hosts x {per_host} "
          "ranks, mul/ksplit/PLE bit-identical over the host boundary")
    return "".join(logs)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    dev = "cpu" if "--cpu" in sys.argv[1:] else None
    dryrun_multihost(device=dev)
    dryrun_multichip(int(args[0]) if args else 4, device=dev)

"""Process groups, the device mesh and the collectives of the multi-device
layer.

The reference's only parallelism is OpenMP shared memory (mp.c 2x2
sections).  The JAX package runs SPMD from one controller over a
jax.sharding.Mesh (``shard_map``).  The port takes PyTorch's idiom, which
every module of ``parallel/`` follows:

- One rank per process, one device per rank.  The backend is NCCL on the
  card and gloo on the CPU.  A caller may name gloo on the card: it is the
  only way several ranks share one GPU.  Rank r computes on
  ``cuda:(local_rank % device_count())``.
- The mesh is a ``DeviceMesh`` over the whole world with dimension names
  ("x", "y"); ranks fill it row-major, so "x" indexes rows.  Each axis has
  its own process groups, made here with the world's backend and timeout.
- Global in, global out, like the JAX API: every rank calls a function with
  the same global matrices, computes only on its own block, and gets the
  whole result back.
- Every branch that a collective follows is decided by a value all ranks
  share (a reduced flag, a replicated rank), never by a rank's own data.

NCCL has no bitwise reduce, so the XOR all-reduce is an all-gather and a
local fold on both backends.
"""

from __future__ import annotations

import datetime
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils import spans

__all__ = ["make_mesh", "make_multihost_mesh", "xor_allgather_reduce",
           "all_gather", "psum", "any_reduce", "init_group", "axis_size",
           "axis_index"]

# A collective that waits longer than this fails instead of hanging.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)

# Collectives of a gloo group on card tensors are each staged through host
# memory (gloo's CUDA support differs by collective and by release, so with
# that backend every collective on card tensors takes the host path), and
# counted as ``host_staged_collectives`` (utils/spans.py).

# The meshes made over the current world, by (shape, axis names): a mesh's
# process groups (NCCL communicators hold device memory) are made once, and
# every rank asks for the same meshes in the same order, so all hit alike.
_meshes: dict = {}


def init_group(backend: str | None = None, device=None,
               init_method: str | None = None, world_size: int = 1,
               rank: int = 0) -> None:
    """Start this process's rank of a process group.  ``device``: where the
    rank computes, None for the card; ``backend``: None for NCCL on the card
    and gloo on the CPU.  A 1-rank group with no ``init_method`` meets in an
    in-process store."""
    dev = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a process group on the card needs a CUDA "
                               "device; pass device='cpu' to run on the host")
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = dict(backend=backend, world_size=world_size, rank=rank,
              timeout=COLLECTIVE_TIMEOUT)
    if init_method is None and world_size == 1:
        kw["store"] = dist.HashStore()
    else:
        kw["init_method"] = init_method
    dist.init_process_group(**kw)


def _device_type() -> str:
    """The device type of the ranks: the card for NCCL, and for gloo the
    card when this process has one selected for it."""
    if dist.get_backend() == "nccl":
        return "cuda"
    return "cuda" if torch.cuda.is_available() \
        and torch.cuda.is_initialized() else "cpu"


def _mesh(shape: tuple[int, int], axis_names) -> DeviceMesh:
    """A DeviceMesh of the given shape over the whole world, one process
    group for each line of each axis (every rank makes every group, in the
    same order, as new_group requires), made once for each world."""
    key = (dist.group.WORLD, shape, tuple(axis_names))
    if key not in _meshes:
        for k in [k for k in _meshes if k[0] is not dist.group.WORLD]:
            del _meshes[k]                   # meshes of a destroyed world
        _meshes[key] = _new_mesh(shape, axis_names)
    return _meshes[key]


def _new_mesh(shape: tuple[int, int], axis_names) -> DeviceMesh:
    world, rank = dist.get_world_size(), dist.get_rank()
    if shape[0] * shape[1] != world:
        raise ValueError(f"a {shape[0]}x{shape[1]} mesh needs {shape[0] * shape[1]} "
                         f"ranks; the process group has {world}")
    grid = torch.arange(world).reshape(shape)
    backend = dist.get_backend()
    groups = []
    for dim in (0, 1):
        mine = None
        for line in grid.movedim(dim, -1).reshape(-1, shape[dim]).tolist():
            g = dist.new_group(line, backend=backend, timeout=COLLECTIVE_TIMEOUT)
            if rank in line:
                mine = g
        groups.append(mine)
    return DeviceMesh.from_group(groups, _device_type(), mesh=grid,
                                 mesh_dim_names=tuple(axis_names))


def make_mesh(n_devices: int | None = None, axis_names=("x", "y"), *,
              shape: tuple[int, int] | None = None, device=None) -> DeviceMesh:
    """A 2-D mesh as square as possible over the process group's ranks, or
    of the given ``shape`` (rows, columns).  ``n_devices`` must equal the
    world size: each rank is one process, so a mesh cannot leave ranks out.
    With no process group yet, a 1-rank group is started on ``device``
    (None: the card), NCCL on the card and gloo on the CPU."""
    if not dist.is_initialized():
        init_group(device=device)
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(
            f"make_mesh({n_devices}): the process group has {n} ranks, and a "
            "mesh spans all of them (one rank per process); start a group of "
            f"{n_devices} ranks")
    if shape is None:
        rx = math.isqrt(n)
        while n % rx:
            rx -= 1
        shape = (rx, n // rx)
    return _mesh(tuple(shape), axis_names)


def make_multihost_mesh(axis_names=("x", "y"), coordinator: str | None = None,
                        num_processes: int | None = None,
                        process_id: int | None = None,
                        local_world_size: int | None = None, backend=None,
                        device=None) -> DeviceMesh:
    """Mesh spanning several hosts, host-major: the hosts are the outer "x"
    rows and each host's local ranks fill the inner "y" columns, so every
    "y" collective stays inside a host.  For the SUMMA product that puts the
    larger transfer (the A row panels) on the intra-host links and the
    smaller one (B's column panels) across hosts.  ``coordinator``
    (``host:port`` or a URL of ``init_process_group``), ``num_processes``
    and ``process_id`` start the group when none exists.  The ranks of one
    host are ``local_world_size`` (default: the ``LOCAL_WORLD_SIZE`` variable
    of the launcher, else the whole world) consecutive ranks.  One host:
    the same mesh as make_mesh()."""
    if not dist.is_initialized():
        if num_processes is not None and num_processes > 1:
            url = coordinator if coordinator is None or "://" in coordinator \
                else f"tcp://{coordinator}"
            init_group(backend, device, url, num_processes, process_id)
        else:
            init_group(backend, device)
    world = dist.get_world_size()
    per_host = local_world_size or int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per_host:
        raise ValueError(f"{world} ranks do not split into hosts of {per_host}")
    n_hosts = world // per_host
    if n_hosts == 1:
        return make_mesh(axis_names=axis_names)
    return _mesh((n_hosts, per_host), axis_names)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _gather_parts(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> list:
    """Every rank's ``x`` along ``axis``, in axis order, on x's device.
    The list form of all_gather: newer releases deprecate
    all_gather_into_tensor for a call that older ones lack."""
    group = mesh.get_group(axis)
    staged = _staged(x, group)
    src = x.cpu() if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    if staged:
        spans.count("host_staged_collectives")
        parts = [p.to(x.device) for p in parts]
    return parts


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str,
               dim: int = 0) -> torch.Tensor:
    """The blocks of every rank along ``axis`` laid end to end along
    ``dim`` (jax.lax.all_gather with tiled=True)."""
    return torch.cat(_gather_parts(x, mesh, axis), dim=dim)


def xor_allgather_reduce(x: torch.Tensor, mesh: DeviceMesh,
                         axis: str) -> torch.Tensor:
    """XOR all-reduce along a mesh axis: all-gather the partial parities and
    fold them locally.  The partials are packed words, so the gather moves
    the data a ring XOR-reduce would."""
    parts = _gather_parts(x, mesh, axis)
    out = parts[0].clone()
    for p in parts[1:]:
        out ^= p
    return out


def psum(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Integer sum over the ranks of ``axis`` (a new tensor)."""
    group = mesh.get_group(axis)
    staged = _staged(x, group)
    out = x.cpu().clone() if staged else x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    if staged:
        spans.count("host_staged_collectives")
        out = out.to(x.device)
    return out


def any_reduce(flag: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """0-dim bool: whether the flag is set on any rank of ``axis``."""
    return psum(flag.to(torch.int32).reshape(1), mesh, axis)[0] > 0

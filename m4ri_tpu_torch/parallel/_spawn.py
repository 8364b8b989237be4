"""Start a process group on this host and run one function on every rank.

``launch`` starts ``world`` processes, each running

    python -m m4ri_tpu_torch.parallel._spawn SPEC RANK

which joins the group (rendezvous through a file in the caller's work
directory, so launches running side by side never meet), imports the target
``module:function`` and calls it with the spec's arguments.  The launch has
a wall-clock limit: when a rank fails, or the limit passes, every rank still
running is killed and ``launch`` raises with the end of each rank's log.
A hung group therefore fails; it never waits out its collectives.

``run_calls`` is a rank body that calls functions of the port on inputs
given as 0/1 numpy arrays and writes every rank's outputs to a file, for
tests that hold the distributed functions to a reference run elsewhere.
"""

from __future__ import annotations

import importlib
import json
import os
import pathlib
import pickle
import subprocess
import sys
import time
import traceback

__all__ = ["launch", "run_calls", "Shard", "RankFailed"]

_ROOT = pathlib.Path(__file__).resolve().parents[2]


class RankFailed(RuntimeError):
    pass


def _tail(path: pathlib.Path, n: int = 3000) -> str:
    text = path.read_text(errors="replace") if path.exists() else ""
    return text[-n:]


def launch(target: str, world: int, workdir, *, backend: str, device: str,
           args=(), timeout_s: float, local_world_size: int | None = None,
           init: bool = True) -> list[str]:
    """Run ``target`` ("module:function") on ``world`` ranks, each its own
    process, and return their logs.  ``device``: "cpu" or "cuda", where the
    ranks compute; ``init=False`` leaves joining the group to the target
    (which then gets the rendezvous URL, the world size and its rank as its
    first three arguments).  Raises RankFailed when a rank exits with an
    error and TimeoutError when ``timeout_s`` passes first."""
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    rendezvous = workdir / "rendezvous"
    rendezvous.unlink(missing_ok=True)
    spec = workdir / "spec.json"
    spec.write_text(json.dumps({
        "target": target, "world": world, "backend": backend,
        "device": device, "args": list(args), "init": init,
        "init_method": f"file://{rendezvous}",
        "local_world_size": local_world_size or world}))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(_ROOT), os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    logs = [workdir / f"rank{r}.log" for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", __name__, str(spec), str(r)],
                    stdout=log, stderr=subprocess.STDOUT, cwd=_ROOT, env=env))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                # a rank that fails takes the ranks waiting for it down
                # with it; give them a moment so that the report names all
                time.sleep(2)
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                raise RankFailed(
                    f"rank(s) {bad} of {target} failed (exit {[codes[r] for r in bad]}):\n"
                    + "\n".join(f"--- rank {r}\n{_tail(logs[r])}" for r in bad))
            if all(c == 0 for c in codes):
                return [p.read_text(errors="replace") for p in logs]
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{target} on {world} ranks passed its limit of "
                    f"{timeout_s} s:\n" + "\n".join(
                        f"--- rank {r}\n{_tail(p)}" for r, p in enumerate(logs)))
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def _rank_main(spec_path: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    from .mesh import init_group
    spec = json.loads(pathlib.Path(spec_path).read_text())
    world, local = spec["world"], spec["local_world_size"]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank % local), LOCAL_WORLD_SIZE=str(local))
    torch.set_num_threads(1)        # many ranks share the host's cores
    args = spec["args"]
    if spec["init"]:
        init_group(spec["backend"], spec["device"], spec["init_method"],
                   world, rank)
    else:
        args = [spec["init_method"], world, rank, *args]
    module, name = spec["target"].split(":")
    try:
        getattr(importlib.import_module(module), name)(*args)
        if dist.is_initialized():
            dist.barrier()          # every rank is done: all leave together
        code = 0
    except Exception:
        traceback.print_exc()
        code = 1
    # leave without tearing the group down: a gloo group's threads can abort
    # the process at exit ("terminate called without an active exception")
    # while a peer is closing its sockets, after the work is done
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


# --- a rank body for tests ---------------------------------------------

class Shard:
    """An argument of ``run_calls``: uint32 words cut into equal row blocks
    along a mesh axis; each rank gets its own block as an int32 tensor."""

    def __init__(self, words, axis: str):
        self.words, self.axis = words, axis


def _to_port(x, device, mesh):
    import numpy as np
    import torch

    from ..core.bitmatrix import from_numpy
    from .mesh import axis_index, axis_size
    if isinstance(x, Shard):
        rows = x.words.shape[0] // axis_size(mesh, x.axis)
        i = axis_index(mesh, x.axis)
        blk = np.ascontiguousarray(x.words[i * rows:(i + 1) * rows], np.uint32)
        return torch.from_numpy(blk.view(np.int32)).to(device)
    return from_numpy(x, device=device) if isinstance(x, np.ndarray) else x


def _from_port(x):
    import torch

    from ..core.bitmatrix import BitMatrix
    if isinstance(x, BitMatrix):
        words = x.data.detach().cpu().contiguous().numpy()
        return {"words": words.view("uint32"), "ncols": x.ncols}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple):
        return tuple(_from_port(v) for v in x)
    return x


def run_calls(calls_path: str, out_path: str, device: str) -> None:
    """Rank body: ``calls_path`` holds a pickled list of dicts {"name",
    "fn": "module:function", "args", "kwargs", "mesh": (rows, cols) or None
    for make_mesh()'s}; 0/1 numpy arrays among the arguments become matrices
    on ``device``, a ``Shard`` this rank's block, and the function gets the
    mesh as ``mesh=``.  Rank r pickles {name: output}, with matrices as
    their uint32 words, to ``out_path`` + ".r"."""
    import torch.distributed as dist

    from .mesh import make_mesh
    with open(calls_path, "rb") as f:
        calls = pickle.load(f)
    meshes, results = {}, {}
    for c in calls:
        shape = c["mesh"] and tuple(c["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh(shape=shape)
        mesh = meshes[shape]
        module, name = c["fn"].split(":")
        fn = getattr(importlib.import_module(module), name)
        out = fn(*[_to_port(a, device, mesh) for a in c["args"]],
                 mesh=mesh, **c.get("kwargs", {}))
        results[c["name"]] = _from_port(out)
    with open(f"{out_path}.{dist.get_rank()}", "wb") as f:
        pickle.dump(results, f)


def fault_on_rank(bad_rank: int) -> None:
    """Rank body for testing the launcher: rank ``bad_rank`` raises while
    every other rank waits for it in a collective."""
    import torch
    import torch.distributed as dist
    if dist.get_rank() == bad_rank:
        raise RuntimeError(f"rank {bad_rank} fails on purpose")
    dist.all_reduce(torch.ones(1))


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))

"""Import hygiene of the PyTorch/CUDA port: it imports torch and numpy,
never jax and nothing of the JAX package; importing it builds nothing; and
without a card a matrix is only made on the CPU when the caller says so."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "m4ri_tpu_torch"
FILES = sorted(p for p in PKG.rglob("*.py")   # build/ holds outputs, no sources
               if "build" not in p.relative_to(PKG).parts) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "m4ri_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_import_of_jax_or_the_jax_package(path):
    for name in _imports(path):
        assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_the_walk_sees_the_port():
    names = {p.name for p in FILES}
    assert {"bitmatrix.py", "mul.py", "strassen.py", "hopper_mul.py",
            "hopper_mul2.py", "_build.py", "chip_smoke.py", "hopper_schur.py",
            "hopper_panel.py", "hopper_post.py", "ple.py", "echelon.py",
            "spans.py", "graycode.py", "bitops.py", "permutation.py",
            "triangular.py", "solve.py", "split_solve.py",
            "m4rm.py", "djb.py", "io.py", "compat.py",
            "build.py", "mesh.py", "dist_mul.py", "dist_echelon.py",
            "dist_ple.py", "dist_solve.py", "_spawn.py", "dryrun.py",
            "batched.py"} <= names
    assert PKG / "parallel" / "dist_ple.py" in FILES
    assert PKG / "models" / "batched.py" in FILES
    assert PKG / "dryrun.py" in FILES
    assert PKG / "native" / "build.py" in FILES


def test_every_kernel_source_has_a_wrapper_module():
    """Each csrc/*.cu is loaded by name from exactly the module that wraps
    it, inside a function: nothing is built when the package is imported."""
    sources = {p.stem for p in (PKG / "csrc").glob("*.cu")}
    assert {"gf2_schur_hopper", "gf2_panel_hopper", "gf2_post_hopper"} <= sources
    text = {p: p.read_text() for p in FILES}
    for stem in sources:
        users = [p for p, t in text.items()
                 if f'load("{stem}")' in t or f'"{stem}"' in t]
        assert users, f"no module loads csrc/{stem}.cu"
    for path in FILES:
        tree = ast.parse(text[path])
        for node in tree.body:           # module level: no call of load/build
            for call in ast.walk(node) if not isinstance(
                    node, (ast.FunctionDef, ast.ClassDef)) else ():
                if isinstance(call, ast.Call):
                    name = getattr(call.func, "id", getattr(call.func, "attr", ""))
                    assert name not in ("load", "build"), f"{path}: {name}() at import"


_CHILD = r"""
import subprocess
import sys
sys.modules["jax"] = None
sys.modules["m4ri_tpu"] = None
import numpy as np
import torch


def _no_compiler(*args, **kwargs):
    raise AssertionError(f"importing the port started a process: {args[:1]}")


popen, subprocess.Popen = subprocess.Popen, _no_compiler
import m4ri_tpu_torch as mt
import m4ri_tpu_torch.compat
from m4ri_tpu_torch.native import build as native
subprocess.Popen = popen
assert native._lib is None and not native._tried, "import loaded gf2core"
from m4ri_tpu_torch.ops import _build
assert not _build.BUILD.exists() or not any(_build.BUILD.glob("*.so")), "import built something"
rng = np.random.default_rng(3)
a = (rng.random((70, 90)) < 0.5).astype(np.uint8)
b = (rng.random((90, 50)) < 0.5).astype(np.uint8)
C = mt.mul(mt.from_numpy(a, device="cpu"), mt.from_numpy(b, device="cpu"))
assert (mt.to_numpy(C) == (a.astype(np.int64) @ b.astype(np.int64)) % 2).all()
A = mt.from_numpy(a, device="cpu")
M, P, Q, r = mt.ple(A, nb=32)
assert r == mt.rank(A) == mt.block_factor(A, preserve_l=False, engine="hopper")[3]
assert not _build.BUILD.exists() or not any(_build.BUILD.glob("*.so")), "the CPU path built something"
assert not torch.cuda.is_available()
for make in (lambda: mt.zeros(4, 4), lambda: mt.identity(4),
             lambda: mt.from_numpy(a), lambda: mt.from_packed(np.zeros((2, 1), np.uint32), 5),
             lambda: mt.randomize(3, 3, torch.Generator()),
             lambda: mt.randomize_reference(3, 3),
             lambda: mt.from_reference(np.zeros((2, 1), np.uint32), 5),
             lambda: m4ri_tpu_torch.compat.mzd_init(3, 3),
             lambda: m4ri_tpu_torch.compat.mzp_init(3),
             lambda: m4ri_tpu_torch.compat.mzd_from_str(1, 2, "10")):
    try:
        make()
    except RuntimeError as e:
        assert "device='cpu'" in str(e)
    else:
        raise AssertionError("made a matrix with no card and no device='cpu'")
assert "jax" not in [m for m in sys.modules if sys.modules[m] is not None]
print("child ok")
"""


def test_port_runs_with_jax_blocked():
    """In a fresh interpreter where ``import jax`` and ``import m4ri_tpu``
    fail, the port imports, multiplies and factors on the CPU, and refuses to make a
    matrix on a card that is not there."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("the refusal is only observable on a machine with no card")
    res = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "child ok" in res.stdout


def test_chip_smoke_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("only observable on a machine with no card")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_every_kernel_source_is_built_in_one_variant():
    """The build takes a source's name and nothing else, no flag defines a
    macro and no source asks for one: what is timed is what is shipped."""
    import inspect

    from m4ri_tpu_torch.ops import _build
    assert list(inspect.signature(_build.load).parameters) == ["name"]
    assert list(inspect.signature(_build.build).parameters) == ["names"]
    assert not [f for f in _build.NVCC_FLAGS if f.startswith("-D")]
    for src in (PKG / "csrc").glob("*.cu*"):
        assert "#ifdef" not in src.read_text(), src.name

"""Which device operations are the program's own kernels.

A kernel is the program's own when its name is a ``__global__`` function of
``m4ri_tpu_torch/csrc/``, read from the sources when a run starts, so a
kernel that a later change adds there counts as the program's without an
edit here.  Everything else on the device (PyTorch's kernels, cuBLAS,
copies and memsets) is the glue.  The classification is the one of the
program's ``benches/split_batched.py``, by the sources instead of the
namespace.
"""

from __future__ import annotations

import pathlib
import re

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def own_kernel_names(csrc: pathlib.Path) -> frozenset:
    """Names of the ``__global__`` functions of the ``.cu`` / ``.cuh``
    sources in ``csrc``."""
    names = set()
    for path in sorted(csrc.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            names.update(_GLOBAL.findall(path.read_text()))
    return frozenset(names)


def short_name(name: str) -> str:
    """A device operation's name without its return type, namespaces,
    template arguments and parameters: ``void gf2::gemm::gf2_gemm_kernel<
    ...>(...)`` -> ``gf2_gemm_kernel``.  A copy, a memset or a name with no
    parameter list stays whole."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    head, depth = [], 0
    for ch in name.replace("(anonymous namespace)", "anonymous"):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            if ch == "(":
                break
            head.append(ch)
    else:
        return name
    words = "".join(head).split()
    return words[-1].split("::")[-1] if words else name

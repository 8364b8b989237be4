"""The batched trailing update (4b), elimination (6b) and pivot loop (5b)
with a part left out, to see what sets their pace.

Each variant is the kernel source with one piece of text replaced (the MMA
instructions by an XOR that keeps their operands live; C's loads and stores
of the trailing update by nothing; the elimination's search for an item's
element by arithmetic that holds at the McEliece first panel, two tiles an
element; the pivot loop's group ends left out, which leaves its chain of
steps alone; or its chain's search replaced by taking the rank's own row as
the pivot at every step, no ballot, which leaves the group-end pass with 32
pivots a group behind a chain of shuffles only).  The results of a variant are wrong; only its time means
anything.  For each tree (this one, and the one under ``--parent DIR`` if
given) and each variant whose text that tree's source has, the variant is
built with ``nvcc`` into the tree's build directory, put in place of the
tree's library for its own wrapper, and the wrapper is called on the
operands the batched sweep gives it on the first panel of 256 McEliece
matrices; printed: the device ms a call by kernel from a ``torch.profiler``
trace (``split_batched.trace``), so that the host's time is left out.
Needs the card and ``nvcc``:

    python -m m4ri_tpu_torch.benches.variants_batched [--parent DIR]
        [--kernel gf2_panel_hopper]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess

import torch

from ..ops import _build
from .old_new import load_parent, sub
from .split_batched import MCELIECE, capture_panel, stack, trace

_MMA_TILE = """        mma_b1(acc[0][nt], fa[0], fb.x, fb.y);
        mma_b1(acc[1][nt], fa[1], fb.x, fb.y);"""
_MMA_SCHUR = """          mma_b1(acc[0][nt], af[0][ks], fb.x, fb.y);
          mma_b1(acc[1][nt], af[1][ks], fb.x, fb.y);"""
_C_LOAD = "const int valid = row < a.m ? min(max(a.nw - w, 0), 4) : 0;"
_C_STORE = "    if (row < a.m) {\n      const uint32_t* src = cs"
_SEARCH = """      int l = 0, h = a.batch - 1;
      while (l < h) {
        const int mid = (l + h) >> 1;
        if (a.cum[mid] > s) h = mid; else l = mid + 1;
      }
      e = l;
      first = l ? a.cum[l - 1] : 0;"""

# (kernel, variant) -> [(source file, text, replacement)]
VARIANTS = {
    ("gf2_schur_hopper", "as built"): [],
    ("gf2_schur_hopper", "no C loads or stores"): [
        ("gf2_schur_hopper.cu", _C_LOAD, "const int valid = 0;"),
        ("gf2_schur_hopper.cu", _C_STORE, _C_STORE.replace("row < a.m", "false"))],
    ("gf2_schur_hopper", "no MMAs"): [
        ("gf2_schur_hopper.cu", _MMA_SCHUR,
         "          acc[0][nt][0] ^= fb.x ^ af[0][ks][0];\n"
         "          acc[1][nt][1] ^= fb.y ^ af[1][ks][1];")],
    ("gf2_post_hopper", "as built"): [],
    ("gf2_post_hopper", "no search for the element"): [
        ("gf2_post_hopper.cu", _SEARCH, "      e = s / 2;\n      first = e * 2;")],
    ("gf2_post_hopper", "no MMAs"): [
        ("gf2_tile.cuh", _MMA_TILE,
         "        acc[0][nt][0] ^= fb.x ^ fa[0][0];\n"
         "        acc[1][nt][1] ^= fb.y ^ fa[1][1];")],
}
# the pivot loop: the batched launch's group ends, and the fast path's search
_ROW_WORK = "a.search_window = search_window; a.row_work = 1;"
_FOUND = "const bool found = (b0 | b1) != 0u;"
_SRC = """const bool low = b0 != 0u;
            const int src = __ffs(low ? b0 : b1) - 1;"""
VARIANTS.update({
    ("gf2_panel_hopper", "as built"): [],
    ("gf2_panel_hopper", "chain alone (no group ends)"): [
        ("gf2_panel_hopper.cu", _ROW_WORK, _ROW_WORK.replace("= 1;", "= 0;"))],
    ("gf2_panel_hopper", "pass behind a chain without search"): [
        ("gf2_panel_hopper.cu", _FOUND, "const bool found = true;"),
        ("gf2_panel_hopper.cu", _SRC,
         "const bool low = true;\n            const int src = K;")],
})
VARIANTS[("gf2_schur_hopper", "no C and no MMAs")] = (
    VARIANTS[("gf2_schur_hopper", "no C loads or stores")]
    + VARIANTS[("gf2_schur_hopper", "no MMAs")])


def build_variant(pkg, kernel: str, label: str, edits) -> str | None:
    """The shared library of the variant, or None if the tree's source
    lacks one of the texts to replace."""
    csrc = _build.CSRC if pkg is None else \
        pathlib.Path(pkg.__file__).parent / "csrc"
    out = csrc.parent / "build" / "variants" / f"{kernel}-{label.replace(' ', '_')}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    for name, text, new in edits:
        path = out / name
        src = path.read_text()
        if text not in src:
            return None
        path.write_text(src.replace(text, new))
    lib = out / f"{kernel}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(out), "-o",
                    str(lib), str(out / f"{kernel}.cu")], check=True,
                   capture_output=True)
    return str(lib)


def install(pkg, kernel: str, lib: str):
    """The tree's wrapper of ``kernel``, now calling ``lib``."""
    build = sub(pkg, "ops._build")
    build._LIBS[kernel] = ctypes.CDLL(lib)
    mod = sub(pkg, {"gf2_schur_hopper": "ops.hopper_schur",
                    "gf2_post_hopper": "ops.hopper_post",
                    "gf2_panel_hopper": "ops.hopper_panel"}[kernel])
    for name in ("_fns", "_capacity", "_scratch_words"):
        if hasattr(mod, name):
            getattr(mod, name).cache_clear()
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of another commit")
    ap.add_argument("--kernel", choices=sorted({k for k, _ in VARIANTS}),
                    help="this source's variants only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("variants_batched: needs the card")
    import m4ri_tpu_torch as this
    trees = {"this": this}
    if args.parent:
        trees["parent"] = load_parent(args.parent)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    B, m, n = MCELIECE
    ops = capture_panel(stack(900, B, m, n), n, False)
    c, lp, up, r0s, c0w = ops["gf2_schur_update_batched_hopper"]
    post_ops = ops["panel_post_hopper_batched"]
    loop_ops = ops["panel_loop_hopper_batched"]
    for tree, pkg in trees.items():
        for (kernel, label), edits in VARIANTS.items():
            if args.kernel and kernel != args.kernel:
                continue
            lib = build_variant(None if pkg is this else pkg, kernel, label,
                                edits)
            if lib is None:
                print(json.dumps({"tree": tree, "kernel": kernel,
                                  "variant": label, "skipped": "text absent"}))
                continue
            mod = install(pkg, kernel, lib)
            if "schur" in kernel:
                cc = c.clone()
                fn = (lambda: mod.gf2_schur_update_batched_hopper(
                    cc, lp, up, r0s, c0w))
            elif "post" in kernel:
                fn = (lambda: mod.panel_post_hopper_batched(*post_ops))
            else:
                fn = (lambda: mod.panel_loop_hopper_batched(*loop_ops))
            for _ in range(3):
                fn()
            print(json.dumps({"tree": tree, "kernel": kernel, "variant": label,
                              **trace(fn, calls=10)}), flush=True)


if __name__ == "__main__":
    main()

"""Build and load the native gf2core library via g++ + ctypes.

gf2core (``gf2core.cpp`` beside this file, the port's own copy) is an
independent CPU oracle: a naive popcount product, Gauss elimination and the
glibc ``random()`` stream, in plain C++.  It is not on the device path.  The
shared object is compiled at first use, never at import, into
``m4ri_tpu_torch/build/native/``; ``load()`` returns ``None`` where there is
no compiler, and the ``native_*`` functions then return ``None`` too.
Arrays go in and come out as numpy uint32 words (int32 words are taken as
the same bits).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "gf2core.cpp"
BUILD = _DIR.parent / "build" / "native"
_SO = BUILD / "libgf2core.so"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lib = None
_tried = False


def build(force: bool = False) -> str | None:
    """Compile the library for *this* host.  The .so is never shipped in
    the repo (it is built with -march=native, so a foreign binary could
    SIGILL at call time); a stale or foreign file is simply rebuilt.  The
    compiler writes a temporary file that replaces the library atomically,
    so a concurrent build sees all of it or none."""
    if (not force and _SO.exists()
            and _SO.stat().st_mtime >= _SRC.stat().st_mtime):
        return str(_SO)
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, _SO)
    return str(_SO)


def _open(so: str):
    """dlopen + bind + a tiny selftest; any failure means 'no native'."""
    lib = ctypes.CDLL(so)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64 = ctypes.c_int64
    lib.gf2_mul_naive.argtypes = [u32p, u32p, u32p, i64, i64, i64]
    lib.gf2_mul_naive.restype = None
    lib.gf2_transpose.argtypes = [u32p, u32p, i64, i64]
    lib.gf2_transpose.restype = None
    lib.gf2_echelonize.argtypes = [u32p, i64, i64, ctypes.c_int]
    lib.gf2_echelonize.restype = i64
    lib.gf2_srandom.argtypes = [ctypes.c_uint32]
    lib.gf2_srandom.restype = None
    lib.gf2_random_word.argtypes = []
    lib.gf2_random_word.restype = ctypes.c_uint64
    lib.gf2_randomize.argtypes = [u32p, i64, i64]
    lib.gf2_randomize.restype = None
    # selftest: transpose of a 2x2 identity must round-trip
    src = np.array([[1], [2]], np.uint32)
    dst = np.zeros((2, 1), np.uint32)
    lib.gf2_transpose(_u32(src), _u32(dst), 2, 2)
    if dst.tolist() != [[1], [2]]:
        raise OSError("gf2core selftest failed")
    return lib


def load():
    """The bound library, built at the first call; ``None`` without a
    compiler."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = build()
    if so is None:
        return None
    try:
        _lib = _open(so)
    except OSError:
        # e.g. a leftover binary from another host: rebuild once
        so = build(force=True)
        if so is not None:
            try:
                _lib = _open(so)
            except OSError:
                _lib = None
    return _lib


def _words(a: np.ndarray) -> np.ndarray:
    """C-contiguous uint32 words; int32 words are viewed, not converted."""
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def _u32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def native_mul(a_packed: np.ndarray, b_packed: np.ndarray, k: int,
               n: int) -> np.ndarray | None:
    """Packed GF(2) product A (m x k) * B (k x n) via the native popcount
    oracle."""
    lib = load()
    if lib is None:
        return None
    a = _words(a_packed)
    b = _words(b_packed)
    m, kw = a.shape
    bt = np.zeros((n, kw), np.uint32)
    btmp = np.zeros((n, (k + 31) // 32), np.uint32)
    lib.gf2_transpose(_u32(b), _u32(btmp), k, n)
    bt[:, : btmp.shape[1]] = btmp
    c = np.zeros((m, (n + 31) // 32), np.uint32)
    lib.gf2_mul_naive(_u32(a), _u32(bt), _u32(c), m, n, kw)
    return c


def native_echelonize(a_packed: np.ndarray, n: int, full: bool):
    """(echelon form as uint32 words, rank) of an m x n packed matrix."""
    lib = load()
    if lib is None:
        return None
    a = _words(a_packed).copy()
    r = lib.gf2_echelonize(_u32(a), a.shape[0], n, int(full))
    return a, int(r)


def native_randomize(rows: int, cols: int, seed: int = 17) -> np.ndarray | None:
    """Packed words filled like the reference's mzd_randomize under
    srandom(seed)."""
    lib = load()
    if lib is None:
        return None
    lib.gf2_srandom(seed)
    out = np.zeros((rows, (cols + 31) // 32), np.uint32)
    lib.gf2_randomize(_u32(out), rows, cols)
    return out

"""Matrix I/O of the PyTorch/CUDA port against the JAX package (mirrors
test_io.py): strings, JCF, PNG and npz.  Strings and files written by the
two packages from the same numpy input must be byte for byte equal, every
format must round-trip, and a file written by either package must load in
the other with equal words (tolerance 0)."""

import struct
import zlib

import numpy as np
import pytest

import m4ri_tpu as mj
import m4ri_tpu_torch as mt
from m4ri_tpu.core.bitmatrix import randomize_custom as j_randomize_custom
from m4ri_tpu.utils import io as jio
from m4ri_tpu.utils.hashing import matrix_hash as j_hash
from m4ri_tpu.utils.rng import GlibcRandom as JGlibcRandom
from m4ri_tpu_torch.core.bitmatrix import randomize_custom
from m4ri_tpu_torch.utils import io as tio
from m4ri_tpu_torch.utils.hashing import matrix_hash
from m4ri_tpu_torch.utils.rng import GlibcRandom

from conftest import random_dense
from torch_port import assert_padding_zero, assert_same, both, with_bit31


@pytest.mark.parametrize("m,n", [(2, 3), (1, 3), (3, 70), (5, 129)])
def test_strings_equal_jax(rng, m, n):
    a = with_bit31(rng, m, n) if n > 31 else random_dense(rng, m, n)
    s = "".join("1" if x else "0" for x in a.reshape(-1))
    Aj, At = jio.from_str(m, n, s), tio.from_str(m, n, s, device="cpu")
    assert_same(Aj, At)
    assert tio.to_str(At) == jio.to_str(Aj) == s
    assert tio.to_text(At) == jio.to_text(Aj)


def test_from_to_str():
    A = tio.from_str(2, 3, "101010", device="cpu")
    np.testing.assert_array_equal(mt.to_numpy(A), [[1, 0, 1], [0, 1, 0]])
    assert tio.to_str(A) == "101010"
    assert tio.to_text(tio.from_str(1, 3, "101", device="cpu")) == "[1 1]"


# (writer name, file suffix, density of the matrix)
FORMATS = [("jcf", "jcf", 0.2), ("png", "png", 0.5), ("npz", "npz", 0.5)]


def _write(io_mod, fmt, M, path):
    {"jcf": io_mod.to_jcf, "png": io_mod.write_png,
     "npz": io_mod.save_npz}[fmt](M, path)


def _read_jax(fmt, path):
    return {"jcf": jio.from_jcf, "png": jio.read_png,
            "npz": jio.load_npz}[fmt](path)


def _read_port(fmt, path):
    return {"jcf": tio.from_jcf, "png": tio.read_png,
            "npz": tio.load_npz}[fmt](path, device="cpu")


@pytest.mark.parametrize("m,n", [(17, 40), (33, 70), (300, 65)])
@pytest.mark.parametrize("fmt,suffix,dens", FORMATS,
                         ids=[f[0] for f in FORMATS])
def test_files_round_trip_and_cross_packages(rng, tmp_path, fmt, suffix, dens,
                                             m, n):
    a = random_dense(rng, m, n, density=dens)
    a[:, 31::32] = 1
    Aj, At = both(a)
    pj, pt = str(tmp_path / f"j.{suffix}"), str(tmp_path / f"t.{suffix}")
    _write(jio, fmt, Aj, pj)
    _write(tio, fmt, At, pt)
    if fmt != "npz":  # a zip archive stamps its members; the words agree
        assert open(pj, "rb").read() == open(pt, "rb").read()
    back = _read_port(fmt, pt)
    assert_same(Aj, back, "round trip")
    assert_padding_zero(back)
    assert_same(Aj, _read_port(fmt, pj), "JAX file read by the port")
    assert_same(_read_jax(fmt, pt), At, "port file read by the JAX package")


def test_npz_holds_uint32_words(rng, tmp_path):
    At = mt.from_numpy(with_bit31(rng, 9, 64), device="cpu")
    path = str(tmp_path / "m.npz")
    tio.save_npz(At, path)
    with np.load(path) as z:
        assert z["data"].dtype == np.uint32 and int(z["ncols"]) == 64
        np.testing.assert_array_equal(
            z["data"], At.data.numpy().view(np.uint32))


def test_info_and_hash_equal_jax(rng):
    a = with_bit31(rng, 10, 40)
    Aj, At = both(a)
    assert tio.info(At, compute_rank=True) == jio.info(Aj, compute_rank=True)
    assert tio.info(At) == jio.info(Aj)
    assert "10 x 40" in tio.info(At) and "rank" in tio.info(At, True)
    assert int(matrix_hash(At)) == int(j_hash(Aj))


def test_hash_changes(rng):
    a = random_dense(rng, 8, 8)
    h1 = int(matrix_hash(mt.from_numpy(a, device="cpu")))
    b = a.copy()
    b[3, 3] ^= 1
    assert int(matrix_hash(mt.from_numpy(b, device="cpu"))) != h1
    c = a[::-1].copy()
    if not np.array_equal(a, c):
        assert int(matrix_hash(mt.from_numpy(c, device="cpu"))) != h1


def test_randomize_custom_equals_jax():
    A = randomize_custom(5, 100, GlibcRandom(17).random_word, device="cpu")
    assert_same(j_randomize_custom(5, 100, JGlibcRandom(17).random_word), A)
    assert_same(mj.randomize_reference(5, 100, seed=17), A)


def _encode(body, prev, f):
    """One scanline under PNG filter f (bpp = 1 byte)."""
    out = np.zeros_like(body)
    for j in range(len(body)):
        a = int(body[j - 1]) if j else 0
        b = int(prev[j])
        c = int(prev[j - 1]) if j else 0
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = b
        elif f == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[j] = (int(body[j]) - pred) & 0xFF
    return out


def _png_with_filters(bits, filts):
    h, w = bits.shape
    stride = (w + 7) // 8
    raws = []
    prev = np.zeros(stride, np.uint8)
    for i in range(h):
        body = np.packbits(1 - bits[i], axis=None)[:stride]
        raws.append(bytes([filts[i]]) + _encode(body, prev, filts[i]).tobytes())
        prev = body

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 1, 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(raws)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["all_five", "none_sub_up"])
def test_png_filters_read_like_jax(tmp_path, kind):
    """Every PNG scanline filter (0/1/2/3/4) on the per-row path, and the
    {None, Sub, Up} set on the vectorized path with a leading Up run."""
    if kind == "all_five":
        rng = np.random.default_rng(11)
        h, w = 10, 70
        filts = [i % 5 for i in range(h)]
    else:
        rng = np.random.default_rng(23)
        h, w = 37, 190
        filts = [2, 2, 2, 2] + [(0, 1, 2, 2, 2, 1, 2)[i % 7] for i in range(h - 4)]
    bits = (rng.random((h, w)) < 0.5).astype(np.uint8)
    path = tmp_path / "filters.png"
    path.write_bytes(_png_with_filters(bits, filts))
    got = tio.read_png(str(path), device="cpu")
    np.testing.assert_array_equal(mt.to_numpy(got), bits)
    assert_same(jio.read_png(str(path)), got)


def test_read_png_refuses_other_files(tmp_path):
    path = tmp_path / "x.png"
    path.write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="not a PNG"):
        tio.read_png(str(path), device="cpu")

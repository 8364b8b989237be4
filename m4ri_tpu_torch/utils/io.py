"""Matrix I/O (reference analogue: io.[ch]).

- ``from_str`` / ``to_str``: dense 0/1 strings (reference: mzd_from_str,
  io.c:350; mzd_fprint ASCII with ``:`` every 64 columns, io.c:53-90).
- ``from_jcf`` / ``to_jcf``: the JCF sparse text format (reference:
  mzd_from_jcf, io.c:297-345 — header "m n p / nonzero", then one index per
  line, 1-based; a negative value starts a new row).
- ``read_png`` / ``write_png``: 1-bit PNG images (reference: io.c:72-293,
  gated on libpng), in pure python on top of zlib.
- ``save_npz`` / ``load_npz``: packed words and ``ncols``.
- ``info``: dimensions, density, hash, optional rank (reference: mzd_info,
  io.c:41-52).

Files and strings are byte for byte the JAX package's on the same matrix,
so a file written by either package loads in the other.  Readers take
``device=None``, which means the card; the matrix is read on the host and
its words are copied there once.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..core.bitmatrix import BitMatrix, density, from_numpy, from_packed, \
    to_numpy

__all__ = ["from_str", "to_str", "to_text", "from_jcf", "to_jcf",
           "write_png", "read_png", "info", "save_npz", "load_npz"]

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def from_str(m: int, n: int, s: str, device=None) -> BitMatrix:
    bits = np.array([1 if c == "1" else 0 for c in s], np.uint8)
    assert bits.size == m * n
    return from_numpy(bits.reshape(m, n), device=device)


def to_str(a: BitMatrix) -> str:
    return (to_numpy(a).reshape(-1) + ord("0")).tobytes().decode("ascii")


def to_text(a: BitMatrix) -> str:
    """Human-readable rows like mzd_fprint: [0110:1011] with a colon every
    64 columns."""
    dense = to_numpy(a)
    lines = []
    for row in dense:
        parts = ["".join("1" if b else " " for b in row[i : i + 64])
                 for i in range(0, a.ncols, 64)]
        lines.append("[" + ":".join(parts) + "]")
    return "\n".join(lines)


def from_jcf(path: str, device=None) -> BitMatrix:
    with open(path) as fh:
        header = fh.readline().split()
        m, n, p = int(header[0]), int(header[1]), int(header[2])
        if p != 2:
            raise ValueError(f"expected p==2 but found p=={p}")
        fh.readline()  # nonzero count
        dense = np.zeros((m, n), np.uint8)
        i = -1
        for line in fh:
            line = line.strip()
            if not line:
                continue
            j = int(line)
            if j < 0:
                i += 1
                j = -j
            dense[i, j - 1] = 1
    return from_numpy(dense, device=device)


def to_jcf(a: BitMatrix, path: str) -> None:
    dense = to_numpy(a)
    nonzero = int(dense.sum(dtype=np.int64))
    with open(path, "w") as fh:
        fh.write(f"{a.nrows} {a.ncols} 2\n{nonzero}\n\n")
        for i in range(a.nrows):
            cols = np.nonzero(dense[i])[0]
            for k, j in enumerate(cols):
                fh.write(f"{-(j + 1) if k == 0 else j + 1}\n")


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def write_png(a: BitMatrix, path: str) -> None:
    """1-bit grayscale PNG; bit 1 = black (0), matching the reference's
    convention of writing the complement (io.c uses ~tmp)."""
    dense = to_numpy(a)
    h, w = dense.shape
    row_bytes = np.packbits(1 - dense, axis=1)  # MSB-first per PNG spec
    lines = np.zeros((h, row_bytes.shape[1] + 1), np.uint8)
    lines[:, 1:] = row_bytes  # filter byte 0 (None) per scanline
    ihdr = struct.pack(">IIBBBBB", w, h, 1, 0, 0, 0, 0)
    png = (_PNG_MAGIC + _chunk(b"IHDR", ihdr)
           + _chunk(b"IDAT", zlib.compress(lines.tobytes()))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(png)


def read_png(path: str, device=None) -> BitMatrix:
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos = 8
    idat = []
    w = h = depth = color = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", payload[:10])
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if depth != 1 or color != 0:
        raise ValueError("only 1-bit grayscale PNGs are supported")
    raw = zlib.decompress(b"".join(idat))
    nb = (w + 7) // 8
    lines = np.frombuffer(raw, np.uint8).reshape(h, nb + 1)
    filt, body = lines[:, 0], lines[:, 1:].copy()
    if np.all(filt <= 2):
        out = _png_unfilter_rows_012(filt, body)
    else:
        # Average/Paeth scanlines (never emitted by libpng for sub-byte
        # bit depths; kept for arbitrary writers): per-row scalar path
        out = np.zeros_like(body)
        prev = np.zeros(nb, np.uint8)
        for i in range(h):
            prev = out[i] = _png_unfilter(int(filt[i]), body[i], prev)
    bits = np.unpackbits(out, axis=1)[:, :w]
    return from_numpy(1 - bits, device=device)


def _png_unfilter_rows_012(filt: np.ndarray, body: np.ndarray) -> np.ndarray:
    """Vectorized unfilter for whole images using only filters
    {0 None, 1 Sub, 2 Up}, the set libpng produces for 1-bit images.

    Sub rows are an independent per-row prefix sum.  A run of Up rows is a
    column-wise prefix sum anchored at the nearest non-Up row above (whose
    value is final after the Sub pass, since filters 0/1 don't look up);
    uint8 arithmetic wraps mod 256 exactly as the spec requires."""
    h = body.shape[0]
    sub = filt == 1
    if sub.any():
        body[sub] = np.cumsum(body[sub], axis=1, dtype=np.uint8)
    up = filt == 2
    if not up.any():
        return body
    # anchor[i] = last row <= i with filt != 2 (or -1 inside a leading run)
    idx = np.arange(h)
    anchor = np.maximum.accumulate(np.where(~up, idx, -1))
    cs = np.cumsum(body, axis=0, dtype=np.uint8)  # wraps mod 256
    a_idx = np.maximum(anchor, 0)
    has_anchor = (anchor >= 0)[:, None]
    run_sum = cs - np.where(has_anchor, cs[a_idx], 0).astype(np.uint8)
    final_anchor = np.where(has_anchor, body[a_idx], 0).astype(np.uint8)
    out = body.copy()
    out[up] = (final_anchor + run_sum)[up]
    return out


def _png_unfilter(filt: int, body: np.ndarray, prev: np.ndarray) -> np.ndarray:
    """All five PNG scanline filters (the reference reads arbitrary
    libpng-written files, io.c:72-293; for 1-bit grayscale bpp = 1 byte)."""
    if filt == 0:  # None
        return body
    if filt == 2:  # Up
        return (body + prev).astype(np.uint8)
    if filt == 1:  # Sub: out[i] = body[i] + out[i-1] == prefix sum mod 256
        return np.cumsum(body, dtype=np.uint64).astype(np.uint8)
    out = np.zeros_like(body)
    for i in range(len(body)):
        a = int(out[i - 1]) if i else 0          # left
        b = int(prev[i])                          # up
        if filt == 3:  # Average
            out[i] = (int(body[i]) + ((a + b) >> 1)) & 0xFF
        elif filt == 4:  # Paeth
            c = int(prev[i - 1]) if i else 0      # up-left
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            out[i] = (int(body[i]) + pred) & 0xFF
        else:
            raise ValueError(f"unsupported PNG filter {filt}")
    return out


def info(a: BitMatrix, compute_rank: bool = False) -> str:
    from .hashing import matrix_hash
    d = float(density(a))
    s = (f"{a.nrows} x {a.ncols} matrix, density {d:8.6f}, "
         f"hash 0x{int(matrix_hash(a)):08x}")
    if compute_rank:
        from ..models.echelon import rank
        s += f", rank {rank(a)}"
    return s


def save_npz(a: BitMatrix, path: str) -> None:
    """Persist a BitMatrix: its words as uint32 (the JAX package's type,
    the same bits as the port's int32) and ``ncols``, so that a file
    written by either package loads in the other."""
    words = np.ascontiguousarray(a.data.detach().cpu().numpy()).view(np.uint32)
    np.savez_compressed(path, data=words, ncols=a.ncols)


def load_npz(path: str, device=None) -> BitMatrix:
    with np.load(path) as z:
        return from_packed(z["data"], int(z["ncols"]), device=device)

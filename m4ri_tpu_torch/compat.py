"""Reference-API compatibility layer: the mzd_* / mzp_* surface.

A user of the reference C library can keep their call names: every public
function of m4ri/m4ri.h:57-71 has a counterpart here with matching
semantics (functional instead of in-place: mutators return the new matrix).
Cutoff/k tuning parameters are accepted and ignored where the engine tunes
itself (the reference recommends passing 0 for auto anyway).  The names and
their semantics are the JAX package's ``compat`` module's.

Results land on the input's device and never share storage with the
caller's tensors: ``mzd_copy``, ``mzd_combine*``, the capped column
permutations and the permutation windows copy where the JAX package (whose
arrays are immutable) may share.  Functions that make a matrix or a
permutation from nothing take ``device=None``, which means the card.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from . import (add, addmul, col_swap, concat, density, echelonize,
               echelonize_pluq, equal, invert, is_zero, kernel_left,
               mul, mul_naive, ple, pluq, randomize, randomize_reference,
               read_bit, row_swap, solve_left, stack, submatrix, to_numpy,
               top_echelonize, transpose, write_bit, zeros)
from .core import bitops
from .core.bitmatrix import (BitMatrix, from_numpy, randomize_custom,
                             resolve_device)
from .core.permutation import (apply_p_left, apply_p_left_trans,
                               apply_p_right, apply_p_right_trans,
                               apply_p_right_trans_tri)
from .models.djb import djb_apply, djb_compile
from .models.triangular import (trsm_lower_left, trsm_lower_right,
                                trsm_upper_left, trsm_upper_right,
                                trtri_upper)
from .ops.m4rm import addmul_m4rm, mul_m4rm
from .utils import io
from .utils.hashing import matrix_hash
from .utils.rng import GlibcRandom


# __all__ is assembled at the very end of the module so the long-tail
# section below is included.


# --- container -----------------------------------------------------------

def mzd_init(nrows, ncols, device=None):
    return zeros(nrows, ncols, device=device)


def mzd_copy(dst, src):
    return BitMatrix(src.data.clone(), src.ncols)


def mzd_free(a):  # no-op: tensors are garbage collected
    return None


mzd_transpose = lambda dst, a=None: transpose(a if a is not None else dst)
mzd_stack = lambda dst, a, b=None: stack(a, b) if b is not None else stack(dst, a)
mzd_concat = lambda dst, a, b=None: concat(a, b) if b is not None else concat(dst, a)


def mzd_submatrix(dst, a, r0, c0, r1, c1):
    return submatrix(a, r0, c0, r1, c1)


def mzd_init_window(a, r0, c0, r1, c1):
    # zero-copy in the reference; a copy here
    return submatrix(a, r0, c0, r1, c1)


mzd_set_ui = bitops.set_ui
mzd_is_zero = is_zero
mzd_equal = equal
mzd_density = lambda a, res=0: density(a)


_GLOBAL_RNG = {"rng": None}


def m4ri_srandom(seed: int) -> None:
    _GLOBAL_RNG["rng"] = GlibcRandom(seed)


def m4ri_random_word() -> int:
    if _GLOBAL_RNG["rng"] is None:
        _GLOBAL_RNG["rng"] = GlibcRandom(0)
    return _GLOBAL_RNG["rng"].random_word()


_RANDOMIZE_CALLS = itertools.count(1)  # atomic under the GIL


def mzd_randomize(a: BitMatrix) -> BitMatrix:
    """A random matrix of A's shape on A's device.

    After m4ri_srandom it is the reference's glibc stream, bit for bit the
    JAX package's.  Unseeded it draws from a ``torch.Generator`` on A's
    device seeded from this module's call counter, so that successive calls
    differ, as the reference's stream advances; those bits are not the JAX
    package's (it folds its counter into a threefry key), nor need they be."""
    if _GLOBAL_RNG["rng"] is not None:
        return randomize_reference(a.nrows, a.ncols, rng=_GLOBAL_RNG["rng"],
                                   device=a.device)
    gen = torch.Generator(device=a.device)
    gen.manual_seed(next(_RANDOMIZE_CALLS))
    return randomize(a.nrows, a.ncols, gen, device=a.device)


def mzd_randomize_custom(a, rc, data=None):
    return randomize_custom(a.nrows, a.ncols,
                            (lambda: rc(data)) if data is not None else rc,
                            device=a.device)


# --- bit access ----------------------------------------------------------

mzd_read_bit = read_bit
mzd_write_bit = write_bit
# Field access up to 64 bits (reference semantics: m4ri_radix = 64,
# mzd.h:892-901).  The packed word here is 32-bit, so a 33..64-bit field
# is composed of two radix-32 sub-fields; each sub-call handles its own
# 2-word straddle, so an unaligned 64-bit field correctly spans 3 words.
# A field of up to 32 bits is an int32 tensor with the field's bits (as
# bitops.read_bits gives it); a wider one is a non-negative Python int.

_U32 = 0xFFFFFFFF


def mzd_read_bits(m, i, j, n_bits: int):
    if n_bits <= 32:
        return bitops.read_bits(m, i, j, n_bits)
    assert n_bits <= 64, "mzd_read_bits: n_bits must be <= 64"
    # int() of an int32 word with bit 31 set is negative: mask each half
    lo = int(bitops.read_bits(m, i, j, 32)) & _U32
    hi = int(bitops.read_bits(m, i, j + 32, n_bits - 32)) & _U32
    return lo | (hi << 32)


mzd_read_bits_int = mzd_read_bits


def _split64(m, i, j, n_bits, values, op32):
    if n_bits <= 32:
        return op32(m, i, j, n_bits, values)
    assert n_bits <= 64, "bit-field ops support n_bits <= 64"
    v = int(values)
    # the port's bit-field ops mask a Python int to the field, so a half
    # of 2**31 or more needs no conversion to an int32 value
    m = op32(m, i, j, 32, v & _U32)
    return op32(m, i, j + 32, n_bits - 32, (v >> 32) & _U32)


def mzd_xor_bits(m, i, j, n_bits: int, values):
    return _split64(m, i, j, n_bits, values, bitops.xor_bits)


def mzd_and_bits(m, i, j, n_bits: int, values):
    return _split64(m, i, j, n_bits, values, bitops.and_bits)


def mzd_clear_bits(m, i, j, n_bits: int):
    if n_bits <= 32:
        return bitops.clear_bits(m, i, j, n_bits)
    assert n_bits <= 64, "mzd_clear_bits: n_bits must be <= 64"
    m = bitops.clear_bits(m, i, j, 32)
    return bitops.clear_bits(m, i, j + 32, n_bits - 32)


mzd_row_swap = row_swap
mzd_col_swap = col_swap
mzd_row_add = bitops.row_add
mzd_row_add_offset = lambda a, dst, src, off: bitops.row_add_offset(
    a, dst, src, off)
mzd_extract_u = lambda dst, a=None: bitops.extract_u(a if a is not None else dst)
mzd_extract_l = lambda dst, a=None: bitops.extract_l(a if a is not None else dst)
mzd_find_pivot = bitops.find_pivot


def _row_mask(m: BitMatrix, start_row: int, stop_row=None):
    """bool[nrows, 1]: the rows in [start_row, stop_row)."""
    i = torch.arange(m.nrows, device=m.device)
    keep = i >= start_row
    if stop_row is not None:
        keep &= i < stop_row
    return keep[:, None]


def mzd_col_swap_in_rows(a, c1, c2, start_row, stop_row):
    swapped = col_swap(a, c1, c2)
    data = torch.where(_row_mask(a, start_row, stop_row), swapped.data,
                       a.data)
    return BitMatrix(data, a.ncols)


# --- arithmetic ----------------------------------------------------------

def mzd_add(c, a, b=None):
    return add(a, b) if b is not None else add(c, a)


mzd_sub = mzd_add  # GF(2): identical


def mzd_mul(c, a, b, cutoff=0):
    return mul(a, b)


def mzd_addmul(c, a, b, cutoff=0):
    return addmul(c, a, b)


def mzd_mul_naive(c, a, b):
    return mul_naive(a, b)


def mzd_addmul_naive(c, a, b):
    return add(c, mul_naive(a, b))


def mzd_mul_m4rm(c, a, b, k=0):
    return mul_m4rm(a, b, k)


def mzd_addmul_m4rm(c, a, b, k=0):
    return addmul_m4rm(c, a, b, k)


def mzd_mul_mp(c, a, b, cutoff=0):
    """OpenMP multiply analogue: the SUMMA product over the ranks of the
    process group (mp.c:39).  With no group yet, a 1-rank group is started
    on the matrices' device."""
    from .parallel.dist_mul import mul_dist
    from .parallel.mesh import make_mesh
    return mul_dist(a, b, make_mesh(device=a.device))


# --- elimination / factorization ----------------------------------------

def mzd_echelonize(a, full=True):
    return echelonize(a, full=full, strategy="heuristic")


def mzd_echelonize_m4ri(a, full=True, k=0):
    return echelonize(a, full=full)


def mzd_echelonize_pluq(a, full=True):
    return echelonize_pluq(a, full=full)


def mzd_top_echelonize_m4ri(a, k=0):
    return top_echelonize(a, k)


def mzd_ple(a, p=None, q=None, cutoff=0):
    """Returns (A_inplace, P, Q, rank) — the reference writes P/Q into the
    preallocated mzp_t arguments and returns the rank."""
    return ple(a)


def mzd_pluq(a, p=None, q=None, cutoff=0):
    return pluq(a)


def mzd_inv_m4ri(dst, src, k=0):
    """Inversion; raises on singular input like the reference's
    m4ri_die("A is not invertible") (brilliantrussian.c:984)."""
    inv, r = invert(src)
    if r != src.ncols:
        raise ValueError(
            f"mzd_inv_m4ri: matrix is not invertible (rank {r} < "
            f"{src.ncols})")
    return inv


def mzd_solve_left(a, b, cutoff=0, inconsistency_check=1):
    return solve_left(a, b)


def mzd_invert_naive(dst, src, identity_arg=None):
    """Independent naive-Gauss inversion engine (reference:
    mzd_invert_naive, mzd.c); returns None on singular input like the
    reference returns NULL."""
    from .models.echelon import invert_naive
    inv, ok = invert_naive(src)
    return inv if bool(ok) else None


def mzd_mul_va(c, v, a, clear=True):
    """Vector-matrix product C = v * A (reference: mzd_mul_va,
    mzd.c:1256-1268); v is a 1 x m matrix."""
    out = mul(v, a)
    if not clear and c is not None:
        out = add(c, out)
    return out


def mzd_kernel_left_pluq(a, cutoff=0):
    return kernel_left(a)


mzd_trsm_upper_left = lambda u, b, cutoff=0: trsm_upper_left(u, b)
mzd_trsm_lower_left = lambda l, b, cutoff=0: trsm_lower_left(l, b)
mzd_trsm_upper_right = lambda u, b, cutoff=0: trsm_upper_right(u, b)
mzd_trsm_lower_right = lambda l, b, cutoff=0: trsm_lower_right(l, b)
mzd_trtri_upper = trtri_upper


# --- permutations (mzp_t) ------------------------------------------------

def mzp_init(length, device=None):
    return torch.arange(length, dtype=torch.int32,
                        device=resolve_device(device))


def mzp_set_ui(p, value=1):
    return torch.arange(p.shape[0], dtype=torch.int32, device=p.device)


mzd_apply_p_left = apply_p_left
mzd_apply_p_left_trans = apply_p_left_trans
mzd_apply_p_right = apply_p_right
mzd_apply_p_right_trans = apply_p_right_trans
mzd_apply_p_right_trans_tri = apply_p_right_trans_tri


# --- io / misc -----------------------------------------------------------

mzd_from_str = io.from_str
mzd_from_jcf = lambda fn, verbose=0, device=None: io.from_jcf(fn, device=device)
mzd_to_png = lambda a, fn, compression=9, comment="", verbose=0: io.write_png(a, fn)
mzd_from_png = lambda fn, verbose=0, device=None: io.read_png(fn, device=device)
mzd_info = lambda a, do_rank=0: print(io.info(a, bool(do_rank)))
mzd_print = lambda a: print(io.to_text(a))
mzd_hash = matrix_hash
djb_compile_ = djb_compile
djb_apply_mzd = lambda prog, w, v: djb_apply(prog, v)


# --- additions: remaining public surface ---------------------------------

from .models.echelon import echelonize_naive as _echelonize_naive  # noqa: E402
from .models.echelon import gauss_delayed as _gauss_delayed  # noqa: E402
from .models.solve import pluq_solve_left as _pluq_solve_left  # noqa: E402
from .utils.bits import word_to_str as m4ri_word_to_str  # noqa: E402,F401


def mzd_echelonize_naive(a, full=True):
    return _echelonize_naive(a, full=full)


def mzd_gauss_delayed(a, startcol=0, full=False):
    return _gauss_delayed(a, start_col=startcol, full=full)


def mzd_pluq_solve_left(a_factored, rank, p, q, b, cutoff=0, check=1):
    return _pluq_solve_left(a_factored, p, q, rank, b)


mzd_cmp = bitops.cmp
mzd_copy_row = lambda m, dst, src_mat, src: bitops.copy_row(m, dst, src_mat, src)
mzd_row_clear_offset = bitops.row_clear_offset
mzd_first_zero_row = bitops.first_zero_row


def mzd_fprint_row(a, i):
    print(io.to_text(submatrix(a, i, 0, i + 1, a.ncols)))


# --- umbrella-header long tail -------------------------------------------
# Every remaining public name of m4ri/m4ri.h, so that the grep of the
# umbrella header against this module is empty.  Memory-management and
# library-lifecycle names are documented no-ops (torch's allocator owns
# device memory and there is no global state to initialize).

from .utils import bits as _bits  # noqa: E402
from .utils import graycode as _graycode  # noqa: E402

# word width of the packed representation (the reference's m4ri_radix is
# 64, misc.h:141; the words here are 32-bit).  Bit-level compat APIs take
# absolute bit indices, so the radix only matters to callers doing their
# own word arithmetic.
from .utils.config import WORD_BITS as m4ri_radix  # noqa: E402,F401

m4ri_swap_bits = _bits.swap_bits
m4ri_spread_bits = _bits.spread_bits
m4ri_shrink_bits = _bits.shrink_bits
m4ri_lesser_LSB = _bits.lesser_lsb
m4ri_parity64 = _bits.parity64
m4ri_parity64_helper = _bits.parity64  # same MIX-tree result (parity.h)
m4ri_gray_code = _graycode.gray_code
m4ri_opt_k = _graycode.opt_k
m4ri_build_code = _graycode.codebook   # returns the (ord, inc) arrays


def m4ri_coin_flip():
    """random() & 1 (misc.h:527)."""
    return m4ri_random_word() & 1


def m4ri_die(msg, *args):
    """printf + abort in the reference (misc.c:36) -> an exception here."""
    raise RuntimeError("m4ri_die: " + ((msg % args) if args else str(msg)))


def m4ri_init():
    """Library ctor (misc.c:73): builds the global Gray codebook.  Here
    codebooks are pure cached functions — nothing to initialize."""
    return None


def m4ri_fini():
    return None


m4ri_build_all_codes = m4ri_init
m4ri_destroy_all_codes = m4ri_fini


def m4ri_mm_malloc(size, *args):
    """Host-side scratch only; device memory belongs to torch."""
    return np.zeros(int(size), np.uint8)


def m4ri_mm_malloc_aligned(size, alignment=64):
    return np.zeros(int(size), np.uint8)


def m4ri_mm_calloc(count, size):
    return np.zeros(int(count) * int(size), np.uint8)


def m4ri_mm_free(ptr, *args):
    return None


m4ri_mmc_malloc = m4ri_mm_malloc
m4ri_mmc_calloc = m4ri_mm_calloc
m4ri_mmc_free = m4ri_mm_free


def m4ri_mmc_cleanup():
    return None


# debug-dump hooks (debug_dump.h:37-61): rolling-hash printers usable to
# diff two engines op by op; mzd/mzp variants hash the object, scalar
# variants print the value.  Permutations and arrays are read back to the
# host.

def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def m4ri_dd_mzd(function, line, a):
    print(f"DD: {function}:{line} mzd {int(matrix_hash(a)):08x}")


def m4ri_dd_mzp(function, line, p):
    p = _host(p)
    h = int(np.bitwise_xor.reduce(
        p.astype(np.uint64) * np.uint64(0x9E3779B1) ^
        np.arange(len(p), dtype=np.uint64)) & np.uint64(0xFFFFFFFF))
    print(f"DD: {function}:{line} mzp {h:08x}")


def m4ri_dd_int(function, line, v):
    print(f"DD: {function}:{line} int {int(v)}")


def m4ri_dd_rci(function, line, v):
    print(f"DD: {function}:{line} rci {int(v)}")


def m4ri_dd_rci_array(function, line, arr, count):
    vals = " ".join(str(int(x)) for x in _host(arr)[: int(count)])
    print(f"DD: {function}:{line} rci[] {vals}")


def m4ri_dd_row(function, line, a, i):
    print(f"DD: {function}:{line} row {i} "
          f"{int(matrix_hash(submatrix(a, i, 0, i + 1, a.ncols))):08x}")


m4ri_dd_rawrow = m4ri_dd_row


# --- row access / combination (mzd.h) ------------------------------------

def mzd_row(a, i):
    """Packed words of row i as host uint32 (the reference returns a word
    pointer)."""
    return np.ascontiguousarray(_host(a.data[i])).view(np.uint32)


mzd_row_const = mzd_row


def mzd_combine(c, c_row, c_startblock, a, a_row, a_startblock,
                b, b_row, b_startblock):
    """C[c_row] = A[a_row] ^ B[b_row] (xor.h:44; word offsets must match
    — every in-tree caller passes equal startblocks), as a new matrix."""
    assert c_startblock == a_startblock == b_startblock, \
        "mismatched word offsets are not part of the reference contract"
    data = c.data.clone()
    data[c_row, c_startblock:] = (a.data[a_row, c_startblock:]
                                  ^ b.data[b_row, c_startblock:])
    return BitMatrix(data, c.ncols)


mzd_combine_even = mzd_combine


def mzd_combine_even_in_place(a, a_row, a_startblock, b, b_row,
                              b_startblock):
    """A[a_row] ^= B[b_row] from word offset (xor.h:96), as a new matrix."""
    return mzd_combine(a, a_row, a_startblock, a, a_row, a_startblock,
                       b, b_row, b_startblock)


def mzd_is_windowed(a):
    """Windows are copies here — no shared storage."""
    return False


def mzd_is_dangerous_window(a):
    return False


mzd_init_window_const = mzd_init_window


# --- M4RM internals (brilliantrussian.h) ---------------------------------

def mzd_make_table(m, r, c, k, t=None, l=None, device=None):
    """Gray-code table build (brilliantrussian.c:163-211): returns (T, L)
    where T has 2^k rows — T[i] = T[i-1] ^ M[r + inc[i-1]] with columns
    below c cleared — and L[gray_ord[i]] = i.  Built on the host as the
    JAX package builds it; T and L go to ``device``, M's device by
    default."""
    ordv, inc = _graycode.codebook(k)
    two_k = 1 << k
    rows = to_numpy(m)
    # T[i] = cumulative XOR of rows[r + inc[0..i-1]]: the selection of
    # each source row is the cumulative parity of its toggle count, so
    # the whole table is one (2^k x k) @ (k x ncols) product mod 2
    # instead of a per-table-row host loop.
    incv = np.asarray(inc[: two_k - 1], np.int64)
    onehot = (incv[:, None] == np.arange(k)[None, :]).astype(np.int64)
    sel = np.zeros((two_k, k), np.int64)
    sel[1:] = np.cumsum(onehot, axis=0) & 1
    avail = max(0, min(k, m.nrows - r))
    if avail:
        tt = ((sel[:, :avail] @ rows[r:r + avail].astype(np.int64)) & 1
              ).astype(np.uint8)
    else:
        tt = np.zeros((two_k, m.ncols), np.uint8)
    ll = np.zeros(two_k, np.int64)
    ll[np.asarray(ordv[:two_k], np.int64)] = np.arange(two_k)
    tt[:, :c] = 0
    dev = m.device if device is None else resolve_device(device)
    return (from_numpy(tt, device=dev),
            torch.as_tensor(ll, dtype=torch.int32, device=dev))


def _process_rows_n(m, startrow, stoprow, startcol, k, tables, lookups):
    """Shared body of mzd_process_rows{,2..6}: per row, read n*k bits at
    startcol, look up each table, XOR the rows in (brilliantrussian.c
    :213-601).  Batched over the row range; an index past a table's end
    takes its last row, as the JAX package's clipping gather does."""
    data = m.data
    nsel = torch.arange(m.nrows, device=m.device)
    delta = torch.zeros_like(data)
    for j, (t, l) in enumerate(zip(tables, lookups)):
        bitsv = bitops.read_bits(m, nsel, startcol + j * k, k).long()
        x = l.index_select(0, bitsv.clamp(0, l.shape[0] - 1)).long()
        delta ^= t.data.index_select(0, x.clamp(0, t.nrows - 1))
    act = _row_mask(m, startrow, stoprow)
    return BitMatrix(torch.where(act, data ^ delta, data), m.ncols)


def mzd_process_rows(m, startrow, stoprow, startcol, k, t, l):
    return _process_rows_n(m, startrow, stoprow, startcol, k, [t], [l])


def _make_process_rows(n):
    def f(m, startrow, stoprow, startcol, k, *tl):
        tables, lookups = tl[0::2], tl[1::2]
        assert len(tables) == n
        return _process_rows_n(m, startrow, stoprow, startcol, k,
                               tables, lookups)
    f.__name__ = f"mzd_process_rows{n}"
    return f


mzd_process_rows2 = _make_process_rows(2)
mzd_process_rows3 = _make_process_rows(3)
mzd_process_rows4 = _make_process_rows(4)
mzd_process_rows5 = _make_process_rows(5)
mzd_process_rows6 = _make_process_rows(6)

mzd_trtri_upper_russian = trtri_upper  # basecase engine name (triangular_russian.c:384)


def mzd_addmul_mp(c, a, b, cutoff=0):
    """OpenMP addmul analogue (mp.c:162): the mesh product + XOR."""
    return add(c, mzd_mul_mp(None, a, b))


# --- capped column permutations (mzp.c:262-292) --------------------------

def _apply_p_right_capped(m, v, start_row, start_col, trans):
    full = apply_p_right_trans(m, v) if trans else apply_p_right(m, v)
    data = torch.where(_row_mask(m, start_row), full.data, m.data)
    return BitMatrix(data, m.ncols)


def mzd_apply_p_right_even_capped(a, p, start_row, start_col):
    """Column permutation applied only to rows >= start_row; the swap
    entries must not move columns below start_col (the in-tree contract —
    ple.c uses it on the trailing block only)."""
    return _apply_p_right_capped(a, p, start_row, start_col, trans=False)


def mzd_apply_p_right_trans_even_capped(a, p, start_row, start_col):
    return _apply_p_right_capped(a, p, start_row, start_col, trans=True)


# --- mzp long tail --------------------------------------------------------

def mzp_copy(dst, src=None):
    p = src if src is not None else dst
    return p.clone()


def mzp_free(p):
    return None


def mzp_init_window(p, begin, end):
    """Window into a swap array (mzp.c:40): the values begin..end, as a
    copy."""
    return p[begin:end].clone()


mzp_init_mzp_t_window = mzp_init_window


def mzp_free_window(p):
    return None


mzp_free_mzp_t_window = mzp_free_window


def mzp_print(p):
    print("[ " + " ".join(str(int(x)) for x in _host(p)) + " ]")


# --- printing long tail ---------------------------------------------------

def mzd_fprint(f, a):
    f.write(io.to_text(a) + "\n")


def mzd_print_row(a, i):
    print(io.to_text(submatrix(a, i, 0, i + 1, a.ncols)))


# --- DJB builder API (djb.h) ---------------------------------------------

from .models.djb import SOURCE_INPUT as source_source  # noqa: E402,F401
from .models.djb import SOURCE_OUTPUT as source_target  # noqa: E402,F401
from .models.djb import DjbProgram as _DjbProgram  # noqa: E402


def djb_init(nrows, ncols):
    """Empty straight-line XOR program (djb.c)."""
    return _DjbProgram(nrows, ncols, [], [], [])


def djb_push_back(z, target, source, srctyp):
    z.target.append(int(target))
    z.source.append(int(source))
    z.srctyp.append(int(srctyp))
    return z


def djb_free(z):
    return None


def djb_info(z):
    full = z.nrows * z.ncols
    print(f"{z.length} xors in {z.nrows} rows (naive: {full}, "
          f"saving: {1.0 - z.length / max(full, 1):.2f})")


__all__ = [n for n in dir()
           if n.startswith(("mzd_", "mzp_", "m4ri_", "djb_", "source_"))]

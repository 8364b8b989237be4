"""The batched solver API: TRSM / TRTRI, echelon forms, inversion, linear
solves and kernels of many independent systems at once.

The JAX package gets these from ``jax.vmap`` of its entry points
(m4ri_tpu/models/triangular.py, echelon.py, solve.py), which write every
rank-dependent step as a mask or a drop-slot scatter.  The port's
single-matrix forms (models/triangular.py, echelon.py, solve.py) slice with
the rank as a Python int; the forms here take the JAX package's masks with a
leading batch axis instead, so a batch reads nothing back from the device
beyond ``block_factor_batched``'s one read-back a panel:

- stacks are packed int32 ``[B, rows, words]`` with zero padding bits, as
  ``block_factor_batched`` takes them; ranks, consistency flags, kernel
  counts and inverse ranks are int32 / bool ``[B]`` on the stack's device;
- every ``q[:r]``, ``data[r:]`` and ``n - r`` is a mask by ``k < r[b]`` or
  a scatter whose rows past the rank go to a dump row that is cut off;
- the TRSM / TRTRI recursion is the single one (models/triangular.py) on
  stacks, on the same static splits: each block product is one
  ``mul_packed_batched`` call (on the card the batched Schur kernel), and
  the base blocks of a stack are inverted by one launch of
  ``unit_tri_inv_hopper`` on their packed words;
- ``top_echelonize_batched`` runs the sweep with a search window, and the
  naive engines run models/echelon.py's column step with its batch axis:
  neither reads anything back.

Element ``i`` of every result equals, word for word, the port's
single-matrix call on element ``i``.
"""

from __future__ import annotations

import torch

from ..core.bitmatrix import (BitMatrix, identity, keep_below, padding_words,
                              shift_columns_left, shift_columns_right,
                              width_for)
from ..core.permutation import apply_p_left_batched
from ..core.transpose import transpose_words
from ..ops.mul import pack_bits
from ..utils import spans
from ..utils.config import WORD_BITS
from ..utils.graycode import opt_k
from .batched import _check_stack, _rows, block_factor_batched, \
    mul_packed_batched
from .echelon import naive_sweep
from .solve import _pad_words
from .triangular import (_clean_tri, _trsm_left_rec, _trsm_right_rec,
                         _trtri)

__all__ = [
    "trtri_upper_batched", "trtri_lower_batched", "trsm_upper_left_batched",
    "trsm_lower_left_batched", "trsm_upper_right_batched",
    "trsm_lower_right_batched", "echelonize_batched",
    "echelonize_with_pivots_batched", "invert_batched", "solve_left_batched",
    "pluq_solve_left_batched", "kernel_left_batched",
    "top_echelonize_batched", "echelonize_naive_batched",
    "gauss_delayed_batched", "invert_naive_batched",
]


def _check_width(name: str, t: torch.Tensor, ncols: int) -> None:
    _check_stack(name, t)
    if t.shape[2] != width_for(ncols):
        raise ValueError(f"{name} has {t.shape[2]} words a row, {ncols} "
                         f"columns want {width_for(ncols)}")


# ------------------------------------------------------------ TRSM / TRTRI
# models/triangular.py's recursion on stacks: it indexes the last two axes
# only, and every block product is one mul_packed_batched call.


def _mul(a: BitMatrix, b: BitMatrix) -> BitMatrix:
    return BitMatrix(mul_packed_batched(a.data, b.data), b.ncols)


def _tri_operand(t: torch.Tensor) -> int:
    _check_stack("t", t)
    n = t.shape[1]
    if t.shape[2] != width_for(n):
        raise ValueError(f"t {tuple(t.shape)}: want square elements "
                         "[B, n, width(n)]")
    return n


def _trsm(t: torch.Tensor, b: torch.Tensor, ncols: int, upper: bool,
          left: bool) -> torch.Tensor:
    n = _tri_operand(t)
    _check_width("b", b, ncols)
    if b.shape[0] != t.shape[0] or b.device != t.device:
        raise ValueError(f"t {tuple(t.shape)} on {t.device}, b "
                         f"{tuple(b.shape)} on {b.device}: want one batch")
    if (b.shape[1] if left else ncols) != n:
        raise ValueError(f"t is {n} x {n}, b {b.shape[1]} x {ncols}")
    t = _clean_tri(BitMatrix(t, n), upper)
    rec = _trsm_left_rec if left else _trsm_right_rec
    with spans.span("trsm"):
        return rec(t, BitMatrix(b, ncols), upper, _mul).data


def _trtri_batched(t: torch.Tensor, upper: bool) -> torch.Tensor:
    n = _tri_operand(t)
    with spans.span("trsm"):
        return _trtri(_clean_tri(BitMatrix(t, n), upper), upper, _mul).data


def trtri_upper_batched(t: torch.Tensor) -> torch.Tensor:
    """U^{-1} of every unit upper triangular element of ``[B, n, w(n)]``:
    element i is ``trtri_upper(BitMatrix(t[i], n))``."""
    return _trtri_batched(t, True)


def trtri_lower_batched(t: torch.Tensor) -> torch.Tensor:
    """L^{-1} of every unit lower triangular element (``trtri_lower``)."""
    return _trtri_batched(t, False)


def trsm_upper_left_batched(u: torch.Tensor, b: torch.Tensor,
                            ncols: int) -> torch.Tensor:
    """U X = B for every element: ``u`` [B, n, w(n)], ``b`` [B, n,
    w(ncols)] -> X [B, n, w(ncols)] (``trsm_upper_left``)."""
    return _trsm(u, b, ncols, True, True)


def trsm_lower_left_batched(l: torch.Tensor, b: torch.Tensor,
                            ncols: int) -> torch.Tensor:
    """L X = B for every element (``trsm_lower_left``)."""
    return _trsm(l, b, ncols, False, True)


def trsm_upper_right_batched(u: torch.Tensor, b: torch.Tensor,
                             ncols: int) -> torch.Tensor:
    """X U = B for every element: ``b`` [B, rows, w(n)], ``ncols`` = n
    (``trsm_upper_right``)."""
    return _trsm(u, b, ncols, True, False)


def trsm_lower_right_batched(l: torch.Tensor, b: torch.Tensor,
                             ncols: int) -> torch.Tensor:
    """X L = B for every element (``trsm_lower_right``)."""
    return _trsm(l, b, ncols, False, False)


# ------------------------------------------------------ echelon forms


def _pivot_rows(q: torch.Tensor, r: torch.Tensor, rmax: int) -> torch.Tensor:
    """int64 [B, rmax]: Q_b[k] for k < r[b], k beyond."""
    k = torch.arange(rmax, device=q.device)
    return torch.where(k < r[:, None], q[:, :rmax].long(), k)


def select_pivot_cols(data: torch.Tensor, q: torch.Tensor, r: torch.Tensor,
                      m: int, n: int, rmax: int) -> torch.Tensor:
    """out[b, :, k] = data[b, :, Q_b[k]] for k < r[b], data[b, :, k]
    beyond: the packed transpose-gather-transpose of every element."""
    dt = transpose_words(data[:, :, : width_for(n)], m, n)    # [B, n, w(m)]
    return transpose_words(_rows(dt, _pivot_rows(q, r, rmax)), rmax, m)


def _beyond_rank(r: torch.Tensor, rows: int) -> torch.Tensor:
    """int32 [B, rows, 1]: 1 on the rows k >= r[b]."""
    k = torch.arange(rows, device=r.device)
    return (k >= r[:, None]).to(torch.int32)[:, :, None]


@spans.spanned("rref")
def _rref_from_ref(data: torch.Tensor, q: torch.Tensor, r: torch.Tensor,
                   m: int, n: int) -> torch.Tensor:
    """Top rows of every element's REF -> RREF via U_rr^{-1} U, U_rr
    given a unit diagonal on the rows past the rank."""
    rmax = min(m, n)
    top = data[:, :rmax]
    urr = select_pivot_cols(top, q, r, rmax, n, rmax)
    eye = identity(rmax, device=data.device).data
    urr = urr | eye * _beyond_rank(r, rmax)
    out = trsm_upper_left_batched(urr, top, n)
    if m > rmax:
        out = torch.nn.functional.pad(out, (0, 0, 0, m - rmax))
    return out


@spans.spanned("rref")
def _pluq_echelon_post(data: torch.Tensor, q: torch.Tensor, r: torch.Tensor,
                       m: int, n: int, full: bool) -> torch.Tensor:
    """The single ``_pluq_echelon_post`` with the rank a mask: row i drops
    the pivot columns of the slots k < min(i, r[b]), an exclusive running
    sum of one-hot rows (distinct bits: the sum is their OR)."""
    rmax = min(m, n)
    B, dev = data.shape[0], data.device
    qk = q[:, :rmax].long()
    valid = torch.arange(rmax, device=dev) < r[:, None]
    onehot = torch.zeros((B, rmax, width_for(n)), dtype=torch.long,
                         device=dev)
    onehot.scatter_(2, (qk // WORD_BITS)[:, :, None],
                    torch.where(valid, 1 << (qk % WORD_BITS), 0)[:, :, None])
    clear = onehot.cumsum(dim=1) - onehot
    clear = torch.where(clear >= 2**31, clear - 2**32, clear).to(torch.int32)
    top = data[:, :rmax] & ~clear
    if m > rmax:
        top = torch.nn.functional.pad(top, (0, 0, 0, m - rmax))
    if full:
        top = _rref_from_ref(top, q, r, m, n)
    return top & padding_words(n, dev)


@spans.entry("echelonize_batched")
def echelonize_batched(data: torch.Tensor, ncols: int, full: bool = True,
                       nb: int | None = None, strategy: str = "m4ri"):
    """(R)REF of every element: ``(E [B, m, w], r int32 [B])``, element i
    ``echelonize(BitMatrix(data[i], ncols), full, nb, strategy)``.
    ``strategy``: "m4ri" or "pluq"; "heuristic" raises, since it chooses by
    the density read back to the host (``jax.vmap`` cannot trace that
    either)."""
    if strategy not in ("m4ri", "pluq"):
        raise ValueError(f"strategy={strategy!r}: a batch takes 'm4ri' or "
                         "'pluq' ('heuristic' reads the density back)")
    pluq = strategy == "pluq"
    d, _, q, r = block_factor_batched(data, ncols, pluq, nb=nb)
    m = d.shape[1]
    if pluq:
        return _pluq_echelon_post(d, q, r, m, ncols, full), r
    if full:
        d = _rref_from_ref(d, q, r, m, ncols)
    return d & padding_words(ncols, d.device), r


def top_echelonize_batched(data: torch.Tensor, ncols: int, k: int = 0,
                           nb: int | None = None):
    """RREF of every element by the restricted pivot search:
    ``(E [B, m, w], r int32 [B])``, element i ``top_echelonize(BitMatrix(
    data[i], ncols), k, nb)``.  ``k`` defaults as there; the sweep searches
    the next 6k rows below each element's rank and reads nothing back."""
    _check_width("data", data, ncols)
    if k <= 0:
        k = min(opt_k(data.shape[1], ncols), 7)
    d, _, q, r = block_factor_batched(data, ncols, False, nb=nb,
                                      search_window=6 * k)
    e = _rref_from_ref(d, q, r, data.shape[1], ncols)
    return e & padding_words(ncols, e.device), r


def echelonize_with_pivots_batched(data: torch.Tensor, ncols: int,
                                   nb: int | None = None):
    """RREF, Q and rank of every element (``echelonize_with_pivots``)."""
    d, _, q, r = block_factor_batched(data, ncols, False, nb=nb)
    m = data.shape[1]
    e = _rref_from_ref(d, q, r, m, ncols)
    return e & padding_words(ncols, e.device), q, r


def _shift_left(data: torch.Tensor, shift: int, ncols: int) -> torch.Tensor:
    """Columns [shift, shift + ncols) of every row, as their own matrix."""
    B, rows, w = data.shape
    out = shift_columns_left(data.reshape(B * rows, w), shift,
                             width_for(ncols))
    return (out.reshape(B, rows, width_for(ncols))
            & padding_words(ncols, data.device))


def invert_batched(data: torch.Tensor, nb: int | None = None):
    """A^{-1} of every element of ``[B, n, w(n)]`` via RREF of [A | I]:
    ``(inverse [B, n, w(n)], r_a int32 [B])``, element i ``invert`` of
    element i; the inverse is valid where r_a == n."""
    n = _tri_operand(data)
    B, dev = data.shape[0], data.device
    w2 = width_for(2 * n)
    aug = shift_columns_right(identity(n, device=dev).data, n, w2)
    aug = aug.expand(B, n, w2).clone()
    aug[:, :, : data.shape[2]] ^= data
    d, _, q, r = block_factor_batched(aug, 2 * n, False, nb=nb)
    rref = _rref_from_ref(d, q, r, n, 2 * n) & padding_words(2 * n, dev)
    # the rank of A: the pivots that fall in the left block
    k = torch.arange(n, device=dev)
    r_a = ((k < r[:, None]) & (q[:, :n] < n)).sum(dim=1, dtype=torch.int32)
    return _shift_left(rref, n, n), r_a


def echelonize_naive_batched(data: torch.Tensor, ncols: int,
                             full: bool = True, start_col: int = 0):
    """The naive Gauss engine on every element: ``(E [B, m, w], r int32
    [B])``, element i ``echelonize_naive(BitMatrix(data[i], ncols), full,
    start_col)``; nothing is read back."""
    _check_width("data", data, ncols)
    d, r = naive_sweep(data, data.shape[1], ncols, full, start_col)
    return d & padding_words(ncols, d.device), r


def gauss_delayed_batched(data: torch.Tensor, ncols: int, start_col: int = 0,
                          full: bool = False):
    """Gauss elimination from a column on every element
    (``gauss_delayed``)."""
    return echelonize_naive_batched(data, ncols, full=full,
                                    start_col=start_col)


def invert_naive_batched(data: torch.Tensor):
    """A^{-1} of every element of ``[B, n, w(n)]`` through the naive engine
    on [A | I]: ``(inverse [B, n, w(n)], ok bool [B])``, element i
    ``invert_naive`` of element i; ``ok[b]`` is true iff the left block
    reduced to the identity."""
    n = _tri_operand(data)
    B, dev = data.shape[0], data.device
    w2 = width_for(2 * n)
    eye = identity(n, device=dev).data
    aug = shift_columns_right(eye, n, w2).expand(B, n, w2).clone()
    aug[:, :, : data.shape[2]] ^= data
    red, _ = echelonize_naive_batched(aug, 2 * n, full=True)
    left = red[:, :, : data.shape[2]] & padding_words(n, dev)
    ok = (left == eye).flatten(1).all(dim=1)
    return _shift_left(red, n, n), ok


# ------------------------------------------------------ solve and kernel


@spans.spanned("solve")
def _solve_from_factors(data: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
                        r: torch.Tensor, b: torch.Tensor, bcols: int, m: int,
                        n: int, from_pivot_cols: bool):
    """The JAX package's ``_solve_from_factors`` over a batch: masks by
    ``k < r[b]``, and the solution rows scattered to their pivot columns
    with every slot past the rank sent to a dump row n, cut off (Q_b[k]
    for k >= r[b] can name another slot's pivot column)."""
    rmax = min(m, n)
    B, dev = data.shape[0], data.device
    kidx = torch.arange(rmax, device=dev)
    iidx = torch.arange(m, device=dev)
    if from_pivot_cols:
        # one selection feeds both L (rows masked below the slot diagonal)
        # and U_piv (its top rmax rows)
        sel = select_pivot_cols(data, q, r, m, n, rmax)
        lcols, upiv = sel, sel[:, :rmax]
    else:
        lcols = _pad_words(data, width_for(rmax))
        upiv = _pad_words(data[:, :rmax], width_for(rmax))
    lcols = lcols & keep_below(torch.minimum(iidx, r[:, None]),
                               lcols.shape[2])
    lfull = _pad_words(lcols, width_for(m)) | identity(m, device=dev).data
    y = trsm_lower_left_batched(lfull, apply_p_left_batched(b, p), bcols)
    consistent = ~(y * _beyond_rank(r, m)).flatten(1).any(dim=1)

    upiv = upiv | identity(rmax, device=dev).data * _beyond_rank(r, rmax)
    live = 1 - _beyond_rank(r, rmax)
    z = trsm_upper_left_batched(upiv, y[:, :rmax] * live, bcols) * live
    idx = torch.where(kidx < r[:, None], q[:, :rmax].long(), n)
    x = torch.zeros((B, n + 1, b.shape[2]), dtype=torch.int32, device=dev)
    x.scatter_(1, idx[:, :, None].expand(-1, -1, b.shape[2]), z)
    return x[:, :n] & padding_words(bcols, dev), consistent


@spans.entry("solve_left_batched")
def solve_left_batched(a: torch.Tensor, ncols: int, b: torch.Tensor,
                       bcols: int, nb: int | None = None):
    """A X = B for every element: ``a`` [B, m, w(ncols)], ``b`` [B, m,
    w(bcols)] -> ``(X [B, ncols, w(bcols)], consistent bool [B])``, element
    i ``solve_left`` of element i (free variables zero; X is meaningless
    where ``consistent`` is False)."""
    _check_width("b", b, bcols)
    if b.shape[:2] != a.shape[:2]:
        raise ValueError(f"a {tuple(a.shape)}, b {tuple(b.shape)}: want "
                         "one batch of the same rows")
    data, p, q, r = block_factor_batched(a, ncols, True, nb=nb)
    return _solve_from_factors(data, p, q, r, b, bcols, a.shape[1], ncols,
                               True)


def pluq_solve_left_batched(m: torch.Tensor, ncols: int, p: torch.Tensor,
                            q: torch.Tensor, r: torch.Tensor,
                            b: torch.Tensor, bcols: int):
    """A X = B for every element from its PLUQ factors (``pluq_batched``'s
    outputs; the ranks an int32 ``[B]``), element i ``pluq_solve_left`` of
    element i's factors."""
    _check_width("m", m, ncols)
    _check_width("b", b, bcols)
    return _solve_from_factors(m, p, q, r.to(torch.int32), b, bcols,
                               m.shape[1], ncols, False)


def kernel_left_batched(a: torch.Tensor, ncols: int, nb: int | None = None):
    """A basis of the right kernel of every element: ``(X [B, n, w(n)],
    count int32 [B])`` with count = n - r, element i ``kernel_left`` of
    element i."""
    ref, q, r = echelonize_with_pivots_batched(a, ncols, nb=nb)
    n = ncols
    rmax = min(a.shape[1], n)
    B, dev = a.shape[0], a.device
    w = width_for(n)
    # pivot rows go to row Q_b[k]; the slots past the rank to a dump row
    idx = torch.where(torch.arange(rmax, device=dev) < r[:, None],
                      q[:, :rmax].long(), n)
    ispivot = torch.zeros((B, n + 1), dtype=torch.bool, device=dev)
    ispivot = ispivot.scatter(1, idx, True)[:, :n]
    rows = ref[:, :rmax, :w] * (1 - _beyond_rank(r, rmax))
    x = torch.zeros((B, n + 1, w), dtype=torch.int32, device=dev)
    x = x.scatter(1, idx[:, :, None].expand(-1, -1, w), rows)[:, :n]
    # the free columns get a diagonal 1; the pivot columns are cleared
    free = (~ispivot).to(torch.int32)[:, :, None]
    x = x | identity(n, device=dev).data * free
    x = x & ~pack_bits(ispivot.to(torch.int32))[:, None]
    return x & padding_words(n, dev), n - r

"""The batched sweep's commit of a panel, on the card.

``panel_commit_hopper_batched(A, P, Q, vw, lamw, ALw, rpw, p_f, q_f, r_f,
r_in, miss, t, nb, m)`` writes panel ``t`` of every element of a batch
back, in place, after the pivot loop on its W-row window at ``r_in`` and
the elimination of the rows below it (``models/batched.py::_sweep``):

- ``A`` int32 ``[B, m_pad, w_pad]``, ``P`` ``[B, m_pad]``, ``Q`` ``[B,
  n_pad]``: the sweep's padded matrix and row and column records;
- ``vw``, ``lamw`` int32 ``[B, m_pad, nb/32]``: the elimination's panel
  words and multipliers (``panel_post_hopper_batched``: rows outside
  ``[r_in + W, m)`` pass through, v = X and lam = 0);
- ``ALw`` int32 ``[B, W, 2nb/32]``, ``rpw`` ``[B, W]``, ``p_f`` / ``q_f``
  ``[B, nb]``, ``r_f`` ``[B]``: the pivot loop's fused ``[panel | L]``
  window rows, its row permutation of the window, the pivot slots' rows
  (from the window's top) and columns (from the panel's first), and the
  rank after it;
- ``r_in`` int32 ``[B]``: the rank before; ``miss`` bool ``[B]``: the
  elements whose window missed a pivot.

For every element that did not miss, with r0 = r_in[b]: the window's rows
take, on every word outside the panel, the words of row r0 + rpw[b, i];
A's panel words of the rows in ``[r0, m)`` take ALw's at the window's rows
and vw's below it; lamw's window rows below m take ALw's L words; P[b, r0 +
s] = r0 + p_f[b, s] and Q[b, r0 + s] = t nb + q_f[b, s] for s < r_f[b] - r0,
and no other slot changes.  Rows above r0 keep their panel words (vw = X
there) and rows at or past m are zero padding that no step moves.  An
element that missed is left alone: the sweep redoes it at full height.

Replaces no TPU kernel: the JAX package commits with
``dynamic_update_slice``s in the graph of its sweep
(m4ri_tpu/models/ple.py, ``_block_factor_impl``); the port ran the commit as
about 18 PyTorch operations a panel (gathers and scatters through int64
``[B, W]`` indices, the copy of the panel words of all m_pad rows), which
``panel_commit_batched_plain`` keeps as the plain version.  The kernels
(csrc/gf2_post_hopper.cu) read each needed word once and write it once: what
bounds them on an H100 is bytes, about 1.0 GB (0.30 ms at 3.35 TB/s) at
976,000 x 32^2 and 0.63 GB (0.19 ms) on mceliece348864's first panel at
1024 keys.  ``commit_plan`` is the launch's shape, from the batch, the
window, the widths and the SM count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import spans
from ..utils.config import WORD_BITS

__all__ = ["panel_commit_hopper_batched", "panel_commit_batched_plain",
           "commit_plan"]

_WARP_WORDS = 1024       # the warp plan's largest element, m * nb/32 words
_SMEM_WORDS = 12 * 1024  # a block's staged chunk, W x cw words (48 KB)
_TILE_WORDS = 2048       # panel words a tile of rows below the window


def _check(A, P, Q, vw, lamw, ALw, rpw, p_f, q_f, r_f, r_in, miss, t, nb,
           m) -> None:
    if not isinstance(A, torch.Tensor) or A.dtype != torch.int32 \
            or A.dim() != 3:
        raise TypeError("A: want an int32 tensor [B, m_pad, w_pad]")
    B, m_pad, w_pad = A.shape
    W = rpw.shape[-1] if isinstance(rpw, torch.Tensor) else 0
    n_pad = Q.shape[-1] if isinstance(Q, torch.Tensor) else 0
    nbw = nb // WORD_BITS
    if nb <= 0 or nb % WORD_BITS or (t + 1) * nbw > w_pad:
        raise ValueError(f"nb = {nb}, t = {t}: want the panel's words inside "
                         f"{w_pad}")
    if not 0 <= m <= m_pad or W < nb:
        raise ValueError(f"m = {m}, W = {W}: want m <= {m_pad}, W >= nb")
    want = {"P": (P, (B, m_pad)), "Q": (Q, (B, n_pad)),
            "vw": (vw, (B, m_pad, nbw)), "lamw": (lamw, (B, m_pad, nbw)),
            "ALw": (ALw, (B, W, 2 * nbw)), "rpw": (rpw, (B, W)),
            "p_f": (p_f, (B, nb)), "q_f": (q_f, (B, nb)), "r_f": (r_f, (B,)),
            "r_in": (r_in, (B,)), "miss": (miss, (B,))}
    for name, (x, shape) in want.items():
        dtype = torch.bool if name == "miss" else torch.int32
        if not isinstance(x, torch.Tensor) or x.dtype != dtype:
            raise TypeError(f"{name}: want a {dtype} tensor")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} is {tuple(x.shape)}, want {shape}")
        if x.device != A.device:
            raise ValueError(f"{name} lies on {x.device}, A on {A.device}")
    if n_pad < (t + 1) * nb:
        raise ValueError(f"Q is {tuple(Q.shape)}: want [B, >= {(t + 1) * nb}]")
    for name, x in (("A", A), ("P", P), ("Q", Q), ("lamw", lamw)):
        if not x.is_contiguous():
            raise ValueError(f"{name}: written in place, want it contiguous")


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, i]] for every b, i: rows gathered a batch at a time."""
    return x.gather(1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def _put_rows(x: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> None:
    """x[b, idx[b, i]] = rows[b, i], in place (idx distinct within b)."""
    x.scatter_(1, idx[:, :, None].expand(-1, -1, x.shape[2]), rows)


def panel_commit_batched_plain(A, P, Q, vw, lamw, ALw, rpw, p_f, q_f, r_f,
                               r_in, miss, t: int, nb: int, m: int) -> None:
    """The commit in plain PyTorch, in place; see the module text for the
    contract.  Gathers and scatters of the window's rows through an int64
    ``[B, W]`` index, masked by ``miss`` and by the rows in ``[r_in, m)``."""
    W = rpw.shape[1]
    nbw = nb // WORD_BITS
    c0w = t * nbw
    dev = A.device
    hit = ~miss
    wv = torch.arange(W, dtype=torch.int32, device=dev)
    win = (r_in[:, None] + wv[None, :]).long()              # [B, W] rows
    rows = torch.arange(A.shape[1], dtype=torch.int32, device=dev)
    live = (rows[None, :] >= r_in[:, None]) & (rows[None, :] < m) \
        & hit[:, None]
    in_win = ((win < m) & hit[:, None])[..., None]
    # the panel words as A will hold them: v on the rows in [r_in, m), the
    # window's rows from ALw, A's own elsewhere (taken before the rows move)
    panel = torch.where(live[..., None], vw, A[:, :, c0w : c0w + nbw])
    _put_rows(panel, win, torch.where(in_win, ALw[:, :, :nbw],
                                      _rows(panel, win)))
    _put_rows(lamw, win, torch.where(in_win, ALw[:, :, nbw:],
                                     _rows(lamw, win)))
    rp = torch.where(miss[:, None], wv[None, :], rpw).long()
    _put_rows(A, win, _rows(_rows(A, win), rp))
    A[:, :, c0w : c0w + nbw] = panel
    slotv = torch.arange(nb, dtype=torch.int32, device=dev)
    keep = (slotv[None, :] < (r_f - r_in)[:, None]) & hit[:, None]
    sl = win[:, :nb]
    P.scatter_(1, sl, torch.where(keep, r_in[:, None] + p_f, P.gather(1, sl)))
    Q.scatter_(1, sl, torch.where(keep, t * nb + q_f, Q.gather(1, sl)))


def commit_plan(batch: int, W: int, nbw: int, w_pad: int, m: int,
                sms: int) -> tuple:
    """The launch's shape for ``batch`` elements of a W-row window, nbw
    panel words of w_pad and m real rows, on a card of ``sms`` SMs:
    ``("warp",)`` where no word lies outside the panel and an element is
    small (a warp an element), else ``("block", cw, rows)``: a block an
    (element, cw words of the window's rows), the chunk staged in shared
    memory, and a block an (element, tile of ``rows`` rows below the
    window), the tiles cut smaller while the grid would not fill the
    card four times over."""
    if w_pad == nbw and m * nbw <= _WARP_WORDS:
        return ("warp",)
    cw = 8
    while cw > 1 and W * cw > _SMEM_WORDS:
        cw //= 2
    rows = max(1, _TILE_WORDS // nbw)
    chunks = -(-w_pad // cw)
    while rows > 32 and batch * (chunks + -(-max(m - W, 0) // rows)) \
            < 4 * sms:
        rows //= 2
    return ("block", cw, rows)


_VOID, _LONG, _INT = ctypes.c_void_p, ctypes.c_long, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fn():
    from ._build import load
    f = load("gf2_post_hopper").gf2_panel_commit_batched_launch
    f.argtypes = [_VOID] * 12 + [_LONG] + [_INT] * 10 + [_VOID]
    f.restype = _INT
    return f


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def panel_commit_hopper_batched(A, P, Q, vw, lamw, ALw, rpw, p_f, q_f, r_f,
                                r_in, miss, t: int, nb: int, m: int) -> None:
    """Commit panel ``t`` of every element, in place; see the module text
    for the contract.  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise.  Nothing is read back."""
    _check(A, P, Q, vw, lamw, ALw, rpw, p_f, q_f, r_f, r_in, miss, t, nb, m)
    B, m_pad, w_pad = A.shape
    W = rpw.shape[1]
    nbw = nb // WORD_BITS
    plan = commit_plan(B, W, nbw, w_pad, m,
                       _sms(A.get_device()) if A.is_cuda else 0)
    with spans.span("kernel.panel_commit_hopper_batched", batch=B, W=W,
                    w_pad=w_pad, plan=plan[0]):
        if not A.is_cuda:
            return panel_commit_batched_plain(A, P, Q, vw, lamw, ALw, rpw,
                                              p_f, q_f, r_f, r_in, miss, t,
                                              nb, m)
        if B:
            _launch(A, P, Q, vw, lamw, ALw, rpw, p_f, q_f, r_f, r_in, miss,
                    t, m, plan)
    return None


def _launch(A, P, Q, vw, lamw, ALw, rpw, p_f, q_f, r_f, r_in, miss, t, m,
            plan):
    """Launch the kernel (checked by the caller)."""
    device = A.get_device()
    if torch.cuda.current_device() != device:
        with torch.cuda.device(device):
            return _launch(A, P, Q, vw, lamw, ALw, rpw, p_f, q_f, r_f, r_in,
                           miss, t, m, plan)
    B, m_pad, w_pad = A.shape
    W, nbw = rpw.shape[1], vw.shape[2]
    kind, cw, rows = plan if plan[0] == "block" else (plan[0], 0, 0)
    ins = [x.contiguous() for x in (ALw, rpw, p_f, q_f, r_f, r_in, miss)]
    err = _fn()(A.data_ptr(), P.data_ptr(), Q.data_ptr(),
                vw.contiguous().data_ptr(), lamw.data_ptr(),
                *(x.data_ptr() for x in ins), B, m_pad, w_pad, Q.shape[1], W,
                nbw, t, m, int(kind == "block"), cw, rows,
                torch._C._cuda_getCurrentRawStream(device))
    spans.count("launch.panel_commit_hopper_batched")
    spans.count(f"launch.panel_commit_hopper_batched.{kind}")
    if err:
        raise RuntimeError(f"panel_commit_hopper_batched: CUDA error {err} at "
                           f"launch (B={B}, W={W}, w_pad={w_pad}, "
                           f"plan={kind})")
    return None

"""The below-window elimination's small operands, on the card.

``post_operands_hopper(Pw, rank, r0, q, qoff, col0, n, preserve_l,
miss_check)`` makes, from a window's pivot-slot rows, what the elimination
of the rows below the window (``ops/hopper_post.py``) multiplies by, for one
window or a batch of them (a leading batch axis passes through):

- ``Pw`` int32 ``[..., nb, 2nb/32]``: the fused rows ``[panel | L]`` at the
  pivot slots, words of a row adjacent;
- ``rank`` int32 (0-dim, or ``[B]``) and ``r0`` (an int, or int32 ``[B]``):
  the rank after and before the window's pivot loop, so slot s holds a
  pivot iff ``s < rank - r0``;
- ``q`` int32 ``[..., nb]`` and ``qoff``: slot s's pivot column in the panel
  is ``q[s] - qoff`` (0 <= it < nb, distinct over the pivot slots; anything
  in the other slots);
- ``col0``, ``n``: the panel's first column and the matrix's width.

Returns int8 (m_small = E^T T ``[..., nb, nb]``, wmat ``[..., nb, nb]``,
colmask bits ``[..., nb]``): E the one-hot pivot-column rows, U the pivot
rows' panel words (with ``preserve_l`` their L multipliers at the earlier
pivot columns cleared), T the inverse of U restricted to its pivot columns,
wmat U (plus E with ``preserve_l``), the column mask the valid columns
(``col0 + c < n``) that hold no pivot, or none without ``miss_check``.

Replaces no TPU kernel: the JAX package builds these operands in the graph
of its sweep (m4ri_tpu/models/ple.py:255-293, in ``_block_factor_impl``),
products by the one-hot E and the nilpotent series; the port ran them as a
chain of about 45 PyTorch operations a panel (byte unpacks, gathers,
scatters, a pack, masks and the inverse), which ``post_operands_plain``
keeps as the plain version.  The
kernels (csrc/gf2_trinv_hopper.cu) work on packed words and write each
output once.  What bounds them on an H100 is bytes: the slot rows read once
(B nb^2/4 bytes) and the outputs written once (2 B nb^2 + B nb), 2.28 GB
at 976,000 x 32 (0.68 ms at 3.35 TB/s) and 0.60 GB at 1024 x 512 (0.18 ms);
at a batch of one the three launches' latency and the inverse's chain.
``operands_plan`` is the launch's shape, from (B, nb) and the SM count: a
warp an element at nb = 32 (one launch: the inverse in the same warp), else
a block an (element, 32-slot block) pass that writes U_piv packed and wmat,
the unit-triangular inverse's own kernel on U_piv, and a pass of the same
grid that writes m_small.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import spans
from ..utils.config import WORD_BITS
from .hopper_trinv import _sms, trinv_plan, unit_tri_inv_plain
from .mul import pack_bits, unpack_bits

__all__ = ["post_operands_hopper", "post_operands_plain", "operands_plan"]

_MAX_WORDS = 32          # nb <= 1024
_MAX_GRID_X = 2**31 - 1


def _check(Pw, rank, r0, q) -> None:
    if not isinstance(Pw, torch.Tensor) or Pw.dtype != torch.int32 \
            or Pw.dim() not in (2, 3):
        raise TypeError("Pw: want an int32 tensor [nb, 2nb/32] or "
                        "[B, nb, 2nb/32]")
    nb, w2 = Pw.shape[-2:]
    if nb == 0 or nb % WORD_BITS or w2 != 2 * (nb // WORD_BITS):
        raise ValueError(f"Pw is {tuple(Pw.shape)}: want nb rows, nb a "
                         f"multiple of {WORD_BITS}, of 2nb/32 words")
    if nb // WORD_BITS > _MAX_WORDS:
        raise ValueError(f"nb = {nb}: the kernel takes nb <= "
                         f"{_MAX_WORDS * WORD_BITS}")
    lead = tuple(Pw.shape[:-2])
    for name, t, shape in (("rank", rank, lead), ("q", q, (*lead, nb))):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"{name}: want an int32 tensor")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, want {shape}")
    if isinstance(r0, torch.Tensor):
        if r0.dtype != torch.int32 or tuple(r0.shape) != lead:
            raise TypeError(f"r0: want an int or an int32 tensor of shape "
                            f"{lead}")
    elif not isinstance(r0, int):
        raise TypeError("r0: want an int or an int32 tensor")
    for name, t in (("rank", rank), ("q", q), ("r0", r0)):
        if isinstance(t, torch.Tensor) and t.device != Pw.device:
            raise ValueError(f"{name} lies on {t.device}, Pw on {Pw.device}")


def post_operands_plain(Pw: torch.Tensor, rank: torch.Tensor, r0, q,
                        qoff: int, col0: int, n: int, preserve_l: bool,
                        miss_check: bool = True):
    """The operands in plain PyTorch; see the module text for the contract.

    Every product by E is a selection: U E^T takes U's columns at the pivot
    columns, E^T T puts T's rows at them, L E puts L's columns there; so
    they are gathers on 0/1 bytes, and T is the plain unit-triangular
    inverse on packed words."""
    single = Pw.dim() == 2
    if single:
        Pw, q = Pw[None], q[None]
    B, nb = Pw.shape[:2]
    nbw = nb // WORD_BITS
    slotv = torch.arange(nb, dtype=torch.int32, device=Pw.device)
    live = slotv < (rank - r0).reshape(-1, 1)
    live8 = live.to(torch.int8)
    # pivot column of each slot (0 where it holds none: masked below); inv[c]
    # the slot whose pivot column is c, else nb
    cloc = torch.where(live, q - qoff, 0).long()
    inv = torch.full((B, nb + 1), nb, dtype=torch.int64, device=Pw.device)
    inv.scatter_(1, torch.where(live, cloc, nb), slotv.long().expand(B, -1))
    inv = inv[:, :nb]
    nopiv = inv == nb                        # columns that hold no pivot
    # the masks by slot and by column act on the packed words, a word for
    # 32 bytes of the unpacked operands
    u_words = torch.where(live[..., None], Pw[..., :nbw], 0)
    if preserve_l:
        # the in-place pivot rows carry their own L multipliers at the
        # *earlier* pivot columns; clear them (L E: L's columns moved to the
        # pivot columns) to get the clean U rows
        le = unpack_bits(Pw[..., nbw:], torch.int8).gather(
            2, inv.clamp(max=nb - 1)[:, None, :].expand(-1, nb, -1))
        pivots = pack_bits((~nopiv).to(torch.int8))[:, None, :]
        u_words = torch.where(live[..., None],
                              u_words ^ (pack_bits(le) & pivots), 0)
        del le
    u_clean = unpack_bits(u_words, torch.int8)
    # U restricted to its pivot columns, in slot space (U E^T): unit upper
    # triangular (the inverse reads its strict upper triangle only); T its
    # inverse
    upiv = u_clean.gather(2, cloc[:, None, :].expand(-1, nb, -1))
    T = unit_tri_inv_plain(pack_bits(upiv) & pack_bits(live8)[:, None, :],
                           True)
    del upiv
    # multipliers for every row below the window: lambda = X (E^T T), the
    # row of E^T T at pivot column c T's row inv[c], zero elsewhere;
    # eliminated panel values v = X ^ lambda wmat (preserve_l re-places
    # lambda at the pivot columns, the reference's in-place L layout)
    tz = torch.nn.functional.pad(T, (0, 0, 0, 1))
    m_small = unpack_bits(tz.gather(1, inv[:, :, None].expand(-1, -1, nbw)),
                          torch.int8)
    wmat = u_clean
    if preserve_l:                           # u_clean ^ E, in place
        at = cloc[..., None]
        wmat.scatter_(2, at, wmat.gather(2, at) ^ live8[..., None])
    validcol = (col0 + slotv) < n
    cmb = (nopiv & validcol) if miss_check else torch.zeros_like(live)
    out = (m_small, wmat, cmb.to(torch.int8))
    return tuple(x[0] for x in out) if single else out


def operands_plan(batch: int, nb: int, sms: int) -> tuple:
    """The launches' shape for ``batch`` elements of nb slots on a card of
    ``sms`` SMs: ``("warp",)`` at nb = 32 (a warp an element, eight a block,
    fixed in the kernel), else ``("block", strips an element, words a strip,
    threads a block)`` with the inverse's own plan (``trinv_plan``)."""
    if nb <= WORD_BITS:
        return ("warp",)
    return ("block", *trinv_plan(batch, nb, sms))


_VOID, _LONG, _INT = ctypes.c_void_p, ctypes.c_long, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fn():
    from ._build import load
    f = load("gf2_trinv_hopper").gf2_post_operands_launch
    f.argtypes = ([_VOID, _LONG, _LONG, _VOID, _LONG, _VOID, _LONG, _INT,
                   _VOID, _LONG, _INT] + [_VOID] * 4 + [_INT] * 8 + [_VOID])
    f.restype = _INT
    return f


def post_operands_hopper(Pw: torch.Tensor, rank: torch.Tensor, r0, q,
                         qoff: int, col0: int, n: int, preserve_l: bool,
                         miss_check: bool = True):
    """The operands of every element; see the module text for the
    contract.  ``Pw`` may be a view with any row and batch stride whose
    words of a row are adjacent.  CPU tensors take the plain version; CUDA
    tensors launch the kernels or raise."""
    _check(Pw, rank, r0, q)
    batch = Pw.shape[0] if Pw.dim() == 3 else 1
    nb = Pw.shape[-2]
    with spans.span("kernel.post_operands_hopper", batch=batch, nb=nb,
                    preserve_l=int(bool(preserve_l))):
        if not Pw.is_cuda:
            return post_operands_plain(Pw, rank, r0, q, qoff, col0, n,
                                       preserve_l, miss_check)
        return _launch(Pw, rank, r0, q, qoff, col0, n, preserve_l,
                       miss_check, batch)


def _launch(Pw, rank, r0, q, qoff, col0, n, preserve_l, miss_check, batch):
    """Launch the kernels (checked by the caller)."""
    device = Pw.get_device()
    if torch.cuda.current_device() != device:
        with torch.cuda.device(device):
            return _launch(Pw, rank, r0, q, qoff, col0, n, preserve_l,
                           miss_check, batch)
    lead = tuple(Pw.shape[:-2])
    nb = Pw.shape[-2]
    nbw = nb // WORD_BITS
    dev = Pw.device
    # the three outputs in one buffer, each 16-byte aligned (nb^2 bytes an
    # element)
    out = torch.empty(batch * (2 * nb * nb + nb), dtype=torch.int8,
                      device=dev)
    sq = batch * nb * nb
    m_small = out[:sq].view(*lead, nb, nb)
    wmat = out[sq:2 * sq].view(*lead, nb, nb)
    cmb = out[2 * sq:].view(*lead, nb)
    if batch == 0:
        return m_small, wmat, cmb
    if Pw.stride(-1) != 1:
        Pw = Pw.contiguous()
    if q.stride(-1) != 1:
        q = q.contiguous()
    kind, *shape = operands_plan(batch, nb, _sms(device))
    strips, sw, threads = shape or (1, 0, 0)     # the warp plan reads none
    if batch * max(nbw, strips) > _MAX_GRID_X:
        raise ValueError(f"{batch} elements exceed the launch grid")
    scratch = None
    if kind == "block":      # U_piv and T packed, the slot of each column
        scratch = torch.empty(batch * nb * (2 * nbw + 1), dtype=torch.int32,
                              device=dev)
    batched = Pw.dim() == 3
    if isinstance(r0, torch.Tensor):
        r0p, br0, r0c = r0.data_ptr(), r0.stride(0) if batched else 0, 0
    else:
        r0p, br0, r0c = None, 0, r0
    err = _fn()(Pw.data_ptr(), Pw.stride(-2), Pw.stride(0) if batched else 0,
                rank.data_ptr(), rank.stride(0) if batched else 0,
                r0p, br0, r0c,
                q.data_ptr(), q.stride(0) if batched else 0, qoff,
                out.data_ptr(), out.data_ptr() + sq, out.data_ptr() + 2 * sq,
                None if scratch is None else scratch.data_ptr(),
                batch, nbw, col0, n, int(bool(preserve_l)),
                int(bool(miss_check)), sw, threads,
                torch._C._cuda_getCurrentRawStream(device))
    spans.count("launch.post_operands_hopper")
    spans.count(f"launch.post_operands_hopper.{kind}")
    if err:
        raise RuntimeError(f"post_operands_hopper: CUDA error {err} at launch "
                           f"(B={batch}, nb={nb}, plan={kind})")
    return m_small, wmat, cmb

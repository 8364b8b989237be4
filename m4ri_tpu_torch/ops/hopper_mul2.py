"""gf2_mul_hopper_v2: packed GF(2) product for deep contractions.

Replaces the TPU kernel ``gf2_mul_pallas_v2`` (m4ri_tpu/ops/pallas_mul2.py,
``_mul2_padded``).  Same contract as ``gf2_mul_hopper``; in addition
``accumulate=True`` gives ``out ^= A*B``, which is ``addmul``'s update with
no temporary.

It launches the same kernel as ``gf2_mul_hopper`` (csrc/gf2_gemm_hopper.cu,
see ops/hopper_mul.py): the contraction stays inside the block and C is
written once, or read and written once with ``accumulate``, by the one
block that owns its tile.  What this entry adds is the split of the
contraction across blocks (``gemm_plan``), taken only where the tiles of C
do not fill the card and the contraction is more than one stage deep: the
one case a split buys blocks in flight.  Split, C is zeroed on the stream
(not with ``accumulate``) and each run XORs its words in with atomics; XOR
commutes, so the result is exact in any order.  The TPU kernel instead has
its first chunk write C and the later ones read-modify-write it, which holds
only because its grid runs in order.

What bounds it on an H100: operations (see ops/hopper_mul.py).
"""

from __future__ import annotations

import torch

from ..utils import spans
from .hopper_mul import check_operands, gf2_mul_plain, launch_gemm

__all__ = ["gf2_mul_hopper_v2"]


def gf2_mul_hopper_v2(a: torch.Tensor, b: torch.Tensor,
                      out: torch.Tensor | None = None,
                      accumulate: bool = False) -> torch.Tensor:
    """Packed GF(2) product C = A*B, or ``out ^= A*B`` with ``accumulate``.
    ``out`` may be a strided view and is updated in place; it must not
    overlap a or b.  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    shape = check_operands(a, b, out)
    if accumulate and out is None:
        raise ValueError("accumulate=True needs the matrix to accumulate into")
    m, _, k, nw = shape
    with spans.span("kernel.gf2_mul_hopper_v2", m=m, k=k, nw=nw,
                    accumulate=int(accumulate)):
        if not a.is_cuda:
            res = gf2_mul_plain(a, b)
            if out is None:
                return res
            return out.bitwise_xor_(res) if accumulate else out.copy_(res)
        if out is None:
            out = torch.empty((m, nw), dtype=torch.int32, device=a.device)
        if m == 0 or nw == 0:
            return out
        if k == 0:
            return out if accumulate else out.zero_()
        launch_gemm(a, b, out, shape, accumulate, True)
        spans.count("launch.gf2_mul_hopper_v2")
        return out

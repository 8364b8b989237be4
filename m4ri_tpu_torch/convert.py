"""State carried across from the JAX package.

A JAX ``BitMatrix`` holds ``data: uint32[nrows, width]``; fetched with
``np.asarray`` it arrives here as numpy.  The port stores the same bits as
int32 (``.view(np.int32)``), in the same layout: column ``c`` at bit
``c % 32`` of word ``c // 32``, padding bits zero.  Factors of ``ple`` /
``pluq`` cross as (M, P, Q, r): the body as such words, the swap arrays as
int32 (numpy on the JAX side, tensors here) and the rank as an int.  Nothing
of JAX is imported: the caller hands over numpy, and gets numpy back.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.bitmatrix import BitMatrix, _words, resolve_device, width_for

__all__ = ["from_reference", "to_reference", "factors_from_reference",
           "factors_to_reference"]


def from_reference(data_u32: np.ndarray, ncols: int, device=None) -> BitMatrix:
    """uint32[nrows, width] words of the JAX package -> BitMatrix, bit for
    bit (the padding bits are taken as they come: zero by its invariant)."""
    data_u32 = np.asarray(data_u32)
    assert data_u32.dtype == np.uint32 and data_u32.ndim == 2, data_u32.dtype
    assert data_u32.shape[1] == width_for(ncols)
    return BitMatrix(_words(data_u32, device), ncols)


def to_reference(m: BitMatrix) -> tuple[np.ndarray, int]:
    """BitMatrix -> (uint32[nrows, width], ncols) for the JAX package."""
    data = np.ascontiguousarray(m.data.detach().cpu().numpy())
    return data.view(np.uint32), m.ncols


def factors_from_reference(m_u32: np.ndarray, ncols: int, p, q, r,
                           device=None):
    """The JAX package's (M, P, Q, r) of ``ple`` / ``pluq``, fetched as
    numpy -> the port's (BitMatrix, int32 P, int32 Q, int r)."""
    dev = resolve_device(device)
    swaps = [torch.tensor(np.asarray(v, dtype=np.int32), device=dev)
             for v in (p, q)]
    return (from_reference(m_u32, ncols, dev), *swaps, int(r))


def factors_to_reference(m: BitMatrix, p: torch.Tensor, q: torch.Tensor, r):
    """The port's (M, P, Q, r) -> (uint32 words, ncols, int32 P, int32 Q,
    int r) as numpy, for the JAX package."""
    words, ncols = to_reference(m)
    return (words, ncols, p.detach().cpu().numpy().astype(np.int32),
            q.detach().cpu().numpy().astype(np.int32), int(r))

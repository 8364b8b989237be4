"""m4ri_tpu_torch — the PyTorch/CUDA port of m4ri_tpu, for one NVIDIA H100.

Dense linear algebra over GF(2) with the capabilities of M4RI: bit-packed
matrices as int32 word tensors in device memory, GF(2) products on the
tensor cores through hand-written kernels that work on the packed words
(1-bit AND/popcount MMA, parity, pack), with Strassen-Winograd on top, and a
blocked PLE factorization whose pivot loop, below-window elimination and
Schur updates are hand-written kernels too.

This package imports torch and numpy only.  Matrices are created on the
card unless the caller passes ``device="cpu"``.  The CUDA kernels are
compiled from ``csrc/`` at first use, never at import.

Ported so far: the container, transpose, the multiply path (``mul`` /
``addmul`` / squaring / ``mul_naive`` / Strassen) and the factorization path
(``block_factor`` / ``ple`` / ``rank``).
"""

from .core.bitmatrix import (  # noqa: F401
    BitMatrix, zeros, identity, from_numpy, to_numpy, from_packed,
    randomize, randomize_reference, add, equal, is_zero, read_bit,
    write_bit, submatrix, stack, concat, row_swap, col_swap, density,
)
from .convert import from_reference, to_reference  # noqa: F401
from .core.transpose import transpose as _transpose
from .models.echelon import rank  # noqa: F401
from .models.ple import block_factor, ple as _ple  # noqa: F401
from .ops.mul import mul as _mul, addmul as _addmul, mul_naive as _mul_naive
from .utils.hashing import instrument as _dd_instrument

# the public matrix-producing surface is dd-instrumented: with
# utils.hashing.debug_dump(True) every call logs `name: hash`, the
# reference's engine-diffing stream (__M4RI_DD_MZD, debug_dump.h:29-61)
transpose = _dd_instrument("mzd_transpose", _transpose)
mul = _dd_instrument("mzd_mul", _mul)
addmul = _dd_instrument("mzd_addmul", _addmul)
mul_naive = _dd_instrument("mzd_mul_naive", _mul_naive)
ple = _dd_instrument("mzd_ple", _ple)

__version__ = "0.1.0"

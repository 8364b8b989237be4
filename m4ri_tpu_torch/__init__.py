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

Ported so far: the container, transpose, the bit-field helpers, the
multiply path (``mul`` / ``addmul`` / squaring / ``mul_naive`` / Strassen),
the factorization path (``block_factor`` / ``ple`` / ``pluq`` / ``rank``),
permutations, TRSM / TRTRI, the echelon forms and inversion,
``solve_left`` / ``pluq_solve_left`` / ``kernel_left``, the Gray-table
product (``mul_m4rm`` / ``addmul_m4rm``), DJB linear maps (``djb_compile`` /
``djb_apply``), matrix I/O (``utils/io.py``), the native C++ oracle
(``native/``), the reference C API by name (``compat``) and the
multi-device layer (``parallel/``: SUMMA and k-split products, row-sharded
PLE / rank / echelon, distributed TRSM / solve / invert / kernel on
``torch.distributed``, with its dry runs in ``dryrun.py``) and batching
(``mul_packed_batched`` / ``block_factor_batched`` / ``rank_batched``,
``ple_batched`` / ``pluq_batched`` and the batched solver API of
``models/batched_solve.py``: TRSM / TRTRI, echelon forms,
``top_echelonize``, ``invert``, the naive engines, ``solve_left`` /
``pluq_solve_left`` / ``kernel_left``; what the JAX package gets from
``jax.vmap``).  Like the JAX package, the top
level does not export ``parallel``.
"""

from .core.bitmatrix import (  # noqa: F401
    BitMatrix, zeros, identity, from_numpy, to_numpy, from_packed,
    randomize, randomize_reference, add, equal, is_zero, read_bit,
    write_bit, submatrix, stack, concat, row_swap, col_swap, density,
)
from .convert import (  # noqa: F401
    factors_from_reference, factors_to_reference, from_reference,
    to_reference,
)
from .core.bitops import (  # noqa: F401
    and_bits, clear_bits, extract_l, extract_u, find_pivot, read_bits,
    row_add, row_add_offset, set_ui, xor_bits,
)
from .core.transpose import transpose as _transpose
from .models import echelon as _echelon, ple as _ple_mod, solve as _solve
from .models import triangular as _triangular
from .models.echelon import rank  # noqa: F401
from .models.batched import (  # noqa: F401
    block_factor_batched, mul_packed_batched, ple_batched, pluq_batched,
    rank_batched,
)
from .models.batched_solve import (  # noqa: F401
    echelonize_batched, echelonize_naive_batched,
    echelonize_with_pivots_batched, gauss_delayed_batched, invert_batched,
    invert_naive_batched, kernel_left_batched, pluq_solve_left_batched,
    solve_left_batched, top_echelonize_batched, trsm_lower_left_batched,
    trsm_lower_right_batched, trsm_upper_left_batched,
    trsm_upper_right_batched, trtri_lower_batched, trtri_upper_batched,
)
from .models.djb import djb_apply, djb_compile  # noqa: F401
from .models.ple import block_factor  # noqa: F401
from .ops import m4rm as _m4rm
from .ops.mul import mul as _mul, addmul as _addmul, mul_naive as _mul_naive
from .utils.hashing import instrument as _dd_instrument

# the public matrix-producing surface is dd-instrumented: with
# utils.hashing.debug_dump(True) every call logs `name: hash`, the
# reference's engine-diffing stream (__M4RI_DD_MZD, debug_dump.h:29-61)
transpose = _dd_instrument("mzd_transpose", _transpose)
mul = _dd_instrument("mzd_mul", _mul)
addmul = _dd_instrument("mzd_addmul", _addmul)
mul_naive = _dd_instrument("mzd_mul_naive", _mul_naive)

# the factorizations and solvers under the JAX package's dd names
ple = _dd_instrument("mzd_ple", _ple_mod.ple)
pluq = _dd_instrument("mzd_pluq", _ple_mod.pluq)
echelonize = _dd_instrument("mzd_echelonize", _echelon.echelonize)
echelonize_pluq = _dd_instrument("mzd_echelonize_pluq",
                                 _echelon.echelonize_pluq)
top_echelonize = _dd_instrument("mzd_top_echelonize_m4ri",
                                _echelon.top_echelonize)
invert = _dd_instrument("mzd_inv_m4ri", _echelon.invert)
invert_naive = _dd_instrument("mzd_invert_naive", _echelon.invert_naive)
echelonize_naive = _dd_instrument("mzd_echelonize_naive",
                                  _echelon.echelonize_naive)
gauss_delayed = _dd_instrument("mzd_gauss_delayed", _echelon.gauss_delayed)
trsm_lower_left = _dd_instrument("mzd_trsm_lower_left",
                                 _triangular.trsm_lower_left)
trsm_upper_left = _dd_instrument("mzd_trsm_upper_left",
                                 _triangular.trsm_upper_left)
trsm_lower_right = _dd_instrument("mzd_trsm_lower_right",
                                  _triangular.trsm_lower_right)
trsm_upper_right = _dd_instrument("mzd_trsm_upper_right",
                                  _triangular.trsm_upper_right)
trtri_upper = _dd_instrument("mzd_trtri_upper", _triangular.trtri_upper)
trtri_lower = _dd_instrument("mzd_trtri_lower", _triangular.trtri_lower)
solve_left = _dd_instrument("mzd_solve_left", _solve.solve_left)
kernel_left = _dd_instrument("mzd_kernel_left_pluq", _solve.kernel_left)
pluq_solve_left = _dd_instrument("mzd_pluq_solve_left", _solve.pluq_solve_left)
mul_m4rm = _dd_instrument("mzd_mul_m4rm", _m4rm.mul_m4rm)
addmul_m4rm = _dd_instrument("mzd_addmul_m4rm", _m4rm.addmul_m4rm)

__version__ = "0.1.0"

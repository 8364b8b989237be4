"""Hardware-derived tuning configuration of the PyTorch/CUDA port.

The reference library derives every algorithmic cutoff from CPU cache sizes
detected at configure time (reference: configure.ac:198-219, misc.h:569-599,
strassen.h:133-135).  Here ``get_config()`` inspects ``torch.cuda`` once and
derives the constants the multiply and factorization paths read: block sizes
bounding the unpacked float32 intermediates of the blocked ``torch.matmul``
path, the Strassen crossover, the gates that route a product to the
hand-written Hopper kernels, and the panel widths of the PLE sweep.  The
fields are constants derived from the device; nothing a user sets at run
time reaches them.  Whether a kernel runs at all is decided by where its tensor
lives (``is_cuda``), not by a field.

All sizes are in *bits* (matrix dimensions) unless noted.
"""

from __future__ import annotations

import dataclasses
import functools

WORD_BITS = 32  # words are int32 tensors; the reference uses 64 (misc.h:87).


@dataclasses.dataclass(frozen=True)
class Config:
    # NOTE: every gate and cutoff below starts at the value the JAX package
    # uses so both packages route alike; on the card _derive() replaces the
    # Strassen cutoffs with measured values, and trsm_wide_base was measured
    # and kept (PERF.md); the others are not yet measured on this card.
    # Depth-block size of the blocked matmul path (reference analogue:
    # __M4RI_MUL_BLOCKSIZE, mzd.h:59).
    mul_block_k: int = 8192
    # Row-block size bounding the float32 product intermediate.
    mul_block_m: int = 8192
    # Below this dimension, use one matmul with no blocking.
    mul_block_threshold: int = 8192
    # Strassen-Winograd crossover (reference: __M4RI_STRASSEN_MUL_CUTOFF,
    # strassen.h:133-135).  mul() recurses from min-dim >= 2 * cutoff.
    strassen_cutoff: int = 8192
    # Strassen recursion depth cap.
    strassen_max_levels: int = 2
    # A third level engages at min-dim >= this.
    strassen_depth3_min: int = 65536
    # On the card, large products (m >= 2048, nw >= 128, max-dim >=
    # hopper_big_min) go to the Hopper kernels (ops/mul.py::_route).
    hopper_big_min: int = 4096
    # Panel width of the blocked PLE / echelonization sweep, and the height
    # of the row window its sequential pivot loop runs on (models/ple.py).
    # A window that goes rank-deficient is detected exactly and the panel is
    # redone at full height, so the 64-row margin is a matter of speed only.
    panel_width: int = 512
    panel_window: int = 576
    # From min-dim >= panel_width_big_min the sweep takes the wide panel.
    panel_width_big: int = 1024
    panel_window_big: int = 1088
    panel_width_big_min: int = 32768
    # TRSM / TRTRI recursion (models/triangular.py): blocks of at most
    # trsm_base are inverted whole (ops/hopper_trinv.py); a B at least a
    # quarter as wide as T substitutes down to trsm_wide_base, then inverts
    # the block and multiplies.
    trsm_base: int = 512
    trsm_wide_base: int = 4096
    # Density from which echelonize(strategy="heuristic") takes the PLUQ
    # path (reference: echelonform.h:37).
    echelon_density_crossover: float = 0.15
    # Provenance of the derived values ("cuda:<name>", "cpu", "default").
    derived_from: str = "default"


def _derive() -> Config:
    """Inspect the device (reference analogue: configure-time cache
    detection).  With a card the defaults stand; without one the
    one-matmul products are smaller."""
    import torch
    if torch.cuda.is_available():
        # Strassen measured on an H100 80GB HBM3 at 700 W (direct / one
        # level / two levels): 0.73-0.75 / 1.03-1.06 / 2.67-2.92 ms at
        # 16384, 5.18-5.35 / 5.56-5.70 / 7.23-7.32 at 32768, 45.3 / 41.5 /
        # 41.6-44.1 at 65536; so a level only where its base products stay
        # at 32768 or more
        return Config(strassen_cutoff=32768, strassen_depth3_min=262144,
                      derived_from=f"cuda:{torch.cuda.get_device_name(0)}")
    return Config(mul_block_k=4096, mul_block_m=4096,
                  mul_block_threshold=4096, strassen_cutoff=4096,
                  derived_from="cpu")


@functools.lru_cache(maxsize=1)
def get_config() -> Config:
    return _derive()

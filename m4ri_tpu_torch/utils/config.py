"""Hardware-derived tuning configuration of the PyTorch/CUDA port.

The reference library derives every algorithmic cutoff from CPU cache sizes
detected at configure time (reference: configure.ac:198-219, misc.h:569-599,
strassen.h:133-135).  Here ``get_config()`` inspects ``torch.cuda`` once and
derives the knobs the multiply and factorization paths read: block sizes
bounding the unpacked float32 intermediates of the blocked ``torch.matmul``
path, the Strassen crossover, the gates that route a product to the
hand-written Hopper kernels, and the panel widths of the PLE sweep.  Every field can be overridden with an ``M4RI_TPU_TORCH_<FIELD>``
environment variable.

All sizes are in *bits* (matrix dimensions) unless noted.
"""

from __future__ import annotations

import dataclasses
import functools
import os

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
    # Route shallow products (kw <= 32 words, m >= 2048, nw >= 128) to
    # gf2_mul_hopper (ops/hopper_mul.py): the matmul path would write an
    # m x n float32 product to device memory first.
    use_hopper_schur: bool = True
    # Route large products (m >= 2048, nw >= 128, max-dim >= hopper_big_min)
    # to the Hopper kernels.
    use_hopper_big: bool = True
    hopper_big_min: int = 4096
    # Of those, contractions deeper than 64 words go to gf2_mul_hopper_v2
    # (ops/hopper_mul2.py), the split-contraction kernel.
    use_hopper_v2: bool = True
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
    # Take the persistent Schur kernel, which derives its tile range from the
    # bounds on the device (ops/hopper_schur.py), instead of the gridded one.
    schur_dyn: bool = False
    # On the card, run the factorization through the hand-written kernels
    # (engine "hopper" of models/ple.py); off, the plain PyTorch engine.
    use_hopper_panel: bool = True
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


def _env_overrides(cfg: Config) -> Config:
    updates = {}
    for f in dataclasses.fields(Config):
        raw = os.environ.get(f"M4RI_TPU_TORCH_{f.name.upper()}")
        if raw is None:
            continue
        if f.type in ("int", int):
            updates[f.name] = int(raw)
        elif f.type in ("float", float):
            updates[f.name] = float(raw)
        elif f.type in ("bool", bool):
            updates[f.name] = raw.lower() in ("1", "true", "yes", "on")
        else:
            updates[f.name] = raw
    return dataclasses.replace(cfg, **updates) if updates else cfg


def _derive() -> Config:
    """Inspect the device (reference analogue: configure-time cache
    detection).  With a card the defaults stand; without one the kernel
    gates are off and the one-matmul products are smaller."""
    import torch
    if torch.cuda.is_available():
        # Strassen measured on an H100 (benches/tune_cutoffs.py): the direct
        # kernel product wins at 16384 and 32768, one level over 32768 bases
        # wins at 65536, two levels lose there; so a level only where its
        # base products stay at 32768 or more
        return Config(strassen_cutoff=32768, strassen_depth3_min=262144,
                      derived_from=f"cuda:{torch.cuda.get_device_name(0)}")
    return Config(use_hopper_schur=False, use_hopper_big=False,
                  use_hopper_panel=False, mul_block_k=4096, mul_block_m=4096,
                  mul_block_threshold=4096, strassen_cutoff=4096,
                  derived_from="cpu")


@functools.lru_cache(maxsize=1)
def get_config() -> Config:
    return _env_overrides(_derive())

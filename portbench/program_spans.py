"""The spans the program recorded in a traced window, for the readers of
``program_span`` metrics.

The program records spans for each entry-point call begun while PyTorch's
profiler records (``m4ri_tpu_torch/utils/spans.py``), so a ``--trace 1``
run holds the spans of its window's calls and an untraced run none.  They
are taken from the program once a run and kept here for every reader of
that run.  A program without spans gives None, and so does every reader.
"""

from __future__ import annotations

import sys

PROGRAM_SPANS = "m4ri_tpu_torch.utils.spans"
_taken: dict = {}


def recorded(rec):
    """The window's spans (a list; empty when the program recorded none),
    or None where the program has no spans or the run was not traced."""
    key = id(rec)
    if key not in _taken:
        program = sys.modules.get(PROGRAM_SPANS)
        _taken.clear()
        _taken[key] = (program.take() if program is not None
                       and rec.trace is not None else None)
    return _taken[key] or None

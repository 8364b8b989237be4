"""The traced window put down to the program's spans.

The program (``m4ri_tpu_torch/utils/spans.py``) records spans on the clock
of the profiler's events: each has a name, a start and an end in Unix-epoch
nanoseconds, its id, its parent's id, its root's id (the entry-point call)
and the thread that ran it.  Each device operation is put down to the
innermost span open when the runtime call that launched it began (the two
share a correlation id), on the launching thread; each idle gap of the
device to the innermost span open on the host when the gap began.

Nothing here touches torch, so the tests check it on synthetic timelines.
A span is any object with ``name``, ``start``, ``end``, ``id``, ``parent``,
``root`` and ``tid``.
"""

from __future__ import annotations

from . import timeline

NO_SPAN = "(no span)"        # launched or idle outside every span
NO_LAUNCH = "(no launch)"    # no runtime call carries the operation's id
SWEEP = "sweep"
SCHUR = "kernel.gf2_schur_update_hopper"


def open_at(spans, times):
    """For each time (in any order), the innermost span with ``start <= t <
    end``, or None.  ``spans`` nest as a call stack does."""
    order = sorted(range(len(times)), key=times.__getitem__)
    ranked = sorted(spans, key=lambda s: (s.start, -s.end))
    out, stack, i = [None] * len(times), [], 0
    for q in order:
        t = times[q]
        while i < len(ranked) and ranked[i].start <= t:
            while stack and stack[-1].end <= ranked[i].start:
                stack.pop()
            stack.append(ranked[i])
            i += 1
        while stack and stack[-1].end <= t:
            stack.pop()
        out[q] = stack[-1] if stack else None
    return out


def _open_on_threads(spans, queries):
    """``open_at`` for ``(time, tid)`` queries, each against the spans of its
    own thread; a query whose thread ran no span (tid None, or a thread id
    the trace names otherwise) is asked of all of them."""
    by_tid: dict = {}
    for s in spans:
        by_tid.setdefault(s.tid, []).append(s)
    groups: dict = {}
    for q, (t, tid) in enumerate(queries):
        groups.setdefault(tid if tid in by_tid else None, []).append(q)
    out = [None] * len(queries)
    for tid, qs in groups.items():
        found = open_at(by_tid[tid] if tid is not None else spans,
                        [queries[q][0] for q in qs])
        for q, s in zip(qs, found):
            out[q] = s
    return out


class Tree:
    """The parent links of the recorded spans, asked for ancestors."""

    def __init__(self, spans):
        self.by_id = {s.id: s for s in spans}
        self._under: dict = {}

    def under(self, span, name: str) -> bool:
        """Whether ``span`` or one of its ancestors is named ``name``."""
        key = (span.id, name)
        got = self._under.get(key)
        if got is None:
            parent = self.by_id.get(span.parent)
            got = span.name == name or (parent is not None
                                        and self.under(parent, name))
            self._under[key] = got
        return got


def attribute(device, launches, spans, window, own, schur_least_s=None):
    """The window's device work and idle gaps by span.

    ``device``: ``(name, start, end, correlation)`` of each kernel, copy and
    memset; ``launches``: ``{correlation: (start, tid)}`` of the runtime
    calls; ``spans``: the program's; ``window``: ``(lo, hi)`` ns; ``own``:
    the short names of the program's own kernels, applied to ``name``
    already shortened.  ``schur_least_s(attrs)``: the least time of one
    ``kernel.gf2_schur_update_hopper`` span from its attributes.

    Returns seconds: ``device_by_span`` and ``glue_by_span`` (the innermost
    span at the launch; ``(no span)``, ``(no launch)``), ``idle_by_span``,
    ``sweep_glue_s`` (glue launched inside a ``sweep``), ``solver_glue_s``
    (inside a root, outside every ``sweep``), ``glue_s``, and the counts
    ``own_launches``, ``own_outside_kernel_spans`` (own kernels whose
    innermost span at launch is not a ``kernel.*`` one) and
    ``unmatched``; with ``schur_least_s`` (None where a bound was a
    tensor), ``schur_least_s`` and ``schur_device_s``: the spans' least
    time, and the device time launched inside them.
    """
    lo, hi = window
    work = []
    for name, s, e, corr in device:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            work.append((name, s, e, corr))
    queries, which = [], []
    for q, (_, _, _, corr) in enumerate(work):
        if corr in launches:
            queries.append(launches[corr])
            which.append(q)
    at = [None] * len(work)
    for q, sp in zip(which, _open_on_threads(spans, queries)):
        at[q] = sp
    matched = set(which)
    tree = Tree(spans)
    dev_by, glue_by = {}, {}
    out = {"sweep_glue_s": 0.0, "solver_glue_s": 0.0, "glue_s": 0.0,
           "own_launches": 0, "own_outside_kernel_spans": 0,
           "unmatched": len(work) - len(matched)}
    schur_dev: dict = {}
    for q, (name, s, e, _) in enumerate(work):
        sec = (e - s) / 1e9
        sp = at[q]
        key = sp.name if sp is not None else (
            NO_SPAN if q in matched else NO_LAUNCH)
        dev_by[key] = dev_by.get(key, 0.0) + sec
        if sp is not None and sp.name == SCHUR:
            schur_dev[sp.id] = schur_dev.get(sp.id, 0.0) + sec
        if name in own:
            out["own_launches"] += 1
            if sp is None or not sp.name.startswith("kernel."):
                out["own_outside_kernel_spans"] += 1
            continue
        glue_by[key] = glue_by.get(key, 0.0) + sec
        out["glue_s"] += sec
        if sp is None:
            continue
        if tree.under(sp, SWEEP):
            out["sweep_glue_s"] += sec
        else:
            out["solver_glue_s"] += sec
    idle = timeline.gaps([(s, e) for _, s, e, _ in work], lo, hi)
    idle_by: dict = {}
    for (gs, ge), sp in zip(idle, open_at(spans, [g[0] for g in idle])):
        key = sp.name if sp is not None else NO_SPAN
        idle_by[key] = idle_by.get(key, 0.0) + (ge - gs) / 1e9
    out["device_by_span"] = timeline.top(dev_by, len(dev_by))
    out["glue_by_span"] = timeline.top(glue_by, len(glue_by))
    out["idle_by_span"] = timeline.top(idle_by, len(idle_by))
    if schur_least_s is not None:
        # the spans whose bound the host knew (int bounds) and that began
        # in the window
        least = [(s.id, schur_least_s(s.attrs)) for s in spans
                 if s.name == SCHUR and lo <= s.start < hi]
        least = [(i, t) for i, t in least if t is not None]
        out["schur_least_s"] = sum(t for _, t in least)
        out["schur_device_s"] = sum(schur_dev.get(i, 0.0) for i, _ in least)
    return out


def host_ms(spans, name: str, less: str | None = None) -> float:
    """Host milliseconds in the spans named ``name``, less the time of the
    spans named ``less`` inside them."""
    tree = Tree(spans)
    total = sum(s.end - s.start for s in spans if s.name == name)
    if less is not None:
        total -= sum(s.end - s.start for s in spans
                     if s.name == less and tree.under(s, name))
    return total / 1e6

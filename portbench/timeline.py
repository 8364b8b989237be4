"""The benchmark's arithmetic over a window: rates, percentiles, the union
of device activity, idle gaps and what the host was doing in each.

Times are in nanoseconds on one clock (the profiler's) unless a name says
otherwise.  Nothing here touches torch, so the tests check it on synthetic
timelines.
"""

from __future__ import annotations

import statistics


def rate(work: float, seconds: float) -> float:
    """All the work of a window over all its time."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return work / seconds


def p95(values) -> float:
    """95th percentile of every value, interpolated between the two nearest
    ranks (numpy's default), never from medians of chunks."""
    values = list(values)
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def clip(intervals, lo: int, hi: int):
    """The parts of ``(start, end)`` intervals inside [lo, hi]."""
    out = []
    for s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            out.append((s, e))
    return out


def union(intervals):
    """Sorted, disjoint intervals covering the same time."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy(intervals) -> int:
    return sum(e - s for s, e in union(intervals))


def gaps(intervals, lo: int, hi: int):
    """The idle stretches of [lo, hi] between the union's intervals."""
    out, t = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def host_ops_at(gap_list, host_events):
    """For each gap (sorted by start), the names of the host operations open
    at its start, outermost first.  ``host_events`` are ``(start, end,
    name)`` on one thread, nested as a call stack is."""
    events = sorted(host_events, key=lambda ev: (ev[0], -ev[1]))
    stack, out, i = [], [], 0
    for gs, _ in gap_list:
        while i < len(events) and events[i][0] <= gs:
            while stack and stack[-1][1] <= events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] <= gs:
            stack.pop()
        out.append([ev[2] for ev in stack if ev[1] > gs])
    return out


def top(totals: dict, n: int = 10):
    """The ``n`` largest ``[name, value]`` pairs."""
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])
    return [[k, v] for k, v in ranked[:n]]


def idle_by_host_op(gap_list, stacks, depth: int = 2) -> dict:
    """Idle seconds summed by the innermost ``depth`` host operations open
    when each gap began (``"(no host operation)"`` for none)."""
    out: dict = {}
    for (gs, ge), names in zip(gap_list, stacks):
        key = " > ".join(names[-depth:]) if names else "(no host operation)"
        out[key] = out.get(key, 0.0) + (ge - gs) / 1e9
    return out

"""Spans and counters: where a call of the port spends its time, and how
often things happen in it.

- ``span(name, **attrs)`` is a context manager around one part of a call:
  the sweep, a panel, a phase of a panel, a kernel wrapper.  Each span
  records its name, start, end, its parent span, the id of its root span
  and its attributes (host values only: ints and strings; a span never
  reads a device tensor, so it adds no read-back).
- ``spanned(name)`` puts each call of a function in a span; ``entry(name)``
  makes each call of a public entry point a root span, whose id is the
  call's id, which every span of the call shares.
- ``count(name, n=1)`` adds to a counter.  Counters are always on: kernel
  launches (``launch.<wrapper>``, ``launch.panel_batched.<kind>``),
  read-backs (``readback.<sweep>``), panels redone at full height
  (``fallback.<sweep>``) and collectives staged through host memory
  (``host_staged_collectives``).

Recording is off by default, and then ``span`` returns one shared object
that does nothing: no clock read, no record.  It is on after ``enable()``,
and, in the default state, for each entry-point call begun while PyTorch's
profiler records (``torch.profiler``), so that a traced window holds the
spans of its calls.  ``take()`` hands back the recorded spans and forgets
them.

Times are ``time.time_ns()``: the Unix-epoch nanoseconds of the profiler's
events (``start_ns()``), so spans, the runtime's launches and the device's
work lie on one timeline.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

__all__ = ["Span", "span", "spanned", "entry", "count", "counts",
           "reset_counts", "enable", "disable", "take", "self_ns"]


class Span(NamedTuple):
    name: str
    start: int            # ns since the Unix epoch
    end: int
    id: int
    parent: int | None    # the enclosing span's id; None for a root
    root: int             # the root span's id: the call's
    tid: int              # the native id of the thread that ran it
    attrs: dict


_mode: bool | None = None   # enable(): True records, False never, None
                            # records the calls begun under the profiler
_on = False                 # spans record now
_live = 0                   # entry-point calls recording now
_ids = itertools.count(1)
_records: list = []           # plain tuples, made Spans by take()
_counts: dict = {}


class _Thread(threading.local):
    """The open spans of the calling thread, and its native id."""

    def __init__(self):
        self.stack = []
        self.tid = threading.get_native_id()


_thread = _Thread()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _profiling() -> bool:
    """Whether PyTorch's profiler records now: its own flag for fast
    checks from Python, or the C++ state where a release lacks the flag."""
    return _profiler._is_profiler_enabled


if not hasattr(_profiler, "_is_profiler_enabled"):
    _profiling = torch._C._autograd._profiler_enabled  # noqa: F811


class _Open:
    __slots__ = ("name", "attrs", "thread", "start", "id", "parent", "root")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.thread = thread = _thread
        stack = thread.stack
        self.id = next(_ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = None, self.id
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        thread = self.thread
        thread.stack.pop()
        _records.append((self.name, self.start, end, self.id, self.parent,
                         self.root, thread.tid, self.attrs))
        return False


def span(name: str, **attrs):
    """A span around the ``with`` block, recorded when recording is on."""
    if not _on:
        return _NOOP
    return _Open(name, attrs)


def spanned(name: str):
    """Decorator: each call of the function runs in a span named
    ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Open(name, {}):
                return fn(*args, **kwargs)
        return call
    return wrap


def entry(name: str):
    """Decorator: each call of the function is a span named ``name``, a
    root unless it runs inside another span.  A call begun while PyTorch's
    profiler records turns recording on for its length (unless
    ``disable()`` was called)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            global _on, _live
            if not _on and (_mode is False or not (
                    _mode or _profiling())):
                return fn(*args, **kwargs)
            _live += 1
            _on = True
            try:
                with _Open(name, {}):
                    return fn(*args, **kwargs)
            finally:
                _live -= 1
                _on = _mode is True or (_mode is None and _live > 0)
        return call
    return wrap


def enable(on: bool | None = True) -> None:
    """Record every span from now on (True), none (False), or, the default
    state (None), the spans of the entry-point calls begun while PyTorch's
    profiler records."""
    global _mode, _on
    _mode = on
    _on = on is True or (on is None and _live > 0)


def disable() -> None:
    """Record no span, whether the profiler records or not."""
    enable(False)


def take() -> list:
    """The spans recorded so far, each a ``Span``, in the order they
    ended; forgotten here."""
    global _records
    out, _records = _records, []
    return [Span._make(r) for r in out]


def self_ns(spans) -> dict:
    """Nanoseconds by span name, each span's time less its children's."""
    children: dict = {}
    for s in spans:
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0) + s.end - s.start
    out: dict = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0) + s.end - s.start - children.get(
            s.id, 0)
    return out


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def counts() -> dict:
    """Every counter's value, a copy."""
    return dict(_counts)


def reset_counts(prefix: str = "") -> None:
    """Set the counters whose names begin with ``prefix`` (all by default)
    back to zero."""
    for key in [k for k in _counts if k.startswith(prefix)]:
        del _counts[key]

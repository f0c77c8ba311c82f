"""The port's spans and counters: where its host time goes, and what it did.

A span (``span(name)``, a context manager) is recorded only while
``torch.profiler`` is recording or after ``enable()``; otherwise it is one
check and a shared no-op context.  A recorded span is

- a range on the profiler's host timeline while the profiler records, so
  it lies beside the device's activity: the profiler's fast record
  (``_RecordFunctionFast``, a host op named after the span): ~6 us a span
  under the CUDA profiler on an H100's host, where ``record_function``
  costs ~43 us (PERF.md §6);
- a ``Span`` record (name, start_ns, end_ns, parent, request) appended to a
  ring of ``CAPACITY`` records (``records()``).  Its times are on the
  profiler's clock (Unix-epoch ns: ``perf_counter_ns`` plus an offset
  measured at import and at ``enable()``); ``parent`` is the name of the
  enclosing span of the same thread (None at the top); ``request`` is the
  sequence number of the outermost span, shared by everything inside it.
  A record that pushes the ring's oldest out counts ``trace.dropped``.

Counters (``count(name, n)``, ``counters()``) are always on.  The kernel
wrappers count each launch as ``launch.<wrapper>``; ``render/graph.py``
counts ``graph.captures`` and ``graph.evictions``.  The viewer's ``/stats``
shows ``graph.captures``, ``graph.evictions`` and ``trace.dropped``, and
the mean host ms of the render's phases and of ``ws.graph.capture``.

Span names are ``ws.<layer>.<phase>``: ``ws.render`` (GaussianRenderer.
render) and its ``.prep`` and ``.readback``; ``ws.graph.lookup``,
``.replay`` and ``.capture`` (render/graph.py); ``ws.frame.decompress``,
``.stream``, ``.sort``, ``.ranges`` and ``.raster``, the stages of an
uncompiled frame (render_frame), which run at a capture and on the CPU,
never inside a replay.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

import torch

CAPACITY = 65_536  # records the ring keeps

_profiler_enabled = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


class Span(NamedTuple):
    name: str
    start_ns: int  # the profiler's clock (Unix-epoch ns)
    end_ns: int
    parent: Optional[str]  # the enclosing span's name, None at the top
    request: int  # the outermost span's sequence number


def _clock_offset() -> int:
    """The profiler's clock (Unix-epoch ns) less perf_counter's."""
    return time.time_ns() - time.perf_counter_ns()


_enabled = False
_offset = _clock_offset()
# plain tuples, which the cyclic collector stops tracking, not Spans
_ring: "deque[tuple]" = deque(maxlen=CAPACITY)
_counters: Dict[str, int] = {}
_requests = itertools.count()
_local = threading.local()
_NULL = contextlib.nullcontext()  # the span of an inactive trace


class _Active:
    """A recorded span: its range on the profiler's timeline while the
    profiler records, and its record at exit."""

    __slots__ = ("name", "range", "start", "parent", "request", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.stack = stack
        self.parent = stack[-1] if stack else None
        self.request = self.parent.request if self.parent else next(_requests)
        stack.append(self)
        self.range = None
        if _profiler_enabled():
            self.range = _Range(self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.stack.pop()
        if len(_ring) == _ring.maxlen:
            count("trace.dropped")
        _ring.append((self.name, self.start + _offset, end + _offset,
                      self.parent.name if self.parent else None, self.request))
        return False


def span(name: str):
    """A context manager that records ``name`` while the trace is active
    (the profiler recording, or ``enable()``), and does nothing otherwise."""
    if _enabled or _profiler_enabled():
        return _Active(name)
    return _NULL


def enable(on: bool = True) -> None:
    """Record spans whether or not the profiler records (a viewer's
    ``/stats``); measures the clock offset again."""
    global _enabled, _offset
    _enabled = bool(on)
    _offset = _clock_offset()


def records() -> List[Span]:
    """The ring's records, oldest first."""
    while True:
        try:
            return [Span._make(r) for r in list(_ring)]
        except RuntimeError:  # another thread appended during the copy
            continue


def count(name: str, n: int = 1) -> None:
    _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """The counter registry (name -> count); counters never counted are absent."""
    return _counters


def reset() -> None:
    """Clear the records and the counters."""
    _ring.clear()
    _counters.clear()

"""Spans of the port's layers: always on, kept in one bounded ring in memory.

    with tracing.span("serve.flush", trace_id=batch) as s:
        ...
    ms = (s.end_ns - s.start_ns) / 1e6

A span records its name, its start and end, its own id, its parent's id
(the enclosing span on the same thread), a trace id (the request, batch or
step number; a span given none takes its parent's), an optional ``link``
(the id of a span or trace on another thread) and the thread.  A finished
span goes into one process-wide ring of RING_SPANS entries, the oldest
dropped first; ``spans(lo_ns, hi_ns)`` returns those that overlap a window.

The clock is ``time.time_ns()``, Unix-epoch nanoseconds: the clock of the
torch profiler's (kineto's) events, so spans lay over a profile's device
intervals and runtime calls.  Where the calling thread has a torch profiler
running (``torch._C._autograd._profiler_enabled()``, which is per thread;
autograd's device threads inherit it from the thread that called
``backward``), a span also opens a ``torch.profiler.record_function`` of its
name, so a profile with CPU activity attributes device time to it.  Without
a profiler a span costs two clock reads and an append.

A span never touches the device (no sync, no launch, no tensor read), so a
CUDA graph capture holds it (train/scan.py); a graph's replays record none.

A ``held`` span is opened by a block but ended by ``finish()``, which may
run on another thread: its children nest under it inside the block as
under any span, and others name it as their ``parent`` in ``record``
(a drive batch dispatched by the collector and answered by the completer,
serve.py).  It keeps the thread that opened it.

The names, and what reads them (PERF.md §3):
  serve.request > serve.decode, serve.wait, serve.encode   handler thread
  serve.queue     enqueue to the start of the flush that took the request
  serve.flush > serve.assemble, serve.graph > net.*   collector thread (held)
              > serve.readback                        completer thread
  train.step > train.aug, train.g_forward > net.*, train.g_backward,
      train.g_adam, train.d_forward > net.*, train.d_backward, train.d_adam
  remat.recompute.<net>   a region's replay in the backward (remat.py)
"""
from __future__ import annotations

import collections
import itertools
import math
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

RING_SPANS = 1 << 16


class Span(NamedTuple):
    """A finished span.  Times in Unix-epoch ns."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    trace_id: Optional[int]
    link: Optional[int]
    thread: int


class Ring:
    """The last ``maxlen`` finished spans, safe to add to from any thread."""

    def __init__(self, maxlen: int):
        self._spans = collections.deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self.maxlen = maxlen

    def add(self, s: Span) -> None:
        with self._lock:
            self._spans.append(s)

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._spans)


RING = Ring(RING_SPANS)
_ids = itertools.count(1)
_local = threading.local()
_profiling = torch._C._autograd._profiler_enabled


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        _local.thread = threading.get_native_id()
    return stack


class span:
    """``with span(name, trace_id=None, link=None, held=False) as s:``
    records one span of the block (see the module's docstring); ``s.id``,
    ``s.trace_id`` and ``s.start_ns`` are set on entry, ``s.end_ns`` on exit,
    or with ``held`` on ``s.finish()``."""

    __slots__ = ("name", "trace_id", "link", "held", "id", "parent", "thread", "start_ns",
                 "end_ns", "_rf")

    def __init__(self, name: str, trace_id: Optional[int] = None, link: Optional[int] = None,
                 held: bool = False):
        self.name, self.trace_id, self.link, self.held = name, trace_id, link, held

    def __enter__(self) -> "span":
        stack = _stack()
        outer = stack[-1] if stack else None
        self.parent = None if outer is None else outer.id
        if self.trace_id is None and outer is not None:
            self.trace_id = outer.trace_id
        self.id = next(_ids)
        self.thread = _local.thread
        stack.append(self)
        self._rf = None
        if _profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end_ns = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        stack = _local.stack
        if stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        if not self.held:
            self.end_ns = end_ns
            self._add()
        return False

    def finish(self) -> None:
        """End a ``held`` span now and record it, from any thread."""
        self.end_ns = time.time_ns()
        self._add()

    def _add(self) -> None:
        RING.add(Span(self.name, self.start_ns, self.end_ns, self.id, self.parent,
                      self.trace_id, self.link, self.thread))


def current() -> Optional[span]:
    """The innermost open span of the calling thread, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def record(name: str, start_ns: int, end_ns: int, trace_id: Optional[int] = None,
           parent: Optional[int] = None, link: Optional[int] = None) -> int:
    """Add a finished span whose clock reads were taken elsewhere (a queue
    wait, from a timestamp its request carries); returns its id."""
    _stack()
    sid = next(_ids)
    RING.add(Span(name, start_ns, end_ns, sid, parent, trace_id, link, _local.thread))
    return sid


def spans(lo_ns: Optional[int] = None, hi_ns: Optional[int] = None) -> List[Span]:
    """The ring's spans that overlap [lo_ns, hi_ns], oldest first."""
    return [s for s in RING.snapshot()
            if (lo_ns is None or s.end_ns >= lo_ns) and (hi_ns is None or s.start_ns <= hi_ns)]


def _rank(sorted_values: List[float], q: float) -> float:
    return sorted_values[max(0, math.ceil(q * len(sorted_values)) - 1)]


def summary(prefix: str = "") -> Dict[str, Dict[str, float]]:
    """For each span name that starts with ``prefix``: its count in the
    ring and the p50 and p95 of its durations in ms (nearest rank)."""
    by_name = collections.defaultdict(list)
    for s in RING.snapshot():
        if s.name.startswith(prefix):
            by_name[s.name].append((s.end_ns - s.start_ns) / 1e6)
    out = {}
    for name, ms in sorted(by_name.items()):
        ms.sort()
        out[name] = {"count": len(ms), "p50_ms": _rank(ms, 0.5), "p95_ms": _rank(ms, 0.95)}
    return out

"""Program spans: named host intervals around the phases of a run (set-up,
steps, reports, LM's linearisations and CG iterations), kept in memory while a
``record()`` is open, and free while none is.

    with spans.span("train.epoch"):
        ...

    with spans.record() as rec:
        vn.train(...)
    rec.spans     # [Span(name, parent, t0_ns, t1_ns), ...] in the order they opened
    rec.counts    # {name: spans of that name closed}

While the recorder is off, ``span`` returns one shared no-op context after a
single flag check: no allocation, no clock read.  While it is on, each span is
kept with ``parent``, the index of the innermost span open on the same thread
when it began (None at the top), and its ends from ``time.time_ns()``: Unix
nanoseconds, the clock of ``torch.profiler``'s events, so a span lines up with
the CUDA runtime calls made inside it and, through their correlation ids, with
the kernels they launched.  Nothing is written out while a run goes: whoever
opened ``record()`` reads it.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

_ON = False              # a record() is open
_BUF: List[list] = []    # [name, parent, t0_ns, t1_ns] per span, in the order they opened
_DEPTH = 0               # record() scopes open (nested ones share the buffer)
_OFF = contextlib.nullcontext()
_LOCAL = threading.local()
_LOCK = threading.Lock()


class Span(NamedTuple):
    name: str
    parent: Optional[int]   # index of the enclosing span in the same recording
    t0_ns: int
    t1_ns: Optional[int]    # None while the span is open


class _Open:
    """One span while the recorder is on."""

    __slots__ = ("name", "entry")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        buf = _BUF
        parent = stack[-1][1] if stack and stack[-1][0] is buf else None
        self.entry = [self.name, parent, None, None]
        with _LOCK:   # the index is the entry's place: another thread may append
            index = len(buf)
            buf.append(self.entry)
        stack.append((buf, index))
        self.entry[2] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.entry[3] = time.time_ns()
        _LOCAL.stack.pop()
        return False


def span(name: str):
    """A context around one phase, recorded while a ``record()`` is open."""
    if not _ON:
        return _OFF
    return _Open(name)


class timed:
    """``span(name)`` that also measures its host seconds (``perf_counter``),
    whether or not the recorder is on: a phase that a result reports and the
    recorder sees is timed at one pair of boundaries."""

    __slots__ = ("_span", "_t0", "seconds")

    def __init__(self, name: str):
        self._span = span(name)
        self.seconds = 0.0

    def __enter__(self):
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return self._span.__exit__(*exc)


class Recording:
    """The spans recorded between a ``record()``'s entry and exit."""

    def __init__(self, buf: List[list], start: int):
        self._buf, self._start, self._end = buf, start, None

    @property
    def spans(self) -> List[Span]:
        start = self._start
        return [Span(name, None if parent is None or parent < start else parent - start, t0, t1)
                for name, parent, t0, t1 in self._buf[start:self._end]]

    @property
    def counts(self) -> Dict[str, int]:
        return dict(collections.Counter(s.name for s in self.spans if s.t1_ns is not None))


@contextlib.contextmanager
def record() -> Iterator[Recording]:
    """Turn the recorder on for the scope and yield what it records; the
    recorder is off again after the outermost one closes."""
    global _ON, _BUF, _DEPTH
    rec = Recording(_BUF, len(_BUF))
    _DEPTH += 1
    _ON = True
    try:
        yield rec
    finally:
        rec._end = len(rec._buf)
        _DEPTH -= 1
        _ON = _DEPTH > 0
        if not _ON:
            _BUF = []


def chrome_events(spans: List[Span], base_ns: int) -> List[dict]:
    """Closed spans as Chrome-trace complete events on a ``varnet`` track, in
    microseconds after ``base_ns`` (a torch.profiler trace's
    ``baseTimeNanoseconds``), so they line up with the trace's own events."""
    return [{"ph": "X", "cat": "varnet", "name": s.name, "pid": "varnet", "tid": 0,
             "ts": (s.t0_ns - base_ns) / 1e3, "dur": (s.t1_ns - s.t0_ns) / 1e3}
            for s in spans if s.t1_ns is not None]

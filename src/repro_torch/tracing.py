"""Spans and counters inside the port, on the profiler's clock, kept in memory.

A span is a named interval on one thread::

    with tracing.span("sink.put", group):
        ...

Spans sit at layer boundaries, at most once per flush group or dispatch
(the frontend's admission sweeps and sleeps excepted), never once per
event.  ``count(name, n)`` adds to a counter; ``values(name, x)`` keeps an
array of per-item values, once per dispatch or call.  ``PERF.md`` names
every span and counter with the metric that reads it.

Taking a recording: around any calls into the program, on any thread::

    from repro_torch import tracing

    with tracing.recording() as rec:
        state, info = pipe.process_stream(state, keys, qs, ts, sink=sink)
        sink.flush()
    rec.spans    # Span(name, thread, start_ns, end_ns, parent, id), by start
    rec.counts   # {"stream.blocks": ...}

Or profile the program with ``torch.profiler``: a call into the program
(``run_stream``, ``ServingFrontend.run``: the functions marked ``entry``)
that finds a profiler running on its thread, and no recording active, is
recorded until it returns, and ``profiled()`` hands over the recordings
of such calls.  They hold the spans of the threads the profiler does not
see, the sink's flush dispatcher and partition workers; a sink span that
starts after its call returned is not recorded.  A profiled call pays
for the recording as well as for the profiler.

Stamps are ``time.time_ns()``, the clock of the profiler's events, so the
spans of every thread lie on the profiler's timeline.  While a profiler
runs on a span's thread, the span is also a host range of the profile
named ``repro_torch.<name>``, so its host events and idle gaps take the
program's names.

With no recording active, a span costs one check of a module-level name
and returns a shared no-op context: no clock read, no allocation.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["Span", "Recording", "span", "count", "values", "active",
           "recording", "entry", "profiled", "PREFIX"]

# the prefix of the spans' ranges in a profile
PREFIX = "repro_torch."

_clock = time.time_ns

# the active recording (None: tracing off)
_rec: Optional["Recording"] = None
# the recordings of the last profiled calls (``entry``), for ``profiled``
_profiled: "deque[Recording]" = deque(maxlen=256)


class Span(NamedTuple):
    name: str
    thread: str                 # the thread's name
    start_ns: int               # time.time_ns()
    end_ns: int
    parent: Optional[str]       # the enclosing span on the same thread
    id: Optional[int]           # flush group or dispatch number


class _Thread:
    """One thread's part of a recording, appended to without a lock."""
    __slots__ = ("name", "spans", "stack", "counts", "values")

    def __init__(self):
        self.name = threading.current_thread().name
        self.spans: List[Span] = []
        self.stack: List[str] = []
        self.counts: Dict[str, int] = {}
        self.values: Dict[str, List[np.ndarray]] = {}


class Recording:
    """Spans, counts and values of every thread while it was active;
    ``collect`` gathers them into ``spans`` (by start), ``counts`` and
    ``values``."""

    def __init__(self):
        self._local = threading.local()
        self._threads: List[_Thread] = []
        self._lock = threading.Lock()
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}
        self.values: Dict[str, np.ndarray] = {}

    def _thread(self) -> _Thread:
        t = getattr(self._local, "t", None)
        if t is None:
            t = self._local.t = _Thread()
            with self._lock:
                self._threads.append(t)
        return t

    def collect(self) -> "Recording":
        with self._lock:
            threads = list(self._threads)
        spans: List[Span] = []
        counts: Dict[str, int] = {}
        vals: Dict[str, List[np.ndarray]] = {}
        for t in threads:
            spans += list(t.spans)
            for k, n in dict(t.counts).items():
                counts[k] = counts.get(k, 0) + n
            for k, v in dict(t.values).items():
                vals.setdefault(k, []).extend(v)
        self.spans = sorted(spans, key=lambda s: s.start_ns)
        self.counts = counts
        self.values = {k: np.concatenate(v) for k, v in vals.items()}
        return self


class _Span:
    __slots__ = ("name", "id", "t", "t0", "parent", "rf")

    def __init__(self, name: str, id, t: _Thread):
        self.name, self.id, self.t = name, id, t

    def __enter__(self):
        t = self.t
        self.parent = t.stack[-1] if t.stack else None
        t.stack.append(self.name)
        self.rf = None
        if torch.autograd._profiler_enabled():
            # a function-scope range: ``record_function``'s user scope is
            # mirrored onto the card's timeline as an annotation over the
            # kernels the range launched, which a trace counts as device
            # work
            self.rf = torch._C._profiler._RecordFunctionFast(
                PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t = self.t
        t.stack.pop()
        t.spans.append(Span(self.name, t.name, self.t0, t1, self.parent,
                            self.id))
        return False


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def span(name: str, id: Optional[int] = None):
    """A span named ``name`` (a literal: ``"<layer>.<what>"``) around the
    ``with`` body; ``id`` links the spans of one flush group or dispatch
    across threads."""
    rec = _rec
    if rec is None:
        return _NOOP
    return _Span(name, id, rec._thread())


def count(name: str, n: int = 1) -> None:
    rec = _rec
    if rec is not None:
        c = rec._thread().counts
        c[name] = c.get(name, 0) + n


def values(name: str, x) -> None:
    """Keep the per-item values ``x`` (a copy) under ``name``; callers that
    must build ``x`` check ``active()`` first."""
    rec = _rec
    if rec is not None:
        rec._thread().values.setdefault(name, []).append(
            np.array(x, np.float64).reshape(-1))


def active() -> bool:
    return _rec is not None


@contextlib.contextmanager
def recording():
    """Record the spans, counts and values of every thread for the body;
    the yielded ``Recording`` holds them once the body exits."""
    global _rec
    rec = Recording()
    outer, _rec = _rec, rec
    try:
        yield rec
    finally:
        _rec = outer
        rec.collect()


def entry(fn):
    """Mark ``fn`` as a call into the program: under a ``torch.profiler``
    running on the calling thread, with no recording active, record every
    thread for the call and keep the recording for ``profiled``."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        global _rec
        if _rec is not None or not torch.autograd._profiler_enabled():
            return fn(*args, **kwargs)
        rec = _rec = Recording()
        try:
            return fn(*args, **kwargs)
        finally:
            _rec = None
            _profiled.append(rec)
    return call


def profiled() -> Optional[Recording]:
    """Hand over the recordings of the profiled calls (``entry``) since
    the last ``profiled()``, as one (None if there were none)."""
    recs = list(_profiled)
    _profiled.clear()
    if not recs:
        return None
    rec = Recording()
    rec._threads = [t for r in recs for t in r._threads]
    return rec.collect()

"""The port's spans, counters and dispatch notes.

Spans and counters record only while a ``torch.profiler`` session records;
otherwise each call costs one read of the profiler's enabled flag and
enters nothing (``torch.profiler.record_function`` alone costs about 14 us
a call even with no profiler running).

  * ``with span(name): ...`` enters ``record_function(name)``, so the span
    lies in the profiler's own timeline beside the kernels it launches, and
    keeps a :class:`Span` in memory: its name, the index of the enclosing
    span, a request id shared by every span under one root, and start and
    end stamps from ``time.time_ns()``, the Unix-epoch clock of the
    profiler's events (``KinetoEvent.start_ns()``).  ``stage=True`` also
    records the span's extent on the device: a pair of CUDA events on the
    current stream once CUDA is in use (its kernels plus the idle the host
    left inside it, exact even where no host read ends the span), the host
    duration otherwise.  The pair is resolved when the records are read.
  * ``count(name, n)`` adds to a counter, and to the same counter of the
    root span open at the time.
  * ``note(tag)`` appends ``tag`` to every log :func:`dispatch_log` opened,
    recording or not, and while recording to the innermost open span.

:func:`records` returns what was taken so far and :func:`reset` clears it.
Nothing is written out: the profiler's own trace holds the spans.

Spans and counters sit at the layer boundaries of the serving advance
(``serve.*``, ``serve/window_sweep.py``) and of the distributed EA loop
(``ea.*`` and ``fixpoint.*``, ``distributed/graph_engine.py``).  Every
host loop of a fixpoint counts ``fixpoint.rounds`` once a round, and every
site on these paths that reads a device value on the host (which drains the
queue) counts ``host_reads``."""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler


@dataclasses.dataclass(eq=False)
class Span:
    """One recorded span.  ``parent`` is the index of the enclosing span in
    :func:`records`' ``spans`` (-1 for a root); ``device_ms`` is the extent
    of a ``stage`` span (None for another, or one still open); ``notes``
    holds the dispatch tags noted while it was the innermost span, and a
    root's ``counts`` every counter taken under it."""

    name: str
    index: int
    parent: int
    request: int
    stage: bool
    start_ns: int = 0
    end_ns: int = 0
    device_ms: Optional[float] = None
    notes: List[str] = dataclasses.field(default_factory=list)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)


class Records(NamedTuple):
    spans: List[Span]
    counts: Dict[str, int]


_SPANS: List[Span] = []
_COUNTS: Dict[str, int] = {}
_LOCK = threading.Lock()
_REQUESTS = itertools.count()
_OPEN: "contextvars.ContextVar[tuple]" = contextvars.ContextVar(
    "repro_torch_obs_open_spans", default=())
_LOGS: "contextvars.ContextVar[tuple]" = contextvars.ContextVar(
    "repro_torch_serve_dispatch_logs", default=())
_OFF = contextlib.nullcontext()


class _Recording:
    """A span while a profiler session records."""

    __slots__ = ("name", "stage", "span", "_fn", "_token")

    def __init__(self, name: str, stage: bool):
        self.name, self.stage = name, stage

    def __enter__(self) -> Span:
        open_ = _OPEN.get()
        parent = open_[-1] if open_ else None
        with _LOCK:
            rec = Span(self.name, len(_SPANS), -1 if parent is None else parent.index,
                       next(_REQUESTS) if parent is None else parent.request, self.stage)
            _SPANS.append(rec)
        self.span = rec
        self._token = _OPEN.set(open_ + (rec,))
        self._fn = torch.profiler.record_function(self.name)
        rec.start_ns = time.time_ns()
        self._fn.__enter__()
        if self.stage and torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            rec.events = (start,)
        return rec

    def __exit__(self, *exc):
        rec = self.span
        if rec.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            rec.events += (end,)
        self._fn.__exit__(*exc)
        rec.end_ns = time.time_ns()
        if self.stage and rec.events is None:
            rec.device_ms = (rec.end_ns - rec.start_ns) * 1e-6
        _OPEN.reset(self._token)
        return False


def span(name: str, stage: bool = False):
    """A context manager that records the span ``name`` while a profiler
    session records, and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, stage)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler session records."""
    if not _profiler._is_profiler_enabled:
        return
    open_ = _OPEN.get()
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n
        if open_:
            root = open_[0].counts
            root[name] = root.get(name, 0) + n


@contextlib.contextmanager
def dispatch_log():
    """Collect the dispatch-site tags of the enclosed calls: ``with
    dispatch_log() as log: ...``.  Re-entrant: nested scopes stack and every
    enclosing log receives the tags of its whole extent."""
    log: list = []
    token = _LOGS.set(_LOGS.get() + (log,))
    try:
        yield log
    finally:
        _LOGS.reset(token)


def note(tag: str) -> None:
    """Note a dispatch-site tag into every open :func:`dispatch_log` and,
    while a profiler session records, into the innermost open span."""
    for log in _LOGS.get():
        log.append(tag)
    if _profiler._is_profiler_enabled:
        open_ = _OPEN.get()
        if open_:
            open_[-1].notes.append(tag)


def records() -> Records:
    """The spans (in the order they were entered) and counters taken since
    the last :func:`reset`; each finished stage span's CUDA events are
    resolved into ``device_ms`` here (waiting for the second one)."""
    with _LOCK:
        spans, counts = list(_SPANS), dict(_COUNTS)
    for rec in spans:
        if rec.events is not None and len(rec.events) == 2:
            start, end = rec.events
            end.synchronize()
            rec.device_ms = start.elapsed_time(end)
            rec.events = None
    return Records(spans, counts)


def reset() -> None:
    """Forget every span and counter taken so far."""
    with _LOCK:
        _SPANS.clear()
        _COUNTS.clear()


__all__ = ["Span", "Records", "span", "count", "note", "dispatch_log", "records", "reset"]

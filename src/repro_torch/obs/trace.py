"""Structured tracing: nested spans, thread-local context, carriers.

Design notes
------------
A :class:`Span` is an interval (epoch start + duration) with a name,
category, attributes, and parent/trace ids. Spans are recorded into
their :class:`Tracer` when **ended**; open spans live only on the
objects holding them, so an abandoned span costs nothing but its own
allocation.

Context propagation is thread-local by default: ``with obs.span(...)``
nests under whatever span the current thread last activated, and costs
one dict lookup (returning a shared no-op) when no tracer is active —
library code (store, planner, executor) can be instrumented
unconditionally. Two boundaries break thread-locality and use explicit
carriers instead:

* the **scheduler queue** hand-off: the submitting thread starts the
  root + queue spans and stores their contexts on the job object; the
  worker thread ends the queue span and ``activate()``-s the root
  context before executing;
* the **process pool**: worker processes build a throwaway local
  ``Tracer``, return ended spans as dicts next to the result, and the
  parent re-parents them under its dispatch span via
  :meth:`Tracer.adopt` (ids are uuid-based, so cross-process spans
  can't collide; starts are ``time.time()`` epoch so clocks line up
  to NTP accuracy).

Timing: ``t_start`` is ``time.time()`` (comparable across processes,
and the clock a ``torch.profiler`` trace maps to as ``ts +
baseTimeNanoseconds / 1e3``), ``dur`` is measured with ``perf_counter``
(monotonic, ns resolution). A span started and ended on one thread also
carries ``cpu_ms``, that thread's CPU time over the span
(``time.thread_time``): its wall time less ``cpu_ms`` is the time the
thread was off the CPU (a device wait, I/O, or the interpreter lock).
``tid`` is the OS thread id (``threading.get_native_id``), the id
``torch.profiler`` gives the events of the thread that started it (the
CUDA runtime calls of other threads carry an id derived from
``pthread_self()`` instead).

Export is the Chrome trace-event JSON format (``ph: "X"`` complete
events, microsecond units), loadable in Perfetto / chrome://tracing.
"""
from __future__ import annotations

import json
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "NOOP_SPAN", "Span", "SpanContext", "Tracer", "current",
    "current_ctx", "current_tracer", "span",
]


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


class SpanContext(Tuple[str, str]):
    """Immutable (trace_id, span_id) pair — the wire-safe handle that
    crosses queue/process boundaries instead of a live Span."""
    __slots__ = ()

    def __new__(cls, trace_id: str, span_id: str):
        return tuple.__new__(cls, (trace_id, span_id))

    def __getnewargs__(self):           # pickles across the pool boundary
        return (self[0], self[1])

    @property
    def trace_id(self) -> str:
        return self[0]

    @property
    def span_id(self) -> str:
        return self[1]

    def __repr__(self):  # pragma: no cover - debug aid
        return f"SpanContext(trace_id={self[0]!r}, span_id={self[1]!r})"


class Span:
    """One timed interval. Created by a Tracer; recorded when ended."""

    __slots__ = ("name", "category", "trace_id", "span_id", "parent_id",
                 "t_start", "dur", "attrs", "tid", "cpu_ms", "_tracer",
                 "_pc0", "_tc0")

    def __init__(self, tracer: "Tracer", name: str, category: str,
                 trace_id: str, parent_id: Optional[str],
                 attrs: Optional[Dict[str, Any]] = None,
                 t_start: Optional[float] = None):
        self.name = name
        self.category = category
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.t_start = time.time() if t_start is None else t_start
        self.dur: Optional[float] = None          # seconds; None = open
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.tid = threading.get_native_id()
        self.cpu_ms: Optional[float] = None
        self._tracer = tracer
        # perf_counter anchor for precise durations when t_start was
        # not backdated by the caller; the thread-time anchor is read
        # after it (and read first at the end), so cpu_ms <= wall where
        # the thread clock and perf_counter agree
        self._pc0 = time.perf_counter() if t_start is None else None
        self._tc0 = time.thread_time() if t_start is None else None

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    @property
    def ended(self) -> bool:
        return self.dur is not None

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self, t_end: Optional[float] = None, **attrs: Any) -> "Span":
        """End the span (idempotent) and record it into the tracer."""
        if self.dur is not None:
            if attrs:
                self.attrs.update(attrs)
            return self
        if attrs:
            self.attrs.update(attrs)
        if (self._tc0 is not None and t_end is None
                and threading.get_native_id() == self.tid):
            self.cpu_ms = (time.thread_time() - self._tc0) * 1e3
        if t_end is not None:
            self.dur = max(0.0, t_end - self.t_start)
        elif self._pc0 is not None:
            self.dur = time.perf_counter() - self._pc0
        else:
            self.dur = max(0.0, time.time() - self.t_start)
        self._tracer._record(self)
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "cat": self.category,
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "t_start": self.t_start,
            "dur": self.dur, "tid": self.tid, "cpu_ms": self.cpu_ms,
            "attrs": dict(self.attrs),
        }


class _NoopSpan:
    """Inert Span stand-in returned when no tracer is active."""
    __slots__ = ()
    ended = True
    context = None
    dur = None
    attrs: Dict[str, Any] = {}

    def set(self, **attrs):
        return self

    def end(self, t_end=None, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()

_local = threading.local()


def current() -> Tuple[Optional["Tracer"], Optional[SpanContext]]:
    """(active tracer, active span context) for this thread."""
    return getattr(_local, "tracer", None), getattr(_local, "ctx", None)


def current_tracer() -> Optional["Tracer"]:
    return getattr(_local, "tracer", None)


def current_ctx() -> Optional[SpanContext]:
    return getattr(_local, "ctx", None)


class _SpanCM:
    """Context manager: opens a child span of the thread-local context
    and makes it the thread-local context for the block."""
    __slots__ = ("_span", "_prev")

    def __init__(self, sp: Span):
        self._span = sp
        self._prev = None

    def __enter__(self) -> Span:
        self._prev = getattr(_local, "ctx", None)
        _local.ctx = self._span.context
        return self._span

    def __exit__(self, exc_type, exc, tb):
        _local.ctx = self._prev
        if exc_type is not None and "error" not in self._span.attrs:
            self._span.attrs["error"] = f"{exc_type.__name__}: {exc}"
        self._span.end()
        return False


def span(name: str, category: str = "", **attrs: Any):
    """Open a child span of this thread's active context.

    Returns a context manager yielding the :class:`Span` (or a shared
    no-op when no tracer is active — safe to call unconditionally from
    library code; the off cost is one attribute lookup).
    """
    tracer = getattr(_local, "tracer", None)
    if tracer is None:
        return NOOP_SPAN
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        return NOOP_SPAN
    sp = Span(tracer, name, category, ctx.trace_id, ctx.span_id,
              attrs or None)
    return _SpanCM(sp)


class _Activation:
    __slots__ = ("_tracer", "_ctx", "_prev")

    def __init__(self, tracer: "Tracer", ctx: Optional[SpanContext]):
        self._tracer = tracer
        self._ctx = ctx
        self._prev = None

    def __enter__(self):
        self._prev = (getattr(_local, "tracer", None),
                      getattr(_local, "ctx", None))
        _local.tracer = self._tracer
        _local.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        _local.tracer, _local.ctx = self._prev
        return False


class Tracer:
    """Bounded, thread-safe span sink.

    Ended spans are kept per trace id in an LRU of ``max_traces``
    traces, each capped at ``max_spans_per_trace`` (overflow increments
    a drop counter instead of growing without bound — a tracer wired
    into a long-lived service must never be a leak); ``stats()`` counts
    the spans dropped and the traces evicted with their spans.

    ``lane_detail`` controls whether the executor switches to the
    per-lane traced execution path (a span and a device synchronization
    per lane, bit-identical results) when this tracer is active;
    ``False`` keeps the fused run and its synchronizations, with one
    span per iteration and per phase of it (issue, wait, convergence
    read).
    """

    def __init__(self, max_traces: int = 256,
                 max_spans_per_trace: int = 4096,
                 lane_detail: bool = True):
        self.max_traces = int(max_traces)
        self.max_spans_per_trace = int(max_spans_per_trace)
        self.lane_detail = bool(lane_detail)
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, List[Dict[str, Any]]]" = OrderedDict()
        self._dropped = 0
        self._recorded = 0
        self._traces_evicted = 0
        self._spans_evicted = 0

    # -- span creation -------------------------------------------------
    def start_trace(self, name: str, category: str = "",
                    t_start: Optional[float] = None,
                    **attrs: Any) -> Span:
        """Start a new root span with a fresh trace id."""
        trace_id = uuid.uuid4().hex
        sp = Span(self, name, category, trace_id, None, attrs or None,
                  t_start=t_start)
        with self._lock:
            self._traces[trace_id] = []
            self._traces.move_to_end(trace_id)
            self._evict()
        return sp

    def start_span(self, name: str, category: str = "",
                   parent: Optional[SpanContext] = None,
                   t_start: Optional[float] = None,
                   **attrs: Any) -> Span:
        """Start a span under an explicit parent context (carrier use),
        or under the thread-local context when parent is omitted."""
        if parent is None:
            parent = getattr(_local, "ctx", None)
        if parent is None:
            return self.start_trace(name, category, t_start=t_start,
                                    **attrs)
        return Span(self, name, category, parent.trace_id,
                    parent.span_id, attrs or None, t_start=t_start)

    def activate(self, ctx: Optional[SpanContext]) -> _Activation:
        """Bind (self, ctx) as this thread's active tracing context for
        the duration of the ``with`` block."""
        return _Activation(self, ctx)

    # -- recording -----------------------------------------------------
    def _evict(self) -> None:
        """Drop the least recently started traces past ``max_traces``,
        counting them and their spans (caller holds the lock)."""
        while len(self._traces) > self.max_traces:
            _, bucket = self._traces.popitem(last=False)
            self._traces_evicted += 1
            self._spans_evicted += len(bucket)

    def _record(self, sp: Span) -> None:
        d = sp.to_dict()
        with self._lock:
            bucket = self._traces.get(sp.trace_id)
            if bucket is None:
                bucket = []
                self._traces[sp.trace_id] = bucket
                self._evict()
            if len(bucket) >= self.max_spans_per_trace:
                self._dropped += 1
                return
            bucket.append(d)
            self._recorded += 1

    def adopt(self, span_dicts: Iterable[Dict[str, Any]],
              parent: SpanContext) -> int:
        """Re-parent spans exported by another tracer (typically a pool
        worker process) under ``parent``: every span's trace_id becomes
        the parent's, and spans that were roots over there (parent_id
        None) hang off the parent span. Returns the adopted count."""
        n = 0
        with self._lock:
            bucket = self._traces.get(parent.trace_id)
            if bucket is None:
                bucket = []
                self._traces[parent.trace_id] = bucket
                self._evict()
            for d in span_dicts:
                if len(bucket) >= self.max_spans_per_trace:
                    self._dropped += 1
                    continue
                d = dict(d)
                d["trace_id"] = parent.trace_id
                if d.get("parent_id") is None:
                    d["parent_id"] = parent.span_id
                bucket.append(d)
                n += 1
            self._recorded += n
        return n

    # -- export --------------------------------------------------------
    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._traces)

    def export(self, trace_id: str) -> List[Dict[str, Any]]:
        """Ended spans of one trace, sorted by start time."""
        with self._lock:
            spans = list(self._traces.get(trace_id, ()))
        spans.sort(key=lambda d: d["t_start"])
        return spans

    def to_chrome_trace(self, path: Optional[str] = None,
                        trace_id: Optional[str] = None) -> Dict[str, Any]:
        """Chrome trace-event JSON for one trace (or all traces when
        ``trace_id`` is None). Optionally written to ``path``."""
        with self._lock:
            if trace_id is None:
                spans = [d for b in self._traces.values() for d in b]
            else:
                spans = list(self._traces.get(trace_id, ()))
        spans.sort(key=lambda d: d["t_start"])
        pids = {}
        events = []
        for d in spans:
            pid = pids.setdefault(d["trace_id"], len(pids))
            args = {k: v for k, v in d["attrs"].items()}
            args["span_id"] = d["span_id"]
            if d.get("cpu_ms") is not None:
                args["cpu_ms"] = d["cpu_ms"]
            if d["parent_id"] is not None:
                args["parent_id"] = d["parent_id"]
            events.append({
                "ph": "X",
                "name": d["name"],
                "cat": d["cat"] or "span",
                "ts": d["t_start"] * 1e6,
                "dur": (d["dur"] or 0.0) * 1e6,
                "pid": pid,
                "tid": d["tid"],
                "args": args,
            })
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
        return doc

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "traces": len(self._traces),
                "spans_recorded": self._recorded,
                "spans_dropped": self._dropped,
                "traces_evicted": self._traces_evicted,
                "spans_evicted": self._spans_evicted,
            }

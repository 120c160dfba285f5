"""Structured observability: tracing spans + perf-model drift.

* :mod:`~repro_torch.obs.trace` — a lock-guarded :class:`Tracer`
  producing nested :class:`Span` records with thread-local context
  propagation and Chrome-trace/Perfetto JSON export. The store, planner
  and executor open spans unconditionally; they cost one lookup when no
  tracer is active.
* :mod:`~repro_torch.obs.drift` — :class:`DriftAccumulator`, aggregating
  measured-vs-model-estimated lane and iteration times per kind.

Framework-free copies of the reference package's modules of the same
names.
"""
from .drift import DriftAccumulator
from .trace import (NOOP_SPAN, Span, SpanContext, Tracer, current,
                    current_ctx, current_tracer, span)

__all__ = [
    "DriftAccumulator", "NOOP_SPAN", "Span", "SpanContext", "Tracer",
    "current", "current_ctx", "current_tracer", "span",
]

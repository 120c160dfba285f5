"""Structured observability: tracing spans, perf-model drift and
pipeline utilization.

* :mod:`~repro_torch.obs.trace` — a lock-guarded :class:`Tracer`
  producing nested :class:`Span` records with thread-local context
  propagation and Chrome-trace/Perfetto JSON export. The store, planner
  and executor open spans unconditionally; they cost one lookup when no
  tracer is active.
* :mod:`~repro_torch.obs.drift` — :class:`DriftAccumulator`, aggregating
  measured-vs-model-estimated lane and iteration times per kind.
* :mod:`~repro_torch.obs.profile` — the pipeline utilization profiler:
  analytic per-lane byte/FLOP footprints (:class:`LaneFootprint`, the
  reference's byte classes), the bytes and operations a lane must move
  and do on the card (:func:`lane_traffic`), and measured lane times
  combined into achieved GB/s, operations per byte and %-of-peak
  (:class:`UtilizationAccumulator`).

Ports of the reference package's modules of the same names; drift is a
framework-free copy, and trace one that also records each span's thread
CPU time and OS thread id.
"""
from .drift import DriftAccumulator
from .profile import (LaneFootprint, UtilizationAccumulator,
                      lane_footprint, lane_footprints, lane_traffic,
                      launch_traffic, tensor_lane_bytes)
from .trace import (NOOP_SPAN, Span, SpanContext, Tracer, current,
                    current_ctx, current_tracer, span)

__all__ = [
    "DriftAccumulator", "LaneFootprint", "NOOP_SPAN", "Span",
    "SpanContext", "Tracer", "UtilizationAccumulator", "current",
    "current_ctx", "current_tracer", "lane_footprint", "lane_footprints",
    "lane_traffic", "launch_traffic", "span", "tensor_lane_bytes",
]

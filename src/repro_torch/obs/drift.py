"""Perf-model drift: measured vs estimated lane times, per kind.

Every traced executor run (and every ``time_lanes`` calibration pass)
produces (pipeline kind, model estimate, measured seconds) samples.
:class:`DriftAccumulator` aggregates them into the drift report that
ROADMAP item 1 (device-spec-calibrated autotuning) needs: if the
``little`` ratio sits at 2.0 while ``big`` sits at 1.1, the model's
Little-pipeline coefficients are what recalibration should move.

Accumulators chain: an Executor-local accumulator forwards samples to
the service-level one (``parent=``), so per-executor detail and the
fleet-wide report come from the same stream.

Report fields per kind (see docs/OBSERVABILITY.md):

``n``              samples seen
``est_s``          total estimated seconds
``measured_s``     total measured seconds
``ratio``          measured_s / est_s  (the headline drift figure)
``ratio_p50``      median of recent per-sample ratios (window)
``ratio_min/max``  extremes over the window
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, Optional

__all__ = ["DriftAccumulator"]


class DriftAccumulator:
    """Thread-safe measured-vs-estimated aggregator keyed by kind.

    Kinds in practice: ``little`` / ``big`` (per-lane samples, lanes
    mixing entry kinds report ``mixed``) and ``makespan`` (whole
    iterations vs the plan's ``est_makespan``).
    """

    def __init__(self, parent: Optional["DriftAccumulator"] = None,
                 window: int = 512):
        self._parent = parent
        self._window = int(window)
        self._lock = threading.Lock()
        self._tot: Dict[str, Dict[str, float]] = {}
        self._recent: Dict[str, deque] = {}

    def set_parent(self, parent: Optional["DriftAccumulator"]) -> None:
        """(Re)chain this accumulator to a parent sink. The autotune
        layer uses this to splice its own clearable accumulator above
        an already-constructed service-level one — executors keep
        chaining to the service accumulator, samples keep flowing up."""
        if parent is self:
            raise ValueError("a DriftAccumulator cannot parent itself")
        self._parent = parent

    def add(self, kind: str, est_s: float, measured_s: float) -> None:
        """Record one sample. Samples with a non-positive estimate are
        counted but excluded from ratio statistics."""
        est_s = float(est_s)
        measured_s = float(measured_s)
        with self._lock:
            tot = self._tot.get(kind)
            if tot is None:
                tot = self._tot[kind] = {"n": 0, "est_s": 0.0,
                                         "measured_s": 0.0}
                self._recent[kind] = deque(maxlen=self._window)
            tot["n"] += 1
            tot["est_s"] += max(0.0, est_s)
            tot["measured_s"] += max(0.0, measured_s)
            if est_s > 0.0:
                self._recent[kind].append(measured_s / est_s)
        if self._parent is not None:
            self._parent.add(kind, est_s, measured_s)

    def report(self) -> Dict[str, Dict[str, Any]]:
        """Per-kind drift summary; empty dict when no samples yet."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for kind, tot in self._tot.items():
                ratios = sorted(self._recent[kind])
                entry: Dict[str, Any] = {
                    "n": int(tot["n"]),
                    "est_s": tot["est_s"],
                    "measured_s": tot["measured_s"],
                    "ratio": (tot["measured_s"] / tot["est_s"]
                              if tot["est_s"] > 0 else None),
                }
                if ratios:
                    entry["ratio_p50"] = ratios[len(ratios) // 2]
                    entry["ratio_min"] = ratios[0]
                    entry["ratio_max"] = ratios[-1]
                out[kind] = entry
        return out

    def clear(self) -> None:
        with self._lock:
            self._tot.clear()
            self._recent.clear()

"""Online calibrator: folds measured lane timings into perf-model fits.

Executors attached to a Calibrator (``Executor(..., calibrator=...)``)
push one sample per measured lane — from traced runs and from
``time_lanes`` sweeps alike — as ``(feature row, kind, seconds)``.
The feature row is the lane's summed unit-coefficient model terms
(:func:`repro_torch.core.perf_model.lane_feature_rows`), which depend only on
the plan and the base HW rate constants, NOT on the calibrated
multipliers — so samples taken under different calibration generations
remain mutually consistent and accumulate evidence across retunes.

``fit`` delegates to :func:`repro_torch.core.perf_model.fit_terms`, which
guards against underdetermined systems (min samples per pipeline class,
regularised toward the prior, residual check) and returns the fit
diagnostics alongside the calibrated HW.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Any, Dict, Optional, Sequence

import numpy as np

from ..core import perf_model

__all__ = ["Calibrator", "CalibrationFit"]


@dataclasses.dataclass
class CalibrationFit:
    hw: perf_model.HW
    diag: Dict[str, Any]

    @property
    def ok(self) -> bool:
        return self.diag.get("fallback") is None


class Calibrator:
    """Thread-safe bounded ring of lane calibration samples + guarded fit.

    ``window`` bounds memory; ``min_per_class`` / ``min_samples`` gate
    when a fit is even attempted (and are re-checked inside ``fit_terms``
    per design-matrix column).
    """

    def __init__(self, window: int = 2048, min_samples: int = 6,
                 min_per_class: int = 3, max_cond: float = 1e8,
                 max_residual: float = 0.75):
        self._lock = threading.Lock()
        self._samples: deque = deque(maxlen=int(window))
        self.min_samples = int(min_samples)
        self.min_per_class = int(min_per_class)
        self.max_cond = float(max_cond)
        self.max_residual = float(max_residual)
        self._n_total = 0   # lifetime count (ring may have evicted)

    def add_lane(self, row: Sequence[float], kind: str,
                 measured_s: float) -> None:
        measured_s = float(measured_s)
        if measured_s <= 0.0:
            return
        row = np.asarray(row, dtype=np.float64)
        with self._lock:
            self._samples.append((row, str(kind), measured_s))
            self._n_total += 1

    def counts(self) -> Dict[str, int]:
        """Sample counts: total in window, and per pipeline class (a
        mixed lane counts toward both classes — its row has both edge
        columns populated)."""
        with self._lock:
            rows = list(self._samples)
        little = sum(1 for r, _, _ in rows if r[0] > 0.0)
        big = sum(1 for r, _, _ in rows if r[1] > 0.0)
        return {"n": len(rows), "n_total": self._n_total,
                "little": little, "big": big}

    def ready(self) -> bool:
        c = self.counts()
        if c["n"] < self.min_samples:
            return False
        return (c["little"] >= self.min_per_class
                or c["big"] >= self.min_per_class)

    def fit(self, prior_hw: perf_model.HW) -> Optional[CalibrationFit]:
        """Fit calibrated multipliers against the window; returns None
        when there is nothing to fit yet. The returned fit may still be
        a guarded fallback (``fit.ok`` False) when the system was
        underdetermined or the residual too large — the caller decides
        whether a fallback is worth acting on."""
        with self._lock:
            samples = list(self._samples)
        if len(samples) < self.min_samples:
            return None
        rows = [r for r, _, _ in samples]
        ys = [y for _, _, y in samples]
        hw, diag = perf_model.fit_terms(
            rows, ys, prior_hw, min_per_class=self.min_per_class,
            max_cond=self.max_cond, max_residual=self.max_residual)
        return CalibrationFit(hw=hw, diag=diag)

    def clear(self) -> None:
        with self._lock:
            self._samples.clear()

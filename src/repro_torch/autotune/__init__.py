"""Autotune: device-spec registry, online calibration, drift-driven
re-planning — the port of the reference package's ``autotune``.

- :mod:`.specs` — persisted, versioned calibrated HW constants keyed by
  (device kind — the card's name and the host —, Geometry).
- :mod:`.calibrator` — folds measured lane timings into guarded
  ``perf_model.fit_terms`` fits.
- :mod:`.retuner` — the drift-watching policy that recalibrates,
  re-searches the plan space and atomically swaps plans into the store.

The analytic prior is ``perf_model.DEFAULT_HW``; on the card the fit
sees lane times measured there.
"""
from .calibrator import CalibrationFit, Calibrator
from .retuner import AutoTuner, RetunePolicy, candidate_configs, search_plan
from .specs import (DeviceSpec, SpecRegistry, default_device_kind,
                    geometry_key, hw_from_dict, hw_to_dict)

__all__ = [
    "AutoTuner",
    "CalibrationFit",
    "Calibrator",
    "DeviceSpec",
    "RetunePolicy",
    "SpecRegistry",
    "candidate_configs",
    "default_device_kind",
    "geometry_key",
    "hw_from_dict",
    "hw_to_dict",
    "search_plan",
]

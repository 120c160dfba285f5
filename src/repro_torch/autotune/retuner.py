"""Retuner: drift-triggered recalibration and adaptive re-planning.

The :class:`AutoTuner` closes the model-guided loop: the perf model
plans, the card's measured lane times refit it, and the plan follows.
It owns a clearable :class:`~repro_torch.obs.drift.DriftAccumulator` spliced
ABOVE the service-level one (``metrics.drift.set_parent(tuner.drift)``),
so every measured sample — per-lane from traced runs and ``time_lanes``
sweeps, per-iteration makespans from every run — flows into its window.
When the per-kind ``ratio_p50`` crosses the policy threshold (with
hysteresis after a retune, plus a cooldown), the tuner:

1. runs a ``time_lanes`` calibration sweep (feeding the Calibrator),
2. fits new HW multipliers (:meth:`Calibrator.fit`, guarded),
3. re-derives the plan under the new HW: ``classify()`` re-runs inside
   ``Planner.build`` for every candidate ``PlanConfig`` (model mode plus
   the fixed M:N sweep), each scored by its LPT ``est_makespan``,
4. atomically publishes the winner: the rebuilt bundle is inserted into
   the store's plan LRU under its quantized-HW cache key BEFORE the
   tuner's current HW flips, so a submit that races the retune either
   sees the old (config, plan) pair or the new one — never a mix,
5. persists the calibrated spec to the :class:`~.specs.SpecRegistry`
   with a bumped version.

In-flight executors keep their old plans (equal results either way:
bit for bit for min/max/or apps, to fp32 rounding for sum apps, whose
in-edge sums a new plan may group differently); new submits resolve
through :meth:`AutoTuner.resolve_config` and pick up the calibrated HW +
best split.

On the card every measured lane time is the host clock around the
lane's kernel launches (and the Big gathers before them), ended by a
device synchronize (``Executor.time_lanes``): the launch overhead and
the host's dispatch are part of what the fit sees.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..core import perf_model
from ..core.planner import PlanConfig, Planner
from ..core.types import Geometry
from ..kernels import ops
from ..obs.drift import DriftAccumulator
from .calibrator import Calibrator
from .specs import DeviceSpec, SpecRegistry, default_device_kind, geometry_key

__all__ = ["RetunePolicy", "AutoTuner", "candidate_configs", "search_plan"]


@dataclasses.dataclass
class RetunePolicy:
    """When to trip a retune.

    A kind trips when its windowed ``ratio_p50`` (measured/estimated)
    leaves ``[1/drift_threshold, drift_threshold]`` with at least
    ``min_samples`` ratio samples. After a retune the effective
    threshold is widened by ``hysteresis`` until drift is observed back
    inside the base band once (re-arming), and no retune fires within
    ``cooldown_s`` of the previous one.
    """

    drift_threshold: float = 1.5
    min_samples: int = 8
    cooldown_s: float = 30.0
    hysteresis: float = 1.3
    kinds: Tuple[str, ...] = ("little", "big", "mixed", "makespan")

    def __post_init__(self):
        if self.drift_threshold <= 1.0:
            raise ValueError("drift_threshold must be > 1")
        if self.hysteresis < 1.0:
            raise ValueError("hysteresis must be >= 1")


def _worst_kind(report: Dict[str, Dict[str, Any]], kinds, threshold: float,
                min_samples: int) -> Optional[Tuple[str, float]]:
    """The kind whose p50 drift ratio is furthest outside the band, or
    None if every (sufficiently sampled) kind is inside."""
    worst = None
    for kind in kinds:
        entry = report.get(kind)
        if not entry or entry.get("n", 0) < min_samples:
            continue
        r = entry.get("ratio_p50", entry.get("ratio"))
        if not r or r <= 0:
            continue
        sev = max(r, 1.0 / r)   # symmetric: 2x slow == 2x fast
        if sev > threshold and (worst is None or sev > worst[1]):
            worst = (kind, sev)
    return worst


def candidate_configs(base: PlanConfig, hw: perf_model.HW,
                      include_monolithic: bool = False) -> List[PlanConfig]:
    """The retune search space: model mode plus the fixed M:N lane-split
    sweep (paper Fig. 10) under the freshly calibrated HW. Interior
    fixed splits keep the model classification (only lane allocation is
    forced), so their blockings are shared with the model candidate and
    scoring them is cheap. The monolithic baseline re-blocks everything
    through Big and is opt-in."""
    n = base.n_lanes
    cands = [PlanConfig(mode="model", n_lanes=n, hw=hw)]
    for m in range(1, n):
        cands.append(PlanConfig(mode="fixed", forced_little=m,
                                forced_big=n - m, n_lanes=n, hw=hw))
    if include_monolithic:
        cands.append(PlanConfig(mode="monolithic", n_lanes=n, hw=hw))
    return cands


def search_plan(store, base: PlanConfig, hw: perf_model.HW,
                include_monolithic: bool = False):
    """Score every candidate by its LPT plan's ``est_makespan`` (built
    via Planner directly — losers never pollute the store's plan LRU)
    and return ``(best_config, best_bundle, scores)``."""
    best = None
    scores: List[Dict[str, Any]] = []
    for cfg in candidate_configs(base, hw, include_monolithic):
        bundle = Planner(store, cfg).build()
        est = float(bundle.plan.est_makespan)
        scores.append({"mode": cfg.mode,
                       "split": f"{cfg.forced_little}:{cfg.forced_big}"
                       if cfg.mode == "fixed" else None,
                       "est_makespan": est})
        if best is None or est < best[2]:
            best = (cfg, bundle, est)
    assert best is not None
    return best[0], best[1], scores


class AutoTuner:
    """Drift-watching calibrate-and-replan policy for a GraphService.

    ``registry=None`` uses the default :class:`SpecRegistry` (persist
    specs across processes); ``registry=False`` disables persistence.
    ``device`` is the device whose lane times the tuner fits (default
    ``cuda``; raises when there is no CUDA device and ``device="cpu"``
    was not passed); ``device_kind`` defaults to its
    :func:`~.specs.default_device_kind`, the key of its specs.
    """

    def __init__(self, policy: Optional[RetunePolicy] = None,
                 calibrator: Optional[Calibrator] = None,
                 registry=None, device_kind: Optional[str] = None,
                 sweep_repeats: int = 3, time_repeats: int = 2,
                 include_monolithic: bool = False,
                 max_events: int = 64, device=None):
        self.policy = policy or RetunePolicy()
        self.calibrator = calibrator or Calibrator()
        self.registry: Optional[SpecRegistry]
        if registry is False:
            self.registry = None
        else:
            self.registry = registry or SpecRegistry()
        self.device = ops.resolve_device(device)
        self.device_kind = device_kind or default_device_kind(self.device)
        self.sweep_repeats = int(sweep_repeats)      # time_lanes calls
        self.time_repeats = int(time_repeats)        # repeats per call
        self.include_monolithic = bool(include_monolithic)
        # the tuner-scope drift window (cleared at each retune); splice
        # with metrics.drift.set_parent(self.drift)
        self.drift = DriftAccumulator()
        self.hw: Optional[perf_model.HW] = None      # current calibrated HW
        self.version = 0
        self.calibrated_at: Optional[float] = None
        self.retunes = 0
        self.fit_rejects = 0
        self.events: List[Dict[str, Any]] = []
        self._max_events = int(max_events)
        self._best_cfg: Dict[Any, PlanConfig] = {}   # per graph skey
        self._lock = threading.RLock()
        self._last_retune_mono = -math.inf
        self._armed = True

    # -- startup ------------------------------------------------------
    def load(self, geom: Geometry) -> Optional[DeviceSpec]:
        """Adopt the persisted spec for (device kind, geom), if any.
        Returns the spec when one was adopted."""
        if self.registry is None:
            return None
        spec = self.registry.get(self.device_kind, geom)
        if spec is None or spec.source == "analytic":
            return None
        with self._lock:
            self.hw = spec.hw
            self.version = spec.version
            self.calibrated_at = spec.created_at
        return spec

    # -- submit-path hook ---------------------------------------------
    def resolve_config(self, config: PlanConfig,
                       skey=None) -> PlanConfig:
        """Rewrite a default-shaped config to the current calibrated HW
        (and, in model mode, to the last search winner for this graph).
        Configs carrying an explicit user HW (anything that is not the
        ``perf_model.DEFAULT_HW`` module singleton) pass through untouched
        — autotuning never overrides a caller's model."""
        if config.hw is not perf_model.DEFAULT_HW:
            return config
        with self._lock:
            if self.hw is None:
                return config
            best = self._best_cfg.get(skey) if skey is not None else None
            if (best is not None and config.mode == "model"
                    and best.n_lanes == config.n_lanes
                    and best.hw is self.hw):
                return best
            return dataclasses.replace(config, hw=self.hw)

    # -- drift policy -------------------------------------------------
    def _trip(self) -> Optional[Tuple[str, float]]:
        """Policy check against the tuner's own drift window. Handles
        re-arming: after a retune the band widens by ``hysteresis``
        until drift is observed back inside the base band."""
        pol = self.policy
        report = self.drift.report()
        base = _worst_kind(report, pol.kinds, pol.drift_threshold,
                           pol.min_samples)
        with self._lock:
            if not self._armed:
                if base is None and any(
                        report.get(k, {}).get("n", 0) >= pol.min_samples
                        for k in pol.kinds):
                    self._armed = True    # back in band: re-arm
                else:
                    wide = pol.drift_threshold * pol.hysteresis
                    return _worst_kind(report, pol.kinds, wide,
                                       pol.min_samples)
            return base

    def _cooldown_ok(self) -> bool:
        return (time.monotonic() - self._last_retune_mono
                >= self.policy.cooldown_s)

    def should_retune(self) -> Optional[Tuple[str, float]]:
        """(kind, severity) when policy + cooldown say retune now."""
        trip = self._trip()
        if trip is None or not self._cooldown_ok():
            return None
        return trip

    # -- the retune itself --------------------------------------------
    def observe(self, store, executor, config: PlanConfig,
                skey=None) -> Optional[Dict[str, Any]]:
        """Post-execution hook: retune iff the policy trips. Non-blocking
        under contention — a concurrent retune makes this a no-op."""
        trip = self.should_retune()
        if trip is None:
            return None
        if not self._lock.acquire(blocking=False):
            return None
        try:
            if self.should_retune() is None:   # raced: someone retuned
                return None
            return self.retune(store, executor, config, skey=skey,
                               reason={"kind": trip[0],
                                       "severity": trip[1]})
        finally:
            self._lock.release()

    def retune(self, store, executor, config: PlanConfig, skey=None,
               reason: Optional[Dict[str, Any]] = None,
               force: bool = False) -> Dict[str, Any]:
        """Calibration sweep -> guarded fit -> candidate search -> atomic
        plan swap -> spec persist. Returns an event dict (also appended
        to ``self.events``); ``event["applied"]`` tells whether a new
        calibration took effect."""
        with self._lock:
            t0 = time.perf_counter()
            event: Dict[str, Any] = {
                "reason": reason or ({"kind": "manual"} if force
                                     else {"kind": "unknown"}),
                "applied": False,
            }
            # 1. calibration sweep — executor feeds self.calibrator.
            # Adaptive: small plans have few lanes, so keep sweeping
            # (bounded) until the calibrator can even attempt a fit.
            max_sweeps = max(self.sweep_repeats, 2 * self.calibrator.min_samples)
            for i in range(max_sweeps):
                executor.time_lanes(repeats=self.time_repeats)
                if (i + 1 >= self.sweep_repeats
                        and self.calibrator.counts()["n"]
                        >= self.calibrator.min_samples):
                    break
            # 2. guarded fit (prior = current calibrated HW, else the
            # bundle's — both carry the same base rate constants)
            prior = self.hw or executor.bundle.config.hw
            fit = self.calibrator.fit(prior)
            self._last_retune_mono = time.monotonic()
            if fit is None or not fit.ok:
                self.fit_rejects += 1
                event["fit"] = fit.diag if fit is not None else None
                event["rejected"] = ("no_fit" if fit is None
                                     else fit.diag.get("fallback"))
                self._push_event(event)
                return event
            new_hw = fit.hw
            event["fit"] = fit.diag
            # 3. candidate search under the new HW
            best_cfg, best_bundle, scores = search_plan(
                store, config, new_hw,
                include_monolithic=self.include_monolithic)
            event["candidates"] = scores
            event["chosen"] = {"mode": best_cfg.mode,
                               "split": (f"{best_cfg.forced_little}:"
                                         f"{best_cfg.forced_big}"
                                         if best_cfg.mode == "fixed"
                                         else None),
                               "est_makespan":
                                   float(best_bundle.plan.est_makespan)}
            # 4. atomic swap: cache the rebuilt bundle FIRST, then flip
            # the tuner's HW — racing submits see old or new, never torn
            store.adopt_plan(best_bundle)
            self.hw = new_hw
            self.version += 1
            self.calibrated_at = time.time()
            if skey is not None:
                self._best_cfg[skey] = best_cfg
            self.retunes += 1
            self._armed = False          # hysteresis until back in band
            self.drift.clear()           # judge the NEW model from zero
            # 5. persist the spec
            if self.registry is not None:
                try:
                    spec = DeviceSpec(
                        device_kind=self.device_kind,
                        geom_key=geometry_key(store.geom),
                        hw=new_hw, version=self.version,
                        created_at=self.calibrated_at,
                        source="calibrated", fit=fit.diag)
                    event["spec_path"] = self.registry.put(spec)
                except OSError:
                    event["spec_path"] = None   # persistence is advisory
            event["applied"] = True
            event["t_retune_s"] = time.perf_counter() - t0
            self._push_event(event)
            return event

    def _push_event(self, event: Dict[str, Any]) -> None:
        self.events.append(event)
        if len(self.events) > self._max_events:
            del self.events[:len(self.events) - self._max_events]

    # -- introspection ------------------------------------------------
    def calibration_info(self) -> Dict[str, Any]:
        """Small dict for metrics: version / age / retune counters."""
        with self._lock:
            age = (time.time() - self.calibrated_at
                   if self.calibrated_at else None)
            return {"version": self.version, "age_s": age,
                    "retunes": self.retunes,
                    "fit_rejects": self.fit_rejects}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            info = {
                "device_kind": self.device_kind,
                "version": self.version,
                "calibrated_at": self.calibrated_at,
                "retunes": self.retunes,
                "fit_rejects": self.fit_rejects,
                "armed": self._armed,
                "policy": dataclasses.asdict(self.policy),
                "samples": self.calibrator.counts(),
                "drift": self.drift.report(),
                "events": list(self.events[-8:]),
            }
            if self.hw is not None:
                info["hw"] = {
                    "c_edges": self.hw.c_edges,
                    "c_edges_big": self.hw.c_edges_big,
                    "c_vertices": self.hw.c_vertices,
                    "c_compute": self.hw.c_compute,
                    "c_store": self.hw.c_store,
                    "t_const": self.hw.t_const,
                    "combine": self.hw.combine,
                }
            return info

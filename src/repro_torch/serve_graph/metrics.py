"""Serving metrics: per-request latency breakdown + service counters.

Every request carries a :class:`RequestMetrics` record filled in as it
moves through the service (queue wait → store build/fetch → plan →
execute); :class:`ServiceMetrics` aggregates them into hit/miss
counters and bounded latency reservoirs with percentile queries. All
mutation is lock-guarded — worker threads record concurrently.

Two export forms feed the control plane's ``GET /metrics`` endpoint
and the benchmark artifact dumps: :meth:`ServiceMetrics.snapshot_json`
(the snapshot dict as JSON) and :meth:`ServiceMetrics.render_prometheus`
(Prometheus text exposition — counters, gauges, and the stage latency
percentiles as ``quantile``-labeled gauges, with per-tenant admission
outcomes as labeled series).
"""
from __future__ import annotations

import dataclasses
import json
import threading
from collections import deque
from typing import Deque, Dict, Optional

from ..obs import DriftAccumulator, UtilizationAccumulator

__all__ = ["RequestMetrics", "ServiceMetrics", "merge_expositions"]


def _escape_label(v) -> str:
    """Escape a label VALUE per the Prometheus text exposition grammar:
    backslash, double-quote and newline must be escaped (backslash
    first, or the other escapes get double-escaped)."""
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def merge_expositions(*texts: str) -> str:
    """Merge Prometheus text expositions into one valid document.

    The control plane concatenates ``ServiceMetrics.render_prometheus``
    with its own scheduler/pool/job blocks; a metric family appearing
    in more than one input would then carry duplicate ``# HELP`` /
    ``# TYPE`` headers (invalid — parsers reject repeated metadata).
    This groups samples by family, keeps the FIRST help/type header of
    each, and preserves first-appearance family order."""
    help_: Dict[str, str] = {}
    type_: Dict[str, str] = {}
    samples: Dict[str, list] = {}
    for text in texts:
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                parts = line.split(None, 3)
                if len(parts) < 3:
                    continue
                name = parts[2]
                target = help_ if parts[1] == "HELP" else type_
                target.setdefault(name, line)
                samples.setdefault(name, [])
            elif line.startswith("#"):
                continue
            else:
                name = line.split("{", 1)[0].split(" ", 1)[0]
                samples.setdefault(name, []).append(line)
    out = []
    for name, lines in samples.items():
        if name in help_:
            out.append(help_[name])
        if name in type_:
            out.append(type_[name])
        out.extend(lines)
    return "\n".join(out) + "\n"


@dataclasses.dataclass
class RequestMetrics:
    """Latency breakdown and cache outcomes of one serviced request.
    Times are milliseconds; ``None`` means the stage never ran (e.g. a
    failed request, or a coalesced duplicate that piggybacked on
    another request's execution). Coalesced duplicates still carry
    their own end-to-end ``t_total_ms`` and the hit flags of the
    execution that produced their result."""

    request_id: int
    app: str
    fingerprint: str
    tenant: str = "default"
    coalesced: bool = False           # attached to an in-flight twin job
    store_hit: Optional[bool] = None
    plan_hit: Optional[bool] = None
    t_queue_ms: Optional[float] = None    # submit -> worker pickup
    t_store_ms: Optional[float] = None    # GraphStore fetch-or-build
    t_plan_ms: Optional[float] = None     # Planner (cache hit ~ 0)
    t_execute_ms: Optional[float] = None  # Executor materialize + run
    t_total_ms: Optional[float] = None    # submit -> result available
    error: Optional[str] = None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Reservoir:
    """Bounded sample reservoir (keeps the most recent ``maxlen``)."""

    def __init__(self, maxlen: int = 2048):
        self._samples: Deque[float] = deque(maxlen=maxlen)

    def add(self, x: float) -> None:
        self._samples.append(float(x))

    def __len__(self) -> int:
        return len(self._samples)

    def percentile(self, p: float) -> Optional[float]:
        """Nearest-rank percentile of the retained samples (p in
        [0, 100]); None when empty."""
        if not self._samples:
            return None
        xs = sorted(self._samples)
        rank = max(0, min(len(xs) - 1, int(round(p / 100.0 * (len(xs) - 1)))))
        return xs[rank]

    def mean(self) -> Optional[float]:
        if not self._samples:
            return None
        return sum(self._samples) / len(self._samples)


class ServiceMetrics:
    """Aggregate counters + latency distributions for a GraphService."""

    STAGES = ("queue", "store", "plan", "execute", "total", "update")

    def __init__(self, reservoir_size: int = 2048):
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.executions = 0          # jobs actually run (post-coalescing)
        self.coalesced = 0           # requests that rode an in-flight job
        self.store_hits = 0
        self.store_misses = 0
        self.plan_hits = 0
        self.plan_misses = 0
        self.store_evictions = 0
        self.executor_evictions = 0
        # streaming delta updates (GraphService.update)
        self.updates = 0
        self.update_failures = 0
        self.updates_deferred = 0     # applied lazily (store not cached)
        self.stores_retired = 0       # old snapshots re-keyed out
        self.plans_rebuilt = 0
        self.packed_lanes_reused = 0
        self.packed_lanes_repacked = 0
        self.packed_bytes_reused = 0
        # streaming lifecycle: drift-triggered DBG re-registrations,
        # delta-chain compactions, placement-drift re-placements
        self.regroups = 0
        self.compactions = 0
        self.placements_rebalanced = 0
        self._chain_depth_fn = None   # wired by the service
        # control-plane admission outcomes
        self.rejected_queue_full = 0
        self.rejected_quota = 0
        self.shed_deadline = 0        # expired-deadline jobs load-shed
        # tenant -> outcome counters (submitted/completed/failed/
        # coalesced/rejected/shed); bounds itself to tenants seen
        self._tenants: Dict[str, Dict[str, int]] = {}
        self._stage: Dict[str, _Reservoir] = {
            s: _Reservoir(reservoir_size) for s in self.STAGES}
        self._queue_depth_fn = None  # wired by the service
        # drift-triggered recalibrations (repro_torch.autotune); the gauge
        # details (version, age) come from the pull hook below
        self.retunes = 0
        self._calibration_info_fn = None  # wired when autotune= is on
        # service-level perf-model drift sink: executors chain their
        # per-run accumulators to this one (see repro_torch.obs.drift)
        self.drift = DriftAccumulator()
        # service-level pipeline-utilization sink (repro_torch.obs.profile):
        # executors chain their per-lane achieved-GB/s samples here the
        # same way; feeds the regraph_lane_bandwidth_gbps /
        # regraph_pipeline_utilization gauges and the dashboard bars
        self.utilization = UtilizationAccumulator()

    def _tenant(self, tenant: str) -> Dict[str, int]:
        t = self._tenants.get(tenant)
        if t is None:
            t = self._tenants[tenant] = {
                "submitted": 0, "completed": 0, "failed": 0,
                "coalesced": 0, "rejected": 0, "shed": 0}
        return t

    # -- recording ------------------------------------------------------
    def record_submit(self, coalesced: bool,
                      tenant: str = "default") -> None:
        with self._lock:
            self.submitted += 1
            t = self._tenant(tenant)
            t["submitted"] += 1
            if coalesced:
                self.coalesced += 1
                t["coalesced"] += 1

    def record_rejected(self, kind: str, tenant: str = "default") -> None:
        """Typed admission rejection: ``kind`` is ``"queue_full"`` or
        ``"quota"`` (matching the scheduler's exception types)."""
        with self._lock:
            if kind == "queue_full":
                self.rejected_queue_full += 1
            elif kind == "quota":
                self.rejected_quota += 1
            else:
                raise ValueError(f"unknown rejection kind {kind!r}")
            self._tenant(tenant)["rejected"] += 1

    def record_shed(self, tenant: str = "default") -> None:
        """A queued job's deadline expired before a worker reached it."""
        with self._lock:
            self.shed_deadline += 1
            self._tenant(tenant)["shed"] += 1

    def record_execution(self, store_hit: bool, plan_hit: bool) -> None:
        with self._lock:
            self.executions += 1
            if store_hit:
                self.store_hits += 1
            else:
                self.store_misses += 1
            if plan_hit:
                self.plan_hits += 1
            else:
                self.plan_misses += 1

    def record_eviction(self, n: int = 1) -> None:
        with self._lock:
            self.store_evictions += n

    def record_executor_eviction(self, n: int = 1) -> None:
        """Warm-path executor LRU evictions (count or byte budget)."""
        with self._lock:
            self.executor_evictions += n

    def record_retune(self, n: int = 1) -> None:
        """An applied drift-triggered recalibration + plan swap."""
        with self._lock:
            self.retunes += n

    def _calibration_info(self):
        fn = self._calibration_info_fn
        if fn is None:
            return None
        try:
            return fn()
        except Exception:
            return None

    def record_update(self, t_ms: float, stats: Optional[dict] = None,
                      deferred: bool = False, retired: bool = False) -> None:
        """One GraphService.update: latency plus the apply's
        reuse/invalidation accounting (None when deferred)."""
        with self._lock:
            self.updates += 1
            if deferred:
                self.updates_deferred += 1
            if retired:
                self.stores_retired += 1
            if stats is not None:
                self.plans_rebuilt += stats.get("plans_rebuilt", 0)
                self.packed_lanes_reused += stats.get(
                    "packed_lanes_reused", 0)
                self.packed_lanes_repacked += stats.get(
                    "packed_lanes_repacked", 0)
                self.packed_bytes_reused += stats.get(
                    "packed_bytes_reused", 0)
                self.placements_rebalanced += stats.get(
                    "placements_rebalanced", 0)
            self._stage["update"].add(t_ms)

    def record_update_failure(self) -> None:
        with self._lock:
            self.update_failures += 1

    def record_regroup(self, n: int = 1) -> None:
        """An applied drift-triggered DBG re-registration + store swap."""
        with self._lock:
            self.regroups += n

    def record_compaction(self, n: int = 1) -> None:
        """A delta chain squashed into one composed delta."""
        with self._lock:
            self.compactions += n

    @property
    def max_chain_depth(self) -> int:
        """Deepest registered delta chain (0 without the service hook)."""
        fn = self._chain_depth_fn
        if fn is None:
            return 0
        try:
            return int(fn())
        except Exception:
            return 0

    def record_done(self, m: RequestMetrics) -> None:
        with self._lock:
            t = self._tenant(m.tenant)
            if m.error is None:
                self.completed += 1
                t["completed"] += 1
            else:
                self.failed += 1
                t["failed"] += 1
            if m.coalesced:
                # INVARIANT: a coalesced duplicate never contributes to
                # the per-stage reservoirs — it did not queue, build, or
                # run anything; only its own end-to-end latency counts.
                # The service keeps stage times None on coalesced
                # records, but this guard is the layer that enforces it
                # even if a caller fills them in.
                if m.t_total_ms is not None:
                    self._stage["total"].add(m.t_total_ms)
                return
            for stage, val in (("queue", m.t_queue_ms),
                               ("store", m.t_store_ms),
                               ("plan", m.t_plan_ms),
                               ("execute", m.t_execute_ms),
                               ("total", m.t_total_ms)):
                if val is not None:
                    self._stage[stage].add(val)

    # -- queries --------------------------------------------------------
    def latency_ms(self, stage: str = "total", p: float = 50.0):
        with self._lock:    # workers append concurrently via record_done
            return self._stage[stage].percentile(p)

    @property
    def store_hit_rate(self) -> float:
        n = self.store_hits + self.store_misses
        return self.store_hits / n if n else 0.0

    @property
    def plan_hit_rate(self) -> float:
        n = self.plan_hits + self.plan_misses
        return self.plan_hits / n if n else 0.0

    @property
    def queue_depth(self) -> int:
        fn = self._queue_depth_fn
        return int(fn()) if fn is not None else 0

    def snapshot(self) -> dict:
        with self._lock:
            snap = {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "executions": self.executions,
                "coalesced": self.coalesced,
                "store_hits": self.store_hits,
                "store_misses": self.store_misses,
                "plan_hits": self.plan_hits,
                "plan_misses": self.plan_misses,
                "store_evictions": self.store_evictions,
                "executor_evictions": self.executor_evictions,
                "updates": self.updates,
                "update_failures": self.update_failures,
                "updates_deferred": self.updates_deferred,
                "stores_retired": self.stores_retired,
                "plans_rebuilt": self.plans_rebuilt,
                "packed_lanes_reused": self.packed_lanes_reused,
                "packed_lanes_repacked": self.packed_lanes_repacked,
                "packed_bytes_reused": self.packed_bytes_reused,
                "rejected_queue_full": self.rejected_queue_full,
                "rejected_quota": self.rejected_quota,
                "shed_deadline": self.shed_deadline,
                "retunes": self.retunes,
                "regroups": self.regroups,
                "compactions": self.compactions,
                "placements_rebalanced": self.placements_rebalanced,
                "tenants": {t: dict(c) for t, c in self._tenants.items()},
                "queue_depth": self.queue_depth,
            }
            for s in self.STAGES:
                snap[f"p50_{s}_ms"] = self._stage[s].percentile(50)
                snap[f"p99_{s}_ms"] = self._stage[s].percentile(99)
        snap["store_hit_rate"] = self.store_hit_rate
        snap["plan_hit_rate"] = self.plan_hit_rate
        # OUTSIDE the metrics lock: the hook re-enters the service lock,
        # which other paths take BEFORE this one (record_rejected under
        # submit) — pulling it under our lock would invert the order
        snap["max_chain_depth"] = self.max_chain_depth
        snap["drift"] = self.drift.report()   # its own lock
        snap["utilization"] = self.utilization.report()   # its own lock
        snap["calibration"] = self._calibration_info()
        return snap

    def snapshot_json(self, **extra) -> str:
        """The snapshot (plus any ``extra`` top-level keys — services
        merge cache/scheduler/pool stats in) as a JSON document."""
        snap = self.snapshot()
        snap.update(extra)
        return json.dumps(snap, indent=2, sort_keys=True, default=str)

    def render_prometheus(self, prefix: str = "regraph") -> str:
        """Prometheus text exposition of the snapshot: monotonic counts
        as ``counter``, point-in-time values as ``gauge``, stage latency
        percentiles as ``quantile``-labeled gauges, and the per-tenant
        breakdown as ``tenant``/``outcome``-labeled series."""
        snap = self.snapshot()
        out = []

        def metric(name, mtype, help_, samples):
            out.append(f"# HELP {prefix}_{name} {help_}")
            out.append(f"# TYPE {prefix}_{name} {mtype}")
            for labels, val in samples:
                if val is None:
                    val = "NaN"
                lab = ("{" + ",".join(
                    f'{k}="{_escape_label(v)}"' for k, v in labels)
                    + "}") if labels else ""
                out.append(f"{prefix}_{name}{lab} {val}")

        metric("requests_total", "counter", "Requests by final outcome.",
               [((("outcome", o),), snap[o])
                for o in ("submitted", "completed", "failed", "coalesced")])
        metric("rejected_total", "counter",
               "Admission rejections by typed reason.",
               [((("reason", "queue_full"),), snap["rejected_queue_full"]),
                ((("reason", "quota"),), snap["rejected_quota"])])
        metric("shed_total", "counter",
               "Jobs load-shed after their deadline expired in queue.",
               [((), snap["shed_deadline"])])
        metric("cache_events_total", "counter",
               "Store/plan cache outcomes and evictions.",
               [((("layer", "store"), ("event", "hit")), snap["store_hits"]),
                ((("layer", "store"), ("event", "miss")),
                 snap["store_misses"]),
                ((("layer", "store"), ("event", "eviction")),
                 snap["store_evictions"]),
                ((("layer", "plan"), ("event", "hit")), snap["plan_hits"]),
                ((("layer", "plan"), ("event", "miss")),
                 snap["plan_misses"]),
                ((("layer", "executor"), ("event", "eviction")),
                 snap["executor_evictions"])])
        metric("updates_total", "counter",
               "Streaming delta updates by outcome.",
               [((("outcome", "applied"),), snap["updates"]),
                ((("outcome", "failed"),), snap["update_failures"]),
                ((("outcome", "deferred"),), snap["updates_deferred"])])
        metric("queue_depth", "gauge", "Jobs currently queued.",
               [((), snap["queue_depth"])])
        metric("latency_ms", "gauge",
               "Stage latency percentiles over the sample reservoir.",
               [((("stage", s), ("quantile", q)), snap[f"p{p}_{s}_ms"])
                for s in self.STAGES
                for p, q in ((50, "0.5"), (99, "0.99"))])
        metric("tenant_requests_total", "counter",
               "Per-tenant request outcomes.",
               [((("tenant", t), ("outcome", o)), c)
                for t, cs in sorted(snap["tenants"].items())
                for o, c in cs.items()])
        drift = snap["drift"]
        metric("perf_model_drift", "gauge",
               "Measured/estimated time ratio per pipeline kind "
               "(1.0 = the perf model is exact).",
               [((("kind", k),), rep["ratio"])
                for k, rep in sorted(drift.items())])
        metric("perf_model_drift_samples", "counter",
               "Measured-vs-estimated samples folded into the drift "
               "report, per pipeline kind.",
               [((("kind", k),), rep["n"])
                for k, rep in sorted(drift.items())])
        util_kinds = (snap.get("utilization") or {}).get("kinds") or {}
        metric("lane_bandwidth_gbps", "gauge",
               "Achieved bandwidth per pipeline kind: analytic lane "
               "footprint bytes over measured lane seconds "
               "(repro.obs.profile).",
               [((("kind", k),), rep.get("gbps"))
                for k, rep in sorted(util_kinds.items())])
        metric("pipeline_utilization", "gauge",
               "Achieved bandwidth as a fraction of the calibrated "
               "device peak (HW.peak_bandwidth_gbps), per pipeline "
               "kind.",
               [((("kind", k),), rep.get("utilization"))
                for k, rep in sorted(util_kinds.items())])
        metric("retunes_total", "counter",
               "Applied drift-triggered recalibrations (perf-model "
               "refit + plan re-derivation + atomic swap).",
               [((), snap["retunes"])])
        metric("regroups_total", "counter",
               "Applied grouping-drift re-registrations (fresh DBG "
               "rebuild + atomic store swap).",
               [((), snap["regroups"])])
        metric("compactions_total", "counter",
               "Delta chains squashed into one composed delta.",
               [((), snap["compactions"])])
        metric("placements_rebalanced_total", "counter",
               "Sharded lane placements re-placed from scratch after "
               "keep-pinned drift exceeded the rebalance threshold.",
               [((), snap["placements_rebalanced"])])
        metric("chain_depth", "gauge",
               "Deepest delta chain behind any registered snapshot "
               "(replay length of a cold rebuild).",
               [((), snap["max_chain_depth"])])
        calib = snap.get("calibration")
        if calib is not None:
            metric("calibration_version", "gauge",
                   "Device-spec version of the active calibrated HW "
                   "constants (0 = analytic defaults).",
                   [((), calib.get("version", 0))])
            metric("calibration_age_seconds", "gauge",
                   "Seconds since the active calibration was fitted "
                   "(NaN until the first fit).",
                   [((), calib.get("age_s"))])
        return "\n".join(out) + "\n"

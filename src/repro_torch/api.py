"""Layered public API of the PyTorch / CUDA port.

Three composable layers, as in the reference package:

    GraphStore  — app-independent; DBG relabeling, dst-range
                  partitioning, Little/Big brick blockings (host numpy).
                  Built once per (graph, Geometry); memoizes blockings
                  and plans.
    Planner     — per PlanConfig; classifies partitions with the perf
                  model and builds the lane schedule. Cached on the store.
    Executor    — per (plan, app, device); device payloads and the eager
                  iteration loop (run / time_iteration / time_lanes).
                  ``shard=`` gives the lane-sharded ShardedExecutor
                  instead (each lane on its owner device, one merge).

A prepared graph changes through :mod:`repro_torch.streaming`
(``apply_delta(store, delta)`` → a derived store that reuses every
clean lane's device payloads). Many graphs, apps and tenants are served
through :class:`GraphService` (:mod:`repro_torch.serve_graph`: a
scheduled queue, store and plan caches, coalescing, a process pool for
store builds and delta splices) and managed as jobs, over HTTP too,
through :class:`ControlPlane` (:mod:`repro_torch.control`), and
``GraphService(autotune=...)`` refits the perf model to lane times
measured on the card and re-plans (:mod:`repro_torch.autotune`).

Everything runs on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no ``device="cpu"`` the entry points raise.

Quickstart::

    from repro_torch import api
    from repro_torch.graphs.rmat import rmat

    compiled = api.compile(rmat(12, 16, seed=7), "pagerank", n_lanes=8)
    props, meta = compiled.run()

    sharded = api.compile(None, "pagerank", store=compiled.store,
                          n_lanes=8, shard=2)        # first two cards
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from .autotune import (AutoTuner, Calibrator, DeviceSpec, RetunePolicy,
                       SpecRegistry)
from .control import (ControlPlane, DeadlineExpired, JobRecord,
                      JobScheduler, JobStore, QueueFull, QuotaExceeded,
                      RejectedJob, TenantQuota, WorkerCrashed, WorkerPool,
                      serve_jobs)
from .core.executor import Executor
from .core.gas import (BUILTIN_APPS, GASApp, SCATTER_OPS, make_bfs,
                       make_closeness, make_pagerank, make_sssp, make_wcc)
from .core.perf_model import DEFAULT_HW, HW
from .core.planner import PlanBundle, PlanConfig, Planner
from .core.store import GraphStore
from .core.types import Geometry, SchedulePlan
from .graphs.formats import Graph, fingerprint as graph_fingerprint
from .obs import (DriftAccumulator, LaneFootprint, Span, SpanContext,
                  Tracer, UtilizationAccumulator)
from .serve_graph import (GraphService, GraphStoreCache, RequestHandle,
                          ServiceMetrics, UpdateResult)
from .sharding import (LanePlacement, ShardedExecutor, ShardedLanes,
                       place_lanes)
from .streaming import (GraphDelta, RegroupPolicy, apply_delta,
                        apply_delta_to_graph, chain_fingerprint,
                        compact_deltas, compose_deltas, grouping_drift,
                        grown_num_vertices, make_delta, random_delta,
                        rebuild_plans, reregister, splice_delta)

__all__ = [
    "AutoTuner", "BUILTIN_APPS", "Calibrator", "CompiledApp",
    "ControlPlane", "DEFAULT_HW", "DeadlineExpired", "DeviceSpec",
    "DriftAccumulator", "Executor", "GASApp",
    "Geometry", "Graph", "GraphDelta", "GraphService", "GraphStore",
    "GraphStoreCache", "HW", "JobRecord", "JobScheduler", "JobStore",
    "LaneFootprint", "LanePlacement", "PlanBundle",
    "PlanConfig", "Planner", "QueueFull", "QuotaExceeded",
    "RegroupPolicy", "RejectedJob", "RequestHandle", "RetunePolicy",
    "SCATTER_OPS", "SchedulePlan", "ServiceMetrics", "ShardedExecutor",
    "ShardedLanes", "SpecRegistry",
    "Span", "SpanContext", "TenantQuota", "Tracer", "UpdateResult",
    "UtilizationAccumulator", "WorkerCrashed", "WorkerPool",
    "apply_delta", "apply_delta_to_graph", "chain_fingerprint",
    "compact_deltas", "compile", "compose_deltas", "graph_fingerprint",
    "grouping_drift", "grown_num_vertices", "make_bfs", "make_closeness",
    "make_delta", "make_pagerank", "make_sssp", "make_wcc",
    "place_lanes", "random_delta", "rebuild_plans", "reregister",
    "serve_jobs", "splice_delta",
]


@dataclasses.dataclass
class CompiledApp:
    """The result of :func:`compile`: one app bound to a (possibly
    shared) GraphStore and a cached plan, ready to run. ``executor`` is
    an :class:`Executor` or — under ``compile(shard=...)`` — a
    :class:`ShardedExecutor` (same run/time_iteration/stats surface;
    ``time_lanes`` exists only on the single-device form)."""

    store: GraphStore
    executor: Union[Executor, ShardedExecutor]

    @property
    def app(self) -> GASApp:
        return self.executor.app

    @property
    def config(self) -> PlanConfig:
        return self.executor.bundle.config

    @property
    def plan(self) -> SchedulePlan:
        return self.executor.plan

    def run(self, max_iters: Optional[int] = None, collect_history=False):
        return self.executor.run(max_iters=max_iters,
                                 collect_history=collect_history)

    def time_iteration(self, repeats: int = 5) -> float:
        return self.executor.time_iteration(repeats=repeats)

    def time_lanes(self, repeats: int = 3):
        return self.executor.time_lanes(repeats=repeats)

    def stats(self) -> dict:
        return self.executor.stats()


def compile(
    graph: Optional[Graph],
    app: Union[GASApp, str],
    *,
    geom: Optional[Geometry] = None,
    config: Optional[PlanConfig] = None,
    store: Optional[GraphStore] = None,
    path: Optional[str] = None,
    use_dbg: Optional[bool] = None,
    fuse_lanes: bool = True,
    device=None,
    shard=None,
    **cfg,
) -> CompiledApp:
    """Push-button entry point: prepare (or reuse) a GraphStore, plan,
    and materialize an executor for one app on ``device`` (default
    ``cuda``; raises when there is none and ``device="cpu"`` was not
    passed).

    ``app`` may be a :class:`GASApp` or a builtin name ("pagerank",
    "bfs", "sssp", "wcc", "closeness"). Extra keyword arguments become
    :class:`PlanConfig` fields (``n_lanes``, ``mode``, ``hw``,
    ``forced_little``, ``forced_big``). Pass ``store=`` to amortize
    preprocessing across apps; ``graph`` may then be None. ``path`` is
    "cuda" (the GAS kernel) or "ref" (the plain PyTorch version);
    ``fuse_lanes=False`` launches once per plan entry instead of once
    per packed lane (bit-identical results). ``shard`` runs the plan
    lane-sharded (:class:`~repro_torch.sharding.ShardedExecutor`):
    ``True`` over every CUDA device, an int n over the first n, a device
    sequence over exactly those (repeats allowed); it names the devices,
    so it excludes ``device``.
    """
    if isinstance(app, str):
        if app not in BUILTIN_APPS:
            raise ValueError(f"unknown builtin app {app!r}; available: "
                             f"{sorted(BUILTIN_APPS)}")
        app = BUILTIN_APPS[app]()
    if config is not None and cfg:
        raise ValueError("pass either config= or PlanConfig kwargs, not both")
    if config is None:
        config = PlanConfig(**cfg)
    if store is None:
        if graph is None:
            raise ValueError("compile() needs a graph when no store= given")
        store = GraphStore(graph, geom=geom or Geometry(),
                           use_dbg=use_dbg if use_dbg is not None else True)
    else:
        # a shared store fixes graph/geometry/DBG — reject contradictions
        store.validate_compatible(graph=graph, geom=geom, use_dbg=use_dbg)
    return CompiledApp(store=store,
                       executor=store.executor(app, config, path=path,
                                               fuse_lanes=fuse_lanes,
                                               device=device, shard=shard))

"""GraphService — multi-tenant serving front-end over the layered API.

The service turns the library's GraphStore → Planner → Executor stack
into a long-lived system: requests (graph-or-fingerprint, app, config)
go into a scheduled queue, worker threads drain it, and two cache
layers do the heavy lifting — a byte-budgeted LRU of GraphStores
across graphs (:class:`~.store_cache.GraphStoreCache`) and each
store's bounded plan LRU within a graph. Identical in-flight requests
are coalesced: N concurrent PageRank submissions on the same graph
execute once and fan the result out to every caller's handle.

Dispatch is model-guided, not FIFO: each job is pushed into a
:class:`~repro_torch.control.scheduler.JobScheduler` with a priority, an
optional deadline, and a cost estimate (a measured per-(store, app)
EWMA when the service has run the job shape before, else the perf
model's ``PlanBundle.plan.est_makespan`` rescaled by an adaptive
calibration factor), so urgent work preempt-orders the queue and
cheap jobs don't starve behind giant builds of equal rank. Admission
is typed — a full queue raises
:class:`~repro_torch.control.scheduler.QueueFull`, an over-quota tenant
:class:`~repro_torch.control.scheduler.QuotaExceeded` — and queued jobs
whose deadline passes are load-shed with
:class:`~repro_torch.control.scheduler.DeadlineExpired` on their handles.

With ``pool=`` set, CPU-heavy store builds and delta splices run in a
:class:`~repro_torch.control.pool.WorkerPool` of separate *processes*, so
their seconds of hot numpy stop stealing GIL timeslices from
``update()`` and from the threads that launch the GAS kernel; plan
rebuilds and execution stay on in-process threads (they hold the CUDA
tensors).

Every executor the service builds runs on the service's ``device``
(default ``cuda``; with no CUDA device and no ``device="cpu"`` the
constructor raises), through the hand-written GAS kernel on a card and
the plain PyTorch version on the CPU.

Quickstart::

    from repro_torch.serve_graph import GraphService

    with GraphService(byte_budget=512 << 20, workers=2) as svc:  # cuda
        h1 = svc.submit(graph, "pagerank", n_lanes=8)
        h2 = svc.submit(graph, "bfs", app_kwargs={"root": 0})
        props, meta = h1.result(timeout=60)

Submission by fingerprint (no graph payload on the hot path)::

    fp = svc.register(graph)          # prepare + remember the graph
    h = svc.submit(fingerprint=fp, app="pagerank")
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import obs
from ..control.pool import WorkerPool
from ..control.scheduler import (DeadlineExpired, JobScheduler, QueueFull,
                                 RejectedJob, TenantQuota)
from ..core.executor import Executor
from ..core.gas import BUILTIN_APPS, GASApp
from ..core.planner import PlanConfig
from ..core.store import LAYOUTS, GraphStore
from ..core.types import Geometry
from ..graphs.formats import Graph
from ..kernels import ops
from ..streaming import (GraphDelta, RegroupPolicy, apply_delta,
                         apply_delta_to_graph, chain_fingerprint,
                         compact_deltas, grouping_drift, rebuild_plans,
                         reregister)
from .fingerprint import StoreKey, resolve_fingerprint, store_key
from .metrics import RequestMetrics, ServiceMetrics
from .store_cache import GraphStoreCache

__all__ = ["GraphService", "RequestHandle", "ServiceClosed", "UpdateResult"]

_SENTINEL = object()


class _LazyGraph:
    """Registry entry for a delta-chained snapshot: the post-delta graph
    is materialized (base graph + delta replay) only if a rebuild is
    actually needed — a store eviction followed by a fingerprint-only
    resubmit — so the update hot path never pays the full-graph apply.
    Once materialized, the chain link collapses to the graph and drops
    its base/delta references."""

    _MAT_LOCK = threading.Lock()   # materialization is rare; one lock
                                   # keeps multi-node chain walks simple

    __slots__ = ("_base", "_delta", "_graph")

    def __init__(self, base, delta: GraphDelta):
        self._base = base          # Graph | _LazyGraph
        self._delta = delta
        self._graph: Optional[Graph] = None

    def materialize(self) -> Graph:
        with self._MAT_LOCK:
            if self._graph is None:
                stack = [self]
                base = self._base
                while isinstance(base, _LazyGraph) and base._graph is None:
                    stack.append(base)
                    base = base._base
                g = base._graph if isinstance(base, _LazyGraph) else base
                for node in reversed(stack):
                    # chained fps are identity, not content: skip fp check
                    g = apply_delta_to_graph(g, node._delta, check_fp=False)
                    node._graph = g
                    node._base = node._delta = None
            return self._graph


@dataclasses.dataclass
class UpdateResult:
    """Outcome of :meth:`GraphService.update`.

    fingerprint: the NEW chained snapshot fingerprint — submit against
        this from now on.
    mode: ``"incremental"`` (cached store spliced in place) or
        ``"deferred"`` (store wasn't cached; the delta was validated
        and applied at graph level, and the STORE builds on the next
        cold submit).
    retired: what happened to the old snapshot's cache entry
        (``"now"`` / ``"deferred"`` until in-flight leases drain /
        ``"absent"``).
    stats: the :class:`~repro_torch.streaming.DeltaApplyResult` accounting
        (None when deferred).
    """

    fingerprint: str
    base_fingerprint: str
    mode: str
    retired: str
    stats: Optional[dict]
    t_update_ms: float
    trace_id: Optional[str] = None   # set when the service has a tracer


class ServiceClosed(RuntimeError):
    """Raised by submit() after close()."""


class RequestHandle:
    """Future-like handle for one submitted request.

    ``result(timeout)`` blocks for (props, meta); ``exception()``
    returns the failure instead of raising. Coalesced duplicates share
    one execution, so their handles resolve to the *same* result
    objects — treat returned arrays as read-only.
    """

    def __init__(self, request_id: int, metrics: RequestMetrics):
        self.request_id = request_id
        self.metrics = metrics
        self._t_submit = time.perf_counter()   # this handle's own clock
        self._event = threading.Event()
        self._result: Optional[tuple] = None
        self._exception: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not done within {timeout}s")
        if self._exception is not None:
            raise self._exception
        return self._result

    def exception(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not done within {timeout}s")
        return self._exception

    # service-side
    def _set_result(self, value: tuple) -> None:
        self._result = value
        self._event.set()

    def _set_exception(self, exc: BaseException) -> None:
        self._exception = exc
        self._event.set()


class _Job:
    """One unit of execution: a coalescing group of identical requests."""

    __slots__ = ("key", "skey", "graph", "app_name", "make_app", "config",
                 "use_dbg", "geom", "max_iters", "path", "shard", "handles",
                 "t_submit", "tenant", "priority", "model_est", "observers",
                 "trace_ctx", "root_span", "queue_span")

    def __init__(self, key, skey: StoreKey, graph: Optional[Graph],
                 app_name: str, make_app, config: PlanConfig,
                 geom: Geometry, use_dbg: bool,
                 max_iters: Optional[int], path: Optional[str],
                 shard=None, tenant: str = "default", priority: int = 0):
        self.key = key
        self.skey = skey
        self.graph = graph
        self.app_name = app_name
        self.make_app = make_app
        self.config = config
        self.geom = geom
        self.use_dbg = use_dbg
        self.max_iters = max_iters
        self.path = path
        self.shard = shard
        self.tenant = tenant          # the FIRST submitter's tenant; the
        self.priority = priority      # scheduler charges only that quota
        self.model_est = None         # est_makespan behind the cost, if any
        # guarded by the service lock: attachment of coalesced twins and
        # the finishing snapshot must be mutually atomic
        self.handles: List[RequestHandle] = []
        self.observers: List = []     # control-plane lifecycle callbacks
        self.t_submit = time.perf_counter()
        # tracing carrier across the queue hand-off: the submitting
        # thread starts these, the draining worker ends/activates them
        self.trace_ctx: Optional[obs.SpanContext] = None
        self.root_span: Optional[obs.Span] = None
        self.queue_span: Optional[obs.Span] = None


class GraphService:
    """Multi-tenant graph-processing service (request queue + caches).

    Parameters
    ----------
    byte_budget / max_stores: forwarded to the internal
        :class:`GraphStoreCache` (ignored when ``cache=`` is given).
    workers: number of draining threads. 1 gives strict FIFO execution;
        more overlap store builds of different graphs.
    device: where every executor of the service runs — default
        ``cuda`` (the current card); raises when there is no CUDA
        device and ``device="cpu"`` was not passed. Each job runs with
        this device current on its worker thread.
    default_geom / default_use_dbg / default_path / default_shard:
        per-request defaults; each submit() may override (``path`` is
        "cuda" or "ref", default the device's — the GAS kernel on a
        card, the plain version on the CPU; ``shard`` selects
        multi-card execution with per-device lane ownership — see
        ``repro_torch.sharding``; ``submit(shard=False)`` opts a single
        request out of a service-wide default).
    max_plans_per_store: bound of each store's plan LRU.
    max_executors: bound of the warm-path Executor LRU. Store and plan
        caches make re-PLANNING cheap; caching executors keyed like
        coalescing keys (store, app, config, path, shard) also lets
        warm repeats skip the executor's set-up (payload lookup, lane
        estimates, the lazily derived footprints and byte counts; each
        shard variant of an otherwise-identical request is its own
        entry). Executors of an evicted store are purged with it (they
        would otherwise keep its device tensors alive behind the byte
        budget's back).
    executor_byte_budget: optional device-byte bound on the same LRU,
        using each Executor's ``memory_footprint()`` (the bundle's
        materialized/packed payload bytes). Executors sharing a plan
        share payloads, so the sum over-attributes shared bytes — it is
        a conservative budget, not an exact accounting. The
        most-recently-inserted executor always stays (a single oversized
        plan must still be servable). NOTE: evicting an executor drops
        its own state immediately, but its payloads stay pinned by
        the store's plan cache until that plan is evicted there — pair
        this budget with ``max_plans_per_store`` (and the store cache's
        ``byte_budget``, which counts those payload bytes) to bound
        actual device memory.
    max_queue_depth: bound on queued jobs; submits past it raise
        :class:`~repro_torch.control.scheduler.QueueFull` (typed, so callers
        can shed or retry). None = unbounded.
    default_quota / quotas: per-tenant token-bucket admission
        (:class:`~repro_torch.control.scheduler.TenantQuota`; ``quotas`` maps
        tenant name to an override). An over-quota submit raises
        :class:`~repro_torch.control.scheduler.QuotaExceeded`. Coalesced
        duplicates attach to the in-flight job without charging quota
        or queue depth.
    pool: CPU offload tier — a
        :class:`~repro_torch.control.pool.WorkerPool`, or an int to have the
        service own one with that many worker processes (closed with
        the service, warmed at construction). When set, store builds
        and delta splices run in worker processes instead of holding
        the GIL under a worker thread.
    max_chain_depth: bound on the delta-chain length behind any
        registered snapshot. An :meth:`update` that pushes a chain past
        it auto-compacts (see :meth:`compact_chain`): the chain's
        deltas are composed into ONE equivalent delta, so a cold
        rebuild after eviction replays O(1) deltas instead of O(chain).
        None = never auto-compact (explicit :meth:`compact_chain`
        still works).
    regroup: grouping-drift repair policy — a
        :class:`~repro_torch.streaming.RegroupPolicy`, True (defaults), or a
        kwargs dict. When set, :meth:`update` tracks cumulative churn
        per served snapshot; once churn passes the policy's floor the
        drift metric runs (:func:`~repro_torch.streaming.grouping_drift`) and
        past its threshold the store is re-registered with a fresh DBG
        grouping (:func:`~repro_torch.streaming.reregister`) and swapped into
        the cache atomically — in the background unless the policy says
        ``sync=True``. None = never regroup automatically
        (:meth:`regroup_now` still works).
    rebalance_threshold: placement-drift bound forwarded to
        :func:`~repro_torch.streaming.rebuild_plans` on every update: a
        sharded lane placement whose max/mean device load exceeds it
        after a ``keep=``-pinned re-placement is dropped and re-placed
        from scratch (fresh LPT, no residency pins). None = keep pins
        regardless of skew.
    autotune: drift-driven autotuning (:mod:`repro_torch.autotune`): an
        :class:`~repro_torch.autotune.AutoTuner`, True (one with
        defaults) or a dict of its keyword arguments; a tuner the
        service builds fits this service's ``device``. The tuner adopts
        the persisted spec of its device kind for ``default_geom``,
        rewrites default-shaped configs on submit to its calibrated HW,
        feeds its calibrator from every single-device executor, and
        after each execution may retune (outside the request's
        latency; a failing retune never fails serving).
    store_layout: ``"padded"`` (default) or ``"stream"``, the layout of
        every store the service builds (``GraphStore(layout=)``).
        ``"stream"`` describes a static graph served for analytics, as
        LDBC Graphalytics serves its graphs: the store keeps live edges
        only, built on the service's ``device``, so graphs whose padded
        blocks would not fit the card can be served. Such a service
        takes no deltas: :meth:`update` and the regroup policy, sharded
        requests and a worker ``pool`` (which builds stores in other
        processes) need padded stores and are refused with a
        ``ValueError``.
    """

    def __init__(self, *, cache: Optional[GraphStoreCache] = None,
                 device=None,
                 byte_budget: Optional[int] = None,
                 max_stores: Optional[int] = None,
                 workers: int = 1,
                 default_geom: Optional[Geometry] = None,
                 default_use_dbg: bool = True,
                 default_path: Optional[str] = None,
                 default_shard=None,
                 max_plans_per_store: Optional[int] = None,
                 max_executors: int = 64,
                 executor_byte_budget: Optional[int] = None,
                 max_queue_depth: Optional[int] = None,
                 default_quota: Optional[TenantQuota] = None,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 pool: Union[WorkerPool, int, None] = None,
                 metrics: Optional[ServiceMetrics] = None,
                 tracer: Optional[obs.Tracer] = None,
                 autotune=None,
                 max_chain_depth: Optional[int] = None,
                 regroup: Union[RegroupPolicy, bool, dict, None] = None,
                 rebalance_threshold: Optional[float] = None,
                 store_layout: str = "padded"):
        if store_layout not in LAYOUTS:
            raise ValueError(f"store_layout must be one of {LAYOUTS}, got "
                             f"{store_layout!r}")
        if store_layout != "padded":
            for what, given in (("pool", pool), ("regroup", regroup),
                                ("default_shard", default_shard)):
                if given not in (None, False):
                    raise ValueError(
                        f"{what}= needs the padded store layout; "
                        f"store_layout={store_layout!r} keeps live edges "
                        f"only (no padded blocks)")
        self.store_layout = store_layout
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if executor_byte_budget is not None and executor_byte_budget < 1:
            raise ValueError("executor_byte_budget must be >= 1, got "
                             f"{executor_byte_budget}")
        if max_chain_depth is not None and max_chain_depth < 1:
            raise ValueError(f"max_chain_depth must be >= 1, got "
                             f"{max_chain_depth}")
        if rebalance_threshold is not None and rebalance_threshold < 1.0:
            # imbalance is max/mean load, >= 1.0 by construction; a
            # threshold below that would re-place on EVERY update
            raise ValueError(f"rebalance_threshold must be >= 1.0, got "
                             f"{rebalance_threshold}")
        self.device = ops.resolve_device(device)
        self.metrics = metrics or ServiceMetrics()
        # optional end-to-end tracing (repro_torch.obs): every job gets a root
        # span carried across the queue/pool boundaries; None = off
        self.tracer = tracer
        self.cache = cache or GraphStoreCache(
            byte_budget=byte_budget, max_stores=max_stores,
            on_evict=self._on_store_evicted)
        self.default_geom = default_geom or Geometry()
        self.default_use_dbg = default_use_dbg
        self.default_path = default_path
        self.default_shard = default_shard
        self.max_plans_per_store = max_plans_per_store
        self.max_executors = max_executors
        self.executor_byte_budget = executor_byte_budget
        # key -> (Executor, footprint bytes frozen at insert time)
        self._executors: "collections.OrderedDict[tuple, tuple]" = \
            collections.OrderedDict()
        self._executor_bytes = 0

        self._scheduler = JobScheduler(
            max_depth=max_queue_depth, default_quota=default_quota,
            quotas=quotas, on_shed=self._on_shed)
        self.metrics._queue_depth_fn = self._scheduler.qsize
        self._own_pool = isinstance(pool, int)
        self._pool: Optional[WorkerPool] = (
            WorkerPool(workers=pool, warm=True) if self._own_pool else pool)
        # measured job-cost model: (skey, app) -> EWMA seconds, plus an
        # adaptive scale mapping plan est_makespan (model units) onto
        # measured seconds — its own lock, it is touched outside the
        # service lock (cost estimation reads cache state)
        self._cost_lock = threading.Lock()
        self._cost_ewma: Dict[tuple, float] = {}
        self._cost_alpha = 0.3
        self._model_scale = 1.0
        self._cost_sum = 0.0
        self._cost_n = 0
        self._lock = threading.Lock()
        self._inflight: Dict[tuple, _Job] = {}
        # fp -> Graph | _LazyGraph (delta chain); enables cold rebuilds
        self._registry: Dict[str, object] = {}
        # streaming lifecycle policies (see the class docstring)
        self.max_chain_depth = max_chain_depth
        self.rebalance_threshold = rebalance_threshold
        if regroup is True:
            regroup = RegroupPolicy()
        elif isinstance(regroup, dict):
            regroup = RegroupPolicy(**regroup)
        elif regroup is not None and not isinstance(regroup, RegroupPolicy):
            raise TypeError(f"regroup= accepts a RegroupPolicy, True, or "
                            f"a kwargs dict, got {regroup!r}")
        self._regroup = regroup or None
        # skey -> cumulative changed edges since registration/regroup;
        # carried across re-keys so churn accrues over the whole chain
        self._churn: Dict[StoreKey, int] = {}
        self._regroup_last: Dict[StoreKey, float] = {}   # cooldown clock
        self._regroup_busy: set = set()   # one regroup per key at a time
        self.metrics._chain_depth_fn = self._max_chain_depth
        # skey -> count of queued/executing jobs; update() defers store
        # retirement while any exist, so even jobs still WAITING in the
        # queue (not yet lease-pinned) finish on the old snapshot
        self._skey_jobs: Dict[StoreKey, int] = {}
        self._retire_pending: set = set()
        self._next_id = 0
        self._closed = False
        # optional drift-driven autotuning (repro_torch.autotune): accepts
        # an AutoTuner instance, True (defaults), or a kwargs dict. The
        # tuner's clearable drift accumulator is spliced ABOVE the
        # service-level one so every executor sample reaches both.
        self._autotuner = None
        if autotune:
            from ..autotune import AutoTuner
            if isinstance(autotune, AutoTuner):
                self._autotuner = autotune
            elif isinstance(autotune, dict):
                self._autotuner = AutoTuner(
                    **{"device": self.device, **autotune})
            else:
                self._autotuner = AutoTuner(device=self.device)
            self._autotuner.load(self.default_geom)
            self.metrics.drift.set_parent(self._autotuner.drift)
            self.metrics._calibration_info_fn = \
                self._autotuner.calibration_info
        self._workers = [
            threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"graph-serve-{i}")
            for i in range(workers)]
        for w in self._workers:
            w.start()

    # -- lifecycle ------------------------------------------------------
    def __enter__(self) -> "GraphService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self, wait: bool = True) -> None:
        """Stop accepting work; by default drain the queue and join the
        workers (each worker eats one sentinel and exits — sentinels
        sort after every queued job, so the drain finishes real work
        first). The closed flag and the sentinels go in under the
        service lock, atomically with submit()'s enqueue — a racing
        submit either lands before the sentinels (and is drained) or
        raises ServiceClosed."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for _ in self._workers:
                self._scheduler.push_sentinel(_SENTINEL)
        if wait:
            for w in self._workers:
                w.join()
            with self._lock:
                self._executors.clear()
                self._executor_bytes = 0
        if self._own_pool and self._pool is not None:
            self._pool.close(wait=wait)

    @property
    def accepting(self) -> bool:
        """True while submit() would enqueue work (i.e. not closed) —
        the scheduler half of the control plane's readiness probe."""
        with self._lock:
            return not self._closed

    # -- registration ---------------------------------------------------
    def register(self, graph: Graph, *, geom: Optional[Geometry] = None,
                 use_dbg: Optional[bool] = None,
                 prepare: bool = True) -> str:
        """Remember a graph so later submits can pass only its
        fingerprint, and (by default) prepare its GraphStore eagerly so
        the first request is a warm hit. Returns the fingerprint."""
        fp = graph.fingerprint()
        with self._lock:
            self._registry[fp] = graph
        if prepare:
            geom = geom or self.default_geom
            use_dbg = (self.default_use_dbg if use_dbg is None
                       else use_dbg)
            skey = store_key(fp, geom, use_dbg)
            self.cache.get_or_build(
                skey, lambda: self._build_store(graph, geom, use_dbg,
                                                fp=fp))
        return fp

    def unregister(self, fingerprint: str) -> bool:
        """Forget a registered graph (its cached store, if any, stays
        until normally evicted; it just can't be REBUILT from the
        registry afterwards). Returns whether it was registered."""
        with self._lock:
            return self._registry.pop(fingerprint, None) is not None

    # -- streaming updates ----------------------------------------------
    def update(self, fingerprint: str, delta: GraphDelta, *,
               geom: Optional[Geometry] = None,
               use_dbg: Optional[bool] = None,
               keep_base: bool = False) -> UpdateResult:
        """Trace-wrapping front door for :meth:`_update_impl` — updates
        run in the CALLER's thread, so the root span starts and the
        context activates here (there is no queue hand-off). See
        :meth:`_update_impl` for semantics."""
        tr = self.tracer
        if tr is None:
            return self._update_impl(fingerprint, delta, geom=geom,
                                     use_dbg=use_dbg, keep_base=keep_base)
        root = tr.start_trace("service.update", "service",
                              fingerprint=fingerprint[:12])
        try:
            with tr.activate(root.context):
                res = self._update_impl(fingerprint, delta, geom=geom,
                                        use_dbg=use_dbg,
                                        keep_base=keep_base)
            res.trace_id = root.trace_id
            root.end(outcome="done", mode=res.mode)
            return res
        except BaseException as exc:
            root.end(outcome="failed", error=str(exc))
            raise

    def _update_impl(self, fingerprint: str, delta: GraphDelta, *,
                     geom: Optional[Geometry] = None,
                     use_dbg: Optional[bool] = None,
                     keep_base: bool = False) -> UpdateResult:
        """Apply a :class:`~repro_torch.streaming.GraphDelta` to a served
        graph and re-key the store cache to the new chained snapshot
        fingerprint.

        Snapshot semantics: the base store is never mutated — requests
        against the OLD fingerprint that are executing *or still
        waiting in the queue* at update time finish against the old
        snapshot; its cache entry is retired once the last of them
        drains (lease pins cover executing work, a per-key job count
        covers queued work). Submits against the returned
        ``UpdateResult.fingerprint`` see the post-delta graph, warm
        from the incremental apply (clean blockings, cached plans
        rebuilt from carried-over per-partition stats, untouched lanes'
        packed device payloads reused). An old-fingerprint submit that
        races the retirement itself may still lose the store; the
        worker then rebuilds it when the Graph is known (submitted or
        registered) and fails the request with a clear KeyError
        otherwise.

        When the base store is cached the delta is applied
        incrementally in the CALLER's thread (store builds queue behind
        workers; a splice is milliseconds and callers usually want the
        new fingerprint synchronously). When it is not cached but the
        base graph is registered, the update is *deferred*: the delta
        is validated and applied at graph level (so a bad delta fails
        here, never on a later submit) and the store itself builds only
        if a cold submit needs it. Two updates racing on one base both
        succeed and branch the snapshot lineage (like git commits);
        neither invalidates the other.

        ``keep_base=False`` (default) drops the base fingerprint from
        the registry — the base Graph object itself stays referenced by
        the delta chain, so memory grows only by the (small) deltas.
        A base that was never registered still gets its lineage
        anchored (on the store's own source graph), so the chained
        fingerprint remains rebuildable after eviction.
        """
        if self.store_layout != "padded":
            raise ValueError(
                f"update() needs the padded store layout; this service "
                f"builds store_layout={self.store_layout!r} stores, which "
                f"keep live edges only (no padded blocks to splice a delta "
                f"into)")
        if delta.base_fp != fingerprint:
            raise ValueError(
                f"delta targets snapshot {delta.base_fp[:12]}… but "
                f"update() was called for {fingerprint[:12]}…")
        geom = geom or self.default_geom
        use_dbg = self.default_use_dbg if use_dbg is None else bool(use_dbg)
        old_key = store_key(fingerprint, geom, use_dbg)
        t0 = time.perf_counter()

        with self._lock:
            if self._closed:
                raise ServiceClosed("update() after close()")
            base_entry = self._registry.get(fingerprint)

        result = None
        base_src = None
        if old_key in self.cache:
            try:
                with self.cache.lease(old_key) as (store, _hit):
                    if self._pool is not None:
                        # numpy-heavy splice in a worker PROCESS; the
                        # plan rebuild stays here — the packed device
                        # payloads it carries over live in this process
                        t_p = time.perf_counter()
                        tr = obs.current_tracer()
                        if tr is not None and obs.current_ctx() is not None:
                            with obs.span("pool.apply", "pool") as sp:
                                result, wspans = self._pool.apply(
                                    store, delta, trace=True)
                            tr.adopt(wspans, sp.context)
                        else:
                            result = self._pool.apply(store, delta)
                        with obs.span("plan.rebuild", "planner"):
                            result.stats.update(rebuild_plans(
                                store, result.store, result.dirty_pids,
                                rebalance_threshold=self
                                .rebalance_threshold))
                        result.stats["t_apply_ms"] = \
                            (time.perf_counter() - t_p) * 1e3
                    else:
                        with obs.span("store.apply_delta", "store"):
                            result = apply_delta(
                                store, delta,
                                rebalance_threshold=self
                                .rebalance_threshold)
                    # lineage anchor for UNREGISTERED bases: a root
                    # store still knows its source Graph, and capturing
                    # it keeps the chained fingerprint rebuildable after
                    # eviction (a content-hash re-register could never
                    # re-associate with the chained identity)
                    base_src = store.source
            except KeyError:
                result = None       # eviction raced us: defer instead
            except Exception:
                self.metrics.record_update_failure()
                raise
        if result is None and base_entry is None:
            self.metrics.record_update_failure()
            raise KeyError(
                f"cannot update {fingerprint[:12]}…: store not cached and "
                f"graph not registered — register() it or submit a Graph "
                f"first")

        new_fp = (result.fingerprint if result is not None
                  else chain_fingerprint(fingerprint, delta.fingerprint()))
        retired = "absent"
        post_graph: Optional[Graph] = None
        if result is not None:
            self.cache.put(store_key(new_fp, geom, use_dbg), result.store)
            # the old snapshot drains out; its executors are purged by
            # the eviction hook when the entry actually goes. Jobs still
            # WAITING in the queue against the old key haven't leased
            # the store yet, so retirement is deferred until the last of
            # them finishes (_finish fires it) — queue wait never turns
            # a legal old-snapshot request into a miss.
            with self._lock:
                busy = self._skey_jobs.get(old_key, 0) > 0
                if busy:
                    self._retire_pending.add(old_key)
            retired = "deferred" if busy else self.cache.retire(old_key)
        else:
            # deferred: no cached store to splice, so validate + apply
            # at graph level NOW (much cheaper than a store build). An
            # invalid delta must fail THIS call — recording it
            # unvalidated would poison the lineage: every later cold
            # submit against new_fp would fail inside a worker with no
            # way to recover the dropped base fingerprint.
            base_graph = (base_entry.materialize()
                          if isinstance(base_entry, _LazyGraph)
                          else base_entry)
            try:
                post_graph = apply_delta_to_graph(base_graph, delta,
                                                  check_fp=False)
            except Exception:
                self.metrics.record_update_failure()
                raise
        with self._lock:
            # incremental updates register a lazy chain (already
            # validated by apply_delta; materialized only if a cold
            # rebuild needs it) — anchored on the registry entry when
            # the base was registered, else on the root store's source
            # graph; deferred updates register the post-delta graph
            # they just materialized
            anchor = base_entry if base_entry is not None else base_src
            chained = False
            if post_graph is not None:
                self._registry[new_fp] = post_graph
            elif anchor is not None:
                self._registry[new_fp] = _LazyGraph(anchor, delta)
                chained = True
            if base_entry is not None and not keep_base:
                self._registry.pop(fingerprint, None)
            # churn follows the lineage across the re-key: it measures
            # edges changed since the last (re-)registration, not since
            # the last delta
            new_key = store_key(new_fp, geom, use_dbg)
            self._churn[new_key] = (self._churn.pop(old_key, 0)
                                    + delta.num_changes)
        if (chained and self.max_chain_depth is not None
                and self._chain_depth(new_fp) > self.max_chain_depth):
            try:
                self.compact_chain(new_fp)
            except ValueError:
                pass   # a branch-poisoned chain stays long, never fails
                       # the update that happened to trip the bound
        if result is not None and self._regroup is not None:
            self._maybe_regroup(new_key)

        t_ms = (time.perf_counter() - t0) * 1e3
        stats = result.stats if result is not None else None
        self.metrics.record_update(
            t_ms, stats, deferred=result is None,
            retired=retired in ("now", "deferred"))
        return UpdateResult(
            fingerprint=new_fp, base_fingerprint=fingerprint,
            mode="incremental" if result is not None else "deferred",
            retired=retired, stats=stats, t_update_ms=t_ms)

    # -- streaming lifecycle (compaction + regroup) ---------------------
    def _chain_depth(self, fingerprint: str) -> int:
        """Length of the lazy delta chain behind a registered snapshot
        (0 for a plain or already-materialized Graph, and for unknown
        fingerprints). Chain links are read without the materialize
        lock — they are assigned atomically, and a depth racing a
        concurrent materialize/compact only ever overestimates."""
        with self._lock:
            node = self._registry.get(fingerprint)
        depth = 0
        while isinstance(node, _LazyGraph) and node._graph is None:
            depth += 1
            node = node._base
        return depth

    def _max_chain_depth(self) -> int:
        """Deepest delta chain across every registered snapshot — the
        ``regraph_chain_depth`` gauge's pull hook."""
        with self._lock:
            fps = list(self._registry)
        return max((self._chain_depth(fp) for fp in fps), default=0)

    def compact_chain(self, fingerprint: str) -> dict:
        """Squash the delta chain behind a registered snapshot into ONE
        composed delta, preserving the chained-fingerprint lineage.

        The registry keeps the SAME key — compaction shortens the path
        from the anchor graph to the snapshot, never its identity — so
        a cold rebuild after a store eviction replays O(1) deltas
        instead of the whole chain. Chains that another snapshot still
        branches from are safe: intermediate nodes stay referenced by
        the other chain; only this entry's link is rewired. The
        chain's lineage is verified link by link before anything is
        mutated (a mismatch raises ValueError and leaves the chain
        intact): each delta must target the registry identity of the
        node below it. The check is structural — against registry keys,
        not refolded digests — because a PREVIOUSLY composed delta is
        content-equivalent to the links it replaced but hashes
        differently, so repeated compaction cannot rely on
        ``compact_deltas``'s strict digest fold. Returns an accounting
        dict; an unregistered fingerprint raises KeyError."""
        with self._lock:
            entry = self._registry.get(fingerprint)
            ident = {id(v): k for k, v in self._registry.items()}
        if entry is None:
            raise KeyError(f"fingerprint {fingerprint[:12]}… is not "
                           f"registered; nothing to compact")
        t0 = time.perf_counter()
        out = {"fingerprint": fingerprint, "depth_before": 0,
               "depth_after": 0, "compacted": False}
        if not isinstance(entry, _LazyGraph):
            out["t_compact_ms"] = (time.perf_counter() - t0) * 1e3
            return out
        with _LazyGraph._MAT_LOCK:
            if entry._graph is None:
                nodes = []
                base = entry
                while isinstance(base, _LazyGraph) and base._graph is None:
                    nodes.append(base)
                    base = base._base
                anchor = base._graph if isinstance(base, _LazyGraph) \
                    else base
                nodes.reverse()
                out["depth_before"] = out["depth_after"] = len(nodes)
                if len(nodes) > 1:
                    # lineage check: every delta targets the identity
                    # of the node it chains onto
                    below = ident.get(id(base))
                    for node in nodes:
                        want = node._delta.base_fp
                        if below is not None and want != below:
                            raise ValueError(
                                f"chain behind {fingerprint[:12]}… has a "
                                f"delta targeting {want[:12]}… where the "
                                f"parent snapshot is {below[:12]}… — "
                                f"lineage mismatch, not compacting")
                        below = ident.get(id(node))
                    if below != fingerprint:
                        raise ValueError(
                            f"chain tip registered as "
                            f"{'?' if below is None else below[:12]}… != "
                            f"{fingerprint[:12]}… — lineage mismatch, "
                            f"not compacting")
                    # compose BEFORE rewiring: a failed composition
                    # leaves the entry untouched and replayable
                    composed, _ = compact_deltas(
                        [n._delta for n in nodes], strict=False)
                    entry._base = anchor
                    entry._delta = composed
                    out["depth_after"] = 1
                    out["compacted"] = True
                    out["composed_changes"] = composed.num_changes
        if out["compacted"]:
            self.metrics.record_compaction()
        out["t_compact_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    def _maybe_regroup(self, skey: StoreKey) -> None:
        """Post-update policy gate: once cumulative churn on this key
        justifies a drift check (and the cooldown allows one), run the
        check-and-maybe-swap — inline when the policy is ``sync``, else
        on a daemon thread so update() latency stays flat."""
        policy = self._regroup
        store = self.cache.peek(skey)
        if store is None:
            return
        now = time.monotonic()
        with self._lock:
            if skey in self._regroup_busy:
                return
            if not policy.churn_ready(self._churn.get(skey, 0),
                                      store.num_edges):
                return
            last = self._regroup_last.get(skey)
            if (policy.cooldown_s and last is not None
                    and now - last < policy.cooldown_s):
                return
            self._regroup_busy.add(skey)
            self._regroup_last[skey] = now
        if policy.sync:
            self._regroup_run(skey)
        else:
            threading.Thread(target=self._regroup_run, args=(skey,),
                             daemon=True, name="graph-regroup").start()

    def _regroup_run(self, skey: StoreKey) -> Optional[dict]:
        """Measure grouping drift for one cached store and, past the
        policy threshold, swap in a freshly-regrouped rebuild. Never
        raises: regrouping is an optimization and a failed check must
        not break serving."""
        policy = self._regroup or RegroupPolicy()
        try:
            store = self.cache.peek(skey)
            if store is None:
                return None
            event = grouping_drift(store, hw=policy.hw)
            event["fingerprint"] = skey[0]
            event["applied"] = False
            if event["drift"] > policy.drift_threshold:
                self._regroup_swap(skey, store)
                event["applied"] = True
            return event
        except Exception:
            return None
        finally:
            with self._lock:
                self._regroup_busy.discard(skey)

    def _regroup_swap(self, skey: StoreKey, store: GraphStore) -> None:
        """The atomic half of a regroup: rebuild with a fresh DBG
        grouping under the SAME chained fingerprint, replace the cache
        entry in place (``put`` on the live key — the swap other layers
        also use), and purge the key's cached executors explicitly —
        a put-replace fires no eviction hook, and those executors were
        compiled against the OLD store's layout."""
        fresh = reregister(store)
        self.cache.put(skey, fresh)
        with self._lock:
            self._churn[skey] = 0
            for k in [k for k in self._executors if k[0] == skey]:
                self._drop_executor(k)
        self.metrics.record_regroup()

    def regroup_now(self, graph: Union[Graph, str, None] = None, *,
                    fingerprint: Optional[str] = None,
                    geom: Optional[Geometry] = None,
                    use_dbg: Optional[bool] = None,
                    force: bool = False) -> dict:
        """Force a grouping-drift check — and, past the policy
        threshold or unconditionally with ``force=True``, the
        re-registration swap — for one served snapshot, bypassing the
        churn/cooldown gates (admin/debug path, like
        :meth:`retune_now`; the normal trigger is the post-update
        policy check). Requires the store to be cached: regrouping
        re-lays-out a LIVE store, there is nothing to do for an
        evicted one. Returns the drift event dict."""
        geom = geom or self.default_geom
        use_dbg = self.default_use_dbg if use_dbg is None else bool(use_dbg)
        fp = resolve_fingerprint(graph, fingerprint)
        skey = store_key(fp, geom, use_dbg)
        store = self.cache.peek(skey)
        if store is None:
            raise KeyError(f"no cached store for {fp[:12]}…; regroup "
                           f"operates on the cached store — submit or "
                           f"register() first")
        policy = self._regroup or RegroupPolicy()
        event = grouping_drift(store, hw=policy.hw)
        event["fingerprint"] = fp
        event["applied"] = False
        if force or event["drift"] > policy.drift_threshold:
            self._regroup_swap(skey, store)
            event["applied"] = True
        return event

    def _on_store_evicted(self, skey: StoreKey, store: GraphStore) -> None:
        """Cache-eviction hook: purge the evicted store's executors so
        they don't keep its device arrays alive past the byte budget.
        In-flight runs still hold their own executor reference and
        finish untouched."""
        self.metrics.record_eviction()
        with self._lock:
            for k in [k for k in self._executors if k[0] == skey]:
                self._drop_executor(k)
            # a later cold rebuild runs a fresh DBG pass, so the churn
            # clock (changes since last registration) restarts with it
            self._churn.pop(skey, None)
            self._regroup_last.pop(skey, None)

    def _drop_executor(self, key) -> None:
        """Remove one cached executor (caller holds the lock)."""
        _, nbytes = self._executors.pop(key)
        self._executor_bytes -= nbytes

    def _trim_executors(self) -> None:
        """Evict LRU executors past the count bound and (when set) the
        byte budget. The count bound is strict (``max_executors=0``
        still disables caching entirely); the byte bound never evicts
        the newest entry — a single oversized plan must stay servable
        (caller holds the lock)."""
        evicted = 0
        while self._executors and (
                len(self._executors) > self.max_executors
                or (self.executor_byte_budget is not None
                    and self._executor_bytes > self.executor_byte_budget
                    and len(self._executors) > 1)):
            self._drop_executor(next(iter(self._executors)))
            evicted += 1
        if evicted:
            self.metrics.record_executor_eviction(evicted)

    def _build_store(self, graph: Graph, geom: Geometry = None,
                     use_dbg: bool = None,
                     fp: Optional[str] = None) -> GraphStore:
        # fp pins the store's identity to the SERVICE's key: a store
        # rebuilt from a materialized delta chain must keep the chained
        # fingerprint (deltas validate against it), not the content
        # hash of the materialized graph
        geom = geom or self.default_geom
        use_dbg = self.default_use_dbg if use_dbg is None else use_dbg
        if self._pool is not None:
            # DBG + lexsort + partition stats run in a worker process;
            # a WorkerCrashed propagates like any failed build (the
            # cache lease releases, the job's handles get the error)
            tr = obs.current_tracer()
            if tr is not None and obs.current_ctx() is not None:
                # trace carrier across the process boundary: the worker
                # records spans into a throwaway local tracer and ships
                # them back as dicts; adopt() re-parents them here
                with obs.span("pool.build_store", "pool") as sp:
                    store, wspans = self._pool.build_store(
                        graph, geom=geom, use_dbg=use_dbg, fp=fp,
                        max_plans=self.max_plans_per_store, trace=True)
                tr.adopt(wspans, sp.context)
                return store
            return self._pool.build_store(
                graph, geom=geom, use_dbg=use_dbg, fp=fp,
                max_plans=self.max_plans_per_store)
        if self.store_layout != "padded":
            return GraphStore(
                graph, geom=geom, use_dbg=use_dbg,
                max_plans=self.max_plans_per_store, fingerprint=fp,
                layout=self.store_layout, device=self.device)
        return GraphStore(
            graph, geom=geom, use_dbg=use_dbg,
            max_plans=self.max_plans_per_store,
            fingerprint=fp)

    # -- submission -----------------------------------------------------
    def submit(self, graph: Union[Graph, str, None] = None,
               app: Union[GASApp, str] = "pagerank", *,
               fingerprint: Optional[str] = None,
               app_kwargs: Optional[dict] = None,
               config: Optional[PlanConfig] = None,
               geom: Optional[Geometry] = None,
               use_dbg: Optional[bool] = None,
               max_iters: Optional[int] = None,
               path: Optional[str] = None,
               shard=None,
               tenant: str = "default",
               priority: int = 0,
               deadline: Optional[float] = None,
               observer=None,
               **cfg) -> RequestHandle:
        """Enqueue one request; returns immediately with a
        :class:`RequestHandle`.

        ``graph`` may be a :class:`Graph`, a fingerprint string, or None
        with ``fingerprint=`` set (the graph must then be registered or
        its store still cached). ``app`` is a builtin name (coalescable;
        parameterize via ``app_kwargs``) or a prebuilt :class:`GASApp`
        (coalesced only with submissions of that same instance — the
        service can't see inside arbitrary closures). ``shard`` requests
        multi-device execution (``True`` = every card, int n = the
        first n cards — on a CPU service, n CPU owners; ``False`` opts
        out of a service ``default_shard``;
        ``None`` = the service default) — sharded and unsharded requests
        never coalesce with each other. Extra kwargs become
        :class:`PlanConfig` fields, as in :func:`repro_torch.api.compile`.

        Submitting a Graph does NOT retain it past the request: if its
        store is later evicted, a fingerprint-only resubmit needs the
        Graph again — or :meth:`register` it once (registered graphs
        are kept until :meth:`unregister` and always rebuildable).

        Scheduling: ``priority`` (larger drains first), ``deadline``
        (seconds from now; a job still queued past it is load-shed and
        its handles raise
        :class:`~repro_torch.control.scheduler.DeadlineExpired`), and
        ``tenant`` (admission accounting; see ``default_quota``).
        Admission may raise the typed
        :class:`~repro_torch.control.scheduler.QueueFull` /
        :class:`~repro_torch.control.scheduler.QuotaExceeded` — nothing is
        enqueued then. A submit that coalesces onto an in-flight job
        bypasses admission entirely and, if its priority is higher,
        boosts the queued job's. ``observer`` is a
        ``(event, job_info_dict)`` callback for the control plane's
        job records (events: queued, coalesced, running, done, failed,
        shed).
        """
        if config is not None and cfg:
            raise ValueError("pass either config= or PlanConfig kwargs, "
                             "not both")
        config = config or PlanConfig(**cfg)
        geom = geom or self.default_geom
        use_dbg = self.default_use_dbg if use_dbg is None else bool(use_dbg)
        path = path or self.default_path
        shard = self.default_shard if shard is None else shard
        if shard is False:
            shard = None
        elif shard is True:
            # resolve to a count NOW: True == 1 in tuple keys, so leaving
            # the bool in job/executor keys would coalesce an all-devices
            # request with a one-device one
            from ..sharding.executor import resolve_devices
            shard = (len(resolve_devices(True))
                     if self.device.type == "cuda" else 1)
        if shard is not None and (not isinstance(shard, int)
                                  or isinstance(shard, bool) or shard < 1):
            # device sequences aren't hashable job keys; serving keeps
            # the coalescable forms only
            raise ValueError("submit(shard=...) accepts True/False or a "
                             f"positive int device count, got {shard!r}")
        if shard is not None and self.store_layout != "padded":
            raise ValueError(
                f"submit(shard=...) needs the padded store layout; this "
                f"service builds store_layout={self.store_layout!r} stores")

        graph_obj = graph if isinstance(graph, Graph) else None
        fp = resolve_fingerprint(graph, fingerprint)
        skey = store_key(fp, geom, use_dbg)

        app_name, app_token, make_app = _normalize_app(app, app_kwargs)
        if graph_obj is None:
            # NOTE: no auto-registration on the Graph path — only
            # register() pins graphs on the service, so serving many
            # distinct graphs can't grow host memory behind the store
            # cache's byte budget
            with self._lock:
                graph_obj = self._registry.get(fp)
            if graph_obj is None and skey not in self.cache:
                raise KeyError(
                    f"fingerprint {fp[:12]}… is neither registered nor "
                    f"cached; pass the Graph or register() it first")

        if self._autotuner is not None:
            # rewrite default-shaped configs to the current calibrated HW
            # and best-known split BEFORE keying: coalescing, cost
            # estimation and plan lookup all see the effective config
            config = self._autotuner.resolve_config(config, skey)

        job_key = (skey, app_token, config.cache_key(), max_iters, path,
                   shard)
        # cost estimation reads the store/plan caches (their own locks;
        # the eviction hook re-enters the service lock, so peeking from
        # under it would invert the order) — do it before locking
        cost, model_est = self._estimate_cost(skey, app_name, config)
        abs_deadline = (None if deadline is None
                        else time.monotonic() + deadline)
        with self._lock:
            # closed-check is atomic with the enqueue: close() inserts
            # its sentinels under this same lock, so a submit can never
            # land a job behind them (which no worker would ever drain)
            if self._closed:
                raise ServiceClosed("submit() after close()")
            self._next_id += 1
            rid = self._next_id
            job = self._inflight.get(job_key)
            coalesced = job is not None
            m = RequestMetrics(request_id=rid, app=app_name,
                               fingerprint=fp, tenant=tenant,
                               coalesced=coalesced)
            handle = RequestHandle(rid, m)
            if coalesced:
                # piggyback on the identical in-flight job; its single
                # execution resolves every attached handle. No admission
                # charge — the work already paid its way in — but a
                # higher-priority twin boosts the queued job (quota
                # pressure must not invert priorities via coalescing)
                job.handles.append(handle)
                handle._job = job
                if observer is not None:
                    job.observers.append(observer)
                if priority > job.priority:
                    job.priority = priority
                    self._scheduler.reprioritize(job, priority)
            else:
                job = _Job(job_key, skey, graph_obj, app_name, make_app,
                           config, geom, use_dbg, max_iters, path,
                           shard=shard, tenant=tenant, priority=priority)
                job.model_est = model_est
                job.handles.append(handle)
                handle._job = job
                if observer is not None:
                    job.observers.append(observer)
                if self.tracer is not None:
                    # root + queue spans start HERE (the submit thread);
                    # the worker thread ends the queue span at pickup
                    # and activates the root context — the explicit
                    # carrier across the scheduler hand-off
                    job.root_span = self.tracer.start_trace(
                        f"job:{app_name}", "service", app=app_name,
                        fingerprint=fp[:12], tenant=tenant,
                        priority=priority, request_id=rid)
                    job.trace_ctx = job.root_span.context
                    job.queue_span = self.tracer.start_span(
                        "queue.wait", "scheduler", parent=job.trace_ctx)
                self._inflight[job_key] = job
                self._skey_jobs[skey] = self._skey_jobs.get(skey, 0) + 1
                try:
                    self._scheduler.push(job, tenant=tenant,
                                         priority=priority,
                                         deadline=abs_deadline, cost=cost)
                except RejectedJob as exc:
                    # typed rejection: nothing enqueued — unwind the
                    # bookkeeping so the key isn't poisoned in-flight
                    del self._inflight[job_key]
                    left = self._skey_jobs.get(skey, 1) - 1
                    if left <= 0:
                        self._skey_jobs.pop(skey, None)
                    else:
                        self._skey_jobs[skey] = left
                    kind = ("queue_full" if isinstance(exc, QueueFull)
                            else "quota")
                    self.metrics.record_rejected(kind, tenant)
                    if job.queue_span is not None:
                        job.queue_span.end(rejected=kind)
                    if job.root_span is not None:
                        job.root_span.end(outcome="rejected", error=kind)
                    raise
            handle.trace_ctx = job.trace_ctx   # control plane reads this
        self.metrics.record_submit(coalesced, tenant)
        self._notify(job, "coalesced" if coalesced else "queued",
                     request_id=rid)
        return handle

    def run(self, graph=None, app="pagerank", *, timeout=None, **kw):
        """Synchronous convenience: submit + wait."""
        return self.submit(graph, app, **kw).result(timeout=timeout)

    def cancel(self, handle: RequestHandle) -> bool:
        """Detach one handle from its job; the handle then raises
        :class:`concurrent.futures.CancelledError`. Returns False if
        the request already resolved. Cancelling the LAST handle of a
        still-queued job removes the job from the queue entirely; a
        job already executing runs to completion (its result simply
        has no one left to fan out to)."""
        import concurrent.futures
        job = getattr(handle, "_job", None)
        if job is None:
            return False
        do_retire = removed_job = False
        with self._lock:
            if handle.done():
                return False
            try:
                job.handles.remove(handle)
            except ValueError:       # _finish snapshotted concurrently
                return False
            if not job.handles and self._inflight.get(job.key) is job:
                if self._scheduler.remove(job):   # still queued
                    removed_job = True
                    self._inflight.pop(job.key, None)
                    left = self._skey_jobs.get(job.skey, 1) - 1
                    if left <= 0:
                        self._skey_jobs.pop(job.skey, None)
                        if job.skey in self._retire_pending:
                            self._retire_pending.discard(job.skey)
                            do_retire = True
                    else:
                        self._skey_jobs[job.skey] = left
        if do_retire:
            self.cache.retire(job.skey)
        if removed_job:
            if job.queue_span is not None:
                job.queue_span.end(outcome="cancelled")
            if job.root_span is not None:
                job.root_span.end(outcome="cancelled")
        m = handle.metrics
        m.error = "cancelled"
        m.t_total_ms = (time.perf_counter() - handle._t_submit) * 1e3
        self.metrics.record_done(m)
        handle._set_exception(concurrent.futures.CancelledError(
            f"request {handle.request_id} cancelled"))
        if removed_job:
            self._notify(job, "cancelled")
        return True

    # -- cost model ------------------------------------------------------
    def _estimate_cost(self, skey: StoreKey, app_name: str,
                       config: PlanConfig) -> Tuple[float, Optional[float]]:
        """Predict a job's runtime in seconds for queue ordering.
        Preference order: the measured EWMA for this (store, app)
        shape; the perf model's ``est_makespan`` (rescaled by the
        adaptive calibration factor) when store and plan are already
        cached; the global measured average. Returns ``(seconds,
        raw model estimate or None)`` — pure peeks only, an estimate
        must never build anything or touch LRU recency."""
        with self._cost_lock:
            ew = self._cost_ewma.get((skey, app_name))
            scale = self._model_scale
            avg = self._cost_sum / self._cost_n if self._cost_n else 0.0
        if ew is not None:
            return ew, None
        store = self.cache.peek(skey)
        if store is not None:
            bundle = store.peek_plan(config)
            if bundle is not None:
                est = float(bundle.plan.est_makespan)
                return est * scale, est
        return avg, None

    def _record_cost(self, job: _Job, seconds: float) -> None:
        """Fold one measured (store + plan + execute) duration into the
        EWMA for the job's shape, and — when the perf model estimated
        this job — into the model→wall-clock calibration scale."""
        with self._cost_lock:
            k = (job.skey, job.app_name)
            old = self._cost_ewma.get(k)
            a = self._cost_alpha
            self._cost_ewma[k] = (seconds if old is None
                                  else (1 - a) * old + a * seconds)
            if len(self._cost_ewma) > 4096:     # bound: drop the oldest
                self._cost_ewma.pop(next(iter(self._cost_ewma)))
            self._cost_sum += seconds
            self._cost_n += 1
            if job.model_est:
                ratio = seconds / job.model_est
                self._model_scale = (1 - a) * self._model_scale + a * ratio

    # -- worker ---------------------------------------------------------
    def _notify(self, job: "_Job", event: str, **info) -> None:
        """Fire the job's control-plane observers (outside all service
        locks; observers must never be able to break serving)."""
        if not isinstance(job, _Job) or not job.observers:
            return
        info.update(app=job.app_name, fingerprint=job.skey[0],
                    tenant=job.tenant)
        for cb in list(job.observers):
            try:
                cb(event, info)
            except Exception:
                pass

    def _on_shed(self, job: "_Job") -> None:
        """Scheduler callback (fired outside its lock) for a queued job
        whose deadline expired: fail every attached handle with the
        typed error and release the job's bookkeeping."""
        self.metrics.record_shed(job.tenant)
        waited = time.perf_counter() - job.t_submit
        self._finish(job, error=DeadlineExpired(
            f"job for app {job.app_name!r} load-shed: deadline expired "
            f"after {waited:.3f}s in queue"), event="shed")

    def _worker_loop(self) -> None:
        while True:
            job = self._scheduler.pop()
            if job is _SENTINEL:
                return
            self._notify(job, "running")
            try:
                self._execute(job)
            except BaseException as exc:   # never kill the worker
                self._finish(job, error=exc)

    def _execute(self, job: _Job) -> None:
        # end the queue-wait span at pickup, then run the body with the
        # job's trace context active on THIS thread so every deeper
        # obs.span (store build, plan, executor lanes) attaches to it
        if job.queue_span is not None:
            job.queue_span.end()
        if self.tracer is not None and job.trace_ctx is not None:
            with self.tracer.activate(job.trace_ctx):
                self._execute_impl(job)
        else:
            self._execute_impl(job)

    def _execute_impl(self, job: _Job) -> None:
        t_pickup = time.perf_counter()
        t_queue_ms = (t_pickup - job.t_submit) * 1e3

        def build():
            g = job.graph
            if g is None:
                raise KeyError(
                    f"store for {job.skey[0][:12]}… was evicted and the "
                    f"graph is not registered; re-submit with the Graph")
            if isinstance(g, _LazyGraph):   # replay the delta chain
                g = g.materialize()
            return self._build_store(g, job.geom, job.use_dbg,
                                     fp=job.skey[0])

        # max_iters is a run() argument, not executor state, so it is
        # deliberately absent from the executor key (unlike the job key)
        exec_key = (job.skey, job.key[1], job.config.cache_key(), job.path,
                    job.shard)
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            # the lease stays held for the whole execution, but the
            # "service.store" span must cover only its ACQUISITION
            # (fetch or build) — hence ExitStack instead of nesting
            with obs.span("service.store", "service") as sp:
                store, store_hit = stack.enter_context(
                    self.cache.lease(job.skey, build))
                sp.set(hit=store_hit)
            t_store_ms = (time.perf_counter() - t0) * 1e3

            with self._lock:
                hit = self._executors.get(exec_key)
                if hit is not None:
                    self._executors.move_to_end(exec_key)
            if hit is not None:
                ex, plan_hit, t_plan_ms = hit[0], True, 0.0
            else:
                plan_hit = store.has_plan(job.config)
                t0 = time.perf_counter()
                with obs.span("service.plan", "service",
                              hit=plan_hit) as sp:
                    bundle = store.plan(job.config)
                t_plan_ms = (time.perf_counter() - t0) * 1e3
                if job.shard is not None:
                    from ..sharding.executor import ShardedExecutor
                    # n owners: the first n cards, or n CPU owners on a
                    # CPU service
                    devices = (job.shard if self.device.type == "cuda"
                               else [self.device] * job.shard)
                    ex = ShardedExecutor(store, bundle, job.make_app(),
                                         devices=devices, path=job.path)
                else:
                    calib = (self._autotuner.calibrator
                             if self._autotuner is not None else None)
                    ex = Executor(store, bundle, job.make_app(),
                                  path=job.path, device=self.device,
                                  drift_parent=self.metrics.drift,
                                  util_parent=self.metrics.utilization,
                                  calibrator=calib)
                nbytes = ex.memory_footprint()
                with self._lock:
                    if exec_key in self._executors:
                        self._drop_executor(exec_key)   # racing build won
                    self._executors[exec_key] = (ex, nbytes)
                    self._executor_bytes += nbytes
                    self._trim_executors()

            t0 = time.perf_counter()
            with obs.span("service.execute", "service", app=job.app_name,
                          executor_hit=hit is not None) as sp, \
                    _on_device(ex.device):
                result = ex.run(max_iters=job.max_iters)
                sp.set(iterations=result[1]["iterations"])
            t_execute_ms = (time.perf_counter() - t0) * 1e3

        self.metrics.record_execution(store_hit, plan_hit)
        self._record_cost(job,
                          (t_store_ms + t_plan_ms + t_execute_ms) / 1e3)
        # the result's fan-out to the handles, record_done and their
        # wake-up: with service.store, .plan and .execute, the worker's
        # time from pickup to hand-off is covered by spans
        with obs.span("service.finish", "service"):
            self._finish(job, result=result, store_hit=store_hit,
                         plan_hit=plan_hit, t_queue_ms=t_queue_ms,
                         t_store_ms=t_store_ms, t_plan_ms=t_plan_ms,
                         t_execute_ms=t_execute_ms)
        # drift policy check AFTER the handles resolve: a retune sweeps
        # time_lanes + rebuilds plans, and must not delay the request
        # that happened to trip it. Sharded executors have no time_lanes
        # path; single-device drift covers the same model constants.
        if self._autotuner is not None and job.shard is None:
            try:
                with _on_device(ex.device):
                    ev = self._autotuner.observe(store, ex, job.config,
                                                 skey=job.skey)
                if ev is not None and ev.get("applied"):
                    self.metrics.record_retune()
            except Exception as e:   # autotuning must never fail serving
                self._autotuner._push_event(
                    {"error": repr(e), "applied": False})

    def _finish(self, job: _Job, result=None, error=None, store_hit=None,
                plan_hit=None, t_queue_ms=None, t_store_ms=None,
                t_plan_ms=None, t_execute_ms=None,
                event: Optional[str] = None) -> None:
        # unlink and snapshot the handle list atomically: a twin either
        # attaches before this (and is resolved below) or finds the job
        # gone and starts a fresh execution — never lost in between
        do_retire = False
        with self._lock:
            self._inflight.pop(job.key, None)
            handles = list(job.handles)
            left = self._skey_jobs.get(job.skey, 1) - 1
            if left <= 0:
                self._skey_jobs.pop(job.skey, None)
                if job.skey in self._retire_pending:
                    self._retire_pending.discard(job.skey)
                    do_retire = True   # last old-snapshot job drained
            else:
                self._skey_jobs[job.skey] = left
        if do_retire:
            # outside the service lock: retirement may evict and the
            # eviction hook re-enters the lock
            self.cache.retire(job.skey)
        if job.queue_span is not None and not job.queue_span.ended:
            # shed/cancel paths never reached pickup
            job.queue_span.end(outcome=event or "failed")
        if job.root_span is not None:
            outcome = event or ("failed" if error is not None else "done")
            if error is not None:
                job.root_span.end(outcome=outcome, error=str(error))
            else:
                job.root_span.end(outcome=outcome)
        now = time.perf_counter()
        for h in handles:
            m = h.metrics
            m.store_hit = store_hit
            m.plan_hit = plan_hit
            # each handle gets ITS OWN end-to-end latency; the stage
            # breakdown describes the one execution, so it lands only on
            # the request that triggered it — coalesced twins keep the
            # documented None stages (they did not queue/build/run)
            m.t_total_ms = (now - h._t_submit) * 1e3
            if not m.coalesced:
                m.t_queue_ms = t_queue_ms
                m.t_store_ms = t_store_ms
                m.t_plan_ms = t_plan_ms
                m.t_execute_ms = t_execute_ms
            if error is not None:
                m.error = "".join(traceback.format_exception_only(
                    type(error), error)).strip()
                self.metrics.record_done(m)
                h._set_exception(error)
            else:
                self.metrics.record_done(m)
                h._set_result(result)
        self._notify(job, event or ("failed" if error is not None
                                    else "done"),
                     error=(None if error is None else str(error)))

    # -- autotune -------------------------------------------------------
    @property
    def autotuner(self):
        """The attached :class:`~repro_torch.autotune.AutoTuner`, or
        None."""
        return self._autotuner

    def retune_now(self, graph: Union[Graph, str, None] = None, *,
                   fingerprint: Optional[str] = None,
                   app="pagerank", geom: Optional[Geometry] = None,
                   use_dbg: Optional[bool] = None,
                   config: Optional[PlanConfig] = None, **cfg) -> dict:
        """Force a calibrate-and-replan cycle for one graph, bypassing
        the drift policy (admin/debug path; the normal trigger is the
        post-execution drift check). The sweep runs on an executor on
        the service's device. Returns the retune event dict."""
        if self._autotuner is None:
            raise RuntimeError("service was built without autotune=")
        if config is not None and cfg:
            raise ValueError("pass either config= or PlanConfig kwargs, "
                             "not both")
        config = config or PlanConfig(**cfg)
        geom = geom or self.default_geom
        use_dbg = self.default_use_dbg if use_dbg is None else bool(use_dbg)
        graph_obj = graph if isinstance(graph, Graph) else None
        fp = resolve_fingerprint(graph, fingerprint)
        skey = store_key(fp, geom, use_dbg)
        if graph_obj is None:
            with self._lock:
                graph_obj = self._registry.get(fp)
            if graph_obj is None and skey not in self.cache:
                raise KeyError(
                    f"fingerprint {fp[:12]}… is neither registered nor "
                    f"cached; pass the Graph or register() it first")
        config = self._autotuner.resolve_config(config, skey)

        def build():
            g = graph_obj
            if g is None:
                raise KeyError("store evicted and graph not registered")
            if isinstance(g, _LazyGraph):
                g = g.materialize()
            return self._build_store(g, geom, use_dbg, fp=fp)

        _, _, make_app = _normalize_app(app, None)
        with self.cache.lease(skey, build) as (store, _hit), \
                _on_device(self.device):
            bundle = store.plan(config)
            ex = Executor(store, bundle, make_app(),
                          path=self.default_path, device=self.device,
                          drift_parent=self.metrics.drift,
                          util_parent=self.metrics.utilization,
                          calibrator=self._autotuner.calibrator)
            event = self._autotuner.retune(store, ex, config, skey=skey,
                                           force=True)
        if event.get("applied"):
            self.metrics.record_retune()
        return event

    # -- reporting ------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            n_exec = len(self._executors)
            exec_bytes = self._executor_bytes
        return {
            "service": self.metrics.snapshot(),
            "store_cache": self.cache.stats(),
            "scheduler": self._scheduler.stats(),
            "pool": self._pool.stats() if self._pool is not None else None,
            "registered_graphs": len(self._registry),
            "max_chain_depth": self._max_chain_depth(),
            "cached_executors": n_exec,
            "executor_bytes": exec_bytes,
            "executor_byte_budget": self.executor_byte_budget,
            "drift": self.metrics.drift.report(),
            "autotune": (self._autotuner.stats()
                         if self._autotuner is not None else None),
            "tracer": (self.tracer.stats()
                       if self.tracer is not None else None),
        }


def _on_device(device: torch.device):
    """Make ``device`` current on this thread when it is a card (worker
    threads each have their own current CUDA device), so every launch
    and allocation of a run lands on it."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _normalize_app(app: Union[GASApp, str],
                   app_kwargs: Optional[dict]
                   ) -> Tuple[str, tuple, "callable"]:
    """Return (display name, coalescing token, zero-arg factory).

    Builtin apps submitted by name coalesce on (name, kwargs); a
    prebuilt GASApp instance coalesces only with itself (its parameters
    live in closures the service can't inspect, and GASApp instances
    are stateless across runs, so sharing the instance is safe).
    """
    if isinstance(app, str):
        if app not in BUILTIN_APPS:
            raise ValueError(f"unknown builtin app {app!r}; available: "
                             f"{sorted(BUILTIN_APPS)}")
        kwargs = dict(app_kwargs or {})
        token = ("builtin", app,
                 tuple((k, _hashable(v)) for k, v in sorted(kwargs.items())))
        return app, token, lambda: BUILTIN_APPS[app](**kwargs)
    if app_kwargs:
        raise ValueError("app_kwargs only apply to builtin app names")
    return app.name, ("instance", id(app)), lambda: app


def _hashable(v):
    """Coalescing keys must hash; app kwargs may hold numpy arrays
    (e.g. closeness ``sources``) or lists — fold them to value-equal
    hashable forms."""
    if isinstance(v, np.ndarray):
        return ("ndarray", v.shape, str(v.dtype), v.tobytes())
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    return v

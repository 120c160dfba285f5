"""GraphStore — the app-independent preparation layer (paper §IV-A).

Everything that depends only on ``(graph, Geometry)`` lives here and is
computed exactly once: the DBG permutation, dst-range partitioning (the
pristine :class:`PartitionInfo` stats plus partition-sorted edge arrays),
and the Little/Big brick blockings. Blockings are built lazily and
memoized, so running all five builtin apps against one store pays for
preprocessing once. Plans are cached per :class:`~.planner.PlanConfig`.

The store itself is host memory; only ``aux`` (out-degrees etc.) and the
plans' payloads live on a device, memoized per device.

Two layouts (``layout=``). ``"padded"`` (the default) keeps the
partition-sorted edges and the Little/Big brick blockings as host numpy,
the padded blocks the reference builds; every path runs on it.
``"stream"`` is for a static graph served for analytics, which takes no
deltas: it keeps only live edges (:mod:`.stream`), built with torch on
``device``, and its works hold no padded slot, so a graph whose padded
blocks would not fit the card can be served. The paths that need padded
blocks refuse it (:meth:`GraphStore.require_padded`): the streaming
delta apply and regroup, the sharded executor and the SPMD engine.

Layering (see repro_torch/api.py):

    GraphStore  — per (graph, geometry); owns edges + blockings
      Planner   — per PlanConfig; classification + lane schedule (cheap)
        Executor — per (plan, app, device); payloads + eager run loop
        ShardedExecutor — per (plan, app, devices); lane-sharded

A store changes only through :func:`repro_torch.streaming.apply_delta`,
which builds a derived store (:meth:`GraphStore._derived`) and leaves
the base untouched.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..graphs.formats import Graph, relabel
from . import partition as part
from . import stream as stream_mod
from .types import BlockedEdges, Geometry, PartitionInfo

LAYOUTS = ("padded", "stream")


class GraphStore:
    """App-independent graph state, built once and shared by many plans.

    Parameters
    ----------
    graph:   input COO graph (original vertex ids).
    geom:    blocking geometry; one store serves exactly one geometry.
    use_dbg: apply degree-based grouping before partitioning (paper §II-A).
    max_plans: bound on the per-store plan LRU (cached PlanBundles pin
             their device payloads; the least-recently-used bundle is
             dropped once the bound is hit).
    perm:    explicit vertex relabeling (``perm[old_id] = new_id``),
             overriding the DBG computation.
    fingerprint: identity override (defaults to the source graph's
             content hash).
    layout:  ``"padded"`` (default) or ``"stream"`` (the module
             docstring).
    device:  where a ``"stream"`` store builds its layout and its Big
             works (default ``cuda``; ``"cpu"`` runs the same torch
             code on the host); the padded layout ignores it.

    Building a padded store is host work and needs no device; each
    Executor names its own.
    """

    DEFAULT_MAX_PLANS = 32

    def __init__(self, graph: Graph, geom: Geometry = Geometry(),
                 use_dbg: bool = True, max_plans: Optional[int] = None,
                 perm: Optional[np.ndarray] = None,
                 fingerprint: Optional[str] = None,
                 layout: str = "padded", device=None):
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, got "
                             f"{layout!r}")
        self.layout = layout
        self.geom = geom
        self.use_dbg = use_dbg
        self.max_plans = (self.DEFAULT_MAX_PLANS if max_plans is None
                          else int(max_plans))
        if self.max_plans < 1:
            raise ValueError(f"max_plans must be >= 1, got {max_plans}")
        self.source = graph   # pre-DBG input, for sharing-mismatch checks
        self._fp = fingerprint
        self.stream: Optional[stream_mod.StreamEdges] = None
        self._init_caches()
        if layout == "stream":
            self._build_stream(graph, perm, device)
            return

        t0 = time.perf_counter()
        with obs.span("store.dbg", "store", V=graph.num_vertices,
                      E=graph.num_edges, use_dbg=use_dbg):
            if perm is not None:
                perm = np.asarray(perm, dtype=np.int32)
                if perm.shape[0] != graph.num_vertices:
                    raise ValueError(
                        f"perm has {perm.shape[0]} entries for a graph of "
                        f"{graph.num_vertices} vertices")
                self.graph = relabel(graph, perm, name_suffix="_perm")
                self.perm = perm
            elif use_dbg:
                self.graph, self.perm = part.apply_dbg(graph)
            else:
                self.graph = graph
                self.perm = np.arange(graph.num_vertices, dtype=np.int32)
        self.t_dbg = time.perf_counter() - t0

        t0 = time.perf_counter()
        with obs.span("store.partition", "store") as sp:
            self._infos, self.edges = part.partition_graph(self.graph, geom)
            sp.set(partitions=len(self._infos))
        self.V_pad = part.padded_num_vertices(self.graph.num_vertices, geom)
        self.t_partition = time.perf_counter() - t0

    def _init_caches(self) -> None:
        # lazy, memoized blockings (the expensive app-independent work)
        self._little_cache: Dict[int, BlockedEdges] = {}
        self._big_cache: Dict[Tuple[int, ...], BlockedEdges] = {}
        self.t_block = 0.0

        # plan LRU: PlanConfig.cache_key() -> PlanBundle
        self._plan_cache: "collections.OrderedDict[tuple, object]" = \
            collections.OrderedDict()
        self._plan_lock = threading.RLock()
        self.plan_evictions = 0
        self._aux: Dict[torch.device, dict] = {}

    def _build_stream(self, graph: Graph, perm, device) -> None:
        """The ``"stream"`` layout: DBG, partitions and the tile-major
        edges built on ``device`` (:func:`.stream.build`), kept on the
        host; no relabeled graph and no partition-sorted copy."""
        from ..kernels.ops import resolve_device
        if perm is not None and len(perm) != graph.num_vertices:
            raise ValueError(f"perm has {len(perm)} entries for a graph of "
                             f"{graph.num_vertices} vertices")
        self.device = resolve_device(device)
        self.graph = None
        self.edges = None
        t0 = time.perf_counter()
        with obs.span("store.partition", "store", V=graph.num_vertices,
                      E=graph.num_edges, layout="stream") as sp:
            self.perm, self._infos, self.stream = stream_mod.build(
                graph, self.geom, self.use_dbg, perm, self.device)
            sp.set(partitions=len(self._infos))
        self.t_dbg = 0.0
        self.t_partition = time.perf_counter() - t0
        self.V_pad = part.padded_num_vertices(graph.num_vertices, self.geom)

    @classmethod
    def _derived(cls, base: "GraphStore", *, graph: Graph,
                 infos: List[PartitionInfo], edges: dict,
                 little_cache: Dict[int, BlockedEdges],
                 big_cache: Dict[Tuple[int, ...], BlockedEdges],
                 fingerprint: str, t_partition: float = 0.0,
                 perm: Optional[np.ndarray] = None,
                 V_pad: Optional[int] = None) -> "GraphStore":
        """Build a store by splicing delta-updated state into a base
        store's layout (used by :func:`repro_torch.streaming.apply_delta`).
        Shares the base's frozen permutation and the untouched
        blockings; carries no source graph (``source is None`` — the
        chained ``fingerprint`` is its identity) and starts with an
        empty plan cache and no device aux (the streaming layer rebuilds
        plans surgically; aux rebuilds per device on first use).
        Vertex-growth deltas pass ``perm``/``V_pad`` overrides: the
        permutation extended identity-wise over the new tail ids, and
        the padding recomputed for the grown vertex count. While base
        and derived stores are both alive, shared state — perm, carried
        blockings, reused device payloads — is counted in both stores'
        ``memory_footprint()`` (attribution, not exclusive ownership)."""
        base.require_padded("a delta-derived store")
        self = cls.__new__(cls)
        self.layout = base.layout
        self.stream = None
        self.geom = base.geom
        self.use_dbg = base.use_dbg
        self.max_plans = base.max_plans
        self.source = None
        self._fp = fingerprint
        self.graph = graph
        self.perm = base.perm if perm is None else perm
        self.t_dbg = 0.0
        self._infos = infos
        self.edges = edges
        self.V_pad = base.V_pad if V_pad is None else int(V_pad)
        self.t_partition = t_partition
        self._little_cache = dict(little_cache)
        self._big_cache = dict(big_cache)
        self.t_block = 0.0
        self._plan_cache = collections.OrderedDict()
        self._plan_lock = threading.RLock()
        self.plan_evictions = 0
        self._aux = {}
        return self

    # -- pickling (the control plane's process pool) -------------------
    def __getstate__(self) -> dict:
        """Ship the app-independent host state only: the lock does not
        pickle, and the plan cache and the per-device aux hold device
        tensors — a CUDA tensor in the pickle would bring CUDA up in
        the receiving worker. The receiver re-plans (the carried
        blockings make that cheap) and builds aux per device on first
        use. Used by :mod:`repro_torch.control.pool` to move store
        builds and delta splices into worker processes."""
        state = self.__dict__.copy()
        # resolve the identity BEFORE dropping anything: a derived store
        # must not cross the process boundary with a lazy fingerprint
        state["_fp"] = self.fingerprint()
        state["_plan_cache"] = None
        state["_plan_lock"] = None
        state["_aux"] = None
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._plan_cache = collections.OrderedDict()
        self._plan_lock = threading.RLock()
        self._aux = {}

    def fingerprint(self) -> str:
        """Identity of the graph this store was built from: the source
        graph's content hash, or — for delta-derived stores — the
        chained ``(base_fp, delta_fp)`` fingerprint set at derivation."""
        if self._fp is None:
            if self.source is None:
                raise RuntimeError("derived store carries no source graph "
                                   "and was given no fingerprint")
            self._fp = self.source.fingerprint()
        return self._fp

    def validate_compatible(self, graph=None, geom=None, use_dbg=None):
        """Reject asks that contradict what this store was built with.
        ``None`` means "use the store's setting" and always passes."""
        if graph is not None and graph is not self.source:
            raise ValueError("store= was built from a different graph than "
                             "the one passed; pass graph=None or the "
                             "store's own graph")
        if geom is not None and geom != self.geom:
            raise ValueError(f"store was built with {self.geom}, but "
                             f"geom={geom} was requested")
        if use_dbg is not None and use_dbg != self.use_dbg:
            raise ValueError(f"store was built with use_dbg={self.use_dbg},"
                             f" but use_dbg={use_dbg} was requested")

    # -- layout ---------------------------------------------------------
    @property
    def num_vertices(self) -> int:
        return (self.graph.num_vertices if self.stream is None
                else self.stream.num_vertices)

    @property
    def num_edges(self) -> int:
        return (self.graph.num_edges if self.stream is None
                else self.stream.num_edges)

    def out_degrees(self) -> np.ndarray:
        """Out-degree of every vertex, in DBG ids."""
        return (self.graph.out_degrees() if self.stream is None
                else self.stream.out_degrees)

    def require_padded(self, what: str) -> None:
        """Raise ``ValueError`` unless this store keeps padded blocks:
        ``what`` needs them, and a ``"stream"`` store has none."""
        if self.layout != "padded":
            raise ValueError(
                f"{what} needs the padded store layout; this store was "
                f"built with layout={self.layout!r}, which keeps live edges "
                f"only (no padded blocks)")

    # -- partition stats ------------------------------------------------
    @property
    def infos(self) -> List[PartitionInfo]:
        """Pristine (unclassified) partition stats; planners work on
        copies (:meth:`copy_infos`)."""
        return self._infos

    def copy_infos(self) -> List[PartitionInfo]:
        return [dataclasses.replace(i) for i in self._infos]

    # -- memoized blocking ---------------------------------------------
    def little_work(self, pid: int) -> BlockedEdges:
        """Little-pipeline brick layout of one partition (memoized; a
        :class:`.stream.StreamWork` under the ``"stream"`` layout)."""
        w = self._little_cache.get(pid)
        if w is None:
            if self.stream is not None:
                self.prepare_works([pid], [])
                return self._little_cache[pid]
            t0 = time.perf_counter()
            w = part.block_little(self.edges, self._infos[pid], self.geom)
            self.t_block += time.perf_counter() - t0
            self._little_cache[pid] = w
        return w

    def big_work(self, pids: Tuple[int, ...]) -> BlockedEdges:
        """Big-pipeline layout of one batch of partitions (memoized; a
        :class:`.stream.StreamWork` under the ``"stream"`` layout)."""
        pids = tuple(int(p) for p in pids)
        w = self._big_cache.get(pids)
        if w is None:
            if self.stream is not None:
                self.prepare_works([], [pids])
                return self._big_cache[pids]
            t0 = time.perf_counter()
            w = part.block_big(self.edges, [self._infos[p] for p in pids],
                               self.geom)
            self.t_block += time.perf_counter() - t0
            self._big_cache[pids] = w
        return w

    def prepare_works(self, dense_pids, batches) -> None:
        """Build, in one go, the works a plan will ask for that are not
        memoized yet: under the ``"stream"`` layout the Little works of
        ``dense_pids`` and the Big works of ``batches`` (tuples of
        partition ids, built together on the store's device) under one
        ``store.stream`` span with their ``edges`` and ``bytes``. The
        padded layout builds each work when it is asked for."""
        if self.stream is None:
            return
        dense = [int(p) for p in dense_pids
                 if int(p) not in self._little_cache]
        batches = [tuple(int(p) for p in b) for b in batches]
        batches = [b for b in dict.fromkeys(batches)
                   if b not in self._big_cache]
        if not dense and not batches:
            return
        t0 = time.perf_counter()
        with obs.span("store.stream", "store", little=len(dense),
                      big=len(batches)) as sp:
            built = {p: stream_mod.little_work(self.stream, self._infos[p],
                                               self.geom) for p in dense}
            big = (stream_mod.big_works(self.stream, self._infos, self.geom,
                                        batches, self.device)
                   if batches else {})
            works = list(built.values()) + list(big.values())
            sp.set(edges=sum(w.num_real_edges for w in works),
                   bytes=sum(w.nbytes() for w in works))
        self._little_cache.update(built)
        self._big_cache.update(big)
        self.t_block += time.perf_counter() - t0

    # -- shared device-side aux ----------------------------------------
    def aux_on(self, device: torch.device) -> dict:
        """Apply/init auxiliary data (out-degrees on ``device`` etc.),
        built once per device and shared by every Executor there: also
        a read-only host copy of the out-degrees (``outdeg_host``, what
        an app's ``init`` reads) and the permutation on ``device``
        (``perm``, for the reorder to original ids)."""
        with self._plan_lock:
            aux = self._aux.get(device)
            if aux is None:
                outdeg = np.zeros(self.V_pad, np.float32)
                outdeg[:self.num_vertices] = self.out_degrees()
                outdeg.setflags(write=False)
                aux = {
                    "outdeg": torch.tensor(outdeg, device=device),
                    "outdeg_host": outdeg,
                    "perm": torch.tensor(self.perm, dtype=torch.int32,
                                         device=device),
                    "num_v": float(self.num_vertices),
                    "num_v_pad": self.V_pad,
                }
                self._aux[device] = aux
            return aux

    # -- planning / execution ------------------------------------------
    def plan(self, config=None):
        """Build (or fetch the cached) :class:`~.planner.PlanBundle` for a
        :class:`~.planner.PlanConfig` (a bounded, thread-safe LRU)."""
        from .planner import PlanConfig, Planner
        config = config or PlanConfig()
        key = config.cache_key()
        with self._plan_lock:
            bundle = self._plan_cache.get(key)
            if bundle is not None:
                self._plan_cache.move_to_end(key)
                return bundle
            with obs.span("plan.build", "planner",
                          n_lanes=config.n_lanes) as sp:
                bundle = Planner(self, config).build()
                sp.set(est_makespan=bundle.plan.est_makespan)
            self._plan_cache[key] = bundle
            while len(self._plan_cache) > self.max_plans:
                self._plan_cache.popitem(last=False)
                self.plan_evictions += 1
        return bundle

    def adopt_plan(self, bundle) -> None:
        """Insert a pre-built :class:`~.planner.PlanBundle` into the plan
        LRU under its config's cache key, replacing any cached bundle
        for that key: one assignment under the plan lock, so concurrent
        ``plan()`` callers see either the old bundle or the new one,
        never a partial build."""
        key = bundle.config.cache_key()
        with self._plan_lock:
            self._plan_cache[key] = bundle
            self._plan_cache.move_to_end(key)
            while len(self._plan_cache) > self.max_plans:
                self._plan_cache.popitem(last=False)
                self.plan_evictions += 1

    def peek_plan(self, config=None):
        """The cached :class:`~.planner.PlanBundle` for ``config``, or
        None — never builds and never touches LRU recency (the serving
        scheduler reads ``plan.est_makespan`` from it as a queued job's
        cost estimate)."""
        from .planner import PlanConfig
        config = config or PlanConfig()
        with self._plan_lock:
            return self._plan_cache.get(config.cache_key())

    def has_plan(self, config=None) -> bool:
        """True when ``plan(config)`` would hit the cache (a pure peek)."""
        from .planner import PlanConfig
        config = config or PlanConfig()
        with self._plan_lock:
            return config.cache_key() in self._plan_cache

    def clear_plans(self) -> dict:
        """Drop every cached PlanBundle (and the device payloads and
        captured iterations memoized on them). Blockings stay cached, so
        re-planning is cheap. Returns ``{"plans": evicted count,
        "freed_bytes": their device bytes}``."""
        with self._plan_lock:
            n = len(self._plan_cache)
            freed = sum(b.device_bytes()["total_bytes"]
                        for b in self._plan_cache.values())
            self._plan_cache.clear()
        return {"plans": n, "freed_bytes": int(freed)}

    def shard(self, config=None, devices=None):
        """Place and upload the (cached) plan's lanes across devices:
        lanes are LPT-assigned to owners from the perf model's per-lane
        estimates and each lane's packed tensors are uploaded to its
        owner. Returns the memoized
        :class:`~repro_torch.sharding.executor.ShardedLanes`; ``devices``
        is anything :func:`~repro_torch.sharding.executor.resolve_devices`
        accepts (None = every CUDA device, int n = the first n, or an
        explicit device sequence)."""
        from ..sharding.executor import resolve_devices
        self.require_padded("sharding a plan over devices")
        return self.plan(config).sharded_lanes(resolve_devices(devices))

    def executor(self, app, config=None, path: Optional[str] = None,
                 fuse_lanes: bool = True, device=None, shard=None):
        """Materialize an executor for one app on the (cached) plan for
        ``config``, on ``device`` (default ``cuda``; raises when there is
        no CUDA device and ``device="cpu"`` was not passed).
        ``fuse_lanes=False`` launches once per plan entry instead of once
        per packed lane (bit-identical results). ``shard`` switches to
        the multi-device
        :class:`~repro_torch.sharding.executor.ShardedExecutor` (per-device
        lane ownership, one merge per iteration): ``True`` shards over
        every CUDA device, an int over the first n, a device sequence
        over exactly those; ``None``/``False`` keeps the single-device
        Executor. ``shard`` names the devices, so it excludes
        ``device``."""
        if shard is not None and shard is not False:
            if device is not None:
                raise ValueError("pass either device= or shard=, not both "
                                 "(shard= names the devices)")
            if not fuse_lanes:
                raise ValueError("the sharded executor runs packed lanes; "
                                 "fuse_lanes=False has no sharded form")
            from ..sharding.executor import ShardedExecutor
            return ShardedExecutor(self, self.plan(config), app,
                                   devices=shard, path=path)
        from .executor import Executor
        return Executor(self, self.plan(config), app, path=path,
                        fuse_lanes=fuse_lanes,
                        device=device)

    def plan_and_run(self, app, config=None, path: Optional[str] = None,
                     max_iters: Optional[int] = None,
                     collect_history: bool = False, device=None):
        """One-call convenience: plan (cached) + execute one app."""
        ex = self.executor(app, config, path=path, device=device)
        return ex.run(max_iters=max_iters, collect_history=collect_history)

    # -- reporting ------------------------------------------------------
    def memory_footprint(self) -> dict:
        """Byte accounting of everything this store keeps alive: graph
        arrays, partition-sorted edges, memoized blockings, cached plans'
        device payloads and captured iterations, and the per-device aux. Under the ``"stream"``
        layout ``edge_bytes`` are the tile-major edges and
        ``blocking_bytes`` what the works hold beside them."""
        graph_bytes = self.perm.nbytes
        if self.stream is None:
            graph_bytes += sum(
                int(a.nbytes) for a in (self.graph.src, self.graph.dst,
                                        self.graph.weights) if a is not None)
            edge_bytes = sum(int(a.nbytes) for a in self.edges.values())
        else:
            edge_bytes = self.stream.nbytes()
        with self._plan_lock:
            works = (list(self._little_cache.values())
                     + list(self._big_cache.values()))
            blocking_bytes = sum(
                w.owned_nbytes() if isinstance(w, stream_mod.StreamWork)
                else _blocked_nbytes(w) for w in works)
            plan_bytes = sum(b.device_bytes()["total_bytes"]
                             for b in self._plan_cache.values())
            aux_bytes = sum(t.numel() * t.element_size()
                            for a in self._aux.values()
                            for t in a.values()
                            if isinstance(t, torch.Tensor))
        return {
            "graph_bytes": int(graph_bytes),
            "edge_bytes": int(edge_bytes),
            "blocking_bytes": int(blocking_bytes),
            "plan_bytes": int(plan_bytes),
            "aux_bytes": int(aux_bytes),
            "total_bytes": int(graph_bytes + edge_bytes + blocking_bytes
                               + plan_bytes + aux_bytes),
        }

    def placement_stats(self) -> dict:
        """Per-device placement section: lanes and payload bytes per
        device plus the worst imbalance ratio, over every cached plan's
        sharded forms (``devices == 0`` when nothing is sharded)."""
        with self._plan_lock:
            bundles = list(self._plan_cache.values())
        forms = [s.stats() for b in bundles
                 for s in list(b._sharded.values())]
        n_dev = max((s["n_devices"] for s in forms), default=0)
        lanes = [0] * n_dev
        nbytes = [0] * n_dev
        for s in forms:
            for d in range(s["n_devices"]):
                lanes[d] += s["lanes_per_device"][d]
                nbytes[d] += s["bytes_per_device"][d]
        return {
            "devices": n_dev,
            "sharded_plans": len(forms),
            "lanes_per_device": lanes,
            "bytes_per_device": nbytes,
            "imbalance": max((s["imbalance"] for s in forms),
                             default=1.0),
        }

    def device_bytes(self) -> int:
        """Bytes of the store's own edge state on a device (its plans'
        payloads and the per-device aux not counted). 0 in both layouts:
        a ``"stream"`` store builds on the card and keeps its edges in
        host memory."""
        if self.stream is None:
            return 0
        return sum(t.numel() * t.element_size() for t in (
            self.stream.src, self.stream.dst_local, self.stream.weights)
            if t.device.type != "cpu")

    def stats(self) -> dict:
        return {
            "layout": self.layout,
            "device_bytes": self.device_bytes(),
            "V": self.num_vertices,
            "E": self.num_edges,
            "partitions": len(self._infos),
            "t_dbg_ms": self.t_dbg * 1e3,
            "t_partition_ms": self.t_partition * 1e3,
            "t_block_ms": self.t_block * 1e3,
            "cached_little_works": len(self._little_cache),
            "cached_big_works": len(self._big_cache),
            "cached_plans": len(self._plan_cache),
            "plan_evictions": self.plan_evictions,
            "placement": self.placement_stats(),
            **self.memory_footprint(),
        }


def _blocked_nbytes(w) -> int:
    """Host bytes held by one BlockedEdges (numpy brick arrays)."""
    total = 0
    for f in dataclasses.fields(w):
        v = getattr(w, f.name)
        if isinstance(v, np.ndarray):
            total += int(v.nbytes)
    return total

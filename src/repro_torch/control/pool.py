"""Process-pool worker tier for CPU-heavy control-plane jobs.

A GraphStore build or delta splice is seconds of hot numpy; in a
worker *thread* every one of those seconds steals GIL timeslices from
``GraphService.update()`` and from the threads that issue kernel
launches in the same process. This module moves exactly those two job
kinds — store builds and delta splices — into worker *processes*,
while plan rebuilds and execution stay on in-process threads (they
hold CUDA tensors, which must not cross a process boundary).

Workers do host numpy only and never initialise CUDA: nothing they
receive or return holds a torch tensor on a card (a pickled CUDA tensor
would bring CUDA up in the child).

Job specs are pickle-safe and keyed by graph fingerprint:

* **build** ships the Graph and gets back a built
  :class:`~repro_torch.core.store.GraphStore` (its ``__getstate__``
  drops the lock, the plan cache and the per-device aux — the parent
  re-plans, which the carried blockings make cheap). The worker retains
  the store in a small per-process cache keyed ``(fp, geom, use_dbg)``.
* **apply** ships only the delta plus the base key. A worker that
  already holds the base (it applied the previous delta in the chain)
  splices without any graph bytes on the wire; one that doesn't
  answers ``need_state`` and the parent retries once, shipping the
  pickled base store. The result is the *splice-only*
  :class:`~repro_torch.streaming.DeltaApplyResult` — the parent runs
  :func:`~repro_torch.streaming.rebuild_plans` itself, because the
  packed device payloads being carried over live in the parent.

**Heterogeneous lanes.** The pool is N single-process executors, not
one N-process executor, split by workload class the same way the
paper splits pipelines: applies are latency-critical and small,
builds are throughput work that runs for whole seconds — so worker 0
is the dedicated **apply lane** and workers 1..N-1 are **build
lanes**. Mixing them (one shared executor) puts a 5 ms splice in line
behind a 2 s build and the update tail latency becomes the build
duration; it also scatters a snapshot chain across processes, missing
the worker-side cache (and re-shipping the pickled base) on every
other call. With the split, a chained update stream pays one base
ship ever, then stays warm on its lane. A single-worker pool shares
the one process between both classes.

Failure containment: a worker dying mid-job (OOM-kill, segfault,
``os._exit``) breaks its executor, so :class:`WorkerPool` converts
that into a :class:`WorkerCrashed` for the one in-flight job and
respawns just that slot — the pool survives (a fresh apply-lane
process simply re-ships state on first use), and the serving layer's
cache lease for the failed job is released by its normal
failed-build path (the lease-on-crash regression test in
tests/test_torch_control_plane.py holds this).

The default mp context is **spawn**: with CUDA initialised in the
parent, a forked child inherits a CUDA context it cannot use, and fork
would also snapshot the parent's whole heap (device-side bookkeeping
included) into every child.
"""
from __future__ import annotations

import collections
import multiprocessing
import threading
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import Optional

from ..core.store import GraphStore
from ..core.types import Geometry
from ..graphs.formats import Graph
from ..streaming.apply import BULK_THRESHOLD, DeltaApplyResult, splice_delta
from ..streaming.delta import GraphDelta

__all__ = ["WorkerPool", "WorkerCrashed"]


class WorkerCrashed(RuntimeError):
    """The worker process executing this job died before finishing.
    The pool has already respawned; the job itself is NOT retried
    (a crash is evidence the job kills workers)."""


# ---------------------------------------------------------------------
# worker-side (runs in the child processes; module-level for pickling)
# ---------------------------------------------------------------------

_STORE_CACHE: "collections.OrderedDict[tuple, GraphStore]" = \
    collections.OrderedDict()
_STORE_CACHE_MAX = 8


def _w_cache_put(key: tuple, store: GraphStore) -> None:
    _STORE_CACHE[key] = store
    _STORE_CACHE.move_to_end(key)
    while len(_STORE_CACHE) > _STORE_CACHE_MAX:
        _STORE_CACHE.popitem(last=False)


def _w_ping() -> bool:
    return True


def _w_crash() -> None:
    """Test hook: die the way a segfault/OOM-kill does (no exception,
    no cleanup — the parent sees a broken pool)."""
    import os
    os._exit(13)


def _w_traced(root_name: str, fn):
    """Run ``fn`` under a throwaway worker-local tracer and return
    ``(result, ended spans as dicts)`` — the trace carrier across the
    pickled process boundary. Span ids are uuid-based (collision-free
    across processes) and starts are epoch time, so the parent's
    :meth:`~repro_torch.obs.Tracer.adopt` can splice them straight into the
    submitting job's trace."""
    import os

    from ..obs import Tracer
    tracer = Tracer()
    root = tracer.start_trace(root_name, "pool-worker", pid=os.getpid())
    try:
        with tracer.activate(root.context):
            result = fn()
    finally:
        root.end()
    return result, tracer.export(root.trace_id)


def _w_build_store(graph: Graph, geom: Geometry, use_dbg: bool,
                   fp: Optional[str], max_plans: Optional[int],
                   crash: bool = False, trace: bool = False):
    if crash:
        _w_crash()

    def build() -> GraphStore:
        store = GraphStore(graph, geom=geom, use_dbg=use_dbg,
                           max_plans=max_plans, fingerprint=fp)
        _w_cache_put((store.fingerprint(), geom, use_dbg), store)
        return store

    if trace:
        return _w_traced("pool.worker.build", build)
    return build()


def _w_apply_delta(key: tuple, delta: GraphDelta, bulk_threshold,
                   base_store: Optional[GraphStore],
                   crash: bool = False, trace: bool = False):
    if crash:
        _w_crash()
    store = base_store if base_store is not None else _STORE_CACHE.get(key)
    if store is None:
        return ("need_state", None, []) if trace else ("need_state", None)

    def apply() -> DeltaApplyResult:
        res = splice_delta(store, delta, bulk_threshold=bulk_threshold)
        _w_cache_put(key, store)                   # base stays reusable
        _w_cache_put((res.fingerprint, key[1], key[2]), res.store)
        return res

    if trace:
        res, spans = _w_traced("pool.worker.apply", apply)
        return "ok", res, spans
    return "ok", apply()


# ---------------------------------------------------------------------
# parent-side
# ---------------------------------------------------------------------

class WorkerPool:
    """Lane-split, respawning process pool for store builds and delta
    splices.

    Parameters
    ----------
    workers: child process count. With 2+, worker 0 is the dedicated
        apply lane and the rest are build lanes (see the module
        docstring); with 1, both job kinds share the process.
    mp_context: multiprocessing start method (default ``"spawn"``).
    warm: submit a no-op to every worker at construction so the first
        real job doesn't pay interpreter start + import latency.
    """

    _APPLY_LANE = 0

    def __init__(self, workers: int = 2, mp_context: str = "spawn",
                 warm: bool = False):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.workers = workers
        self._ctx = multiprocessing.get_context(mp_context)
        self._lock = threading.Lock()
        self._execs = [self._spawn() for _ in range(workers)]
        self._inflight = [0] * workers
        self._build_lanes = (list(range(1, workers)) if workers > 1
                             else [0])
        self._closed = False
        self.jobs = 0
        self.crashes = 0
        self.need_state_retries = 0
        if warm:
            self.warm()

    def _spawn(self) -> ProcessPoolExecutor:
        return ProcessPoolExecutor(max_workers=1, mp_context=self._ctx)

    def warm(self) -> None:
        """Block until every worker process is up (spawn cost is paid
        here, not on the first build)."""
        futs = [ex.submit(_w_ping) for ex in list(self._execs)]
        for f in futs:
            f.result()

    def _run(self, idx: int, fn, /, *args):
        """Submit + await one job on worker ``idx``; a broken executor
        becomes WorkerCrashed for THIS job and a fresh process (with a
        cold cache) in that slot for the next one."""
        with self._lock:
            if self._closed:
                raise RuntimeError("WorkerPool is closed")
            ex = self._execs[idx]
            self.jobs += 1
            self._inflight[idx] += 1
        try:
            return ex.submit(fn, *args).result()
        except BrokenProcessPool as exc:
            with self._lock:
                self.crashes += 1
                if self._execs[idx] is ex and not self._closed:
                    self._execs[idx] = self._spawn()   # pool survives
            raise WorkerCrashed(
                f"worker process died while running {fn.__name__}; the "
                f"pool respawned but this job is not retried") from exc
        finally:
            with self._lock:
                self._inflight[idx] -= 1

    # -- job kinds ------------------------------------------------------
    def build_store(self, graph: Graph, *, geom: Geometry, use_dbg: bool,
                    fp: Optional[str] = None,
                    max_plans: Optional[int] = None,
                    _crash: bool = False, trace: bool = False):
        """Build a GraphStore in a build-lane worker process (the
        least-loaded one). The returned store has no plans and no locks
        attached (see ``GraphStore.__getstate__``); the parent plans on
        it lazily as usual. With ``trace=True`` the worker records its
        build stages into a local tracer and the call returns
        ``(store, span dicts)`` for the parent to
        :meth:`~repro_torch.obs.Tracer.adopt`."""
        with self._lock:
            idx = min(self._build_lanes, key=lambda i: self._inflight[i])
        return self._run(idx, _w_build_store, graph, geom, use_dbg, fp,
                         max_plans, _crash, trace)

    def apply(self, store: GraphStore, delta: GraphDelta, *,
              bulk_threshold=BULK_THRESHOLD,
              _crash: bool = False, trace: bool = False):
        """Splice ``delta`` against ``store`` in the apply-lane worker
        and return the splice-only result (no plans rebuilt — run
        :func:`repro_torch.streaming.rebuild_plans` in the parent). The lane
        never queues behind builds, and holds each snapshot chain in
        its cache: the first touch of a lineage ships the pickled base
        once, every later delta travels alone. With ``trace=True``
        returns ``(result, span dicts)`` — spans from BOTH calls when a
        ``need_state`` retry re-ships the base."""
        key = (store.fingerprint(), store.geom, store.use_dbg)
        idx = self._APPLY_LANE
        out = self._run(idx, _w_apply_delta, key, delta,
                        bulk_threshold, None, _crash, trace)
        status, res, spans = out if trace else (*out, None)
        if status == "need_state":
            with self._lock:
                self.need_state_retries += 1
            out = self._run(idx, _w_apply_delta, key, delta,
                            bulk_threshold, store, _crash, trace)
            if trace:
                status, res, retry_spans = out
                spans = list(spans) + list(retry_spans)
            else:
                status, res = out
        assert status == "ok"
        return (res, spans) if trace else res

    def alive(self) -> bool:
        """True while every worker slot is usable: the pool is open and
        no executor is broken awaiting its next-job respawn. The pool
        half of the control plane's readiness probe — a crashed slot
        flips this False only for the instant before ``_run`` respawns
        it, so a persistent False means the pool is closed or a respawn
        failed."""
        with self._lock:
            if self._closed:
                return False
            return all(not getattr(ex, "_broken", False)
                       for ex in self._execs)

    # -- lifecycle ------------------------------------------------------
    def close(self, wait: bool = True) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            execs = list(self._execs)
        for ex in execs:
            ex.shutdown(wait=wait)

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        with self._lock:
            return {"workers": self.workers, "jobs": self.jobs,
                    "crashes": self.crashes,
                    "need_state_retries": self.need_state_retries}

"""The one traffic generator: closed-loop clients and an optional updater.

A traffic mix (``traffic/<name>.json``) is data:

* ``clients``: one closed-loop client each, ``{"app": name, "app_kwargs":
  {...}, "root": "nonzero_degree"}``; a client sends its next request
  when the last one has answered, always against the newest snapshot;
* ``updater``: null, or ``{"churn": share of edges, "hot_frac": share of
  vertices}``: one thread that applies skewed deltas back to back through
  ``GraphService.update`` (see :func:`gbench.gen.skewed_churn`).

A request belongs to the window when it was sent before the window
closed; after the close no client sends, and each waits for its request
in flight. An update counts from its call until the new snapshot answers
its first request.

While an update runs, the updater holds a lease on the old snapshot's
store until every request sent against it has answered, so that a
request sent just before the new fingerprint was published never finds
its store retired (which would make the service rebuild it).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from . import gen


@dataclasses.dataclass
class Request:
    app: str
    kwargs: dict
    snap: int
    t_submit: float
    traced: bool
    t_done: Optional[float] = None
    error: Optional[str] = None
    iterations: Optional[int] = None
    stages: Optional[dict] = None


@dataclasses.dataclass
class Update:
    snap: int                      # the snapshot it made
    t_call: float
    stats: dict
    delta: gen.Delta
    t_first: Optional[float] = None


class Keeper:
    """Which answers the judge gets. Requests without per-request
    arguments give one answer per snapshot; every such answer is kept,
    equal ones once. Of the others, a reservoir of ``k`` per app drawn
    from the seed, and the one that took most iterations."""

    K = 32                   # sampled answers an app
    MAX_DISTINCT = 64        # distinct answers kept a snapshot and app

    def __init__(self, seed: int):
        self._rng = np.random.default_rng([int(seed) % (2 ** 63), 11])
        self._lock = threading.Lock()
        self.distinct = {}       # (snap, app) -> [(answer, iterations, n)]
        self.kwargs = {}         # app -> its arguments
        self.sampled = {}        # app -> [(request, answer)]
        self.longest = {}        # app -> (request, answer)
        self._seen = {}

    def offer(self, req: Request, answer: np.ndarray) -> None:
        with self._lock:
            if "root" not in req.kwargs:
                self.kwargs[req.app] = req.kwargs
                kept = self.distinct.setdefault((req.snap, req.app), [])
                for i, (a, it, n) in enumerate(kept):
                    if it == req.iterations and np.array_equal(a, answer):
                        kept[i] = (a, it, n + 1)
                        return
                if len(kept) < self.MAX_DISTINCT:
                    kept.append((answer, req.iterations, 1))
                return
            n = self._seen[req.app] = self._seen.get(req.app, 0) + 1
            pool = self.sampled.setdefault(req.app, [])
            if len(pool) < self.K:
                pool.append((req, answer))
            else:
                j = int(self._rng.integers(n))
                if j < self.K:
                    pool[j] = (req, answer)
            top = self.longest.get(req.app)
            if top is None or req.iterations > top[0].iterations:
                self.longest[req.app] = (req, answer)

    def judged(self):
        """(snap, app, kwargs, answer, iterations, answers it stands
        for) of every kept answer."""
        out = []
        for (snap, app), kept in sorted(self.distinct.items()):
            out += [(snap, app, self.kwargs[app], a, it, n)
                    for a, it, n in kept]
        for app, pool in sorted(self.sampled.items()):
            reqs = {id(r): (r, a) for r, a in pool}
            r, a = self.longest[app]
            reqs[id(r)] = (r, a)
            out += [(r.snap, app, r.kwargs, a, r.iterations, 1)
                    for r, a in reqs.values()]
        return out


class Gate:
    """Lets the harness stop the clients between requests (to start or
    stop the profiler on a quiet device) and mark what they send."""

    def __init__(self):
        self._cond = threading.Condition()
        self._open, self._busy, self.traced = True, 0, False

    def enter(self) -> bool:
        with self._cond:
            while not self._open:
                self._cond.wait()
            self._busy += 1
            return self.traced

    def leave(self) -> None:
        with self._cond:
            self._busy -= 1
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._open = False
            while self._busy:
                self._cond.wait()

    def reopen(self, traced: bool) -> None:
        with self._cond:
            self._open, self.traced = True, traced
            self._cond.notify_all()


class Session:
    """One run's traffic against one service."""

    TIMEOUT_S = 60.0         # how long past the close a request may take

    def __init__(self, svc, mix: dict, fp: str, edges: gen.EdgeSet,
                 args: gen.RequestArgs, keeper: Keeper, seed: int,
                 config, weights):
        self.svc, self.mix, self.keeper = svc, mix, keeper
        self.config, self.weights = config, weights
        self.args, self.seed = args, seed
        self.requests: List[Request] = []
        self.updates: List[Update] = []
        self.update_errors: List[str] = []
        self.fps = [fp]                  # snapshot index -> fingerprint
        self.edge_counts = [edges.num_edges]
        self._edges = edges
        self._cond = threading.Condition()
        self._outstanding = {}           # snap -> requests in flight
        self._first = {}                 # snap -> first answer time
        self.gate = Gate()
        self.t_open = self.t_close = None

    # -- clients -------------------------------------------------------
    def _client(self, spec: dict, stream) -> None:
        while True:
            traced = self.gate.enter()
            try:
                if time.perf_counter() >= self.t_close:
                    return
                self._one(spec, next(stream), traced)
            finally:
                self.gate.leave()

    def _one(self, spec: dict, kwargs: dict, traced: bool) -> None:
        with self._cond:
            snap = len(self.fps) - 1
            fp = self.fps[snap]
            self._outstanding[snap] = self._outstanding.get(snap, 0) + 1
        req = Request(spec["app"], kwargs, snap, time.perf_counter(), traced)
        try:
            h = self.svc.submit(fingerprint=fp, app=spec["app"],
                                app_kwargs=kwargs, config=self.config)
            wait = max(1.0, self.t_close + self.TIMEOUT_S
                       - time.perf_counter())
            props, meta = h.result(timeout=wait)
            req.t_done = time.perf_counter()
            req.iterations = int(meta["iterations"])
            m = h.metrics
            req.stages = {k: getattr(m, k) for k in (
                "t_queue_ms", "t_store_ms", "t_plan_ms", "t_execute_ms",
                "t_total_ms")}
            self.keeper.offer(req, props)
        except Exception as exc:            # a failed request is counted
            req.error = f"{type(exc).__name__}: {exc}"
        with self._cond:
            self._outstanding[snap] -= 1
            if req.t_done is not None and snap not in self._first:
                self._first[snap] = req.t_done
            self.requests.append(req)
            self._cond.notify_all()

    # -- updater -------------------------------------------------------
    def _updater(self, spec: dict) -> None:
        from repro_torch.serve_graph.fingerprint import store_key
        from repro_torch.streaming import make_delta

        svc = self.svc
        g = gen.generator(self.seed, 1, self._edges.keys.device)
        while time.perf_counter() < self.t_close:
            delta = gen.skewed_churn(self._edges, spec["churn"],
                                     spec["hot_frac"], self.weights, g)
            host = [t.to(torch.int32).cpu().numpy() for t in (
                delta.add_src, delta.add_dst, delta.rm_src, delta.rm_dst)]
            old = len(self.fps) - 1
            pd = make_delta(self.fps[old],
                            add=(host[0], host[1],
                                 delta.add_w.to(torch.float32).cpu().numpy()),
                            remove=(host[2], host[3]))
            after = gen.apply(self._edges, delta)
            key = store_key(self.fps[old], svc.default_geom,
                            svc.default_use_dbg)
            t_call = time.perf_counter()
            try:
                with svc.cache.lease(key):
                    res = svc.update(self.fps[old], pd)
                    with self._cond:
                        self.fps.append(res.fingerprint)
                        self.edge_counts.append(after.num_edges)
                        while self._outstanding.get(old, 0):
                            self._cond.wait()
            except Exception as exc:          # a failed update is counted
                self.update_errors.append(f"{type(exc).__name__}: {exc}")
                return
            self._edges = after
            self.updates.append(Update(old + 1, t_call,
                                       dict(res.stats or {}), delta))
            with self._cond:
                while (old + 1 not in self._first
                       and time.perf_counter() < self.t_close):
                    self._cond.wait(0.05)

    def drop_edges(self) -> None:
        """Free the generator's device copy of the newest snapshot."""
        self._edges = None

    # -- the window ----------------------------------------------------
    def run(self, seconds: float, profile=None, trace_s: float = 3.0):
        """Drive the mix for ``seconds``. With ``profile`` (an object
        with ``start()`` and ``stop()``), stop the clients in the middle
        of the window, profile ``trace_s`` seconds of traffic from a
        quiet start to a drained end, and let them go on."""
        threads = []
        self.t_open = time.perf_counter()
        self.t_close = self.t_open + seconds
        for i, spec in enumerate(self.mix["clients"]):
            stream = self.args.stream(i, spec)
            threads.append(threading.Thread(
                target=self._client, args=(spec, stream),
                name=f"gbench-client-{i}", daemon=True))
        if self.mix.get("updater"):
            threads.append(threading.Thread(
                target=self._updater, args=(self.mix["updater"],),
                name="gbench-updater", daemon=True))
        for t in threads:
            t.start()
        if profile is not None:
            trace_s = min(trace_s, seconds / 3)
            time.sleep(max(0.0, (seconds - trace_s) / 2))
            self.gate.close()
            profile.start()
            self.gate.reopen(traced=True)
            time.sleep(trace_s)
            self.gate.close()
            profile.stop()
            self.gate.reopen(traced=False)
        for t in threads:
            t.join(max(1.0, self.t_close + self.TIMEOUT_S + 30
                       - time.perf_counter()))
        hung = [t.name for t in threads if t.is_alive()]
        if hung:
            raise RuntimeError(f"threads still running after the window: "
                               f"{hung}")
        for u in self.updates:
            u.t_first = self._first.get(u.snap)

"""The port's serving layer (``repro_torch.serve_graph``) against the JAX
reference's, and against the port's own executor.

Parity with ``repro.serve_graph`` (the same seeded graphs through both
services; the reference on its ref path, the port with
``device="cpu"``): every builtin app exactly for BFS, SSSP, WCC and
closeness, PageRank within rtol 1e-5; fingerprints and store keys
exactly; the Prometheus exposition text exactly for the same recorded
events. Inside the port, bit for bit: a served result == a direct
``Executor`` run on the same store and plan, sharded == fused, an
update's snapshot == ``apply_delta``'s, and the traced per-lane run ==
the fused run. Plus the refusals: no CUDA and no ``device="cpu"``, and
a retune on a service without ``autotune=``.
"""
import dataclasses
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.graphs.rmat import rmat as jrmat
from repro.serve_graph import GraphService as JGraphService
from repro.serve_graph.fingerprint import store_key as jstore_key
from repro.serve_graph.metrics import (RequestMetrics as JRequestMetrics,
                                       ServiceMetrics as JServiceMetrics)
from repro.streaming import random_delta as jrandom

from repro_torch import api as tapi, convert
from repro_torch.core.executor import Executor
from repro_torch.core.gas import BUILTIN_APPS
from repro_torch.serve_graph import GraphStoreCache, store_key
from repro_torch.serve_graph.metrics import RequestMetrics, ServiceMetrics
from repro_torch.streaming import apply_delta, random_delta

GEOM_J = japi.Geometry(U=512, W=512, T=512, E_BLK=128, big_batch=2)
GEOM = convert.geometry_from(GEOM_J)
N_LANES = 4
WAIT = 300.0
APPS = [("pagerank", {}), ("bfs", {"root": 0}), ("sssp", {"root": 0}),
        ("wcc", {}), ("closeness", {"sources": np.arange(4)})]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run shares the CPU among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_graph(g):
    return convert.graph_from_arrays(g.num_vertices, g.src, g.dst,
                                     g.weights)


@pytest.fixture(scope="module")
def graphs():
    gj = jrmat(11, 8, seed=3, weighted=True)       # 2048 V, 8 partitions
    return gj, _port_graph(gj)


@pytest.fixture(scope="module")
def services(graphs):
    """One port service (CPU) and one reference service (ref path), each
    with the graph registered and its store prepared."""
    gj, gt = graphs
    with tapi.GraphService(device="cpu", default_geom=GEOM,
                           workers=2) as svc, \
            JGraphService(default_geom=GEOM_J, default_path="ref",
                          workers=2) as jsvc:
        fp, jfp = svc.register(gt), jsvc.register(gj)
        assert fp == jfp
        yield svc, jsvc, fp


def _served(svc, fp, app, kw, **extra):
    return svc.submit(fingerprint=fp, app=app, app_kwargs=kw,
                      n_lanes=N_LANES, **extra).result(timeout=WAIT)


def _cached_store(svc, fp):
    store = svc.cache.peek(store_key(fp, GEOM, True))
    assert store is not None
    return store


def test_fingerprint_and_store_key_parity(graphs):
    gj, gt = graphs
    assert gt.fingerprint() == gj.fingerprint()
    assert tapi.graph_fingerprint(gt) == japi.graph_fingerprint(gj)
    k, kj = store_key(gt.fingerprint(), GEOM, 1), \
        jstore_key(gj.fingerprint(), GEOM_J, 1)
    assert k[0] == kj[0] and k[2] is kj[2] is True
    assert dataclasses.astuple(k[1]) == dataclasses.astuple(kj[1])
    with pytest.raises(ValueError):
        store_key("", GEOM, True)
    assert store_key(k[0], GEOM, True) != store_key(k[0], GEOM, False)


@pytest.mark.parametrize("app,kw", APPS, ids=[a for a, _ in APPS])
def test_builtin_app_parity_with_reference(services, app, kw):
    svc, jsvc, fp = services
    props, meta = _served(svc, fp, app, kw)
    jprops, jmeta = _served(jsvc, fp, app, kw)
    jprops = np.asarray(jprops)
    assert props.shape == jprops.shape and props.dtype == jprops.dtype
    if app == "pagerank":
        assert abs(meta["iterations"] - jmeta["iterations"]) <= 1
        np.testing.assert_allclose(props, jprops, rtol=1e-5, atol=1e-7)
    else:
        assert meta["iterations"] == jmeta["iterations"]
        np.testing.assert_array_equal(props, jprops)


@pytest.mark.parametrize("app,kw", APPS[:2], ids=["pagerank", "bfs"])
def test_served_equals_direct_executor(services, app, kw):
    """Same store, same plan, same payloads, same launches: bit-equal."""
    svc, _, fp = services
    props, meta = _served(svc, fp, app, kw)
    store = _cached_store(svc, fp)
    ex = Executor(store, store.plan(tapi.PlanConfig(n_lanes=N_LANES)),
                  BUILTIN_APPS[app](**kw), device="cpu")
    want, wmeta = ex.run()
    assert meta["iterations"] == wmeta["iterations"]
    assert torch.equal(torch.from_numpy(props), torch.from_numpy(want))


def test_request_metrics_and_warm_hits(services):
    svc, _, fp = services
    _served(svc, fp, "wcc", {})
    h = svc.submit(fingerprint=fp, app="wcc", n_lanes=N_LANES)
    h.result(timeout=WAIT)
    m = h.metrics
    assert m.store_hit and m.plan_hit
    for stage in ("t_queue_ms", "t_store_ms", "t_plan_ms", "t_execute_ms",
                  "t_total_ms"):
        assert getattr(m, stage) >= 0.0, stage
    snap = svc.metrics.snapshot()
    assert snap["store_hits"] >= 1 and snap["p50_execute_ms"] > 0
    assert svc.stats()["cached_executors"] >= 1


def test_coalesced_burst_executes_once(graphs):
    """Eight identical submits queued behind a held worker run once and
    fan one result out to every handle."""
    _, gt = graphs
    with tapi.GraphService(device="cpu", default_geom=GEOM,
                           workers=1) as svc:
        fp = svc.register(gt)
        gate = threading.Event()
        hold = svc.submit(fingerprint=fp, app="wcc", n_lanes=N_LANES,
                          observer=lambda e, i: gate.wait(60)
                          if e == "running" else None)
        time.sleep(0.2)                     # hold reaches the worker
        hs = [svc.submit(fingerprint=fp, app="pagerank", n_lanes=N_LANES)
              for _ in range(8)]
        gate.set()
        results = [h.result(timeout=WAIT) for h in hs]
        hold.result(timeout=WAIT)
        snap = svc.metrics.snapshot()
    assert snap["executions"] == 2 and snap["coalesced"] == 7
    assert all(r[0] is results[0][0] for r in results)
    assert sum(h.metrics.coalesced for h in hs) == 7


def test_sharded_service_equals_fused_on_cpu(services):
    """``shard=n`` on a CPU service runs n CPU owners; bit-equal."""
    svc, _, fp = services
    for app, kw in APPS[:2]:
        fused, fm = _served(svc, fp, app, kw)
        sharded, sm = _served(svc, fp, app, kw, shard=2)
        assert fm["iterations"] == sm["iterations"]
        assert torch.equal(torch.from_numpy(fused),
                           torch.from_numpy(sharded))


def test_update_matches_apply_delta_and_reference(graphs):
    """An in-process update re-keys to the reference's chained
    fingerprint and serves what ``apply_delta`` on the same store gives,
    bit for bit."""
    gj, gt = graphs
    kw = dict(churn=0.01, seed=17, hot_frac=0.02)
    d, dj = random_delta(gt, **kw), jrandom(gj, **kw)
    with tapi.GraphService(device="cpu", default_geom=GEOM,
                           workers=1) as svc, \
            JGraphService(default_geom=GEOM_J, default_path="ref",
                          workers=1) as jsvc:
        fp = svc.register(gt)
        jsvc.register(gj)
        _served(svc, fp, "bfs", {"root": 0})    # plans and packs the base
        base = _cached_store(svc, fp)
        up, jup = svc.update(fp, d), jsvc.update(fp, dj)
        assert up.fingerprint == jup.fingerprint
        assert up.mode == jup.mode == "incremental"
        assert up.stats["packed_lanes_reused"] > 0
        want = apply_delta(base, d).store
        for app, kw in APPS[:2]:
            got, gm = _served(svc, up.fingerprint, app, kw)
            ex = Executor(want, want.plan(tapi.PlanConfig(n_lanes=N_LANES)),
                          BUILTIN_APPS[app](**kw), device="cpu")
            ref, rm = ex.run()
            assert gm["iterations"] == rm["iterations"]
            assert torch.equal(torch.from_numpy(got), torch.from_numpy(ref))
        assert svc.metrics.snapshot()["updates"] == 1


def _lane_spans(tracer, trace_id):
    spans = tracer.export(trace_id)
    return ([s for s in spans if s["name"] == "executor.lane"],
            [s for s in spans if s["name"] == "executor.merge_apply"],
            [s for s in spans if s["name"] == "executor.iteration"])


@pytest.mark.parametrize("fuse_lanes", [True, False],
                         ids=["packed", "per_entry"])
def test_traced_lane_run_is_bit_identical(services, fuse_lanes):
    """Under a ``lane_detail`` tracer the executor runs its lanes one at
    a time with a span each; the result equals the fused run's bit for
    bit, and every lane span carries the perf model's estimate."""
    svc, _, fp = services
    store = _cached_store(svc, fp)
    bundle = store.plan(tapi.PlanConfig(n_lanes=N_LANES))
    ex = Executor(store, bundle, tapi.make_pagerank(), device="cpu",
                  fuse_lanes=fuse_lanes)
    want, wmeta = ex.run()
    tracer = tapi.Tracer(lane_detail=True)
    root = tracer.start_trace("job")
    with tracer.activate(root.context):
        got, gmeta = ex.run()
    root.end()
    assert gmeta["iterations"] == wmeta["iterations"]
    assert torch.equal(torch.from_numpy(got), torch.from_numpy(want))
    lanes, merges, iters = _lane_spans(tracer, root.trace_id)
    n_lanes = sum(1 for lane in ex.lanes if lane)
    assert len(iters) == len(merges) == gmeta["iterations"]
    assert len(lanes) == n_lanes * gmeta["iterations"]
    est = {i: e for i, (e, _) in enumerate(ex._lane_est)}
    for s in lanes:
        a = s["attrs"]
        assert a["est_time"] == est[a["lane"]] and a["n_entries"] > 0
        assert a["kind"] in ("little", "big", "mixed")
        assert a["bytes"] > 0 and a["gbps"] >= 0
    assert ex.utilization()["kinds"]           # the lanes were measured
    # a tracer without lane detail keeps the fused run: no lane or
    # merge spans, one iteration span per iteration
    coarse = tapi.Tracer(lane_detail=False)
    root = coarse.start_trace("job")
    with coarse.activate(root.context):
        again, ameta = ex.run()
    root.end()
    assert torch.equal(torch.from_numpy(again), torch.from_numpy(want))
    lanes, merges, iters = _lane_spans(coarse, root.trace_id)
    assert lanes == [] and merges == []
    assert len(iters) == ameta["iterations"] == wmeta["iterations"]


def test_traced_lane_spans_match_reference(services):
    """The port's lane spans name the same lanes, kinds and entry counts
    as the reference's traced run, with the same estimates."""
    svc, jsvc, fp = services
    store = _cached_store(svc, fp)
    jstore = jsvc.cache.peek(jstore_key(fp, GEOM_J, True))
    ex = Executor(store, store.plan(tapi.PlanConfig(n_lanes=N_LANES)),
                  tapi.make_pagerank(), device="cpu")
    jex = japi.Executor(jstore, jstore.plan(japi.PlanConfig(
        n_lanes=N_LANES)), japi.make_pagerank(), path="ref")
    got = []
    for tracer_cls, e in ((tapi.Tracer, ex), (japi.Tracer, jex)):
        tracer = tracer_cls(lane_detail=True)
        root = tracer.start_trace("job")
        with tracer.activate(root.context):
            e.run(max_iters=2)
        root.end()
        got.append(sorted(
            (s["attrs"]["lane"], s["attrs"]["kind"], s["attrs"]["n_entries"],
             s["attrs"]["est_time"]) for s in tracer.export(root.trace_id)
            if s["name"] == "executor.lane"))
    assert got[0] and len(got[0]) == len(got[1])
    for (l, k, n, e), (jl, jk, jn, je) in zip(*got):
        assert (l, k, n) == (jl, jk, jn)
        assert e == pytest.approx(je, rel=1e-9)


def test_service_trace_spans(graphs):
    """A traced job covers the queue, the store, the plan, the execution
    and each lane, and returns what the untraced job returned."""
    _, gt = graphs
    tracer = tapi.Tracer(lane_detail=True)
    with tapi.GraphService(device="cpu", default_geom=GEOM, workers=1,
                           tracer=tracer) as svc:
        h = svc.submit(gt, "pagerank", n_lanes=N_LANES, max_iters=3)
        props, _ = h.result(timeout=WAIT)
        store = _cached_store(svc, gt.fingerprint())
        plain, _ = Executor(store, store.plan(tapi.PlanConfig(
            n_lanes=N_LANES)), tapi.make_pagerank(),
            device="cpu").run(max_iters=3)
    names = [s["name"] for t in tracer.trace_ids() for s in tracer.export(t)]
    for needle in ("job:pagerank", "queue.wait", "service.store",
                   "store.dbg", "service.plan", "plan.build", "plan.pack",
                   "service.execute", "executor.iteration",
                   "executor.lane", "executor.merge_apply"):
        assert needle in names, needle
    assert torch.equal(torch.from_numpy(props), torch.from_numpy(plain))


def _tensors_in(obj, seen=None):
    """Every torch tensor reachable from ``obj`` through containers,
    dataclasses and instance dicts."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, np.ndarray) or obj is None:
        return []
    if isinstance(obj, dict):
        items = list(obj.keys()) + list(obj.values())
    elif isinstance(obj, (list, tuple, set, frozenset)):
        items = list(obj)
    elif hasattr(obj, "__dict__"):
        items = list(vars(obj).values())
    else:
        return []
    return [t for x in items for t in _tensors_in(x, seen)]


def test_pickled_store_carries_no_device_state(graphs):
    """A store planned and run on the port pickles without its plan
    cache (payloads), its aux (device out-degrees) or its lock, with its
    identity resolved; the clone re-plans to the same results."""
    _, gt = graphs
    store = tapi.GraphStore(gt, geom=GEOM)
    ex = store.executor(tapi.make_pagerank(),
                        tapi.PlanConfig(n_lanes=N_LANES), device="cpu")
    want, _ = ex.run(max_iters=3)
    assert store._aux and store.has_plan(tapi.PlanConfig(n_lanes=N_LANES))
    assert _tensors_in(store)                  # payloads and aux live
    state = store.__getstate__()
    assert state["_fp"] == gt.fingerprint()
    clone = pickle.loads(pickle.dumps(store))
    assert _tensors_in(clone) == []
    assert len(clone._plan_cache) == 0 and clone._aux == {}
    assert clone.fingerprint() == store.fingerprint()
    for k in store.edges:
        assert np.array_equal(clone.edges[k], store.edges[k])
    got, _ = clone.executor(tapi.make_pagerank(),
                            tapi.PlanConfig(n_lanes=N_LANES),
                            device="cpu").run(max_iters=3)
    assert torch.equal(torch.from_numpy(got), torch.from_numpy(want))
    # a derived store resolves its chained identity before pickling
    res = apply_delta(store, random_delta(gt, churn=0.01, seed=5))
    dclone = pickle.loads(pickle.dumps(res.store))
    assert dclone.fingerprint() == res.fingerprint
    assert _tensors_in(dclone) == []


def test_peek_and_adopt_plan(graphs):
    _, gt = graphs
    store = tapi.GraphStore(gt, geom=GEOM, max_plans=1)
    four, two = tapi.PlanConfig(n_lanes=4), tapi.PlanConfig(n_lanes=2)
    assert store.peek_plan(four) is None and not store.has_plan(four)
    b4 = store.plan(four)
    assert store.peek_plan(four) is b4
    b2 = tapi.Planner(store, two).build()
    store.adopt_plan(b2)                       # evicts four (max_plans=1)
    assert store.peek_plan(two) is b2 and store.plan(two) is b2
    assert store.peek_plan(four) is None and store.plan_evictions == 1


def test_executor_lru_and_cache_count_device_bytes(graphs):
    """The executor LRU's byte budget counts each executor's payload
    bytes, and the store cache counts the plans' payload bytes."""
    _, gt = graphs
    with tapi.GraphService(device="cpu", default_geom=GEOM, workers=1,
                           executor_byte_budget=1) as svc:
        fp = svc.register(gt)
        _served(svc, fp, "pagerank", {})
        _served(svc, fp, "bfs", {"root": 0})
        st = svc.stats()
        store = _cached_store(svc, fp)
        (ex, nbytes), = svc._executors.values()
        assert st["cached_executors"] == 1
        assert st["service"]["executor_evictions"] >= 1
        assert nbytes == st["executor_bytes"] == ex.memory_footprint() > 0
        mem = store.memory_footprint()
        assert mem["plan_bytes"] == store.plan(tapi.PlanConfig(
            n_lanes=N_LANES)).device_bytes()["total_bytes"] >= nbytes
        assert svc.cache.current_bytes == mem["total_bytes"]
    cache = GraphStoreCache(byte_budget=mem["total_bytes"] - 1)
    cache.put(("a", GEOM, True), store)
    assert len(cache) == 1                     # soft cap keeps the MRU
    cache.put(("b", GEOM, True), tapi.GraphStore(gt, geom=GEOM))
    assert cache.keys() == [("b", GEOM, True)]
    assert cache.stats()["freed_plan_bytes"] == mem["plan_bytes"]


def test_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.GraphService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.GraphService(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.ControlPlane()
    with tapi.GraphService(device="cpu") as svc:
        assert svc.device == torch.device("cpu")


def test_autotune_is_refused(monkeypatch):
    """Autotuning is refused where it cannot run: a service without
    ``autotune=`` has no retune (``retune_now`` raises and
    ``retune_job`` records a failed job), and without CUDA neither a
    tuner nor a service with ``autotune=`` starts unless
    ``device="cpu"``."""
    with tapi.GraphService(device="cpu") as svc:
        with pytest.raises(RuntimeError, match="without autotune"):
            svc.retune_now(fingerprint="x")
        assert svc.stats()["autotune"] is None
        plane = tapi.ControlPlane(svc)
        with pytest.raises(RuntimeError, match="without autotune"):
            plane.retune_job(fingerprint="x")
        (rec,) = plane.jobs.list()
        assert rec["kind"] == "retune" and rec["state"] == "failed"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.GraphService(autotune=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.AutoTuner(registry=False)
    with tapi.GraphService(device="cpu", autotune={"registry": False}) \
            as svc:
        assert svc.autotuner.device == torch.device("cpu")


def _record_events(metrics_cls, request_cls):
    m = metrics_cls()
    m.record_submit(False, tenant="alice")
    m.record_submit(True, tenant="alice")
    m.record_submit(False, tenant='b"ob')
    m.record_rejected("queue_full", tenant="alice")
    m.record_rejected("quota", tenant='b"ob')
    m.record_shed(tenant='b"ob')
    m.record_execution(True, False)
    m.record_execution(False, True)
    m.record_eviction()
    m.record_executor_eviction(2)
    m.record_update(12.5, {"plans_rebuilt": 1, "packed_lanes_reused": 3,
                           "packed_lanes_repacked": 1,
                           "packed_bytes_reused": 4096,
                           "placements_rebalanced": 0})
    m.record_update(3.0, None, deferred=True, retired=True)
    m.record_update_failure()
    m.record_regroup()
    m.record_compaction()
    m.drift.add("makespan", 1e-3, 2e-3)
    m.drift.add("little", 1e-4, 1.5e-4)
    for rid, (coalesced, err) in enumerate([(False, None), (True, None),
                                            (False, "boom")]):
        r = request_cls(request_id=rid, app="pagerank", fingerprint="ab",
                        tenant="alice", coalesced=coalesced,
                        t_queue_ms=1.0 + rid, t_store_ms=2.0,
                        t_plan_ms=0.5, t_execute_ms=7.0 * (rid + 1),
                        t_total_ms=11.0 + rid, error=err)
        m.record_done(r)
    return m


def test_prometheus_exposition_matches_reference():
    """The same recorded events render the same exposition: metric
    names, labels, HELP/TYPE lines and values."""
    m = _record_events(ServiceMetrics, RequestMetrics)
    mj = _record_events(JServiceMetrics, JRequestMetrics)
    assert m.render_prometheus() == mj.render_prometheus()
    snap, jsnap = m.snapshot(), mj.snapshot()
    assert snap == jsnap
    assert m.latency_ms("execute", 99) == mj.latency_ms("execute", 99)

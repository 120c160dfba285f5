"""The port's spans inside the executor's iteration and the service's
execute stage, and what each span records, on the CPU.

Under a tracer without lane detail the executor keeps the fused run, its
launches and its synchronizations, and adds one ``executor.iteration``
span per iteration with ``executor.issue`` (the host's issue of every
launch, the merge and Apply), ``executor.wait`` (the iteration's one
synchronization) and ``executor.converge`` (the host's convergence read)
under it, then one ``executor.reorder``. Every span started and ended on
one thread carries that thread's CPU time (``cpu_ms``) and the OS thread
id the profiler's host events carry, and its start maps onto a
``torch.profiler`` trace's clock as ``ts + baseTimeNanoseconds / 1e3``.
"""
import dataclasses
import json
import threading
import time

import pytest
import torch

from repro_torch import api as tapi, obs
from repro_torch.control.manager import ControlPlane
from repro_torch.core import executor as executor_mod
from repro_torch.core.executor import Executor
from repro_torch.graphs.rmat import rmat

GEOM = tapi.Geometry(U=512, W=512, T=512, E_BLK=128, big_batch=2)
N_LANES = 4
WAIT = 300.0
PHASES = ("executor.issue", "executor.wait", "executor.converge")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run shares the CPU among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    return rmat(10, 8, seed=5, weighted=True)


@pytest.fixture(scope="module")
def store(graph):
    return tapi.GraphStore(graph, geom=GEOM)


def _traced_run(ex, tracer, **kw):
    root = tracer.start_trace("job")
    with tracer.activate(root.context):
        out = ex.run(**kw)
    root.end()
    return out, tracer.export(root.trace_id)


def _named(spans, name):
    return [s for s in spans if s["name"] == name]


@pytest.mark.parametrize("fuse_lanes", [True, False],
                         ids=["packed", "per_entry"])
def test_coarse_traced_run_is_the_fused_run(store, monkeypatch,
                                            fuse_lanes):
    """Bit-identical to the untraced run with as many synchronizations;
    one iteration, issue, wait and convergence span per iteration, the
    three phases under their iteration in that order, one reorder, and
    no lane or merge span."""
    ex = Executor(store, store.plan(tapi.PlanConfig(n_lanes=N_LANES)),
                  tapi.make_pagerank(), device="cpu",
                  fuse_lanes=fuse_lanes)
    syncs = []
    real = executor_mod._synchronize
    monkeypatch.setattr(executor_mod, "_synchronize",
                        lambda d: (syncs.append(d), real(d)))
    want, wmeta = ex.run()
    n_plain = len(syncs)
    syncs.clear()
    (got, gmeta), spans = _traced_run(ex, tapi.Tracer(lane_detail=False))
    assert torch.equal(torch.from_numpy(got), torch.from_numpy(want))
    n = gmeta["iterations"]
    assert n == wmeta["iterations"] > 1
    assert len(syncs) == n_plain == n
    iters = _named(spans, "executor.iteration")
    assert [s["attrs"]["it"] for s in iters] == list(range(n))
    for name in PHASES:
        assert len(_named(spans, name)) == n, name
    for it in iters:
        kids = sorted((s for s in spans
                       if s["parent_id"] == it["span_id"]),
                      key=lambda s: s["t_start"])
        assert [s["name"] for s in kids] == list(PHASES)
        assert all(s["attrs"]["it"] == it["attrs"]["it"] for s in kids)
    assert len(_named(spans, "executor.reorder")) == 1
    assert not _named(spans, "executor.lane")
    assert not _named(spans, "executor.merge_apply")


@pytest.mark.parametrize("lane_detail", [False, True])
def test_converge_span_holds_the_convergence_read(store, lane_detail):
    """A convergence test that sleeps 0.2 s shows in every
    ``executor.converge`` span and in no ``executor.issue`` span; the
    lane-detail run has the same convergence and reorder spans."""
    def slow_converged(old, new, it):
        time.sleep(0.2)
        return False

    app = dataclasses.replace(tapi.make_pagerank(max_iters=3),
                              converged=slow_converged)
    ex = Executor(store, store.plan(tapi.PlanConfig(n_lanes=N_LANES)), app,
                  device="cpu")
    (_, meta), spans = _traced_run(ex, tapi.Tracer(lane_detail=lane_detail))
    conv = _named(spans, "executor.converge")
    assert meta["iterations"] == 3 and len(conv) == 3
    assert all(s["dur"] >= 0.2 for s in conv)
    assert all(s["dur"] < 0.1 for s in _named(spans, "executor.issue"))
    assert len(_named(spans, "executor.reorder")) == 1
    assert len(_named(spans, "executor.iteration")) == 3
    assert bool(_named(spans, "executor.lane")) == lane_detail


def test_issue_span_cpu_time_leaves_out_a_sleep(store, monkeypatch):
    """A launch that sleeps 50 ms keeps the issuing thread off the CPU:
    each ``executor.issue`` span's wall time less its ``cpu_ms`` is at
    least 40 ms a payload, and no span's CPU time exceeds its wall
    time."""
    ex = Executor(store, store.plan(tapi.PlanConfig(n_lanes=N_LANES)),
                  tapi.make_pagerank(max_iters=2), device="cpu")
    real = Executor._run_payload

    def slow(self, payload, vprops):
        time.sleep(0.05)
        return real(self, payload, vprops)

    monkeypatch.setattr(Executor, "_run_payload", slow)
    _, spans = _traced_run(ex, tapi.Tracer(lane_detail=False))
    issue = _named(spans, "executor.issue")
    assert len(issue) == 2
    n_payloads = len(ex._payloads)
    for s in issue:
        assert s["dur"] - s["cpu_ms"] / 1e3 >= 0.04 * n_payloads
    timed = [s for s in spans if s["cpu_ms"] is not None]
    assert {s["name"] for s in timed} >= {"executor.iteration",
                                          "executor.reorder", *PHASES}
    for s in timed:
        assert 0.0 <= s["cpu_ms"] <= s["dur"] * 1e3, s["name"]


def test_span_tid_is_the_os_thread_id():
    """``tid`` is the opening thread's ``threading.get_native_id()``; a
    span ended on another thread has no CPU time."""
    tracer = tapi.Tracer()
    got = {}

    def opener():
        root = tracer.start_trace("job")
        with tracer.activate(root.context):
            with obs.span("inner"):
                pass
        got["tid"] = threading.get_native_id()
        got["root"] = root

    t = threading.Thread(target=opener)
    t.start()
    t.join(timeout=WAIT)
    assert not t.is_alive()
    got["root"].end()             # on this thread
    spans = {s["name"]: s for s in tracer.export(got["root"].trace_id)}
    assert spans["inner"]["tid"] == spans["job"]["tid"] == got["tid"]
    assert got["tid"] != threading.get_native_id()
    assert spans["inner"]["cpu_ms"] is not None
    assert spans["job"]["cpu_ms"] is None
    events = tracer.to_chrome_trace()["traceEvents"]
    by_name = {e["name"]: e for e in events}
    assert by_name["inner"]["args"]["cpu_ms"] == spans["inner"]["cpu_ms"]
    assert "cpu_ms" not in by_name["job"]["args"]


def test_stats_count_evicted_traces_and_their_spans():
    tracer = tapi.Tracer(max_traces=2)
    roots = []
    for i in range(5):
        root = tracer.start_trace(f"job{i}")
        with tracer.activate(root.context):
            with obs.span("a"):
                pass
            with obs.span("b"):
                pass
        root.end()
        roots.append(root)
    st = tracer.stats()
    assert st["traces"] == 2 and st["spans_recorded"] == 15
    assert st["traces_evicted"] == 3 and st["spans_evicted"] == 9
    assert st["spans_dropped"] == 0
    assert tracer.trace_ids() == [r.trace_id for r in roots[-2:]]


def test_span_clock_is_the_profiler_clock(tmp_path):
    """A span around ``torch.ones`` on the profiling thread contains the
    op's ``cpu_op`` event once the trace's ``ts`` is shifted by its
    ``baseTimeNanoseconds`` (to within 1 ms), on the same thread id."""
    from torch.profiler import ProfilerActivity, profile
    tracer = tapi.Tracer()
    root = tracer.start_trace("job")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.activate(root.context):
            with obs.span("ones"):
                torch.ones(1000)
    root.end()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base_us = doc["baseTimeNanoseconds"] / 1e3
    ops = [e for e in doc["traceEvents"]
           if e.get("cat") == "cpu_op" and e.get("name") == "aten::ones"]
    assert len(ops) == 1
    sp = _named(tracer.export(root.trace_id), "ones")[0]
    lo, hi = sp["t_start"] * 1e6, (sp["t_start"] + sp["dur"]) * 1e6
    t0 = ops[0]["ts"] + base_us
    t1 = t0 + ops[0]["dur"]
    assert lo - 1e3 <= t0 and t1 <= hi + 1e3
    assert ops[0]["tid"] == sp["tid"]


def test_served_job_spans_cover_the_worker(graph):
    """A job through a service with a tracer without lane detail: the
    answer equals the untraced job's, the executor's phase spans sit
    under ``service.execute``, ``service.finish`` follows it, and no
    lane span appears."""
    with tapi.GraphService(device="cpu", default_geom=GEOM,
                           workers=1) as svc:
        want, _ = svc.submit(graph, "pagerank", n_lanes=N_LANES,
                             max_iters=3).result(timeout=WAIT)
        tracer = tapi.Tracer(lane_detail=False)
        svc.tracer = tracer
        svc.submit(graph, "bfs", n_lanes=N_LANES,
                   app_kwargs={"root": 0}).result(timeout=WAIT)
        again, _ = svc.submit(graph, "pagerank", n_lanes=N_LANES,
                              max_iters=3).result(timeout=WAIT)
        svc.tracer = None
    assert torch.equal(torch.from_numpy(again), torch.from_numpy(want))
    assert tracer.stats()["traces"] == 2
    for tid in tracer.trace_ids():
        spans = tracer.export(tid)
        by = {s["name"]: s for s in spans}
        for name in ("queue.wait", "service.store", "service.execute",
                     "service.finish", "executor.iteration",
                     "executor.reorder", *PHASES):
            assert name in by, name
        ex, fin = by["service.execute"], by["service.finish"]
        assert fin["t_start"] >= ex["t_start"] + ex["dur"]
        assert fin["parent_id"] == ex["parent_id"]
        assert all(s["parent_id"] == ex["span_id"]
                   for s in _named(spans, "executor.iteration"))
        assert not _named(spans, "executor.lane")
        assert len(_named(spans, "executor.issue")) == \
            ex["attrs"]["iterations"]


def test_control_plane_installs_a_tracer_without_lane_detail():
    with tapi.GraphService(device="cpu", default_geom=GEOM,
                           workers=1) as svc:
        plane = ControlPlane(svc)
        assert svc.tracer is plane.tracer
        assert plane.tracer.lane_detail is False


@pytest.mark.parametrize("layout", ["padded", "stream"])
def test_plan_spans_carry_edges_and_bytes(graph, layout):
    """A first request's plan stage under a tracer: ``plan.pack`` (the
    host payloads) and ``plan.upload`` (the device payloads) carry the
    live edges and the bytes they hold; a stream store's works are built
    under one ``store.stream`` span."""
    tracer = tapi.Tracer(lane_detail=False)
    cfg = tapi.PlanConfig(n_lanes=N_LANES,
                          hw=tapi.DEFAULT_HW.clone(gather_b=0.0))
    with tapi.GraphService(device="cpu", default_geom=GEOM, workers=1,
                           store_layout=layout, tracer=tracer) as svc:
        svc.submit(graph, "pagerank", config=cfg,
                   max_iters=2).result(timeout=WAIT)
        ex = next(iter(svc._executors.values()))[0]
        spans = [s for tid in tracer.trace_ids() for s in tracer.export(tid)]
    d = ex.dispatch_stats()
    pack, = _named(spans, "plan.pack")
    upload, = _named(spans, "plan.upload")
    assert pack["attrs"]["edges"] == upload["attrs"]["edges"] \
        == d["kernel_edges"] == graph.num_edges
    assert upload["attrs"]["bytes"] == d["payload_bytes"] > 0
    assert pack["attrs"]["bytes"] > 0
    assert upload["t_start"] >= pack["t_start"] + pack["dur"]
    built = _named(spans, "store.stream")
    if layout == "stream":
        sp, = built
        assert sp["attrs"]["edges"] == graph.num_edges
        assert sp["attrs"]["bytes"] >= 12 * graph.num_edges
        # a stream payload holds its stream and per-tile arrays only
        assert pack["attrs"]["bytes"] < 13 * graph.num_edges
    else:
        assert not built


@pytest.mark.parametrize("layout", ["padded", "stream"])
def test_store_and_executor_counters(graph, layout):
    """``GraphStore.stats()`` names the layout and counts what the store
    keeps on a device (nothing, in either layout: a stream store keeps
    its edges in host memory); ``big_gathered`` is the Big payloads'
    table lengths, the sources one iteration's gathers read."""
    store = tapi.GraphStore(graph, geom=GEOM, layout=layout, device="cpu")
    st = store.stats()
    assert st["layout"] == layout and st["device_bytes"] == 0
    cfg = tapi.PlanConfig(mode="monolithic", n_lanes=N_LANES)
    ex = Executor(store, store.plan(cfg), tapi.make_pagerank(),
                  device="cpu")
    big = [p for lane in ex.lanes for p in lane if p["kind"] == "big"]
    assert big
    assert ex.dispatch_stats()["big_gathered"] == sum(
        int(p["unique_src"].numel()) for p in big)
    assert ex.stats()["big_gathered"] == ex.dispatch_stats()["big_gathered"]

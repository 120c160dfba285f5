"""The port's control plane (``repro_torch.control``) against the JAX
reference's, and end to end on the CPU.

Parity with ``repro.control``: the same push sequences give the same pop
order, rejections and stats from both schedulers (priority, deadline,
cost, FIFO, ``QueueFull``, per-tenant quota, load-shed); a store built
in a spawned worker equals a local build and the reference's (perm,
partition stats, blockings); the control plane's Prometheus families,
HELP/TYPE lines and label sets equal the reference's for the same job.
Inside the port: a pool splice plus the parent's plan rebuild equals
an in-process ``apply_delta`` bit for bit, a crashed worker respawns and
leaks no cache lease, workers never bring up CUDA, and the HTTP job API
serves jobs on 127.0.0.1 with typed errors and an end-to-end trace.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.control import (ControlPlane as JControlPlane,
                           JobScheduler as JJobScheduler,
                           QueueFull as JQueueFull,
                           QuotaExceeded as JQuotaExceeded,
                           TenantQuota as JTenantQuota)
from repro.control.dashboard import DASHBOARD_HTML as JDASHBOARD_HTML
from repro.graphs.rmat import rmat as jrmat

from repro_torch import api as tapi, convert
from repro_torch.control import (ControlPlane, DeadlineExpired,
                                 JobScheduler, JobStore, QueueFull,
                                 QuotaExceeded, TenantQuota, WorkerCrashed,
                                 WorkerPool)
from repro_torch.control.dashboard import DASHBOARD_HTML
from repro_torch.control.jobs import JobState
from repro_torch.core.executor import Executor
from repro_torch.streaming import apply_delta, random_delta, rebuild_plans

GEOM_J = japi.Geometry(U=512, W=512, T=512, E_BLK=128, big_batch=2)
GEOM = convert.geometry_from(GEOM_J)
CONFIG = tapi.PlanConfig(n_lanes=4)
WAIT = 300.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run shares the CPU among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graphs():
    gj = jrmat(10, 8, seed=1, weighted=True)
    return gj, convert.graph_from_arrays(gj.num_vertices, gj.src, gj.dst,
                                         gj.weights)


@pytest.fixture(scope="module")
def g2():
    gj = jrmat(9, 6, seed=2, weighted=True)
    return convert.graph_from_arrays(gj.num_vertices, gj.src, gj.dst,
                                     gj.weights)


@pytest.fixture(scope="module")
def pool():
    """One warm two-worker pool (worker 0 the apply lane, worker 1 the
    build lane) shared by the pool, service and HTTP tests: spawn
    start-up is the expensive part."""
    with WorkerPool(workers=2, warm=True) as p:
        yield p


def _service(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("default_geom", GEOM)
    kw.setdefault("workers", 1)
    return tapi.GraphService(**kw)


# ---------------------------------------------------------------------------
# the scheduler: the same pushes, the same pops, in both packages
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _drain(s):
    out = []
    while True:
        item = s.pop(0)
        if item is None:
            return out
        out.append(item)


def _sc_priority_fifo(S, clk, out, **_):
    s = S(clock=clk)
    for item, prio in (("a", 0), ("b", 5), ("c", 5), ("d", 1), ("e", 0)):
        s.push(item, priority=prio)
    return s


def _sc_deadline(S, clk, out, **_):
    s = S(clock=clk)
    s.push("late", deadline=clk.t + 50.0)
    s.push("soon", deadline=clk.t + 10.0)
    s.push("none")
    s.push("urgent", priority=1)
    return s


def _sc_cost(S, clk, out, **_):
    s = S(clock=clk)
    s.push("slow", cost=9.0)
    s.push("fast", cost=0.1)
    s.push("mid", cost=1.0)
    s.push("also_fast", cost=0.1)
    return s


def _sc_queue_full(S, clk, out, QF, **_):
    s = S(max_depth=2, clock=clk)
    s.push("a")
    s.push("b", priority=3)
    try:
        s.push("c", priority=9)
    except QF as exc:
        out.append(("QueueFull", str(exc)))
    s.push_sentinel("stop")
    return s


def _sc_quota(S, clk, out, QE, TQ, **_):
    s = S(default_quota=TQ(rate=1.0, burst=2.0),
          quotas={"stingy": TQ(rate=0.001), "rich": TQ(rate=1e9)},
          clock=clk)

    def push(item, tenant):
        try:
            s.push(item, tenant=tenant)
        except QE as exc:
            out.append(("QuotaExceeded", item, str(exc)))

    for item, tenant in (("a", "t"), ("b", "t"), ("c", "t"),
                         ("x", "stingy"), ("y", "stingy")):
        push(item, tenant)
    clk.t += 1.0                        # one token back for "t"
    push("c", "t")
    push("d", "t")
    for i in range(3):
        push(f"rich{i}", "rich")
    out.append(("depth_by_tenant", s.stats()["depth_by_tenant"]))
    return s


def _sc_shed(S, clk, out, **_):
    s = S(clock=clk, on_shed=lambda item: out.append(("shed", item)))
    s.push("doomed", deadline=clk.t + 1.0, priority=9)
    s.push("fine")
    s.push("later", deadline=clk.t + 5.0)
    clk.t += 2.0
    return s


def _sc_remove_reprioritize(S, clk, out, **_):
    s = S(clock=clk)
    for item in ("a", "b", "c", "d"):
        s.push(item)
    out.append(("remove", s.remove("a"), s.remove("a")))
    s.reprioritize("d", 9)
    s.reprioritize("c", 4)
    return s


SCENARIOS = {f.__name__[4:]: f for f in (
    _sc_priority_fifo, _sc_deadline, _sc_cost, _sc_queue_full, _sc_quota,
    _sc_shed, _sc_remove_reprioritize)}


def _run_scenario(fn, S, QF, QE, TQ):
    out = []
    s = fn(S, FakeClock(), out, QF=QF, QE=QE, TQ=TQ)
    out.append(("popped", _drain(s)))
    st = s.stats()
    out.append(("stats", {k: v for k, v in st.items()
                          if "wait" not in k}))     # host-clock times
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scheduler_order_matches_reference(name):
    fn = SCENARIOS[name]
    got = _run_scenario(fn, JobScheduler, QueueFull, QuotaExceeded,
                        TenantQuota)
    want = _run_scenario(fn, JJobScheduler, JQueueFull, JQuotaExceeded,
                         JTenantQuota)
    assert got == want
    assert got[-2][1]                          # something was popped


# ---------------------------------------------------------------------------
# the process pool
# ---------------------------------------------------------------------------

def _blockings(store):
    """Every Little and Big blocking of the store's default plan, as
    numpy arrays by field."""
    store.plan(CONFIG)
    out = {}
    for key, w in sorted(list(store._little_cache.items())
                         + list(store._big_cache.items()), key=repr):
        out[repr(key)] = {f: np.asarray(getattr(w, f))
                          for f in vars(w) if isinstance(getattr(w, f),
                                                         np.ndarray)}
    return out


def test_pool_build_matches_local_and_reference(pool, graphs):
    gj, gt = graphs
    st = pool.build_store(gt, geom=GEOM, use_dbg=True, fp=gt.fingerprint())
    local = tapi.GraphStore(gt, geom=GEOM)
    ref = japi.GraphStore(gj, geom=GEOM_J)
    assert st.fingerprint() == local.fingerprint() == ref.fingerprint()
    assert st._aux == {} and len(st._plan_cache) == 0
    for other in (local, ref):
        assert np.array_equal(st.perm, other.perm)
        assert [vars(i) for i in st.infos] == [vars(i) for i in other.infos]
        for k in ("src", "dst", "weights"):
            assert np.array_equal(st.edges[k], np.asarray(other.edges[k]))
    got, want, jwant = _blockings(st), _blockings(local), _blockings(ref)
    assert got.keys() == want.keys() == jwant.keys() and got
    for key in got:
        for f, a in got[key].items():
            assert np.array_equal(a, want[key][f]), (key, f)
            assert np.array_equal(a, jwant[key][f]), (key, f)


def test_pool_apply_equals_in_process(pool, graphs):
    """A splice in the apply-lane worker plus the parent's plan rebuild
    gives the snapshot an in-process ``apply_delta`` gives: the same
    stores, the same reused lanes, the same results bit for bit. The
    first apply of a lineage ships the base once (``need_state``); the
    next delta on the derived snapshot travels alone."""
    _, gt = graphs
    base = tapi.GraphStore(gt, geom=GEOM)
    Executor(base, base.plan(CONFIG), tapi.make_pagerank(),
             device="cpu").run(max_iters=2)        # packs the base lanes
    d = random_delta(gt, churn=0.02, seed=5, hot_frac=0.05)
    local = apply_delta(base, d)
    retries = pool.stats()["need_state_retries"]
    res = pool.apply(base, d)
    assert pool.stats()["need_state_retries"] == retries + 1
    res.stats.update(rebuild_plans(base, res.store, res.dirty_pids))
    assert res.fingerprint == local.fingerprint
    assert res.dirty_pids == local.dirty_pids
    for k in ("path", "dirty_partitions", "plans_rebuilt",
              "packed_lanes_reused", "packed_lanes_repacked",
              "packed_bytes_reused"):
        assert res.stats[k] == local.stats[k], k
    assert res.stats["packed_lanes_reused"] > 0
    for k in local.store.edges:
        assert np.array_equal(res.store.edges[k], local.store.edges[k])
    for app in (tapi.make_pagerank(), tapi.make_bfs(root=0)):
        got, gm = Executor(res.store, res.store.plan(CONFIG), app,
                           device="cpu").run()
        want, wm = Executor(local.store, local.store.plan(CONFIG), app,
                            device="cpu").run()
        assert gm["iterations"] == wm["iterations"]
        assert torch.equal(torch.from_numpy(got), torch.from_numpy(want))
    # the apply lane kept the derived snapshot: no second ship
    d2 = random_delta(tapi.apply_delta_to_graph(gt, d), churn=0.01,
                      seed=6)
    d2 = tapi.make_delta(res.fingerprint, add=(d2.add_src, d2.add_dst,
                                               d2.add_weights))
    res2 = pool.apply(res.store, d2)
    assert pool.stats()["need_state_retries"] == retries + 1
    assert res2.fingerprint == apply_delta(local.store, d2).fingerprint


def test_pool_workers_never_bring_up_cuda(pool):
    """Workers import the port (torch) for host numpy only: no CUDA
    state, no JAX and nothing of the reference in either process."""
    probe = ("sorted(m for m in __import__('sys').modules "
             "if m.split('.')[0] in ('jax', 'repro'))")
    for idx in range(pool.workers):
        assert pool._run(idx, torch.cuda.is_initialized) is False
        assert pool._run(idx, eval, probe) == []
        assert "repro_torch.core.store" in pool._run(
            idx, eval, "list(__import__('sys').modules)")


def test_pool_crash_respawns(pool, graphs):
    _, gt = graphs
    crashes = pool.stats()["crashes"]
    with pytest.raises(WorkerCrashed):
        pool.build_store(gt, geom=GEOM, use_dbg=True, _crash=True)
    st = pool.build_store(gt, geom=GEOM, use_dbg=True, fp=gt.fingerprint())
    assert st.fingerprint() == gt.fingerprint()
    assert pool.stats()["crashes"] == crashes + 1 and pool.alive()


def test_worker_crash_releases_lease(pool, graphs):
    """A worker crash mid-update leaks no cache lease: the entry stays,
    its pins return to 0, and an explicit retry succeeds."""
    _, gt = graphs
    with _service(pool=pool) as svc:
        fp = svc.register(gt)
        svc.run(fingerprint=fp, app="pagerank", max_iters=2, timeout=WAIT,
                config=CONFIG)
        key = next(iter(svc.cache.keys()))
        d = random_delta(gt, churn=0.02, seed=8)
        real_apply = pool.apply
        pool.apply = lambda store, delta, **kw: real_apply(
            store, delta, _crash=True)
        try:
            with pytest.raises(WorkerCrashed):
                svc.update(fp, d)
        finally:
            pool.apply = real_apply
        assert svc.cache.pin_count(key) == 0 and key in svc.cache
        assert svc.metrics.snapshot()["update_failures"] == 1
        up = svc.update(fp, d)
        assert up.mode == "incremental"
        props, _ = svc.run(fingerprint=up.fingerprint, app="bfs",
                           app_kwargs={"root": 0}, config=CONFIG,
                           timeout=WAIT)
    assert props.shape[0] >= gt.num_vertices


# ---------------------------------------------------------------------------
# service-level scheduling
# ---------------------------------------------------------------------------

def test_priority_shed_and_queue_full(graphs, g2):
    """Behind a held worker: the higher priority drains first, a job
    whose deadline passes is load-shed with the typed error, and a full
    queue rejects while an identical twin still coalesces."""
    _, gt = graphs
    with _service(max_queue_depth=3) as svc:
        fp1, fp2 = svc.register(gt), svc.register(g2)
        gate = threading.Event()
        order = []
        hold = svc.submit(fingerprint=fp1, app="pagerank", max_iters=2,
                          observer=lambda e, i: gate.wait(60)
                          if e == "running" else None)
        time.sleep(0.2)
        lo = svc.submit(fingerprint=fp2, app="bfs", app_kwargs={"root": 0},
                        observer=lambda e, i: order.append(("lo", e)))
        hi = svc.submit(fingerprint=fp2, app="pagerank", max_iters=3,
                        priority=5,
                        observer=lambda e, i: order.append(("hi", e)))
        doomed = svc.submit(fingerprint=fp2, app="sssp",
                            app_kwargs={"root": 0}, deadline=0.05)
        with pytest.raises(QueueFull):
            svc.submit(fingerprint=fp2, app="wcc")
        twin = svc.submit(fingerprint=fp2, app="bfs",
                          app_kwargs={"root": 0})
        time.sleep(0.3)                         # the deadline passes
        gate.set()
        for h in (hold, lo, hi, twin):
            h.result(timeout=WAIT)
        with pytest.raises(DeadlineExpired):
            doomed.result(timeout=WAIT)
        assert [t for t, e in order if e == "running"] == ["hi", "lo"]
        assert twin.result()[1] is lo.result()[1]
        snap = svc.metrics.snapshot()
        assert snap["shed_deadline"] == 1
        assert snap["rejected_queue_full"] == 1


def test_quota_and_cancel(graphs, g2):
    _, gt = graphs
    with _service(quotas={"stingy": TenantQuota(rate=0.001,
                                                burst=1)}) as svc:
        fp1, fp2 = svc.register(gt), svc.register(g2)
        gate = threading.Event()
        hold = svc.submit(fingerprint=fp1, app="wcc", tenant="stingy",
                          observer=lambda e, i: gate.wait(60)
                          if e == "running" else None)
        with pytest.raises(QuotaExceeded):
            svc.submit(fingerprint=fp1, app="pagerank", tenant="stingy")
        time.sleep(0.1)
        victim = svc.submit(fingerprint=fp2, app="bfs",
                            app_kwargs={"root": 0})
        assert svc.cancel(victim) and not svc.cancel(victim)
        gate.set()
        hold.result(timeout=WAIT)
        with pytest.raises(Exception, match="cancelled"):
            victim.result(timeout=WAIT)
        t = svc.stats()["service"]["tenants"]["stingy"]
        assert t["rejected"] == 1 and t["completed"] == 1


# ---------------------------------------------------------------------------
# job records and the HTTP job API
# ---------------------------------------------------------------------------

def test_job_store_and_dashboard_are_the_references():
    assert DASHBOARD_HTML == JDASHBOARD_HTML
    js = JobStore()
    rec = js.create(kind="run", app="pagerank", tenant="t")
    for state in (JobState.QUEUED, JobState.RUNNING, JobState.DONE):
        js.transition(rec.id, state)
    js.transition(rec.id, JobState.RUNNING)     # never goes backwards
    got = js.get(rec.id)
    assert got.state == JobState.DONE
    assert got.timestamps.keys() >= {"submitted", "queued", "running",
                                     "done"}


def _get(url):
    try:
        with urllib.request.urlopen(url) as r:
            body = r.read()
            ctype = r.headers.get("Content-Type", "")
            return r.status, (json.loads(body) if "json" in ctype
                              else body.decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, body=None):
    req = urllib.request.Request(
        url, data=json.dumps(body or {}).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class TestControlPlaneHTTP:
    @pytest.fixture(scope="class")
    def plane(self, graphs, pool):
        # the pool carries the store build across the process boundary;
        # prepare=False so the build happens inside the first traced job
        _, gt = graphs
        with ControlPlane(device="cpu", workers=2, pool=pool,
                          default_geom=GEOM,
                          tracer=tapi.Tracer(lane_detail=True)) as cp:
            cp.register(gt, prepare=False)
            cp.serve_http()
            yield cp

    @pytest.fixture(scope="class")
    def base(self, plane):
        host, port = plane._http_server.server_address[:2]
        assert host == "127.0.0.1"
        return f"http://127.0.0.1:{port}"

    def test_trace_covers_queue_pool_plan_execute(self, plane, base,
                                                  graphs):
        _, gt = graphs
        st, rec = _post(base + "/jobs", {
            "fingerprint": gt.fingerprint(), "app": "pagerank",
            "max_iters": 3, "n_lanes": 4})
        assert st == 201
        jid = rec["id"]
        st, _ = _get(base + f"/jobs/{jid}/result?timeout={WAIT}")
        assert st == 200
        st, doc = _get(base + f"/jobs/{jid}/trace")
        assert st == 200
        events = doc["traceEvents"]
        names = [e["name"] for e in events]
        for needle in ("control.submit", "job:pagerank", "queue.wait",
                       "pool.build_store", "pool.worker.build",
                       "store.dbg", "store.partition", "service.store",
                       "service.plan", "plan.build", "plan.pack",
                       "service.execute", "executor.iteration",
                       "executor.lane", "executor.merge_apply"):
            assert needle in names, (needle, sorted(set(names)))
        by_name = {e["name"]: e for e in events}
        ids = {e["args"]["span_id"] for e in events}
        for e in events:
            parent = e["args"].get("parent_id")
            assert parent is None or parent in ids, e["name"]
        wroot = by_name["pool.worker.build"]
        assert (wroot["args"]["parent_id"]
                == by_name["pool.build_store"]["args"]["span_id"])
        lane = by_name["executor.lane"]
        assert "est_time" in lane["args"] and lane["dur"] >= 0
        assert plane.metrics_snapshot()["drift"]["makespan"]["n"] >= 1

    def test_submit_to_done_over_http(self, plane, base, graphs):
        _, gt = graphs
        st, rec = _post(base + "/jobs", {
            "fingerprint": gt.fingerprint(), "app": "bfs",
            "app_kwargs": {"root": 0}, "tenant": "alice", "priority": 2,
            "n_lanes": 4})
        assert st == 201
        jid = rec["id"]
        st, res = _get(base + f"/jobs/{jid}/result?timeout={WAIT}")
        assert st == 200 and res["num_properties"] == gt.num_vertices
        deadline = time.time() + 10             # observer fires async
        while time.time() < deadline:
            st, rec = _get(base + f"/jobs/{jid}")
            if rec["terminal"]:
                break
            time.sleep(0.05)
        assert rec["state"] == JobState.DONE
        assert "t_execute_ms" in rec["metrics"]
        props, _ = plane.result(jid)
        store = plane.service.cache.peek(
            (gt.fingerprint(), GEOM, True))
        want, _ = Executor(store, store.plan(CONFIG),
                           tapi.make_bfs(root=0), device="cpu").run()
        assert torch.equal(torch.from_numpy(props), torch.from_numpy(want))
        st, logs = _get(base + f"/jobs/{jid}/logs")
        assert st == 200 and logs["done"]
        st, lst = _get(base + "/jobs?tenant=alice")
        assert any(j["id"] == jid for j in lst["jobs"])

    def test_typed_http_errors(self, base):
        st, err = _post(base + "/jobs", {})
        assert (st, err["error"]) == (400, "bad_request")
        st, err = _post(base + "/jobs", {"fingerprint": "nope"})
        assert (st, err["error"]) == (404, "unknown_fingerprint")
        st, err = _post(base + "/jobs", {"fingerprint": "x",
                                         "kind": "bogus"})
        assert (st, err["error"]) == (400, "bad_request")
        st, _ = _get(base + "/jobs/job-99999999")
        assert st == 404
        st, err = _get(base + "/jobs/job-99999999/trace")
        assert (st, err["error"]) == (404, "no_trace")
        st, err = _post(base + "/jobs/job-99999999/cancel")
        assert st == 409 and err["cancelled"] is False

    def test_update_job_then_serve_new_fp(self, plane, base, graphs):
        _, gt = graphs
        d = random_delta(gt, churn=0.02, seed=9)
        st, rec = _post(base + "/jobs", {
            "kind": "update", "fingerprint": gt.fingerprint(),
            "delta": {"add": {"src": d.add_src.tolist(),
                              "dst": d.add_dst.tolist(),
                              "weights": d.add_weights.tolist()}}})
        assert st == 201 and rec["state"] == JobState.DONE
        new_fp = rec["metrics"]["fingerprint"]
        st, r2 = _post(base + "/jobs", {"fingerprint": new_fp,
                                        "app": "pagerank", "max_iters": 3,
                                        "n_lanes": 4})
        assert st == 201
        st, _ = _get(base + f"/jobs/{r2['id']}/result?timeout={WAIT}")
        assert st == 200
        doc = plane.trace(rec["id"])
        names = [e["name"] for e in doc["traceEvents"]]
        for needle in ("service.update", "pool.apply", "pool.worker.apply",
                       "plan.rebuild"):
            assert needle in names, needle

    def test_metrics_dashboard_and_probes(self, base):
        st, snap = _get(base + "/metrics.json")
        assert st == 200 and {"service", "scheduler", "jobs",
                              "pool"} <= snap.keys()
        st, prom = _get(base + "/metrics")
        assert st == 200
        for needle in ("regraph_requests_total", "regraph_scheduler_depth",
                       "regraph_pool_jobs_total",
                       'regraph_jobs{state="done"}',
                       'regraph_tenant_requests_total{tenant="alice"'):
            assert needle in prom, needle
        st, page = _get(base + "/dashboard")
        assert st == 200 and page == DASHBOARD_HTML
        assert _get(base + "/healthz") == (200, {"status": "ok"})
        st, ready = _get(base + "/readyz")
        assert st == 200 and ready["ready"] and ready["pool_alive"]


def _families(text):
    """{family: (HELP line, TYPE line, sorted label-name tuples)}."""
    fams = {}
    for line in text.splitlines():
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            _, kw, name, _ = line.split(None, 3)
            fam = fams.setdefault(name, [None, None, set()])
            fam[0 if kw == "HELP" else 1] = line
        elif line.strip():
            name, _, rest = line.partition("{")
            name = name.split(" ")[0]
            labels = tuple(sorted(
                kv.split("=")[0] for kv in
                rest.rsplit("}", 1)[0].split(",") if kv)) if rest else ()
            fams[name][2].add(labels)
    return fams


def test_control_plane_prometheus_matches_reference(graphs):
    """The same job through both control planes: the same metric
    families, HELP/TYPE lines and label sets. The port's plane gets a
    lane-detail tracer, which the reference's plane installs by default
    (the port's default tracer keeps the fused run and so records no
    lane bandwidth)."""
    gj, gt = graphs
    out = []
    for plane, g in ((ControlPlane(device="cpu", workers=1,
                                   default_geom=GEOM,
                                   tracer=tapi.Tracer(lane_detail=True)),
                      gt),
                     (JControlPlane(workers=1, default_geom=GEOM_J,
                                    default_path="ref"), gj)):
        with plane as cp:
            fp = cp.register(g)
            rec = cp.submit_job(fingerprint=fp, app="pagerank",
                                max_iters=2, tenant="alice")
            cp.result(rec.id, timeout=WAIT)
            deadline = time.time() + 10
            while (cp.jobs.get(rec.id).state not in JobState.TERMINAL
                   and time.time() < deadline):
                time.sleep(0.02)
            out.append(_families(cp.prometheus()))
    got, want = out
    assert list(got) == list(want)
    for name in want:
        assert got[name][:2] == want[name][:2], name
        assert got[name][2] == want[name][2], name

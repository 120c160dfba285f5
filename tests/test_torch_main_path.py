"""The port's main path end to end on the CPU against the JAX reference:
``repro_torch.api.compile(..., device="cpu")`` vs
``repro.api.compile(..., path="ref")`` for the five builtin apps.
BFS, SSSP, WCC and closeness must be exactly equal with equal iteration
counts; PageRank within rtol 1e-5 / atol 1e-7 and iterations within
one (its 1e-7 stop test can flip on an ULP)."""
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.graphs import datasets as jdatasets
from repro.graphs.rmat import rmat as jrmat

from repro_torch import api as tapi, convert
from repro_torch.core.executor import Executor
from repro_torch.kernels import ops, ref as tref

APPS = ["pagerank", "bfs", "sssp", "wcc", "closeness"]
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run shares the CPU among parallel workers; torch's own
    thread pool would oversubscribe it (and disturb timing-sensitive
    tests in other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stores(small_graph, small_geom):
    """One store per graph in each package (stores amortize
    preprocessing across the five apps, as in the reference)."""
    graphs = {"small": small_graph,
              "small_weighted": jrmat(10, 8, seed=4, weighted=True),
              "ggs": jdatasets.load("ggs")}
    geom_t = convert.geometry_from(small_geom)
    out = {}
    for name, g in graphs.items():
        gt = convert.graph_from_arrays(g.num_vertices, g.src, g.dst,
                                       g.weights)
        out[name] = (japi.GraphStore(g, geom=small_geom),
                     tapi.GraphStore(gt, geom=geom_t))
    return out


@pytest.mark.parametrize("app,graph", [
    (app, graph) for graph in ("small", "ggs") for app in APPS]
    + [("sssp", "small_weighted")])
def test_apps_match_reference(app, graph, stores):
    store_j, store_t = stores[graph]
    want, meta_j = japi.compile(None, app, store=store_j, n_lanes=4,
                                path="ref").run()
    got, meta_t = tapi.compile(None, app, store=store_t, n_lanes=4,
                               device="cpu").run()
    assert got.dtype == want.dtype and got.shape == want.shape
    if app == "pagerank":
        assert abs(meta_t["iterations"] - meta_j["iterations"]) <= 1
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    else:
        assert meta_t["iterations"] == meta_j["iterations"]
        assert np.array_equal(got, want)


@pytest.mark.parametrize("app", APPS)
def test_fused_equals_per_entry(app, stores):
    store_t = stores["ggs"][1]
    fused = tapi.compile(None, app, store=store_t, n_lanes=4, device="cpu")
    entry = tapi.compile(None, app, store=store_t, n_lanes=4, device="cpu",
                         fuse_lanes=False)
    a, ma = fused.run(max_iters=4)
    b, mb = entry.run(max_iters=4)
    assert ma["iterations"] == mb["iterations"]
    assert np.array_equal(a, b)
    ds_f, ds_e = fused.executor.dispatch_stats(), \
        entry.executor.dispatch_stats()
    assert ds_f["num_entries"] == ds_e["num_entries"]
    assert ds_f["kernel_dispatches"] <= ds_e["kernel_dispatches"]
    assert ds_f["merge_dispatches"] == ds_e["merge_dispatches"] == 1


def test_gather_matches_edge_oracle(stores):
    """One PageRank gather over the packed lanes == the edge-list oracle
    on the DBG'd graph."""
    store_t = stores["ggs"][1]
    ex = tapi.compile(None, "pagerank", store=store_t, n_lanes=4,
                      device="cpu").executor
    vprops = ex.init_props()
    g = store_t.graph
    oracle = tref.edge_ref(torch.from_numpy(g.src.astype(np.int64)),
                           torch.from_numpy(g.dst.astype(np.int64)),
                           torch.zeros(g.num_edges), vprops, ex.app.scatter,
                           "sum", store_t.V_pad)
    np.testing.assert_allclose(ex.gather(vprops).numpy(), oracle.numpy(),
                               rtol=1e-5, atol=1e-12)


def test_port_imports_no_jax_and_no_reference():
    """Every module of the port, the streaming, sharding, obs, serving,
    control and autotune packages, the SPMD path, the LM serving path,
    the training path, the UDF code generator and the LM sharding among
    them, imports neither JAX, ml_dtypes nor the reference."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for name in ('streaming', 'streaming.apply', 'streaming.delta', "
        "'streaming.regroup', 'sharding', 'sharding.executor', "
        "'sharding.placement', 'obs', 'obs.profile', 'obs.trace', "
        "'serve_graph', 'serve_graph.service', 'serve_graph.store_cache', "
        "'serve_graph.metrics', 'serve_graph.fingerprint', 'control', "
        "'control.scheduler', 'control.pool', 'control.jobs', "
        "'control.manager', 'control.http_api', 'control.dashboard', "
        "'autotune', 'autotune.specs', 'autotune.calibrator', "
        "'autotune.retuner', 'core.distributed', 'core.engine', "
        "'configs', 'configs.base', 'configs.qwen2_1p5b', "
        "'configs.kimi_k2_1t_a32b', 'models', 'models.common', "
        "'models.transformer', 'models.moe', 'models.moe_schedule', "
        "'models.api', 'serve', 'serve.engine', 'serve.kvcache', "
        "'launch', 'launch.serve', 'models.mamba2', 'models.hymba', "
        "'models.whisper', 'tree', 'data.pipeline', 'optim.schedule', "
        "'optim.adamw', 'optim.adafactor', 'optim.grad_compress', "
        "'checkpoint.manager', 'train.fault_tolerance', 'train.step', "
        "'train.loop', 'launch.train', 'kernels.udf_codegen', "
        "'sharding.specs', 'launch.mesh', 'launch.roofline', "
        "'launch.dryrun'):\n"
        "    assert 'repro_torch.' + name in mods, name\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'ml_dtypes', 'repro'))\n"
        "print(len(mods))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 78      # every module was imported


def test_entry_points_raise_without_cuda(monkeypatch, small_graph,
                                         small_geom, stores):
    """With CUDA hidden, the entry points raise unless device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gt = convert.graph_from_arrays(small_graph.num_vertices,
                                   small_graph.src, small_graph.dst)
    geom = convert.geometry_from(small_geom)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.compile(gt, "pagerank", geom=geom)
    store = stores["small"][1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        store.executor(tapi.make_bfs())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Executor(store, store.plan(), tapi.make_bfs())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.default_path()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.compile(gt, "pagerank", geom=geom, device="cuda")
    assert ops.default_path("cpu") == "ref"
    assert tapi.compile(None, "bfs", store=store,
                        device="cpu").executor.path == "ref"


def test_stats_and_footprints(stores):
    store_t = stores["ggs"][1]
    c = tapi.compile(None, "pagerank", store=store_t, n_lanes=4,
                     device="cpu")
    st = c.stats()
    assert st["device"] == "cpu" and st["path"] == "ref"
    assert st["kernel_dispatches"] == len(c.executor._payloads) > 0
    assert 0 < st["padding_efficiency"] <= 1
    assert st["payload_bytes"] == sum(ops.payload_nbytes(p)
                                      for p in c.executor._payloads)
    mem = store_t.memory_footprint()
    assert mem["plan_bytes"] >= st["payload_bytes"]
    assert c.time_iteration(repeats=1) > 0
    lanes = c.time_lanes(repeats=1)
    assert len(lanes) == len(c.plan.lanes)


def test_plan_cache_spans_and_clear(small_graph, small_geom):
    """The store's plan LRU, the spans store and planner open under an
    active tracer, and the payload bytes clear_plans releases."""
    gt = convert.graph_from_arrays(small_graph.num_vertices,
                                   small_graph.src, small_graph.dst)
    geom = convert.geometry_from(small_geom)
    tracer = tapi.Tracer()
    root = tracer.start_trace("job")
    with tracer.activate(root.context):
        store = tapi.GraphStore(gt, geom=geom, max_plans=1)
        four, two = tapi.PlanConfig(n_lanes=4), tapi.PlanConfig(n_lanes=2)
        bundle = store.plan(four)
        assert store.plan(four) is bundle and store.has_plan(four)
        ex = store.executor(tapi.make_pagerank(), two, device="cpu")
    root.end()
    names = {s["name"] for s in tracer.export(root.trace_id)}
    assert {"store.dbg", "store.partition", "plan.build", "plan.classify",
            "plan.blockings", "plan.schedule", "plan.pack"} <= names
    assert store.plan_evictions == 1 and not store.has_plan(four)
    assert store.memory_footprint()["plan_bytes"] == ex.memory_footprint()
    assert store.clear_plans() == {"plans": 1,
                                   "freed_bytes": ex.memory_footprint()}
    assert not store.has_plan(two)


@pytest.mark.parametrize("combine", ["sum", "max"])
def test_makespan_drift_estimate_matches_reference(combine, stores):
    """The "makespan" drift kind compares a measured iteration with the
    reference's like-for-like estimate: the SUM of lane estimates under
    a serial calibration (combine="sum", what every fit returns; lanes
    run back to back), the plan's parallel ``est_makespan`` otherwise.
    The same store and plan through both packages give the same
    estimate, and a run's makespan samples are taken against it."""
    from repro.core import perf_model as jpm
    from repro.core.executor import Executor as JExecutor
    from repro_torch.core import perf_model as tpm

    store_j, store_t = stores["small"]
    kw = {"c_edges": 2.0, "combine": "sum"} if combine == "sum" else {}
    hw_j = jpm.TPU_V5E.clone(**kw) if kw else jpm.TPU_V5E
    hw_t = tpm.DEFAULT_HW.clone(**kw) if kw else tpm.DEFAULT_HW
    app_j, app_t = japi.make_pagerank(max_iters=2), tapi.make_pagerank(
        max_iters=2)
    ex_j = JExecutor(store_j, store_j.plan(japi.PlanConfig(n_lanes=4,
                                                           hw=hw_j)),
                     app_j, path="ref")
    ex_t = Executor(store_t, store_t.plan(tapi.PlanConfig(n_lanes=4,
                                                          hw=hw_t)),
                    app_t, device="cpu")
    assert ex_t._lane_est == ex_j._lane_est
    assert ex_t._est_iteration == ex_j._est_iteration
    if combine == "sum":
        lane_sum = sum(e for e, _ in ex_t._lane_est)
        assert ex_t._est_iteration == pytest.approx(lane_sum)
        assert ex_t._est_iteration > ex_t.plan.est_makespan
    else:
        assert ex_t._est_iteration == ex_t.plan.est_makespan
    ex_t.run()
    rep = ex_t.drift.report()["makespan"]
    assert rep["est_s"] == pytest.approx(rep["n"] * ex_t._est_iteration)


@pytest.mark.parametrize("lane_detail", [False, True])
def test_makespan_sample_excludes_convergence_test(lane_detail, stores):
    """The "makespan" drift sample ends once the new properties are on
    the device, before ``app.converged`` runs, as the reference's
    (``src/repro/core/executor.py:337-343``): a convergence test that
    sleeps 0.2 s stays out of every sample, fused or per lane."""
    store_t = stores["small"][1]

    def slow_converged(old, new, it):
        time.sleep(0.2)
        return False

    app = dataclasses.replace(tapi.make_pagerank(max_iters=3),
                              converged=slow_converged)
    ex = Executor(store_t, store_t.plan(tapi.PlanConfig(n_lanes=4)), app,
                  device="cpu")
    if lane_detail:
        tracer = tapi.Tracer(lane_detail=True)
        root = tracer.start_trace("job")
        with tracer.activate(root.context):
            ex.run()
        root.end()
    else:
        ex.run()
    rep = ex.drift.report()["makespan"]
    assert rep["n"] == 3
    assert rep["measured_s"] / rep["n"] < 0.1


def test_time_lanes_times_fill_launches_and_merge(stores, monkeypatch):
    """Each ``time_lanes`` repeat times what the reference's lane
    function does (``src/repro/core/executor.py:365-383``): the identity
    fill, the lane's launches and ``merge_all``, ended by a
    synchronize. A merge that sleeps 50 ms runs once per repeat and
    shows in every sample."""
    store_t = stores["small"][1]
    ex = Executor(store_t, store_t.plan(tapi.PlanConfig(n_lanes=4)),
                  tapi.make_pagerank(), device="cpu")
    merges = []
    real_merge = ops.merge_all

    def slow_merge(accum, outputs, t):
        merges.append((accum.clone(), len(outputs)))
        time.sleep(0.05)
        return real_merge(accum, outputs, t)

    monkeypatch.setattr(ops, "merge_all", slow_merge)
    lanes = ex.time_lanes(repeats=2)
    busy = [i for i, lane in enumerate(ex.lanes) if lane]
    assert len(merges) == 3 * len(busy)          # 1 warm-up + 2 repeats
    assert [n for _, n in merges] == [len(ex.lanes[i]) for i in busy
                                      for _ in range(3)]
    for accum, _ in merges:                      # the identity fill
        assert accum.shape == (store_t.V_pad,) and not accum.any()
    assert all(lanes[i] >= 0.05 for i in busy)

"""The port's autotuner (``repro_torch.autotune`` and the perf model's
calibration) against the JAX reference's (``repro.autotune``).

Parity, on the same plans and samples: the design rows, the guarded fits
(every fitted HW field equal or within 1e-12 relative, the same
diagnostics), the spec files (names and JSON), the candidate configs and
the ``search_plan`` scores. Then the loop on ``device="cpu"``: a forced
retune, cooldown and hysteresis, specs persisted and reloaded, and the
service's drift-triggered retune, ``retune_now`` and
``ControlPlane.retune_job``. Results across two plans are compared with
allclose for PageRank (a sum app: a new plan may group its in-edge sums
differently) and exactly for BFS.

Tests that need an applied retune pass a ``Calibrator`` whose residual
bound no host load can break (the timing fit is the card's job; here
only the loop is under test); the rejection path runs on synthetic
samples.
"""
import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.autotune import (Calibrator as JCalibrator,
                            SpecRegistry as JSpecRegistry,
                            candidate_configs as jcandidate_configs,
                            search_plan as jsearch_plan)
from repro.core import perf_model as jpm
from repro.graphs.rmat import rmat as jrmat

from repro_torch import api as tapi, convert
from repro_torch.autotune import (AutoTuner, Calibrator, DeviceSpec,
                                  RetunePolicy, SpecRegistry,
                                  candidate_configs, default_device_kind,
                                  geometry_key, hw_from_dict, hw_to_dict,
                                  search_plan)
from repro_torch.core import perf_model
from repro_torch.core.executor import Executor
from repro_torch.core.planner import PlanConfig

WAIT = 300.0
GEOM_J = japi.Geometry(U=256, W=128, T=128, E_BLK=128, big_batch=2)
GEOM = convert.geometry_from(GEOM_J)
# a fit bound no timing can break: the loop, not the fit, is under test
STEADY = dict(max_residual=float("inf"))
HW_FIELDS = [f.name for f in dataclasses.fields(perf_model.HW)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run shares the CPU among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph_j():
    # partitions are U-sized dst ranges: 1024 vertices / U=256 gives 4
    # partitions, so plans get real lane structure to search over
    return jrmat(10, 8, seed=4, weighted=True)


@pytest.fixture(scope="module")
def graph(graph_j):
    return convert.graph_from_arrays(graph_j.num_vertices, graph_j.src,
                                     graph_j.dst, graph_j.weights)


@pytest.fixture(scope="module")
def store(graph):
    return tapi.GraphStore(graph, geom=GEOM)


@pytest.fixture(scope="module")
def store_j(graph_j):
    return japi.GraphStore(graph_j, geom=GEOM_J)


def _hw_j(hw: perf_model.HW) -> jpm.HW:
    """The reference's HW with the same fields."""
    return jpm.HW(**dataclasses.asdict(hw))


def _assert_hw_equal(got: perf_model.HW, want: jpm.HW) -> None:
    for name in HW_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(a, float):
            assert a == pytest.approx(b, rel=1e-12, abs=0), name
        else:
            assert a == b, name


def _assert_fit_equal(port, ref) -> None:
    (hw, diag), (hw_j, diag_j) = port, ref
    _assert_hw_equal(hw, hw_j)
    assert diag.keys() == diag_j.keys()
    for k, v in diag.items():
        if isinstance(v, float):
            assert v == pytest.approx(diag_j[k], rel=1e-12), k
        else:
            assert v == diag_j[k], k


def _synth_samples(store, true_hw, noise=None, seed=0):
    """Lane-style samples whose times come from a KNOWN ground-truth HW:
    y = feature_row(info) . [c_edges, c_edges_big|c_edges, c_vertices,
    c_compute, c_store, t_const]."""
    coef = np.array([true_hw.c_edges,
                     true_hw.c_edges_big or true_hw.c_edges,
                     true_hw.c_vertices, true_hw.c_compute,
                     true_hw.c_store, max(true_hw.t_const, 0.0)])
    rng = np.random.default_rng(seed)
    rows, kinds, ys = [], [], []
    infos = [i for i in store.infos if i.num_edges > 0]
    for _ in range(4):
        for info in infos:
            for kind in ("little", "big"):
                row = np.asarray(perf_model.feature_row(
                    info, GEOM, kind, perf_model.DEFAULT_HW))
                y = float(row @ coef)
                if noise is not None:
                    y *= float(rng.uniform(1 - noise, 1 + noise))
                rows.append(row)
                kinds.append(kind)
                ys.append(y)
    return rows, kinds, ys


def _coef(hw):
    return np.array([hw.c_edges, hw.c_edges_big or hw.c_edges,
                     hw.c_vertices, hw.c_compute, hw.c_store,
                     max(hw.t_const, 0.0)])


# ------------------------------------------------- design rows and fits
def test_feature_rows_equal_reference(store, store_j):
    infos_j = {i.pid: i for i in store_j.infos}
    for info in store.infos:
        for kind in ("little", "big"):
            assert perf_model.feature_row(
                info, GEOM, kind, perf_model.DEFAULT_HW) == \
                jpm.feature_row(infos_j[info.pid], GEOM_J, kind, jpm.TPU_V5E)
    hw = perf_model.DEFAULT_HW.clone(c_edges=1.7)
    rows = perf_model.lane_feature_rows(
        store.plan(PlanConfig(n_lanes=3, hw=hw)))
    rows_j = jpm.lane_feature_rows(
        store_j.plan(japi.PlanConfig(n_lanes=3, hw=_hw_j(hw))))
    assert len(rows) == len(rows_j) == 3
    for a, b in zip(rows, rows_j):
        assert np.array_equal(a, b)
    assert perf_model.effective_peak_bandwidth_bps(hw) == \
        jpm.effective_peak_bandwidth_bps(_hw_j(hw))


def test_calibration_round_trip(store):
    """Noiseless synthetic timings from a known HW: the fitted model
    reproduces the synthesized lane times, and the fit equals the
    reference's on the same samples."""
    true = perf_model.DEFAULT_HW.clone(c_edges=7.0, c_edges_big=19.0,
                                       c_vertices=3.0, c_store=2.0,
                                       t_const=4e-5, combine="sum")
    rows, kinds, ys = _synth_samples(store, true)
    cal, cal_j = Calibrator(), JCalibrator()
    for r, k, y in zip(rows, kinds, ys):
        cal.add_lane(r, k, y)
        cal_j.add_lane(r, k, y)
    assert cal.ready() and cal.counts() == cal_j.counts()
    fit, fit_j = cal.fit(perf_model.DEFAULT_HW), cal_j.fit(jpm.TPU_V5E)
    assert fit is not None and fit.ok, fit.diag
    assert fit.hw.combine == "sum"
    _assert_fit_equal((fit.hw, fit.diag), (fit_j.hw, fit_j.diag))
    pred = np.array([r @ _coef(fit.hw) for r in rows])
    np.testing.assert_allclose(pred, ys, rtol=0.02)
    assert fit.diag["n"] == len(rows) and fit.diag["residual_rel"] < 0.02


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_calibration_under_noise_matches_reference(store, seed):
    """10% multiplicative timing noise: predictions stay within ~15% of
    the noiseless ground truth, and the fit equals the reference's."""
    true = perf_model.DEFAULT_HW.clone(c_edges=5.0, c_vertices=2.0,
                                       c_store=1.5, t_const=2e-5,
                                       combine="sum")
    rows, _, ys_clean = _synth_samples(store, true)
    _, _, ys = _synth_samples(store, true, noise=0.10, seed=seed)
    hw, diag = perf_model.fit_terms(rows, ys, perf_model.DEFAULT_HW)
    _assert_fit_equal((hw, diag), jpm.fit_terms(rows, ys, jpm.TPU_V5E))
    assert diag["fallback"] is None, diag
    pred = np.array([np.asarray(r) @ _coef(hw) for r in rows])
    rel = np.abs(pred - np.asarray(ys_clean)) / np.asarray(ys_clean)
    assert np.median(rel) < 0.15, np.median(rel)


def test_underdetermined_fit_keeps_prior(store):
    """Too few samples must NOT silently zero the coefficients: the fit
    falls back to the prior and says so, as the reference does."""
    prior = perf_model.DEFAULT_HW.clone(c_edges=123.0, c_vertices=7.0)
    info = next(i for i in store.infos if i.num_edges > 0)
    row = perf_model.feature_row(info, GEOM, "little", perf_model.DEFAULT_HW)
    hw, diag = perf_model.fit_terms([row], [1e-3], prior)
    _assert_fit_equal((hw, diag),
                      jpm.fit_terms([row], [1e-3], _hw_j(prior)))
    assert diag["fallback"] == "insufficient_samples"
    assert hw is prior
    cal = Calibrator(min_samples=6)
    cal.add_lane(row, "little", 1e-3)
    assert cal.fit(prior) is None


def test_fit_preserves_big_share_sentinel(store):
    """Little-only samples with the c_edges_big=0 share sentinel keep the
    sentinel, as the reference does."""
    rows, ys = [], []
    for info in [i for i in store.infos if i.num_edges > 0]:
        for _ in range(3):
            r = np.asarray(perf_model.feature_row(info, GEOM, "little",
                                                  perf_model.DEFAULT_HW))
            rows.append(r)
            ys.append(float(r @ np.array([9.0, 0, 1, 1, 1, 5e-6])))
    hw, diag = perf_model.fit_terms(rows, ys, perf_model.DEFAULT_HW)
    _assert_fit_equal((hw, diag), jpm.fit_terms(rows, ys, jpm.TPU_V5E))
    assert diag["fallback"] is None
    assert "c_edges_big" in diag["kept_prior"]
    assert hw.c_edges_big == 0.0


def test_high_residual_falls_back(store):
    """Timings the model cannot explain are rejected, keeping the
    prior, as the reference does."""
    rng = np.random.default_rng(0)
    rows, _, _ = _synth_samples(store, perf_model.DEFAULT_HW)
    ys = [float(rng.uniform(1.0, 100.0)) for _ in rows]
    prior = perf_model.DEFAULT_HW.clone(c_edges=5.0)
    hw, diag = perf_model.fit_terms(rows, ys, prior, max_residual=0.05)
    _assert_fit_equal((hw, diag), jpm.fit_terms(rows, ys, _hw_j(prior),
                                                max_residual=0.05))
    assert diag["fallback"] == "high_residual"
    assert hw.c_edges == prior.c_edges
    # the same rejection through a Calibrator with a tight bound
    cal = Calibrator(max_residual=0.05)
    for r, y in zip(rows, ys):
        cal.add_lane(r, "little", y)
    fit = cal.fit(prior)
    assert fit is not None and not fit.ok
    assert fit.diag["fallback"] == "high_residual"


def test_calibrate_full_matches_reference(store, store_j):
    true = perf_model.DEFAULT_HW.clone(c_edges=3.0, c_vertices=2.0,
                                       combine="sum")
    infos_j = {i.pid: i for i in store_j.infos}
    samples, samples_j = [], []
    for info in [i for i in store.infos if i.num_edges > 0]:
        for kind in ("little", "big"):
            for rep in range(3):
                row = perf_model.feature_row(info, GEOM, kind,
                                             perf_model.DEFAULT_HW)
                y = float(np.asarray(row) @ _coef(true)) * (1 + 0.01 * rep)
                samples.append((info, GEOM, kind, y))
                samples_j.append((infos_j[info.pid], GEOM_J, kind, y))
    _assert_fit_equal(perf_model.calibrate_full(samples,
                                                perf_model.DEFAULT_HW),
                      jpm.calibrate_full(samples_j, jpm.TPU_V5E))
    _assert_hw_equal(perf_model.calibrate(samples, perf_model.DEFAULT_HW),
                     jpm.calibrate(samples_j, jpm.TPU_V5E))
    assert perf_model.calibrate_full([], perf_model.DEFAULT_HW)[1] == \
        {"n": 0, "fallback": "no_samples"}


# ------------------------------------------------------- device specs
def test_spec_registry_round_trip_and_reference_format(tmp_path):
    reg = SpecRegistry(root=str(tmp_path))
    hw = perf_model.DEFAULT_HW.clone(c_edges=3.25, vmem_lane_budget=16e6,
                                     combine="sum")
    spec = DeviceSpec(device_kind="NVIDIA H100 80GB HBM3@host",
                      geom_key=geometry_key(GEOM), hw=hw, version=3,
                      created_at=time.time() - 60, source="calibrated",
                      fit={"residual_rel": 0.01})
    path = reg.put(spec)
    assert os.path.exists(path)
    back = reg.get(spec.device_kind, GEOM)
    assert back is not None and back.version == 3
    assert back.source == "calibrated" and back.hw == hw
    assert 50 < back.age_s() < 3600
    assert back.fit["residual_rel"] == 0.01
    assert back.peak_bandwidth_gbps == pytest.approx(819.0 / 3.25)
    other = tapi.Geometry(U=1024, W=512, T=512, E_BLK=128, big_batch=4)
    assert reg.get(spec.device_kind, other) is None
    # the reference's registry names and reads the same file, and the
    # port reads the reference's
    reg_j = JSpecRegistry(root=str(tmp_path))
    assert reg_j.path_for(spec.device_kind, GEOM_J) == path
    back_j = reg_j.get(spec.device_kind, GEOM_J)
    assert back_j.version == 3
    assert dataclasses.asdict(back_j.hw) == dataclasses.asdict(hw)
    with open(path) as f:
        assert json.load(f) == back_j.to_json() == spec.to_json()


def test_spec_registry_corrupt_env_and_default(tmp_path, monkeypatch):
    reg = SpecRegistry(root=str(tmp_path))
    with open(reg.path_for("k", GEOM), "w") as f:
        f.write("{not json")
    assert reg.get("k", GEOM) is None            # degrade, don't raise
    spec = reg.get_or_default("k", GEOM)
    assert spec.source == "analytic"
    assert spec.hw is perf_model.DEFAULT_HW      # the port's prior
    monkeypatch.setenv("REGRAPH_SPEC_DIR", str(tmp_path / "envdir"))
    assert SpecRegistry().root == str(tmp_path / "envdir")
    monkeypatch.delenv("REGRAPH_SPEC_DIR")
    monkeypatch.chdir(tmp_path)
    assert SpecRegistry().root == os.path.join(str(tmp_path),
                                               ".regraph_specs")


def test_hw_dict_tolerant():
    d = hw_to_dict(perf_model.DEFAULT_HW.clone(c_edges=2.0))
    d["unknown_future_field"] = 42
    del d["c_store"]
    base = perf_model.DEFAULT_HW.clone(c_store=9.0)
    hw = hw_from_dict(d, base=base)
    assert hw.c_edges == 2.0
    assert hw.c_store == 9.0                     # missing -> base
    assert not hasattr(hw, "unknown_future_field")


def test_default_device_kind(monkeypatch):
    k1, k2 = default_device_kind("cpu"), default_device_kind("cpu")
    assert k1 == k2 and k1.startswith("cpu@")
    assert AutoTuner(device="cpu", registry=False).device_kind == k1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device_kind()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AutoTuner(registry=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AutoTuner(registry=False, device_kind="x@y")


# ------------------------------------------------- candidate plan search
def test_candidate_configs_match_reference():
    base = PlanConfig(mode="model", n_lanes=4)
    hw = perf_model.DEFAULT_HW.clone(c_edges=2.0)
    for mono in (False, True):
        cands = candidate_configs(base, hw, include_monolithic=mono)
        cands_j = jcandidate_configs(japi.PlanConfig(mode="model",
                                                     n_lanes=4),
                                     _hw_j(hw), include_monolithic=mono)
        assert [(c.mode, c.forced_little, c.forced_big, c.n_lanes)
                for c in cands] == [(c.mode, c.forced_little,
                                     c.forced_big, c.n_lanes)
                                    for c in cands_j]
        assert all(c.hw is hw for c in cands)
        assert any(c.mode == "monolithic" for c in cands) == mono


@pytest.mark.parametrize("kw", [{"c_edges": 3.0, "combine": "sum"},
                                {"c_edges_big": 0.2, "c_vertices": 40.0,
                                 "combine": "sum"}])
def test_search_plan_scores_match_reference(store, store_j, kw):
    hw = perf_model.DEFAULT_HW.clone(**kw)
    for mono in (False, True):
        best_cfg, best_bundle, scores = search_plan(
            store, PlanConfig(n_lanes=4), hw, include_monolithic=mono)
        best_j, bundle_j, scores_j = jsearch_plan(
            store_j, japi.PlanConfig(n_lanes=4), _hw_j(hw),
            include_monolithic=mono)
        assert scores == scores_j
        assert (best_cfg.mode, best_cfg.forced_little,
                best_cfg.forced_big) == (best_j.mode, best_j.forced_little,
                                         best_j.forced_big)
        assert best_cfg.hw is hw
        assert float(best_bundle.plan.est_makespan) == pytest.approx(
            min(s["est_makespan"] for s in scores))
        assert not store.has_plan(best_cfg)      # losers never cached


# ------------------------------------------------- the loop, end to end
def _mk_tuner(**kw):
    kw.setdefault("policy", RetunePolicy(drift_threshold=1.2,
                                         min_samples=4, cooldown_s=0.0))
    kw.setdefault("registry", False)
    kw.setdefault("calibrator", Calibrator(**STEADY))
    kw.setdefault("device", "cpu")
    return AutoTuner(**kw)


def test_executor_feeds_calibrator(store):
    """time_lanes and the traced per-lane run each add one sample per
    non-empty lane, with the lane's design row."""
    cal = Calibrator()
    bundle = store.plan(PlanConfig(n_lanes=3))
    ex = Executor(store, bundle, tapi.make_pagerank(max_iters=2),
                  device="cpu", calibrator=cal)
    rows = perf_model.lane_feature_rows(bundle)
    lanes = [i for i, lane in enumerate(ex.lanes) if lane]
    ex.time_lanes(repeats=1)
    assert cal.counts()["n"] == len(lanes)
    for (row, kind, _), li in zip(list(cal._samples), lanes):
        assert np.array_equal(row, rows[li])
        assert kind == ex._lane_est[li][1]
    tracer = tapi.Tracer(lane_detail=True)
    root = tracer.start_trace("job")
    with tracer.activate(root.context):
        _, meta = ex.run()
    root.end()
    assert cal.counts()["n"] == len(lanes) * (1 + meta["iterations"])
    ex.run()                                      # untraced: no samples
    assert cal.counts()["n"] == len(lanes) * (1 + meta["iterations"])


def test_forced_retune_swaps_plan(store):
    """A forced retune on the CPU: the fit is applied, the winner is
    adopted into the plan cache, and the new plan's results agree with
    the old plan's: BFS exactly, PageRank within rtol 1e-5 (hazard F0:
    a sum app's in-edge sums may group differently under a new plan)."""
    cfg = PlanConfig(mode="model", n_lanes=2)
    tuner = _mk_tuner()
    pr, bfs = tapi.make_pagerank(max_iters=4), tapi.make_bfs(root=2)
    ex_a = Executor(store, store.plan(cfg), pr, device="cpu",
                    calibrator=tuner.calibrator)
    pr_a, _ = ex_a.run()
    bfs_a, _ = Executor(store, store.plan(cfg), bfs, device="cpu").run()
    event = tuner.retune(store, ex_a, cfg, skey="g", force=True)
    assert event["applied"], event
    assert tuner.version == 1 and tuner.retunes == 1
    assert tuner.hw is not None and tuner.hw.combine == "sum"
    assert event["chosen"]["est_makespan"] == pytest.approx(
        min(c["est_makespan"] for c in event["candidates"]))
    assert event["t_retune_s"] > 0 and event["fit"]["fallback"] is None
    # the winner (the model plan or a fixed split) is remembered per
    # graph key; without the key a default config takes only the HW
    cfg_b = tuner.resolve_config(PlanConfig(mode="model", n_lanes=2), "g")
    assert cfg_b.hw is tuner.hw and store.has_plan(cfg_b)
    assert (cfg_b.mode, cfg_b.forced_little) == (
        event["chosen"]["mode"], 1 if event["chosen"]["split"] else 0)
    assert tuner.resolve_config(PlanConfig(n_lanes=2)).mode == "model"
    bundle_b = store.plan(cfg_b)
    pr_b, _ = Executor(store, bundle_b, pr, device="cpu").run()
    bfs_b, _ = Executor(store, bundle_b, bfs, device="cpu").run()
    np.testing.assert_allclose(pr_b, pr_a, rtol=1e-5, atol=1e-7)
    assert np.array_equal(bfs_b, bfs_a)
    st = tuner.stats()
    assert st["version"] == 1 and st["hw"]["combine"] == "sum"
    assert st["armed"] is False and st["drift"] == {}


def test_rejected_fit_keeps_plan(store):
    """A fit the guard rejects applies nothing: no HW, no version, the
    reason in the event."""
    tuner = _mk_tuner(calibrator=Calibrator(max_residual=0.05))
    rng = np.random.default_rng(0)
    rows, kinds, _ = _synth_samples(store, perf_model.DEFAULT_HW)
    for r, k in zip(rows, kinds):
        tuner.calibrator.add_lane(r, k, float(rng.uniform(1.0, 100.0)))
    cfg = PlanConfig(n_lanes=2)
    ex = Executor(store, store.plan(cfg), tapi.make_bfs(root=2),
                  device="cpu", calibrator=tuner.calibrator)
    event = tuner.retune(store, ex, cfg, force=True)
    assert not event["applied"]
    assert event["rejected"] == "high_residual"
    assert tuner.hw is None and tuner.version == 0
    assert tuner.fit_rejects == 1
    assert tuner.resolve_config(cfg) is cfg


def test_resolve_config_respects_user_hw():
    tuner = _mk_tuner()
    tuner.hw = perf_model.DEFAULT_HW.clone(c_edges=5.0)
    custom = PlanConfig(hw=perf_model.DEFAULT_HW.clone(c_edges=0.5))
    assert tuner.resolve_config(custom) is custom       # untouched
    assert tuner.resolve_config(PlanConfig()).hw is tuner.hw


def test_retune_cooldown_and_hysteresis():
    tuner = _mk_tuner(policy=RetunePolicy(drift_threshold=1.5,
                                          min_samples=2, cooldown_s=3600.0,
                                          hysteresis=2.0))
    for _ in range(4):
        tuner.drift.add("makespan", 1e-3, 1e-1)   # 100x drift
    assert tuner.should_retune() is not None
    tuner._last_retune_mono = time.monotonic()    # as if one just ran
    assert tuner.should_retune() is None          # cooldown holds
    tuner2 = _mk_tuner(policy=RetunePolicy(drift_threshold=1.5,
                                           min_samples=2, cooldown_s=0.0,
                                           hysteresis=3.0))
    tuner2._armed = False
    for _ in range(4):
        tuner2.drift.add("makespan", 1e-3, 2e-3)  # 2.0x: in widened band
    assert tuner2.should_retune() is None
    for _ in range(8):
        tuner2.drift.add("makespan", 1e-3, 8e-3)  # 8x: beyond 1.5*3.0
    assert tuner2.should_retune() is not None
    with pytest.raises(ValueError):
        RetunePolicy(drift_threshold=1.0)
    with pytest.raises(ValueError):
        RetunePolicy(hysteresis=0.5)


def test_spec_persist_and_reload_across_tuners(store, tmp_path):
    reg = SpecRegistry(root=str(tmp_path))
    cfg = PlanConfig(n_lanes=2)
    tuner = _mk_tuner(registry=reg)
    assert tuner.load(GEOM) is None               # nothing persisted yet
    ex = Executor(store, store.plan(cfg), tapi.make_pagerank(max_iters=3),
                  device="cpu", calibrator=tuner.calibrator)
    event = tuner.retune(store, ex, cfg, force=True)
    assert event["applied"] and event["spec_path"]
    with open(event["spec_path"]) as f:
        on_disk = json.load(f)
    assert on_disk["version"] == 1 and on_disk["source"] == "calibrated"
    assert on_disk["device_kind"] == default_device_kind("cpu")
    tuner2 = AutoTuner(registry=reg, device="cpu")
    spec = tuner2.load(GEOM)
    assert spec is not None and tuner2.version == 1
    assert tuner2.hw == tuner.hw


def _service(tuner, **kw):
    return tapi.GraphService(default_geom=GEOM, device="cpu",
                             autotune=tuner, **kw)


def test_service_drift_triggered_retune(graph):
    tuner = _mk_tuner()
    svc = _service(tuner)
    try:
        svc.register(graph)
        r0, _ = svc.submit(graph, "pagerank").result(timeout=WAIT)
        b0, _ = svc.submit(graph, "bfs").result(timeout=WAIT)
        deadline = time.monotonic() + WAIT
        while tuner.retunes == 0 and time.monotonic() < deadline:
            if any("error" in e or e.get("rejected")
                   for e in tuner.events):
                break
            time.sleep(0.05)
        assert tuner.retunes >= 1, tuner.events   # analytic HW on a CPU
        assert tuner.version >= 1
        r1, _ = svc.submit(graph, "pagerank").result(timeout=WAIT)
        b1, _ = svc.submit(graph, "bfs").result(timeout=WAIT)
        np.testing.assert_allclose(r1, r0, rtol=1e-5, atol=1e-7)
        assert np.array_equal(b1, b0)             # swap is invisible
        st = svc.stats()
        assert st["autotune"]["retunes"] >= 1
        assert st["service"]["calibration"]["version"] >= 1
        assert svc.metrics.retunes >= 1
        prom = svc.metrics.render_prometheus()
        assert "regraph_retunes_total" in prom
        assert "regraph_calibration_version" in prom
        assert "regraph_calibration_age_seconds" in prom
    finally:
        svc.close()


def test_service_builds_tuner_on_its_device(tmp_path):
    """autotune=True / a dict builds a tuner on the service's device,
    which adopts a persisted spec of that device kind at start."""
    reg = SpecRegistry(root=str(tmp_path))
    hw = perf_model.DEFAULT_HW.clone(c_edges=4.0, combine="sum")
    reg.put(DeviceSpec(device_kind=default_device_kind("cpu"),
                       geom_key=geometry_key(GEOM), hw=hw, version=7,
                       created_at=time.time(), source="calibrated"))
    with _service({"registry": reg}) as svc:
        assert svc.autotuner.device == torch.device("cpu")
        assert svc.autotuner.version == 7 and svc.autotuner.hw == hw
        assert svc.stats()["service"]["calibration"]["version"] == 7
        cfg = svc.autotuner.resolve_config(PlanConfig())
        assert cfg.hw is svc.autotuner.hw
    with _service(True) as svc:
        assert svc.autotuner.device_kind == default_device_kind("cpu")


def test_service_retune_now_and_control_plane(graph):
    from repro_torch.control import ControlPlane
    tuner = _mk_tuner()
    svc = _service(tuner)
    cp = ControlPlane(svc)
    try:
        svc.register(graph)
        rec = cp.retune_job(graph)
        assert str(rec.state).lower().endswith("done")
        assert rec.metrics["applied"] is True
        assert tuner.retunes == 1 and svc.metrics.retunes == 1
        snap = cp.metrics_snapshot()
        assert snap["autotune"]["version"] == 1
        event = svc.retune_now(fingerprint=graph.fingerprint(), app="bfs",
                               n_lanes=2)
        assert event["applied"] and tuner.retunes == 2
        with pytest.raises(ValueError):
            svc.retune_now(graph, config=PlanConfig(), n_lanes=2)
        with pytest.raises(KeyError):
            svc.retune_now(fingerprint="0" * 32)
    finally:
        cp.close()


def test_service_without_autotune_unchanged(graph):
    svc = tapi.GraphService(default_geom=GEOM, device="cpu")
    try:
        svc.register(graph)
        svc.submit(graph, "pagerank").result(timeout=WAIT)
        assert svc.autotuner is None
        assert svc.stats()["autotune"] is None
        assert svc.stats()["service"]["calibration"] is None
        with pytest.raises(RuntimeError, match="without autotune"):
            svc.retune_now(graph)
    finally:
        svc.close()


"""The port's lane-sharded execution against the JAX reference and
against its own fused path.

Placement parity with ``repro.sharding.place_lanes`` (owners equal for
1-8 devices on the same estimates, with and without ``keep=``);
``resolve_devices``; sharded over k CPU owners (k = 1, 2, 4) bit-equal
to fused for all five apps, with one merge per iteration; a delta keeps
resident shards (no moved bytes for clean lanes); the rebalance trigger;
placement and memory accounting with sharded forms.
"""
import types

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.graphs.rmat import rmat as jrmat
from repro.sharding import place_lanes as jplace

from repro_torch import api as tapi, convert
from repro_torch.kernels import ops
from repro_torch.sharding import (LanePlacement, lane_estimates,
                                  place_lanes, resolve_devices)
from repro_torch.streaming import apply_delta, random_delta

GEOM_J = japi.Geometry(U=128, W=128, T=128, E_BLK=128, big_batch=2)
GEOM = convert.geometry_from(GEOM_J)
APPS = ("pagerank", "bfs", "sssp", "wcc", "closeness")
CPU = torch.device("cpu")


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
    gj = jrmat(9, 8, seed=3)            # 512 vertices, 4 partitions
    return gj, _port_graph(gj)


@pytest.fixture(scope="module")
def shard_store(graphs):
    return tapi.GraphStore(graphs[1], geom=GEOM)


# -- placement ----------------------------------------------------------

@pytest.mark.parametrize("n_lanes", [4, 8])
def test_place_lanes_equal_reference(n_lanes, graphs):
    """On both packages' plans, and on random estimates with and without
    pinned lanes: owners, loads and bounds equal for 1-8 devices."""
    gj, gt = graphs
    pj = japi.GraphStore(gj, geom=GEOM_J).plan(
        japi.PlanConfig(n_lanes=n_lanes)).plan
    pt = tapi.GraphStore(gt, geom=GEOM).plan(
        tapi.PlanConfig(n_lanes=n_lanes)).plan
    rng = np.random.default_rng(n_lanes)
    fake = types.SimpleNamespace(lanes=[[]] * 12, num_little_lanes=5)
    ests = list(rng.random(12) * 1e-3)
    for n_dev in range(1, 9):
        a, b = jplace(pj, n_dev), place_lanes(pt, n_dev)
        assert a.device_of_lane == b.device_of_lane
        assert a.lane_ests == b.lane_ests and a.stats() == b.stats()
        keep = {0: n_dev - 1, 6: 0}
        for kw in (dict(lane_ests=ests), dict(lane_ests=ests, keep=keep)):
            a, b = jplace(fake, n_dev, **kw), place_lanes(fake, n_dev, **kw)
            assert a.device_of_lane == b.device_of_lane
            assert a.loads == b.loads
        fresh = place_lanes(fake, n_dev, lane_ests=ests)
        assert max(fresh.loads) <= fresh.lpt_bound() + 1e-12
    assert lane_estimates(pt) == [float(sum(e.est_time for e in lane))
                                  for lane in pt.lanes]


def test_resolve_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_devices()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_devices(True)
    with pytest.raises(ValueError, match="0 CUDA device"):
        resolve_devices(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_devices(["cuda"])           # never a quiet CPU run
    with pytest.raises(ValueError, match="at least one"):
        resolve_devices([])
    assert resolve_devices(["cpu", torch.device("cpu")]) == (CPU, CPU)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    both = (torch.device("cuda", 0), torch.device("cuda", 1))
    assert resolve_devices() == resolve_devices(True) == both
    assert resolve_devices(1) == both[:1]
    with pytest.raises(ValueError, match="2 CUDA device"):
        resolve_devices(3)


def test_shard_entry_points_raise_without_cuda(monkeypatch, shard_store):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.compile(None, "bfs", store=shard_store, shard=True)
    with pytest.raises(ValueError, match="CUDA device"):
        tapi.compile(None, "bfs", store=shard_store, shard=1)
    with pytest.raises(ValueError, match="not both"):
        tapi.compile(None, "bfs", store=shard_store, shard=["cpu"],
                     device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_store.shard(None, True)


# -- parity: sharded == fused -------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("app", APPS)
def test_sharded_bit_identical_to_fused(shard_store, app, k):
    cfg = tapi.PlanConfig(n_lanes=4)
    f = tapi.compile(None, app, store=shard_store, config=cfg, device="cpu")
    s = tapi.compile(None, app, store=shard_store, config=cfg,
                     shard=["cpu"] * k)
    pf, mf = f.run(max_iters=3)
    ps, ms = s.run(max_iters=3)
    assert mf["iterations"] == ms["iterations"]
    assert np.array_equal(pf, ps)
    d = s.executor.dispatch_stats()
    assert d["shard"] and d["n_devices"] == k
    assert d["cross_device_merges"] == 1
    # what the last iteration actually did: one launch per payload on its
    # owner, ONE merge
    last = d["last_iteration"]
    assert last["merges"] == 1
    assert last["launches_per_device"] == d["kernel_dispatches_per_device"]
    assert sum(last["launches_per_device"]) == d["kernel_dispatches"] \
        == f.executor.dispatch_stats()["kernel_dispatches"]
    vp = f.executor.init_props()
    assert torch.equal(s.executor.gather(vp), f.executor.gather(vp))


def test_sharded_matches_reference_in_pallas_interpret(graphs):
    """One small case against the reference's sharded path through its
    Pallas kernel (interpret mode): BFS exact, SSSP exact."""
    gj, gt = graphs
    sj = japi.GraphStore(gj, geom=GEOM_J)
    st = tapi.GraphStore(gt, geom=GEOM)
    for app in ("bfs", "sssp"):
        want, mj = japi.compile(None, app, store=sj, n_lanes=4,
                                path="pallas", shard=1).run(max_iters=2)
        got, mt = tapi.compile(None, app, store=st, n_lanes=4,
                               shard=["cpu", "cpu"]).run(max_iters=2)
        assert mt["iterations"] == mj["iterations"]
        assert np.array_equal(got, want)


def test_payloads_resident_on_owners_and_accounting(shard_store):
    cfg = tapi.PlanConfig(n_lanes=8)
    devs = ["cpu", "cpu", "cpu"]
    sh = shard_store.shard(cfg, devs)
    assert shard_store.shard(cfg, devs) is sh          # memoized
    ex = shard_store.executor(tapi.make_pagerank(), cfg, shard=devs)
    assert ex.sharded is sh
    per_dev = ex.dispatch_stats()["kernel_dispatches_per_device"]
    assert per_dev == [len(sh.payloads_of(d)) for d in range(3)]
    for i, lane in enumerate(sh.lanes):
        for p in lane:
            assert all(v.device == sh.devices[sh.placement.device_of_lane[i]]
                       for v in p.values() if isinstance(v, torch.Tensor))
    # bytes: per device, in the bundle, in the store
    assert sum(sh.bytes_per_device()) == sh.nbytes() == \
        ex.memory_footprint()
    assert sh.moved == sum(1 for lane in sh.lanes if lane)
    assert sh.bytes_moved == sh.nbytes() and sh.reused == 0
    dev_bytes = shard_store.plan(cfg).device_bytes()
    assert dev_bytes["sharded_bytes"] >= sh.nbytes()
    assert dev_bytes["total_bytes"] == (dev_bytes["entry_bytes"]
                                        + dev_bytes["packed_bytes"]
                                        + dev_bytes["sharded_bytes"])
    place = shard_store.placement_stats()
    assert place["devices"] >= 3 and place["sharded_plans"] >= 1
    assert sum(place["bytes_per_device"]) == sum(
        s.nbytes() for b in shard_store._plan_cache.values()
        for s in b._sharded.values())
    assert shard_store.stats()["placement"] == place
    mem = shard_store.memory_footprint()
    assert mem["plan_bytes"] == sum(b.device_bytes()["total_bytes"]
                                    for b in shard_store._plan_cache.values())
    st = ex.stats()
    assert st["placement"]["lanes_per_device"] == sh.stats()[
        "lanes_per_device"]
    with pytest.raises(ValueError, match="fuse_lanes"):
        shard_store.executor(tapi.make_bfs(), cfg, shard=devs,
                             fuse_lanes=False)


# -- streaming: resident shards -----------------------------------------

def test_delta_keeps_resident_shards():
    """After apply_delta, clean lanes stay on their owners as the same
    tensors: shards_reused counts them, and the bytes moved are exactly
    the re-uploaded (dirty or re-placed) lanes'."""
    gt = _port_graph(jrmat(11, 8, seed=5, weighted=True))
    store = tapi.GraphStore(gt, geom=GEOM)
    cfg = tapi.PlanConfig(n_lanes=8)
    devs = ["cpu", "cpu"]
    old = store.shard(cfg, devs)
    res = apply_delta(store, random_delta(gt, churn=0.005, seed=11,
                                          hot_frac=0.05, grow_frac=0.01))
    s = res.stats
    assert s["grown_vertices"] > 0
    assert s["shards_reused"] >= 1 and s["shard_bytes_reused"] > 0
    new = res.store.shard(cfg, devs)
    carried = [(i, j) for i, lane in enumerate(new.lanes)
               for j, o in enumerate(old.lanes) if lane and lane is o]
    assert len(carried) == s["shards_reused"] == new.reused
    for i, j in carried:
        assert new.placement.device_of_lane[i] == \
            old.placement.device_of_lane[j]
    reused_bytes = sum(ops.payload_nbytes(p) for i, _ in carried
                       for p in new.lanes[i])
    assert reused_bytes == s["shard_bytes_reused"]
    assert s["shard_bytes_moved"] == new.nbytes() - reused_bytes
    assert s["shards_moved"] == sum(1 for lane in new.lanes if lane) \
        - len(carried)
    pf, _ = res.store.executor(tapi.make_pagerank(max_iters=2), cfg,
                               device="cpu").run(max_iters=2)
    ps, _ = res.store.executor(tapi.make_pagerank(max_iters=2), cfg,
                               shard=devs).run(max_iters=2)
    assert np.array_equal(pf, ps)


def test_placement_rebalance_trigger(monkeypatch):
    """rebuild_plans drops keep= pins and re-places from scratch when a
    re-placement's imbalance passes the threshold (forced to fire here,
    as in the reference's test: the machinery under test is the
    pop-and-replace path and its accounting)."""
    assert not LanePlacement(
        n_devices=2, num_little_lanes=1, device_of_lane=(0, 1),
        lane_ests=(1.0, 1.0)).needs_rebalance(1.5)
    assert LanePlacement(
        n_devices=2, num_little_lanes=1, device_of_lane=(0, 0),
        lane_ests=(1.0, 1.0)).needs_rebalance(1.5)

    gt = _port_graph(jrmat(11, 8, seed=5, weighted=True))
    store = tapi.GraphStore(gt, geom=GEOM)
    cfg = tapi.PlanConfig(n_lanes=8)
    ex = store.executor(tapi.make_pagerank(max_iters=2), cfg, shard=["cpu"])
    ex.run(max_iters=2)
    delta = random_delta(gt, churn=0.01, seed=13, hot_frac=0.05,
                         grow_frac=0.01)
    base = apply_delta(store, delta)
    assert base.stats["placements_rebalanced"] == 0
    assert base.stats["placement_imbalance"] >= 1.0
    assert base.stats["shards_reused"] >= 1
    monkeypatch.setattr(LanePlacement, "needs_rebalance",
                        lambda self, t: True)
    res = apply_delta(store, delta, rebalance_threshold=1.0)
    assert res.stats["placements_rebalanced"] == 1
    sh = res.store.shard(cfg, ["cpu"])
    assert sh.reused == 0 and sh.moved == sum(1 for lane in sh.lanes
                                              if lane)
    pf, _ = res.store.executor(tapi.make_pagerank(max_iters=2), cfg,
                               device="cpu").run(max_iters=2)
    ps, _ = res.store.executor(tapi.make_pagerank(max_iters=2), cfg,
                               shard=["cpu"]).run(max_iters=2)
    assert np.array_equal(pf, ps)

"""The port's streaming layer against the JAX reference, and against
itself.

Parity with ``repro.streaming`` (the same seeded graphs and deltas sent
through both packages; the reference on its ref path): delta arrays and
fingerprints, derived stores (edges, partition stats, blockings, plans,
packed host payloads) and the apply stats, exactly; min/max/or apps on
a derived store exactly, PageRank within rtol 1e-5 / atol 1e-7. Inside
the port, bit for bit: a derived store == a cold
``GraphStore(post_graph, perm=...)`` rebuild for all five apps, fused ==
per-entry == sharded on it, and clean lanes keep their very tensors.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import perf_model as jperf
from repro.graphs.rmat import rmat as jrmat
from repro.kernels import ops as jops
from repro.streaming import (apply_delta as japply,
                             apply_delta_to_graph as jpost,
                             chain_fingerprint as jchain,
                             compact_deltas as jcompact,
                             compose_deltas as jcompose,
                             grouping_drift as jdrift,
                             make_delta as jmake, random_delta as jrandom,
                             reregister as jreregister)

from repro_torch import api as tapi, convert
from repro_torch.core import perf_model as tperf
from repro_torch.kernels import ops as tops
from repro_torch.streaming import (apply_delta, apply_delta_to_graph,
                                   chain_fingerprint, compact_deltas,
                                   compose_deltas, grouping_drift,
                                   make_delta, random_delta, reregister)

GEOM_J = japi.Geometry(U=256, W=128, T=128, E_BLK=128, big_batch=2)
GEOM = convert.geometry_from(GEOM_J)
N_LANES = 4
CPU = torch.device("cpu")
APPS = [("pagerank", {}), ("bfs", {"root": 0}), ("sssp", {"root": 0}),
        ("wcc", {}), ("closeness", {"sources": np.arange(4)})]
# (churn, seed, hot_frac, update_frac, grow_frac) of the apply cases
DELTAS = {
    "splice": (0.01, 17, 0.02, 0.005, 0.0),     # skewed: few dirty
    "bulk": (0.01, 19, None, 0.0, 0.0),         # uniform: all dirty
    "growth": (0.005, 11, 0.05, 0.0, 0.01),     # new tail vertices
}
DELTA_KEYS = ("add_src", "add_dst", "add_weights", "remove_src",
              "remove_dst", "update_src", "update_dst", "update_weights")


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


def _deltas(graphs, churn, seed, hot_frac, update_frac, grow_frac):
    gj, gt = graphs
    kw = dict(churn=churn, seed=seed, hot_frac=hot_frac,
              update_frac=update_frac, grow_frac=grow_frac)
    return jrandom(gj, **kw), random_delta(gt, **kw)


def _same_delta(dj, dt):
    for k in DELTA_KEYS:
        a, b = getattr(dj, k), getattr(dt, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert (dj.base_fp, dj.grow_to) == (dt.base_fp, dt.grow_to)
    assert dj.fingerprint() == dt.fingerprint()


def _stores(graphs):
    """Fresh base stores in both packages with one cached plan whose
    packed form is materialized."""
    gj, gt = graphs
    sj = japi.GraphStore(gj, geom=GEOM_J)
    sj.plan(japi.PlanConfig(n_lanes=N_LANES)).packed_lanes()
    st = tapi.GraphStore(gt, geom=GEOM)
    st.plan(tapi.PlanConfig(n_lanes=N_LANES)).packed_lanes(CPU)
    return sj, st


def _same_blocked(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "geom":
            assert dataclasses.asdict(va) == dataclasses.asdict(vb)
        elif isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and np.array_equal(va, vb), f.name
        else:
            assert va == vb, f.name


def _same_host_payload(pj, pt):
    assert set(pt) == set(pj) | {"tile_block_start"}
    for k, vj in pj.items():
        vt = pt[k]
        if k == "geom":
            assert dataclasses.asdict(vj) == dataclasses.asdict(vt)
        elif isinstance(vj, np.ndarray) or vj is None:
            assert (vj is None) == (vt is None), k
            if vj is not None:
                assert vj.dtype == vt.dtype and np.array_equal(vj, vt), k
        else:
            assert vj == vt, k


def _same_store(sj, st):
    for k in ("src", "dst", "weights"):
        assert np.array_equal(sj.edges[k], st.edges[k]), k
    assert [dataclasses.asdict(i) for i in sj.infos] == \
        [dataclasses.asdict(i) for i in st.infos]
    assert (sj.V_pad, sj.graph.num_vertices, sj.graph.num_edges) == \
        (st.V_pad, st.graph.num_vertices, st.graph.num_edges)
    assert np.array_equal(sj.perm, st.perm)
    assert sj.fingerprint() == st.fingerprint()
    assert sorted(sj._little_cache) == sorted(st._little_cache)
    assert sorted(sj._big_cache) == sorted(st._big_cache)
    for k in sj._little_cache:
        _same_blocked(sj._little_cache[k], st._little_cache[k])
    for k in sj._big_cache:
        _same_blocked(sj._big_cache[k], st._big_cache[k])


def _run(store, app, kw, max_iters=5, **where):
    a = tapi.BUILTIN_APPS[app](**kw)
    return tapi.compile(None, a, store=store, n_lanes=N_LANES,
                        **where).run(max_iters=max_iters)


def _jrun(store, app, kw, max_iters=5, path="ref"):
    a = japi.BUILTIN_APPS[app](**kw)
    return japi.compile(None, a, store=store, n_lanes=N_LANES,
                        path=path).run(max_iters=max_iters)


# ---------------------------------------------------------------------------
# Deltas and fingerprints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(DELTAS))
def test_random_delta_and_post_graph_equal_reference(case, graphs):
    dj, dt = _deltas(graphs, *DELTAS[case])
    _same_delta(dj, dt)
    gj, gt = graphs
    pj, pt = jpost(gj, dj), apply_delta_to_graph(gt, dt)
    assert pj.num_vertices == pt.num_vertices
    for k in ("src", "dst", "weights"):
        assert np.array_equal(getattr(pj, k), getattr(pt, k)), k
    assert pj.fingerprint() == pt.fingerprint()
    assert jchain(gj.fingerprint(), dj.fingerprint()) == \
        chain_fingerprint(gt.fingerprint(), dt.fingerprint())


def test_make_delta_digests_equal_reference():
    fp = "ab" * 16
    cases = [dict(add=([0, 3], [1, 2], [0.5, 0.25])),
             dict(remove=([4], [5]), update=([1], [2], [0.75])),
             dict(add=([7], [9]), grow_to=12), dict()]
    for kw in cases:
        _same_delta(jmake(fp, **kw), make_delta(fp, **kw))
    with pytest.raises(ValueError):
        make_delta(fp, add=([0], [1]), remove=([0], [1]))


def test_compose_and_compact_match_reference(graphs):
    """A three-delta chain: composed deltas, the compacted delta and its
    tip fingerprint (the lineage) equal the reference's."""
    gj, gt = graphs
    chain_j, chain_t = [], []
    fj = ft = gj.fingerprint()
    for seed in (31, 37, 41):
        dj = jrandom(gj, churn=0.01, seed=seed, base_fp=fj)
        dt = random_delta(gt, churn=0.01, seed=seed, base_fp=ft)
        _same_delta(dj, dt)
        chain_j.append(dj)
        chain_t.append(dt)
        gj, gt = jpost(gj, dj, check_fp=False), \
            apply_delta_to_graph(gt, dt, check_fp=False)
        fj, ft = jchain(fj, dj.fingerprint()), \
            chain_fingerprint(ft, dt.fingerprint())
    _same_delta(jcompose(chain_j[0], chain_j[1]),
                compose_deltas(chain_t[0], chain_t[1]))
    (cj, tip_j), (ct, tip_t) = jcompact(chain_j), compact_deltas(chain_t)
    _same_delta(cj, ct)
    assert tip_j == tip_t == ft


# ---------------------------------------------------------------------------
# apply_delta: derived stores against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(DELTAS))
def test_apply_delta_matches_reference(case, graphs):
    """Derived store edges, stats, blockings, plans, packed host
    payloads and the apply stats (merge path, dirty pids, reuse and
    repack counts) equal the reference's."""
    dj, dt = _deltas(graphs, *DELTAS[case])
    sj, st = _stores(graphs)
    rj, rt = japply(sj, dj), apply_delta(st, dt)
    assert rj.fingerprint == rt.fingerprint
    assert rj.dirty_pids == rt.dirty_pids
    stats_j = {k: v for k, v in rj.stats.items() if not k.startswith("t_")}
    stats_t = {k: v for k, v in rt.stats.items() if not k.startswith("t_")}
    # the port's device payloads hold the live-edge stream (12 B a real
    # edge, and the tile edge and chunk indices: 2 x 4 x (n_out_tiles +
    # 1) B) in place of the reference's padded slabs (16 B a slot) and
    # per-block routing fields (window and tile id, tile_first: 12 B a
    # block), beside the same tile_idx and tables of the same reused
    # payloads
    base = st.plan(tapi.PlanConfig(n_lanes=N_LANES)).packed_lanes(CPU)
    reused = [p for lane in rt.store.plan(tapi.PlanConfig(
        n_lanes=N_LANES)).packed_lanes(CPU)
        if any(lane is old for old in base) for p in lane]
    stream = sum(8 * (p["n_out_tiles"] + 1) + 12 * p["num_real_edges"]
                 for p in reused)
    padded = sum(p["n_blocks"] * (16 * p["geom"].E_BLK + 12)
                 for p in reused)
    assert stats_t.pop("packed_bytes_reused") - stream + padded == \
        stats_j.pop("packed_bytes_reused")
    assert stats_j == stats_t
    assert stats_t["path"] == ("bulk_sort" if case == "bulk" else "splice")
    assert (stats_t["grown_vertices"] > 0) == (case == "growth")
    _same_store(rj.store, rt.store)
    cfg_j, cfg_t = (japi.PlanConfig(n_lanes=N_LANES),
                    tapi.PlanConfig(n_lanes=N_LANES))
    bj, bt = rj.store.plan(cfg_j), rt.store.plan(cfg_t)
    assert [[dataclasses.asdict(e) for e in lane] for lane in bj.plan.lanes] \
        == [[dataclasses.asdict(e) for e in lane] for lane in bt.plan.lanes]
    n = 0
    for lane_j, lane_t in zip(bj.plan.lanes, bt.plan.lanes):
        for pj, pt in zip(
                jops._pack_lane_np(lane_j, bj.little_works, bj.big_works),
                tops._pack_lane_np(lane_t, bt.little_works, bt.big_works)):
            _same_host_payload(pj, pt)
            n += 1
    assert n > 0


@pytest.fixture(scope="module")
def derived_pair(graphs):
    """The reference's and the port's derived stores after one delta,
    and the port's cold rebuild of the post-delta graph."""
    dj, dt = _deltas(graphs, 0.02, 23, None, 0.005, 0.0)
    sj, st = _stores(graphs)
    rj, rt = japply(sj, dj), apply_delta(st, dt)
    cold = tapi.GraphStore(apply_delta_to_graph(graphs[1], dt), geom=GEOM,
                           perm=rt.store.perm)
    return rj.store, rt.store, cold


@pytest.mark.parametrize("app,kw", APPS)
def test_apps_on_derived_store_match_reference(app, kw, derived_pair):
    sj, st, _ = derived_pair
    want, mj = _jrun(sj, app, kw)
    got, mt = _run(st, app, kw, device="cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    if app == "pagerank":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    else:
        assert mt["iterations"] == mj["iterations"]
        assert np.array_equal(got, want)


@pytest.mark.parametrize("app,kw", APPS)
def test_derived_equals_cold_rebuild_fused_entry_sharded(app, kw,
                                                          derived_pair):
    """Inside the port, bit for bit: derived == cold rebuild, and on the
    derived store fused == per-entry == sharded over two owners."""
    _, st, cold = derived_pair
    got, mt = _run(st, app, kw, device="cpu")
    for other, mo in (_run(cold, app, kw, device="cpu"),
                      _run(st, app, kw, device="cpu", fuse_lanes=False),
                      _run(st, app, kw, shard=["cpu", "cpu"])):
        assert mo["iterations"] == mt["iterations"]
        assert np.array_equal(got, other)


def test_derived_store_matches_reference_in_pallas_interpret():
    """One small case through the reference's Pallas kernel (interpret
    mode): BFS on a derived store, exact."""
    gj = jrmat(9, 6, seed=5, weighted=True)
    graphs = (gj, _port_graph(gj))
    dj, dt = _deltas(graphs, 0.03, 29, None, 0.01, 0.0)
    sj = japi.GraphStore(gj, geom=GEOM_J)
    st = tapi.GraphStore(graphs[1], geom=GEOM)
    want, mj = _jrun(japply(sj, dj).store, "bfs", {"root": 0}, max_iters=3,
                     path="pallas")
    got, mt = _run(apply_delta(st, dt).store, "bfs", {"root": 0},
                   max_iters=3, device="cpu")
    assert mt["iterations"] == mj["iterations"]
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# Reuse and snapshot semantics
# ---------------------------------------------------------------------------

def test_clean_lanes_keep_their_tensors():
    """Reused lanes of the packed form and of every sharded form are the
    SAME objects holding the same tensors (no re-pack, no re-upload);
    their count is what the stats report."""
    gj = jrmat(13, 8, seed=7, weighted=True)       # 32 partitions
    gt = _port_graph(gj)
    st = tapi.GraphStore(gt, geom=GEOM)
    cfg = tapi.PlanConfig(n_lanes=N_LANES)
    forms = [("cpu",), ("cpu", "cpu")]
    packed0 = st.plan(cfg).packed_lanes(CPU)
    sharded0 = {f: st.shard(cfg, list(f)) for f in forms}
    tensors0 = {id(lane): [(k, v) for p in lane for k, v in p.items()
                           if isinstance(v, torch.Tensor)]
                for lane in packed0 + [lane for s in sharded0.values()
                                       for lane in s.lanes]}
    res = apply_delta(st, random_delta(gt, churn=0.01, seed=13,
                                       hot_frac=0.01))
    s = res.stats
    assert s["dirty_partitions"] < s["partitions"] // 2
    assert s["packed_lanes_reused"] >= 1 and s["packed_bytes_reused"] > 0
    assert s["shards_reused"] >= 1 and s["shard_bytes_reused"] > 0

    def carried(new_lanes, old_lanes):
        out = [lane for lane in new_lanes
               if any(lane is old for old in old_lanes)]
        for lane in out:
            now = [(k, v) for p in lane for k, v in p.items()
                   if isinstance(v, torch.Tensor)]
            assert [k for k, _ in now] == [k for k, _ in tensors0[id(lane)]]
            for (_, a), (_, b) in zip(now, tensors0[id(lane)]):
                assert a is b and a.data_ptr() == b.data_ptr()
        return len(out)

    new_bundle = res.store.plan(cfg)
    assert carried(new_bundle.packed_lanes(CPU), packed0) \
        == s["packed_lanes_reused"]
    for f in forms:
        new_sh = res.store.shard(cfg, list(f))
        assert carried(new_sh.lanes, sharded0[f].lanes) == new_sh.reused
        # clean lanes stay with their owners
        for i, lane in enumerate(new_sh.lanes):
            for j, old in enumerate(sharded0[f].lanes):
                if lane and lane is old:
                    assert new_sh.placement.device_of_lane[i] == \
                        sharded0[f].placement.device_of_lane[j]
    # the derived store's device bytes count what it holds, reused or not
    assert res.store.memory_footprint()["plan_bytes"] == \
        new_bundle.device_bytes()["total_bytes"] > 0
    # the bundle's own count is the delta's: every reused lane was
    # spliced into this device's form
    assert new_bundle.packed_lanes_reused == s["packed_lanes_reused"]
    assert new_bundle.packed_bytes_reused == s["packed_bytes_reused"]


def test_base_store_is_an_untouched_snapshot(graphs):
    _, gt = graphs
    st = tapi.GraphStore(gt, geom=GEOM)
    cfg = tapi.PlanConfig(n_lanes=N_LANES)
    packed = st.plan(cfg).packed_lanes(CPU)
    before = {k: v.copy() for k, v in st.edges.items()}
    infos_before = [dataclasses.replace(i) for i in st.infos]
    res = apply_delta(st, random_delta(gt, churn=0.05, seed=19))
    assert res.store is not st
    for k in before:
        assert np.array_equal(st.edges[k], before[k])
    assert st.infos == infos_before
    assert st.fingerprint() == gt.fingerprint()
    assert st.has_plan(cfg) and st.plan(cfg).packed_lanes(CPU) is packed
    with pytest.raises(ValueError, match="targets snapshot"):
        apply_delta(res.store, random_delta(gt, churn=0.01, seed=3))


# ---------------------------------------------------------------------------
# Regrouping
# ---------------------------------------------------------------------------

def test_grouping_drift_and_reregister_match_reference(graphs):
    """Drift before and after heavy churn, and the re-registered store,
    equal the reference's (classified with the reference's scale-model
    constants, as its own test does)."""
    gj, gt = graphs
    hw_t = tperf.HW(**dataclasses.asdict(jperf.TPU_V5E_SCALED))
    sj, st = _stores(graphs)
    dj, dt = _deltas(graphs, 0.4, 9, None, 0.0, 0.0)
    rj, rt = japply(sj, dj).store, apply_delta(st, dt).store
    for a, b in ((sj, st), (rj, rt)):
        want = {k: v for k, v in jdrift(a, hw=jperf.TPU_V5E_SCALED).items()
                if k != "t_drift_ms"}
        got = {k: v for k, v in grouping_drift(b, hw=hw_t).items()
               if k != "t_drift_ms"}
        assert got == want
    assert grouping_drift(rt, hw=hw_t)["drift"] > 0.0
    assert grouping_drift(rt)["partitions"] == len(rt.infos)   # DEFAULT_HW
    fj, ft = jreregister(rj), reregister(rt)
    assert ft.fingerprint() == fj.fingerprint() == rt.fingerprint()
    _same_store(fj, ft)
    assert grouping_drift(ft, hw=hw_t)["drift"] == 0.0
    assert ft.has_plan(tapi.PlanConfig(n_lanes=N_LANES))

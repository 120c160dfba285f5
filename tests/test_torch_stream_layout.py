"""The live-edge store layout (``GraphStore(layout="stream")``), on the CPU.

A stream store builds its DBG permutation, partitions and tile-major
edges with torch, and keeps no padded slot. Held against the padded
store on the same graph:

* the permutation, every ``PartitionInfo`` (the perf model's exact block
  counts included) and the plan equal the padded store's;
* every payload's live-edge stream, tile indices and ``unique_src`` equal
  what the padded payloads derive (``ops.edge_stream``), bit for bit,
  packed and per entry, with the same device bytes and footprints;
* every way a device payload is made, from either layout, gives the one
  key set of ``ops._upload_payload`` and no padded array;
* PageRank, BFS and WCC served from a stream store answer as the plain
  reference of the benchmark (``gbench/reference``) and as the padded
  store does;
* the paths that need padded blocks refuse a stream store, and a stream
  store never allocates a padded array.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch import convert, obs
from repro_torch.core import partition, stream, types
from repro_torch.core.distributed import chunk_queues, pack_chunks
from repro_torch.core.executor import Executor
from repro_torch.core.gas import BUILTIN_APPS
from repro_torch.core.store import GraphStore
from repro_torch.graphs.formats import from_edges
from repro_torch.graphs.rmat import rmat
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gbench import gen, harness  # noqa: E402
from gbench.reference import bfs as rbfs  # noqa: E402
from gbench.reference import edges as redges  # noqa: E402
from gbench.reference import pagerank as rpr  # noqa: E402
from gbench.reference import wcc as rwcc  # noqa: E402

CPU = torch.device("cpu")
GEOMS = {
    "small": types.Geometry(U=128, W=128, T=128, E_BLK=128, big_batch=2),
    "wide": types.Geometry(U=256, W=128, T=128, E_BLK=128, big_batch=3),
}
CONFIGS = {
    "model": api.PlanConfig(n_lanes=3),
    # the Big gather made free, so the sparse partitions go Big
    "big": api.PlanConfig(n_lanes=3, hw=api.DEFAULT_HW.clone(gather_b=0.0)),
    "monolithic": api.PlanConfig(mode="monolithic", n_lanes=4),
}
GRAPHS = ["rmat_w", "rmat", "kron", "urand"]
WAIT = 300.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run shares the CPU among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bench_graph(name: str, seed: int):
    """A graph as the benchmark makes it: symmetric, isolated ids kept,
    the configuration's weights (unit weights for graph500_24)."""
    bench = harness.load_bench(ROOT)
    cfg = harness.load_config(bench, name, ROOT)
    cfg["scale"] = 10
    graph, _ = harness._program_graph(gen.make_graph(cfg, seed, CPU, ROOT),
                                      name)
    return graph


def _symmetric(g):
    """``g`` with both directions of every edge, each keeping one weight."""
    return from_edges(np.concatenate([g.src, g.dst]),
                      np.concatenate([g.dst, g.src]), g.num_vertices,
                      weights=np.concatenate([g.weights, g.weights]))


@pytest.fixture(scope="module")
def graphs():
    return {
        "rmat_w": rmat(10, 16, seed=5, weighted=True),
        "rmat": rmat(10, 16, seed=6),
        "kron": _bench_graph("graph500_24", 7),
        "urand": _bench_graph("urand20", 8),
    }


@pytest.fixture(scope="module")
def stores(graphs):
    """(padded, stream) stores of every graph on every geometry."""
    return {(g, k): (GraphStore(graphs[g], geom=geom),
                     GraphStore(graphs[g], geom=geom, layout="stream",
                                device="cpu"))
            for g in GRAPHS for k, geom in GEOMS.items()}


@pytest.mark.parametrize("geom", sorted(GEOMS))
@pytest.mark.parametrize("graph", GRAPHS)
def test_layout_equals_the_padded_store(stores, graph, geom):
    padded, live = stores[graph, geom]
    assert live.layout == "stream" and live.graph is None
    assert np.array_equal(live.perm, padded.perm)
    assert live.perm.dtype == padded.perm.dtype
    assert live.infos == padded.infos
    assert live.num_vertices == padded.num_vertices
    assert live.num_edges == padded.num_edges
    assert np.array_equal(live.out_degrees(), padded.out_degrees())
    assert live.V_pad == padded.V_pad
    st = live.stats()
    assert st["layout"] == "stream" and st["device_bytes"] == 0
    assert padded.stats()["layout"] == "padded"
    assert padded.stats()["device_bytes"] == 0


def _assert_same_payloads(lanes_a, lanes_b):
    """Payload by payload: the same keys, tensors and counts, device
    bytes and footprints."""
    assert [len(x) for x in lanes_a] == [len(x) for x in lanes_b]
    for pa, pb in zip([p for x in lanes_a for p in x],
                      [p for x in lanes_b for p in x]):
        assert set(pa) == set(pb)
        for k, v in pa.items():
            if isinstance(v, torch.Tensor):
                assert v.dtype == pb[k].dtype and torch.equal(v, pb[k]), k
            else:
                assert v == pb[k], k
        assert ops.payload_nbytes(pa) == ops.payload_nbytes(pb)
        assert ops.payload_footprint(pa) == ops.payload_footprint(pb)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("geom", sorted(GEOMS))
@pytest.mark.parametrize("graph", GRAPHS)
def test_payloads_equal_the_padded_stream(stores, graph, geom, config):
    """The plan, and every payload's stream, tile indices and Big table,
    packed and per entry, equal the padded store's bit for bit."""
    padded, live = stores[graph, geom]
    ba, bb = padded.plan(CONFIGS[config]), live.plan(CONFIGS[config])
    assert ba.plan.lanes == bb.plan.lanes
    assert ba.plan.est_makespan == bb.plan.est_makespan
    assert [i.is_dense for i in ba.infos] == [i.is_dense for i in bb.infos]
    for pid, w in ba.little_works.items():
        assert bb.little_works[pid].n_blocks == w.n_blocks
    assert [w.n_blocks for w in bb.big_works] == \
        [w.n_blocks for w in ba.big_works]
    _assert_same_payloads(ba.packed_lanes(CPU), bb.packed_lanes(CPU))
    _assert_same_payloads(ba.lane_entries(CPU), bb.lane_entries(CPU))
    v_pad = padded.V_pad
    assert obs.lane_footprints(ba.packed_lanes(CPU), v_pad) == \
        obs.lane_footprints(bb.packed_lanes(CPU), v_pad)
    assert ba.device_bytes() == bb.device_bytes()


# what a device payload holds, whatever made it (big payloads add their
# unique_src table), and what it never holds
DEVICE_KEYS = {"kind", "geom", "n_out_tiles", "n_blocks", "n_entries",
               "num_real_edges", "edge_src", "edge_dst", "edge_w",
               "tile_edge_start", "tile_chunk_start", "tile_idx"}
PADDED_KEYS = {"src_local", "dst_local", "weights", "valid", "window_id",
               "tile_id", "tile_first", "segment_starts",
               "tile_block_start"}
PAYLOAD_FORMS = [("padded", f) for f in ("entry", "packed", "sharded",
                                         "distributed", "delta",
                                         "convert")] \
    + [("stream", f) for f in ("entry", "packed")]


def _device_payloads(graph, layout: str, form: str) -> list:
    """Device payloads on the CPU made as ``form`` makes them, from a
    fresh store of ``layout``."""
    store = GraphStore(graph, geom=GEOMS["small"], layout=layout,
                       device="cpu")
    cfg = CONFIGS["big"]
    bundle = store.plan(cfg)
    if form == "entry":
        lanes = bundle.lane_entries(CPU)
    elif form == "packed":
        lanes = bundle.packed_lanes(CPU)
    elif form == "sharded":
        lanes = store.shard(cfg, [CPU, CPU]).lanes
    elif form == "distributed":
        lanes = [[ops._upload_payload(pack_chunks(q), CPU)
                  for q in queues if q]
                 for queues in chunk_queues(bundle, 2, blocks_per_chunk=4)]
    elif form == "delta":                     # lanes carried over
        from repro_torch.streaming import apply_delta, make_delta
        old = bundle.packed_lanes(CPU)
        res = apply_delta(store, make_delta(
            store.fingerprint(), remove=(graph.src[:1], graph.dst[:1])))
        lanes = [lane for lane in res.store.plan(cfg).packed_lanes(CPU)
                 if any(lane is o for o in old)]
        assert len(lanes) == res.stats["packed_lanes_reused"] >= 1
    else:           # from a host payload as the reference builds it
        lanes = [[convert.payload_from_numpy(
            {k: v for k, v in h.items() if k != "tile_block_start"}, CPU)
            for h in ops._pack_lane_np(lane, bundle.little_works,
                                       bundle.big_works)]
            for lane in bundle.plan.lanes]
    return [p for lane in lanes for p in lane]


@pytest.mark.parametrize("layout,form", PAYLOAD_FORMS)
def test_every_device_payload_holds_one_key_set(graphs, layout, form):
    """The counts, the live-edge stream, ``tile_idx`` and (Big)
    ``unique_src``, and no padded array, on every form and layout."""
    payloads = _device_payloads(graphs["rmat_w"], layout, form)
    if form != "delta":
        assert {p["kind"] for p in payloads} == {"little", "big"}
    for p in payloads:
        arrays = DEVICE_KEYS - set(ops._COUNT_KEYS)
        if p["kind"] == "big":
            arrays = arrays | {"unique_src"}
        assert set(p) == arrays | set(ops._COUNT_KEYS)
        assert not set(p) & PADDED_KEYS
        assert all(isinstance(p[k], torch.Tensor) and p[k].device == CPU
                   for k in arrays)
        assert ops.payload_nbytes(p) == sum(
            p[k].numel() * p[k].element_size() for k in arrays)


@pytest.mark.parametrize("graph", ["rmat_w", "kron"])
def test_big_works_in_many_passes_are_the_same(stores, graph, monkeypatch):
    """Big works built a batch at a pass equal those built in one pass."""
    _, live = stores[graph, "small"]
    sparse = [i for i in live.infos if i.num_edges]
    batches = [tuple(i.pid for i in sparse[j:j + 2])
               for j in range(0, len(sparse), 2)]
    one = stream.big_works(live.stream, live.infos, live.geom, batches, CPU)
    monkeypatch.setattr(stream, "BIG_PASS_EDGES", 1)
    many = stream.big_works(live.stream, live.infos, live.geom, batches,
                            CPU)
    assert list(one) == list(many) == batches
    for b in batches:
        x, y = one[b], many[b]
        for f in ("n_blocks", "n_out_tiles", "pids", "num_real_edges"):
            assert getattr(x, f) == getattr(y, f), f
        for f in ("tile_dst_start", "tile_block_start", "tile_edge_start",
                  "unique_src"):
            assert np.array_equal(getattr(x, f), getattr(y, f)), f
        for f in ("edge_src", "edge_dst", "edge_w"):
            assert torch.equal(getattr(x, f), getattr(y, f)), f


@pytest.mark.parametrize("bounds", ["composite", "per_key"])
def test_stable_order_is_a_lexsort(bounds):
    """Both ways of sorting on several keys give numpy's lexsort, ties in
    input order."""
    rs = np.random.RandomState(4)
    a, b, c = (rs.randint(0, n, 5000) for n in (7, 50, 3))
    big = 2 ** 40 if bounds == "per_key" else 1
    keys = [(torch.from_numpy(a), 7 * big), (torch.from_numpy(b), 50 * big),
            (torch.from_numpy(c), 3)]
    got = stream._stable_order(keys).numpy()
    assert np.array_equal(got, np.lexsort((c, b, a)))


@pytest.mark.parametrize("degrees", ["powers", "random"])
def test_dbg_permutation_equals_the_numpy_one(degrees):
    """In-degrees at and next to powers of two land in the same groups."""
    rs = np.random.RandomState(9)
    if degrees == "powers":
        indeg = np.array([0, 1, 2, 3, 4, 7, 8, 15, 16, 31, 32, 63, 64,
                          255, 256, 1023, 1024])
    else:
        indeg = rs.randint(0, 300, 200)
    n = indeg.shape[0]
    dst = np.repeat(np.arange(n, dtype=np.int32), indeg)
    src = rs.randint(0, n, dst.shape[0]).astype(np.int32)
    g = from_edges(src, dst, n, dedup=False)
    want = partition.dbg_permutation(g)
    got = stream.dbg_permutation(torch.from_numpy(g.dst), n).numpy()
    assert np.array_equal(got, want)


# -- answers ---------------------------------------------------------------

def _reference_graph(g):
    return redges.Edges.from_numpy(
        g.num_vertices, g.src, g.dst,
        np.zeros(g.num_edges) if g.weights is None else g.weights, CPU)


def _serve(g, layout, apps, geom=GEOMS["small"]):
    with api.GraphService(device="cpu", default_geom=geom, workers=2,
                          store_layout=layout) as svc:
        fp = svc.register(g)
        handles = [svc.submit(fingerprint=fp, app=app, app_kwargs=kw,
                              n_lanes=3) for app, kw in apps]
        return [h.result(timeout=WAIT) for h in handles]


def _apps(g):
    root = int(g.src[np.argmax(np.bincount(g.src))])
    return [("pagerank", {"damping": 0.85, "max_iters": 16}),
            ("bfs", {"root": root}), ("wcc", {})]


@pytest.mark.parametrize("graph", ["rmat_w", "kron", "urand"])
def test_answers_match_the_plain_reference(graphs, graph):
    """Through ``GraphService(store_layout="stream")``, on symmetric
    graphs (the reference's WCC reads a symmetric graph): PageRank within
    the benchmark's limit of the fp64 reference, BFS levels and WCC's
    partition exact."""
    g = graphs[graph]
    if graph == "rmat_w":
        g = _symmetric(g)
    apps = _apps(g)
    got = _serve(g, "stream", apps)
    ref = _reference_graph(g)
    (pr, pr_meta), (lv, _), (wc, _) = got
    sol = rpr.solve(ref, apps[0][1])
    assert rpr.judge(pr, pr_meta["iterations"], sol)["pagerank_rel_err"] \
        <= rpr.LIMITS["pagerank_rel_err"]
    assert rbfs.judge(lv, 0, rbfs.solve(ref, apps[1][1]))["bfs_mismatch"] \
        == 0
    assert rwcc.judge(wc, 0, rwcc.solve(ref, {}))["wcc_mismatch"] == 0


@pytest.mark.parametrize("graph", GRAPHS)
def test_answers_match_the_padded_store(graphs, graph):
    """The min apps bit for bit; PageRank within 1e-6 relative: both
    layouts fold the same edges in the same order, but the plain path's
    ``scatter_reduce`` does not promise the order of its float32 adds."""
    g = graphs[graph]
    apps = _apps(g)
    padded = _serve(g, "padded", apps)
    live = _serve(g, "stream", apps)
    (pa, ma), (pb, mb) = padded[0], live[0]
    assert ma["iterations"] == mb["iterations"]
    np.testing.assert_allclose(pb, pa, rtol=1e-6, atol=0)
    for (a, a_meta), (b, b_meta) in zip(padded[1:], live[1:]):
        assert a_meta["iterations"] == b_meta["iterations"]
        assert np.array_equal(a, b)


@pytest.mark.parametrize("app", ["pagerank", "bfs", "wcc"])
def test_executor_counters_on_a_stream_store(stores, app):
    """``big_gathered`` sums the Big payloads' tables, and the padded
    count the stats report is the padded store's."""
    padded, live = stores["urand", "small"]
    kw = {"root": 1} if app == "bfs" else {}
    exs = [Executor(s, s.plan(CONFIGS["monolithic"]),
                    BUILTIN_APPS[app](**kw),
                    device="cpu") for s in (padded, live)]
    da, db = (e.dispatch_stats() for e in exs)
    assert db["big_gathered"] == sum(
        int(p["unique_src"].numel()) for lane in exs[1].lanes for p in lane
        if p["kind"] == "big") > 0
    assert da["big_gathered"] == db["big_gathered"]
    assert da["kernel_edges"] == db["kernel_edges"] == padded.num_edges
    assert db["payload_bytes"] == da["payload_bytes"]
    sa, sb = (e.stats() for e in exs)
    assert sa["num_padded_edges"] == sb["num_padded_edges"]
    out_a, _ = exs[0].run()
    out_b, _ = exs[1].run()
    np.testing.assert_allclose(out_b, out_a, rtol=1e-6, atol=0)


# -- refusals ----------------------------------------------------------------

def _refuses(fn):
    with pytest.raises(ValueError, match="stream"):
        fn()


@pytest.mark.parametrize("what", ["update", "submit_shard", "shard",
                                  "sharded_executor", "distributed",
                                  "apply_delta", "service_args"])
def test_paths_that_need_padded_blocks_refuse(graphs, stores, what):
    g = graphs["rmat_w"]
    _, live = stores["rmat_w", "small"]
    if what == "update":
        from repro_torch.streaming import make_delta
        with api.GraphService(device="cpu", default_geom=GEOMS["small"],
                              store_layout="stream") as svc:
            fp = svc.register(g)
            delta = make_delta(fp, remove=(g.src[:2], g.dst[:2]))
            _refuses(lambda: svc.update(fp, delta))
    elif what == "submit_shard":
        with api.GraphService(device="cpu", default_geom=GEOMS["small"],
                              store_layout="stream") as svc:
            _refuses(lambda: svc.submit(g, "pagerank", shard=2))
    elif what == "shard":
        _refuses(lambda: live.shard(devices=[CPU, CPU]))
    elif what == "sharded_executor":
        _refuses(lambda: live.executor(BUILTIN_APPS["pagerank"](),
                                       shard=[CPU, CPU]))
    elif what == "distributed":
        import torch.distributed as dist
        from repro_torch.core.distributed import DistributedEngine
        if not dist.is_initialized():
            store = dist.HashStore()
            dist.init_process_group("gloo", store=store, rank=0,
                                    world_size=1)
        try:
            _refuses(lambda: DistributedEngine(
                live, BUILTIN_APPS["pagerank"](), device="cpu"))
        finally:
            dist.destroy_process_group()
    elif what == "apply_delta":
        from repro_torch.streaming import apply_delta, make_delta
        delta = make_delta(live.fingerprint(),
                           remove=(g.src[:2], g.dst[:2]))
        _refuses(lambda: apply_delta(live, delta))
    else:
        for kw in ({"pool": 1}, {"regroup": True}, {"default_shard": 2}):
            _refuses(lambda: api.GraphService(
                device="cpu", store_layout="stream", **kw))
        with pytest.raises(ValueError, match="store_layout"):
            api.GraphService(device="cpu", store_layout="blocks")


def test_no_padded_slot_is_allocated(graphs, monkeypatch):
    """Build, plan, pack and serve a request from a stream store with the
    padded blocking and its container patched to raise."""
    def refuse(*a, **kw):
        raise AssertionError("a padded blocking was built")

    monkeypatch.setattr(partition, "_block_groups", refuse)
    monkeypatch.setattr(types.BlockedEdges, "__init__", refuse)
    g = graphs["kron"]
    with api.GraphService(device="cpu", default_geom=GEOMS["small"],
                          workers=1, store_layout="stream") as svc:
        fp = svc.register(g)
        for cfg in CONFIGS.values():
            out, meta = svc.submit(fingerprint=fp, app="pagerank",
                                   config=cfg).result(timeout=WAIT)
            assert meta["iterations"] >= 1 and np.isfinite(out).all()
    with pytest.raises(AssertionError, match="padded blocking"):
        GraphStore(g, geom=GEOMS["small"]).plan(CONFIGS["model"])


def test_memory_footprint_counts_the_stream(stores):
    padded, live = stores["kron", "small"]
    live.plan(CONFIGS["big"]).packed_lanes(CPU)
    fp = live.memory_footprint()
    assert fp["edge_bytes"] >= 12 * live.num_edges
    assert fp["plan_bytes"] > 0 and fp["blocking_bytes"] > 0
    assert fp["total_bytes"] == sum(v for k, v in fp.items()
                                    if k != "total_bytes")
    json.dumps(live.stats())

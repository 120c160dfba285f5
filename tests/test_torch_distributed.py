"""The port's SPMD graph path (``repro_torch.core.distributed``) and the
deprecated ``HeterogeneousEngine`` shim against the JAX reference.

``DistributedEngine`` runs under ``torch.distributed`` with gloo on the
CPU: one rank in this process, and two ranks in spawned processes that
meet through a ``FileStore`` under ``tmp_path``. Held to:

* the reference's host work, exactly: each work's chunk list
  (``_chunk_work``: tile snapping, giant-tile overflow) and every rank's
  Little and Big queue (the LPT assignment and its tie order), the
  latter read from the reference's own ``DistributedEngine`` in a
  subprocess with forced host devices, as ``tests/test_distributed.py``
  runs it;
* the single-device reference baseline,
  ``repro.core.store.GraphStore(...).executor(..., path="ref").run()``:
  PageRank within rtol 1e-5 / atol 1e-7, BFS, SSSP, WCC and closeness
  exactly, on every rank.
"""
import datetime
import json
import os
import subprocess
import sys
import textwrap
import time
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro import api as japi
from repro.core import distributed as jdist
from repro.core.engine import HeterogeneousEngine as JEngine
from repro.graphs.rmat import rmat as jrmat

from repro_torch import api as tapi, convert
from repro_torch.core import distributed as tdist
from repro_torch.core.distributed import DistributedEngine
from repro_torch.core.engine import HeterogeneousEngine, run_app
from repro_torch.graphs.rmat import rmat

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
# 16 partitions of 128 vertices; with no fixed Big gather latency the
# model plans 4 Little works and 4 Big ones (2 + 2 lanes), and tiles
# hold more blocks than a 3-block chunk, so giant tiles overflow chunks
GRAPH = (11, 8, 4)                       # rmat scale, edge factor, seed
GEOM_J = japi.Geometry(U=128, W=128, T=128, E_BLK=128, big_batch=2)
GEOM = convert.geometry_from(GEOM_J)
N_LANES = 4
CFG_J = japi.PlanConfig(n_lanes=N_LANES,
                        hw=japi.TPU_V5E.clone(gather_b=0.0))
CFG = tapi.PlanConfig(n_lanes=N_LANES,
                      hw=tapi.DEFAULT_HW.clone(gather_b=0.0))
APPS = [("pagerank", {"max_iters": 6}), ("bfs", {"root": 2}),
        ("sssp", {"root": 2}), ("wcc", {}),
        ("closeness", {"sources": np.arange(4)})]
CHUNKS = (3, 32)
TIMEOUT = 240.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run shares the CPU among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stores():
    g = jrmat(*GRAPH[:2], seed=GRAPH[2], weighted=True)
    gt = convert.graph_from_arrays(g.num_vertices, g.src, g.dst, g.weights)
    return (japi.GraphStore(g, geom=GEOM_J), tapi.GraphStore(gt, geom=GEOM))


@pytest.fixture(scope="module")
def reference_results(stores):
    store_j = stores[0]
    return {name: store_j.executor(japi.BUILTIN_APPS[name](**kw), CFG_J,
                                   path="ref").run()[0]
            for name, kw in APPS}


@pytest.fixture(scope="module")
def gloo1(tmp_path_factory):
    """A one-rank gloo group in this process, met through a FileStore."""
    path = str(tmp_path_factory.mktemp("gloo1") / "rendezvous")
    dist.init_process_group("gloo", store=dist.FileStore(path, 1), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def _check_results(got: dict, want: dict) -> None:
    for name, _ in APPS:
        assert got[name].dtype == want[name].dtype, name
        if name == "pagerank":
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                       atol=1e-7)
        else:
            assert np.array_equal(got[name], want[name]), name


def _work_keys(bundle) -> dict:
    keys = {id(w): ("little", int(pid))
            for pid, w in bundle.little_works.items()}
    keys.update({id(w): ("big", i) for i, w in enumerate(bundle.big_works)})
    return keys


def _queues(little_queues, big_queues, bundle) -> list:
    """Every rank's queues as [kind, [[kind, work, lo, hi], ...]] lists,
    little ranks first, then big (the reference's stacking order)."""
    keys = _work_keys(bundle)
    return [["little" if i < len(little_queues) else "big",
             [[*keys[id(w)], lo, hi] for w, lo, hi in q]]
            for i, q in enumerate(list(little_queues) + list(big_queues))]


# ---------------------------------------------------------------- host work
@pytest.mark.parametrize("bpc", CHUNKS)
def test_chunks_equal_reference(stores, bpc):
    store_j, store_t = stores
    bundle_j, bundle_t = store_j.plan(CFG_J), store_t.plan(CFG)
    pairs = [(bundle_t.little_works[pid], w)
             for pid, w in bundle_j.little_works.items()]
    pairs += list(zip(bundle_t.big_works, bundle_j.big_works))
    assert len(bundle_j.little_works) >= 2 and len(bundle_j.big_works) >= 2
    overflow = 0
    for wt, wj in pairs:
        got = [(lo, hi) for _, lo, hi in tdist._chunk_work(wt, bpc)]
        want = [(lo, hi) for _, lo, hi in jdist._chunk_work(wj, bpc)]
        assert got == want
        overflow += sum(hi - lo > bpc for lo, hi in got)
    if bpc == CHUNKS[0]:
        assert overflow > 0, "the fixture should overflow giant tiles"


def test_queues_equal_reference(stores):
    """Every rank's queues for 1 and 2 ranks equal the ones the
    reference's DistributedEngine stacks, read in a subprocess with two
    forced host devices."""
    code = textwrap.dedent(f"""
        import json
        import jax
        import numpy as np
        from jax.sharding import Mesh
        from repro.core import distributed as D, gas, perf_model
        from repro.core.planner import PlanConfig
        from repro.core.store import GraphStore
        from repro.core.types import Geometry
        from repro.graphs.rmat import rmat
        store = GraphStore(rmat({GRAPH[0]}, {GRAPH[1]}, seed={GRAPH[2]},
                                weighted=True),
                           geom=Geometry(U={GEOM.U}, W={GEOM.W},
                                         T={GEOM.T}, E_BLK={GEOM.E_BLK},
                                         big_batch={GEOM.big_batch}))
        cfg = PlanConfig(n_lanes={N_LANES},
                         hw=perf_model.TPU_V5E.clone(gather_b=0.0))
        bundle = store.plan(cfg)
        keys = {{id(w): ["little", int(pid)]
                for pid, w in bundle.little_works.items()}}
        keys.update({{id(w): ["big", i]
                     for i, w in enumerate(bundle.big_works)}})
        rec, orig = [], D._stack_chunks
        def spy(chunks, B, geom, umax, kind):
            rec.append([kind, [[*keys[id(w)], lo, hi]
                               for w, lo, hi in chunks]])
            return orig(chunks, B, geom, umax, kind)
        D._stack_chunks = spy
        out = {{}}
        for n in (1, 2):
            for bpc in {list(CHUNKS)}:
                rec.clear()
                mesh = Mesh(np.array(jax.devices()[:n]), ("pipe",))
                D.DistributedEngine(store, gas.make_pagerank(), config=cfg,
                                    mesh=mesh, blocks_per_chunk=bpc)
                out[f"{{n}}/{{bpc}}"] = list(rec)
        print(json.dumps(out))
    """)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    bundle_t = stores[1].plan(CFG)
    for n in (1, 2):
        for bpc in CHUNKS:
            lq, bq = tdist.chunk_queues(bundle_t, n, bpc)
            assert _queues(lq, bq, bundle_t) == want[f"{n}/{bpc}"], (n, bpc)
            if n == 2 and bpc == CHUNKS[0]:
                assert all(lq) and all(bq)        # both ranks get work


def test_packed_chunks_validate(stores):
    """Each rank's chunks pack into payloads the packer validates, whose
    tiles are disjoint across ranks and cover every chunk's blocks."""
    bundle = stores[1].plan(CFG)
    lq, bq = tdist.chunk_queues(bundle, 2, CHUNKS[0])
    idx, blocks = [], 0
    for q in lq + bq:
        p = tdist.pack_chunks(q)
        assert p is not None and p["n_entries"] == len(q)
        assert p["n_blocks"] == sum(hi - lo for _, lo, hi in q)
        idx.append(p["tile_idx"])
        blocks += p["n_blocks"]
        if p["kind"] == "big":     # each work's table packed once
            works = {id(w): w for w, _, _ in q}
            assert p["unique_src"].shape[0] == sum(
                w.unique_src.shape[0] for w in works.values())
    idx = np.concatenate(idx)
    assert np.unique(idx).shape[0] == idx.shape[0]
    assert blocks == (sum(w.n_blocks for w in bundle.little_works.values())
                      + sum(w.n_blocks for w in bundle.big_works))
    assert tdist.pack_chunks([]) is None


# ---------------------------------------------------------------- results
def test_raises_without_process_group(stores, monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="init_process_group"):
        DistributedEngine(stores[1], tapi.make_bfs(), device="cpu")


@pytest.mark.parametrize("bpc", CHUNKS)
def test_one_rank_matches_reference(stores, reference_results, gloo1, bpc,
                                    monkeypatch):
    store_t = stores[1]
    got = {}
    for name, kw in APPS:
        eng = DistributedEngine(store_t, tapi.BUILTIN_APPS[name](**kw),
                                config=CFG, device="cpu",
                                blocks_per_chunk=bpc)
        got[name], meta = eng.run()
        assert meta["iterations"] >= 1
    _check_results(got, reference_results)
    st = eng.stats()
    assert st["world_size"] == 1 and st["rank"] == 0
    assert st["payloads"] == st["launches_per_iteration"] == 2
    assert st["chunks_total"] == st["little_chunks"] + st["big_chunks"]
    assert st["packed_bytes"] > 0 and eng.time_iteration(repeats=1) > 0
    # one all_reduce per iteration
    calls = []
    real = dist.all_reduce
    monkeypatch.setattr(dist, "all_reduce",
                        lambda t, **kw: calls.append(kw) or real(t, **kw))
    _, meta = DistributedEngine(store_t, tapi.make_bfs(root=2), config=CFG,
                                device="cpu").run()
    assert len(calls) == meta["iterations"]
    assert calls[0]["op"] == dist.ReduceOp.MIN
    assert store_t.has_plan(CFG)


def _rank_main(rank: int, world: int, rendezvous: str, out_dir: str,
               bpc: int) -> None:
    """One rank of the two-rank run: every app through DistributedEngine,
    results saved for the parent."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(rendezvous, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        store = tapi.GraphStore(rmat(*GRAPH[:2], seed=GRAPH[2],
                                     weighted=True), geom=GEOM)
        out = {}
        for name, kw in APPS:
            eng = DistributedEngine(store, tapi.BUILTIN_APPS[name](**kw),
                                    config=CFG, device="cpu",
                                    blocks_per_chunk=bpc)
            out[name] = eng.run()[0]
        out["blocks"] = np.asarray(eng.stats()["blocks"])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def test_two_ranks_match_reference(reference_results, tmp_path):
    ctx = mp.start_processes(_rank_main,
                             args=(2, str(tmp_path / "rendezvous"),
                                   str(tmp_path), CHUNKS[0]),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            assert time.monotonic() < deadline, "two-rank run timed out"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)
    assert not any(p.is_alive() for p in ctx.processes)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in (0, 1)]
    for got in ranks:
        _check_results(got, reference_results)
    for name, _ in APPS:
        assert np.array_equal(ranks[0][name], ranks[1][name]), name
    blocks = ranks[0]["blocks"]
    assert blocks.shape == (2,) and (blocks > 0).all()


# ---------------------------------------------------------------- the shim
def test_engine_shim(stores, reference_results):
    store_j, store_t = stores
    g = store_t.graph
    with pytest.warns(DeprecationWarning, match="deprecated"):
        eng = HeterogeneousEngine(None, tapi.make_bfs(root=2),
                                  n_lanes=N_LANES, hw=CFG.hw,
                                  store=store_t, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        eng_j = JEngine(None, japi.make_bfs(root=2), n_lanes=N_LANES,
                        hw=CFG_J.hw, store=store_j, path="ref")
        assert np.array_equal(eng.run()[0], eng_j.run()[0])
        assert eng.path == "ref" and eng.device == torch.device("cpu")
        assert eng.graph is store_t.graph and eng.geom == GEOM
        assert np.array_equal(eng.perm, eng_j.perm)
        assert eng.edges is store_t.edges and eng.V_pad == eng_j.V_pad
        assert eng.t_dbg >= 0 and eng.t_schedule >= 0
        assert [i.pid for i in eng.infos] == [i.pid for i in eng_j.infos]
        assert list(eng.little_works) == list(eng_j.little_works)
        assert len(eng.big_works) == len(eng_j.big_works)
        assert eng.big_ests == pytest.approx(eng_j.big_ests)
        assert len(eng.plan.lanes) == len(eng_j.plan.lanes) == N_LANES
        assert len(eng.lane_entries) == N_LANES
        assert eng.accum_dtype == torch.float32 and "outdeg" in eng.aux
        assert eng.init_props().shape == (eng.V_pad,)
        assert eng.time_iteration(repeats=1) > 0
        assert len(eng.time_lanes(repeats=1)) == N_LANES
        assert eng.stats()["device"] == "cpu"
        for mode, want in [("monolithic", ("monolithic", 0, 0, N_LANES)),
                           (("fixed", 1, 2), ("fixed", 1, 2, 3))]:
            e = HeterogeneousEngine(None, tapi.make_bfs(root=2),
                                    n_lanes=N_LANES, plan_mode=mode,
                                    store=store_t, device="cpu")
            c = e.config
            assert (c.mode, c.forced_little, c.forced_big,
                    c.n_lanes) == want
        with pytest.raises(ValueError, match="legacy plan_mode"):
            HeterogeneousEngine(None, tapi.make_bfs(), plan_mode="x",
                                store=store_t, device="cpu")
        with pytest.raises(ValueError, match="needs a graph"):
            HeterogeneousEngine(None, tapi.make_bfs(), device="cpu")
        props, meta = run_app(g, tapi.make_pagerank(max_iters=6),
                              geom=GEOM, n_lanes=N_LANES, device="cpu",
                              use_dbg=False)
        want = JEngine(store_j.graph, japi.make_pagerank(max_iters=6),
                       geom=GEOM_J, n_lanes=N_LANES, path="ref",
                       use_dbg=False).run()[0]
        np.testing.assert_allclose(props, want, rtol=1e-5, atol=1e-7)


def test_engine_shim_raises_without_cuda(stores, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HeterogeneousEngine(None, tapi.make_bfs(), store=stores[1])
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedEngine(stores[1], tapi.make_bfs())

"""Host-side parity of the PyTorch port with the JAX reference package:
graphs, fingerprints, DBG, partitions, blockings, plans and packed
payloads must be exactly equal, array by array."""
import dataclasses

import numpy as np
import pytest

from repro.core import partition as jpart
from repro.core.planner import PlanConfig as JPlanConfig
from repro.core.store import GraphStore as JStore
from repro.graphs import datasets as jdatasets
from repro.graphs import formats as jformats
from repro.graphs.rmat import rmat as jrmat
from repro.kernels import ops as jops

from repro_torch import convert
from repro_torch.core import partition as tpart
from repro_torch.core.planner import PlanConfig as TPlanConfig
from repro_torch.core.store import GraphStore as TStore
from repro_torch.graphs import datasets as tdatasets
from repro_torch.graphs import formats as tformats
from repro_torch.graphs.rmat import rmat as trmat
from repro_torch.kernels import ops as tops



def _same_graph(a, b):
    assert a.num_vertices == b.num_vertices
    assert np.array_equal(a.src, b.src) and np.array_equal(a.dst, b.dst)
    assert (a.weights is None) == (b.weights is None)
    if a.weights is not None:
        assert np.array_equal(a.weights, b.weights)
    assert a.fingerprint() == b.fingerprint()


def _pair(graph_j, geom_j):
    """The same graph and geometry in both packages."""
    graph_t = convert.graph_from_arrays(graph_j.num_vertices, graph_j.src,
                                        graph_j.dst, graph_j.weights)
    return graph_t, convert.geometry_from(geom_j)


@pytest.mark.parametrize("scale,ef,seed,weighted", [
    (8, 6, 1, False), (10, 8, 3, False), (9, 4, 5, True)])
def test_rmat_and_fingerprint_equal(scale, ef, seed, weighted):
    gj = jrmat(scale, ef, seed=seed, weighted=weighted)
    gt = trmat(scale, ef, seed=seed, weighted=weighted)
    _same_graph(gj, gt)
    assert tformats.fingerprint(gt) == jformats.fingerprint(gj)
    # the converted graph keeps the identity too
    _same_graph(gj, convert.graph_from_arrays(gj.num_vertices, gj.src,
                                              gj.dst, gj.weights))


@pytest.mark.parametrize("name", ["ggs", "g17s", "tcs", "hws", "unif16"])
def test_dataset_edges_equal(name):
    assert tdatasets.names() == jdatasets.names()
    _same_graph(jdatasets.load(name), tdatasets.load(name))


def test_dbg_and_partitions_equal(small_graph, small_geom):
    gt, geom_t = _pair(small_graph, small_geom)
    assert np.array_equal(jpart.dbg_permutation(small_graph),
                          tpart.dbg_permutation(gt))
    gj_dbg, perm_j = jpart.apply_dbg(small_graph)
    gt_dbg, perm_t = tpart.apply_dbg(gt)
    assert np.array_equal(perm_j, perm_t)
    _same_graph(gj_dbg, gt_dbg)
    infos_j, edges_j = jpart.partition_graph(gj_dbg, small_geom)
    infos_t, edges_t = tpart.partition_graph(gt_dbg, geom_t)
    assert [dataclasses.asdict(i) for i in infos_j] == \
        [dataclasses.asdict(i) for i in infos_t]
    for k in ("src", "dst", "weights"):
        assert np.array_equal(edges_j[k], edges_t[k])


def _same_blocked(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "geom":
            assert dataclasses.asdict(va) == dataclasses.asdict(vb)
        elif isinstance(va, np.ndarray) or va is None:
            assert (va is None) == (vb is None), f.name
            if va is not None:
                assert va.dtype == vb.dtype and np.array_equal(va, vb), f.name
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("graph_name", ["tiny_graph", "small_graph"])
def test_blockings_equal(graph_name, request, tiny_geom):
    graph = request.getfixturevalue(graph_name)
    gt, geom_t = _pair(graph, tiny_geom)
    infos_j, edges_j = jpart.partition_graph(graph, tiny_geom)
    infos_t, edges_t = tpart.partition_graph(gt, geom_t)
    nonempty = [k for k, i in enumerate(infos_j) if i.num_edges > 0]
    for k in nonempty:
        _same_blocked(jpart.block_little(edges_j, infos_j[k], tiny_geom),
                      tpart.block_little(edges_t, infos_t[k], geom_t))
    for lo in range(0, len(nonempty), 2):
        batch = nonempty[lo:lo + 2]
        _same_blocked(
            jpart.block_big(edges_j, [infos_j[k] for k in batch], tiny_geom),
            tpart.block_big(edges_t, [infos_t[k] for k in batch], geom_t))


def _plans(graph, geom, **cfg):
    gt, geom_t = _pair(graph, geom)
    bj = JStore(graph, geom=geom).plan(JPlanConfig(**cfg))
    bt = TStore(gt, geom=geom_t).plan(TPlanConfig(**cfg))
    return bj, bt


@pytest.mark.parametrize("cfg", [
    dict(n_lanes=4), dict(n_lanes=8), dict(mode="monolithic", n_lanes=4),
    dict(mode="fixed", forced_little=1, forced_big=3, n_lanes=4)])
def test_schedule_plans_equal(cfg, small_graph, small_geom):
    bj, bt = _plans(small_graph, small_geom, **cfg)
    pj, pt = bj.plan, bt.plan
    assert (pj.num_little_lanes, pj.num_big_lanes) == \
        (pt.num_little_lanes, pt.num_big_lanes)
    assert pj.dense_pids == pt.dense_pids
    assert pj.sparse_pids == pt.sparse_pids
    assert pj.est_makespan == pt.est_makespan
    assert [[dataclasses.asdict(e) for e in lane] for lane in pj.lanes] == \
        [[dataclasses.asdict(e) for e in lane] for lane in pt.lanes]
    assert [dataclasses.asdict(i) for i in bj.infos] == \
        [dataclasses.asdict(i) for i in bt.infos]


def _check_tile_block_start(p):
    """tile k's blocks are exactly [start[k], start[k+1]), and the
    starts are where tile_first is set."""
    tbs, tid, tf = p["tile_block_start"], p["tile_id"], p["tile_first"]
    assert tbs.dtype == np.int32 and tbs.shape == (p["n_out_tiles"] + 1,)
    assert tbs[0] == 0 and tbs[-1] == p["n_blocks"]
    for k in range(p["n_out_tiles"]):
        assert np.all(tid[tbs[k]:tbs[k + 1]] == k)
    assert np.array_equal(np.flatnonzero(tf == 1), tbs[:-1])


def _same_payload(pj, pt):
    # port-only key: the tile index (the upload derives the kernel's
    # live-edge stream, tests/test_torch_edge_stream.py)
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
    _check_tile_block_start(pt)


@pytest.mark.parametrize("cfg", [dict(n_lanes=2), dict(n_lanes=4),
                                 dict(mode="monolithic", n_lanes=3)])
def test_packed_payloads_equal(cfg, small_graph, small_geom):
    bj, bt = _plans(small_graph, small_geom, **cfg)
    n_payloads = 0
    for lane_j, lane_t in zip(bj.plan.lanes, bt.plan.lanes):
        packed_j = jops._pack_lane_np(lane_j, bj.little_works, bj.big_works)
        packed_t = tops._pack_lane_np(lane_t, bt.little_works, bt.big_works)
        assert len(packed_j) == len(packed_t)
        for pj, pt in zip(packed_j, packed_t):
            _same_payload(pj, pt)
            n_payloads += 1
        for e_j, e_t in zip(lane_j, lane_t):
            wj = (bj.little_works[e_j.work_id] if e_j.kind == "little"
                  else bj.big_works[e_j.work_id])
            wt = (bt.little_works[e_t.work_id] if e_t.kind == "little"
                  else bt.big_works[e_t.work_id])
            ej = jops._entry_np(wj, e_j.block_lo, e_j.block_hi)
            et = tops._entry_np(wt, e_t.block_lo, e_t.block_hi)
            assert (ej is None) == (et is None)
            if ej is not None:
                _same_payload(ej, et)
    assert n_payloads > 0


def test_payload_from_numpy_matches_port_upload(small_graph, small_geom):
    """A reference host payload carried across equals the port's own
    upload of the same payload, tensor by tensor."""
    bj, bt = _plans(small_graph, small_geom, n_lanes=4)
    pj, pt = next(
        (pj[0], pt[0]) for pj, pt in (
            (jops._pack_lane_np(lj, bj.little_works, bj.big_works),
             tops._pack_lane_np(lt, bt.little_works, bt.big_works))
            for lj, lt in zip(bj.plan.lanes, bt.plan.lanes)) if pj)
    carried = convert.payload_from_numpy(pj, "cpu")
    own = tops._upload_payload(pt, "cpu")
    assert set(carried) == set(own)
    for k in tops._DEVICE_KEYS:
        if own.get(k) is None:
            assert carried.get(k) is None
            continue
        assert carried[k].dtype == own[k].dtype
        assert np.array_equal(carried[k].numpy(), own[k].numpy()), k
    assert tops.payload_nbytes(carried) == tops.payload_nbytes(own)
    assert tops.payload_footprint(carried) == tops.payload_footprint(own)
    # the reference's byte classes, from the host arrays
    fp = tops.payload_footprint(own)
    assert fp["edge_bytes"] == sum(pt[k].nbytes for k in (
        "src_local", "dst_local", "weights", "valid"))
    assert fp["index_bytes"] == sum(pt[k].nbytes for k in (
        "window_id", "tile_id", "tile_first", "tile_idx"))

"""The port's utilization profiler against the JAX reference.

Per-lane footprints equal the reference's field by field, except the
port's own ``stream_bytes`` and ``total_bytes``: the card holds a
payload's live-edge stream (12 B a real edge, and two ``n_out_tiles +
1`` int32 indices) and no padded block, so ``total_bytes`` counts the
stream where the reference counts its padded edge slabs and routing
metadata, and the reference's traffic model ``hbm_bytes`` does not count
the stream. ``tensor_lane_bytes`` (the count over the tensors a lane's
launches take) stays within 10 % of the analytic ``total_bytes``.
Utilization samples count what a lane must move on the card
(``lane_traffic``), not the reference's TPU traffic model.
``UtilizationAccumulator`` gives the reference's results on the inputs
of ``tests/test_profile.py``. On the CPU no peak is known: utilization
is None.
"""
import dataclasses

import pytest
import torch

from repro import api as japi
from repro.graphs.rmat import rmat as jrmat
from repro.obs.profile import UtilizationAccumulator as JAcc

from repro_torch import api as tapi, convert, obs
from repro_torch.core import perf_model
from repro_torch.core.executor import Executor
from repro_torch.kernels import ops
from repro_torch.obs.profile import UtilizationAccumulator

GEOM_J = japi.Geometry(U=512, W=512, T=512, E_BLK=128, big_batch=2)
GEOM = convert.geometry_from(GEOM_J)
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run shares the CPU among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def executors():
    g = jrmat(8, 6, seed=1, weighted=True)
    gt = convert.graph_from_arrays(g.num_vertices, g.src, g.dst, g.weights)
    ej = japi.compile(g, "pagerank", geom=GEOM_J, n_lanes=2,
                      path="ref").executor
    et = tapi.compile(gt, "pagerank", geom=GEOM, n_lanes=2,
                      device="cpu").executor
    return ej, et


# -- footprints ---------------------------------------------------------

def test_lane_footprints_equal_reference(executors):
    ej, et = executors
    fj, ft = ej.footprints(), et.footprints()
    assert len(fj) == len(ft) and any(f is not None for f in ft)
    for lane, a, b in zip(et.lanes, fj, ft):
        assert (a is None) == (b is None)
        if a is None:
            continue
        # the live-edge stream: src, dst, weight a real edge, and the
        # tile edge and chunk indices
        stream = sum(12 * p["num_real_edges"] + 8 * (p["n_out_tiles"] + 1)
                     for p in lane)
        da, db = a.as_dict(), b.as_dict()
        assert db.pop("stream_bytes") == stream == sum(
            p[k].numel() * p[k].element_size() for p in lane
            for k in ("edge_src", "edge_dst", "edge_w", "tile_edge_start",
                      "tile_chunk_start"))
        # the card holds the stream in place of the padded slabs and
        # routing metadata; index_bytes, hbm_bytes and intensity are the
        # reference's exactly
        assert db.pop("total_bytes") == da.pop("total_bytes") \
            - a.edge_bytes - a.index_bytes + stream
        assert da == db


def test_tensor_lane_bytes_within_ten_percent(executors):
    _, et = executors
    checked = 0
    for i, fp in enumerate(et.footprints()):
        counted = obs.tensor_lane_bytes(et, i)
        assert (fp is None) == (counted is None)
        if fp is not None:
            assert fp.total_bytes == pytest.approx(counted, rel=0.10)
            checked += 1
    assert checked > 0
    assert obs.tensor_lane_bytes(et, len(et.lanes)) is None


def test_time_lanes_feeds_utilization_without_a_peak_on_cpu(executors):
    _, et = executors
    assert et.utilization()["kinds"] == {}
    lane_s = et.time_lanes(repeats=1)
    util = et.stats()["utilization"]
    assert util["peak_bandwidth_gbps"] is None
    assert util["kinds"], "time_lanes must record samples"
    for rep in util["kinds"].values():
        assert rep["gbps"] > 0 and rep["n"] > 0
        assert rep["utilization"] is None
    busy = [i for i, fp in enumerate(et.footprints()) if fp is not None]
    assert sorted(util["lanes"]) == busy
    for i in busy:
        (nbytes, n_ops), sample = et.lane_traffic()[i], util["lanes"][i]
        assert sample["kind"] == et.footprints()[i].kind
        assert sample["bytes"] == nbytes and sample["flops"] == n_ops
        assert sample["gbps"] == pytest.approx(nbytes / lane_s[i] / 1e9)
    assert [f["lane"] for f in util["footprints"] if f] == busy


def test_util_parent_receives_the_samples(executors):
    _, et = executors
    parent = UtilizationAccumulator()
    child = Executor(et.store, et.bundle, tapi.make_pagerank(max_iters=2),
                     device="cpu", util_parent=parent)
    child.time_lanes(repeats=1)
    assert child.util.report()["kinds"]
    assert parent.report()["kinds"] == child.util.report()["kinds"]


@pytest.mark.parametrize("app", ["pagerank", "sssp"])
def test_lane_traffic_counts_what_the_launches_read(executors, app):
    """The bytes a lane must move, counted from the padded blocks of
    each host payload: src/dst (+ weight) per real edge, the tile edge and
    chunk indices, each distinct source once, the output tiles, and the
    Big gather's table, values and window; no padded slot and no
    ``valid``."""
    import numpy as np
    _, et = executors
    ex = Executor(et.store, et.bundle, getattr(tapi, f"make_{app}")(),
                  device="cpu")
    per_edge = 12 if ex.app.scatter_op == "add_weight" else 8
    per_op = 2 if ex.app.scatter_op == "add_weight" else 1
    geom, checked = ex.geom, 0
    bundle = ex.bundle
    hosts = ops.pack_lanes_host(bundle.plan, bundle.little_works,
                                bundle.big_works, {},
                                bundle.config.hw.vmem_lane_budget)
    for lane, host, traffic, fp in zip(ex.lanes, hosts, ex.lane_traffic(),
                                       ex.footprints()):
        assert (traffic is None) == (fp is None) == (not lane)
        assert len(host) == len(lane)
        if not lane:
            continue
        want_bytes = want_ops = 0
        for p, h in zip(lane, host):
            valid = h["valid"] != 0
            src = (h["window_id"].astype(np.int64)[:, None]
                   * geom.W + h["src_local"])[valid]
            real = int(valid.sum())
            assert real == p["num_real_edges"]
            want_bytes += (real * per_edge
                           + 2 * 4 * (p["n_out_tiles"] + 1)
                           + np.unique(src).size * 4
                           + p["n_out_tiles"] * geom.T * 4)
            if p["kind"] == "big":
                want_bytes += 12 * p["unique_src"].numel()
            want_ops += real * per_op
        assert traffic == (want_bytes, want_ops)
        # the reference's model streams every padded slot and weight
        assert traffic[0] < fp.hbm_bytes
        checked += 1
    assert checked > 0


def test_peak_is_the_cards_data_sheet_rate(monkeypatch):
    """The %-of-peak denominator: an explicit HW peak, else the card's
    data-sheet rate by name, else none; never on the CPU, and never the
    model's planning constant."""
    hw = perf_model.DEFAULT_HW
    assert perf_model.peak_bandwidth_bps(hw, "cpu") == 0.0
    assert perf_model.peak_bandwidth_bps(
        hw.clone(peak_bandwidth_gbps=2000.0), "cpu") == 0.0
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: H100)
    assert perf_model.peak_bandwidth_bps(hw, "cuda:0") == 3350e9
    assert perf_model.peak_bandwidth_bps(
        hw.clone(peak_bandwidth_gbps=2000.0), "cuda:0") == 2000e9
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "some other card")
    assert perf_model.peak_bandwidth_bps(hw, "cuda:0") == 0.0
    assert perf_model.DATASHEET_HBM_GBPS == {H100: 3350.0}


# -- UtilizationAccumulator (the reference's inputs) --------------------

def _feed(acc):
    acc.add("little", nbytes=2e9, flops=4e9, measured_s=1.0, peak_bps=4e9,
            lane=0)
    acc.add("big", 1e9, 1e9, 0.5)
    acc.add("big", 8e9, 8e9, 2.0, peak_bps=4e9, lane=1)
    acc.add("little", 1e9, 1e9, 0.0, lane=2)


def test_accumulator_reports_equal_reference():
    a, b = JAcc(), UtilizationAccumulator()
    _feed(a)
    _feed(b)
    assert b.report() == a.report()
    assert b.report()["kinds"]["little"]["utilization"] == \
        pytest.approx(3.0 / 4)
    a, b = JAcc(), UtilizationAccumulator()
    a.add("big", 1e9, 1e9, 0.5)
    b.add("big", 1e9, 1e9, 0.5)
    assert b.report() == a.report()
    assert b.report()["kinds"]["big"]["utilization"] is None
    assert b.report()["peak_bandwidth_gbps"] is None


def test_accumulator_chaining_retention_and_clear():
    parent = UtilizationAccumulator()
    child = UtilizationAccumulator(parent=parent)
    child.add("little", 1e9, 1e9, 1.0, peak_bps=2e9, lane=3)
    assert parent.report()["lanes"][3]["gbps"] == pytest.approx(1.0)
    with pytest.raises(ValueError):
        parent.set_parent(parent)
    acc, ref = UtilizationAccumulator(), JAcc()
    for lane in range(UtilizationAccumulator._MAX_LANES + 10):
        acc.add("little", 1.0, 1.0, 1.0, lane=lane)
        ref.add("little", 1.0, 1.0, 1.0, lane=lane)
    assert acc.report() == ref.report()
    assert len(acc.report()["lanes"]) == UtilizationAccumulator._MAX_LANES
    acc.clear()
    assert acc.report()["kinds"] == {} and acc.report()["lanes"] == {}


def test_footprint_dataclass_matches_reference_fields():
    """The reference's fields, in order, and the port's ``stream_bytes``
    after ``index_bytes``."""
    from repro.obs.profile import LaneFootprint as JFootprint
    want = [f.name for f in dataclasses.fields(JFootprint)]
    want.insert(want.index("index_bytes") + 1, "stream_bytes")
    assert [f.name for f in dataclasses.fields(obs.LaneFootprint)] == want

"""The graph500_24 configuration, the ldbc mix and the two readers they
brought (``big_gather_roofline``, ``card_bytes_per_edge``), on the CPU."""
import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from gbench import gen, harness, newest, roofline  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


def _reader(name):
    return harness.load_reader(name, ROOT)


def test_config_and_mix_load_by_name():
    bench = harness.load_bench(ROOT)
    cell = harness.find_cell(bench, "graph500_24.ldbc")
    assert cell["chips"] == 1 and cell["traffic"] == "ldbc"
    cfg = harness.load_config(bench, cell["config"], ROOT)
    assert (cfg["generator"], cfg["scale"], cfg["edge_factor"]) == \
        ("kron", 24, 16)
    assert (cfg["A"], cfg["B"], cfg["C"]) == (0.57, 0.19, 0.19)
    assert cfg["weights"] == [1, 1] and cfg["reduced"] == {}
    assert cfg["service"] == {"workers": 2, "store_layout": "stream"}
    kron = harness.load_config(bench, "kron20", ROOT)
    assert cfg["geometry"] == kron["geometry"]
    assert cfg["plan"] == kron["plan"]
    entry = next(c for c in bench["configs"] if c["name"] == "graph500_24")
    others = [c for c in bench["configs"] if c["name"] != "graph500_24"]
    assert entry["reduced"] == [] and all(
        (c["source"], c["reduced"]) != (entry["source"], entry["reduced"])
        for c in others)
    mix = harness.load_traffic("ldbc", ROOT)
    assert [c["app"] for c in mix["clients"]] == ["pagerank", "bfs", "wcc"]
    assert mix["updater"] is None and "driver" not in mix
    per_layer = {m["name"] for m in harness.cell_metrics(
        bench, "graph500_24.ldbc", "per_layer")}
    assert {"big_gather_roofline", "card_bytes_per_edge", "big_gather_ms",
            "prep_store_s"} <= per_layer
    assert not per_layer & {"delta_splice_ms", "delta_replan_ms"}
    e2e = {m["name"] for m in harness.cell_metrics(
        bench, "graph500_24.ldbc", "end_to_end")}
    assert e2e == {"requests_per_s", "setup_s"}


def test_graph_is_unweighted_and_symmetric():
    bench = harness.load_bench(ROOT)
    cfg = dict(harness.load_config(bench, "graph500_24", ROOT), scale=10)
    g = gen.make_graph(cfg, 2_900_000_007, "cpu", ROOT)
    n = g.num_vertices
    assert n == 1 << 10
    assert torch.equal(g.weights, torch.ones_like(g.weights))
    rev = torch.sort(g.dst * n + g.src).values
    assert torch.equal(rev, g.keys)          # both directions, once each
    assert bool((g.src != g.dst).all())
    # isolated ids are kept: the vertex count is 2**scale
    assert int(torch.bincount(g.src, minlength=n).eq(0).sum()) > 0


def test_readers_without_a_trace():
    ctx = types.SimpleNamespace(extra={}, device_kind="cpu", trace=None)
    assert _reader("big_gather_roofline").read(ctx) is None
    assert _reader("card_bytes_per_edge").read(ctx) is None
    ctx.extra = {"big_gather_roofline": 1000, "big_gather_ms": None}
    assert _reader("big_gather_roofline").read(ctx) is None


def test_readers_on_a_hand_made_ctx():
    # 1,000,000 sources gathered in 0.01 ms at 3.35 TB/s
    ctx = types.SimpleNamespace(
        extra={"big_gather_roofline": 1_000_000, "big_gather_ms": 0.01,
               "card_bytes_per_edge": 12.5},
        device_kind=H100, trace=None)
    want = 100.0 * 12 * 1_000_000 / 3.35e12 / 1e-5
    assert _reader("big_gather_roofline").read(ctx) == pytest.approx(want)
    assert roofline.hbm_bytes_per_s(H100) == 3.35e12
    assert _reader("card_bytes_per_edge").read(ctx) == 12.5
    ctx.device_kind = "cpu"                  # no known rate
    assert _reader("big_gather_roofline").read(ctx) is None


def _live(executor_stats, store_stats):
    """A finished window's ``live`` with one executor on the newest
    snapshot's plan, as the harness hands it to ``after_window``."""
    config = types.SimpleNamespace(cache_key=lambda: ("cfg",))
    svc = types.SimpleNamespace(default_geom="g", default_use_dbg=True)
    skey = ("fp", "g", True)
    ex = types.SimpleNamespace(dispatch_stats=lambda: dict(executor_stats))
    store = types.SimpleNamespace(stats=lambda: dict(store_stats))
    svc._executors = {(skey, "app", ("cfg",), None, None): (ex, 0),
                      (("old", "g", True), "app", ("cfg",), None, None):
                          (None, 0)}
    svc.cache = types.SimpleNamespace(
        peek=lambda key: store if key == skey else None)
    return types.SimpleNamespace(svc=svc, fp="fp", config=config,
                                 device=torch.device("cpu"))


def test_after_window_reads_the_newest_plan():
    live = _live({"big_gathered": 4096, "payload_bytes": 1200,
                  "kernel_edges": 100},
                 {"device_bytes": 50, "layout": "stream"})
    assert _reader("big_gather_roofline").after_window(live) == 4096
    assert _reader("card_bytes_per_edge").after_window(live) == 12.5


def test_after_window_finds_nothing_in_a_program_without_the_counters():
    """A program whose executor has no ``big_gathered`` and whose store
    does not count its device bytes (the parent of these readers) gives
    nothing to read, and nothing raises."""
    live = _live({"payload_bytes": 1200, "kernel_edges": 100}, {})
    assert _reader("big_gather_roofline").after_window(live) is None
    assert _reader("card_bytes_per_edge").after_window(live) is None
    live.fp = "gone"
    assert _reader("big_gather_roofline").after_window(live) is None
    assert _reader("card_bytes_per_edge").after_window(live) is None


@pytest.mark.parametrize("served", [True, False],
                         ids=["after_a_request", "plan_without_a_request"])
def test_readers_on_a_served_stream_store(served):
    """On a real service of the stream layout: the readers' numbers from
    the executor a request left, or, where no request ran on the newest
    plan (an update can land after the last one), from one made on the
    plan's payloads."""
    from repro_torch.core.planner import PlanConfig
    from repro_torch.core.types import Geometry
    from repro_torch.graphs.rmat import rmat
    from repro_torch.serve_graph import GraphService

    g = rmat(10, 8, seed=3)
    config = PlanConfig(mode="monolithic", n_lanes=2)
    with GraphService(device="cpu", workers=1, store_layout="stream",
                      default_geom=Geometry(U=128, W=128, T=128,
                                            E_BLK=128)) as svc:
        fp = svc.register(g)
        if served:
            svc.submit(fingerprint=fp, app="pagerank",
                       config=config).result(timeout=300)
        else:
            svc.cache.peek((fp, svc.default_geom, True)).plan(config)
        assert bool(svc._executors) == served
        live = types.SimpleNamespace(svc=svc, fp=fp, config=config,
                                     device=svc.device)
        gathered = _reader("big_gather_roofline").after_window(live)
        per_edge = _reader("card_bytes_per_edge").after_window(live)
        ex = newest.executor(live)
        d = ex.dispatch_stats()
    assert gathered == d["big_gathered"] > 0
    assert per_edge == pytest.approx(d["payload_bytes"] / g.num_edges)
    assert 12 < per_edge < 16

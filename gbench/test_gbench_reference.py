"""The plain reference held against the port on the CPU at a tiny size
(the port's plain path): all four apps, and a chain of deltas applied by
the port's ``streaming.apply_delta`` and by the reference's own
``apply_delta``."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from gbench import gen, harness, reference  # noqa: E402
from gbench.reference import edges as redges  # noqa: E402

CFG = {"name": "t", "generator": "kron", "scale": 9, "edge_factor": 8,
       "A": 0.57, "B": 0.19, "C": 0.19, "weights": [1, 255]}
SEED = 2 ** 31 + 17


def _port():
    from repro_torch.core.store import GraphStore
    from repro_torch.core.types import Geometry
    edges = gen.make_graph(CFG, SEED, "cpu")
    graph, raw = harness._program_graph(edges, "t")
    geom = Geometry(U=128, W=128, T=128, E_BLK=128, big_batch=2)
    return edges, GraphStore(graph, geom=geom), raw


def _run(store, app, kwargs):
    from repro_torch import api
    from repro_torch.core.gas import BUILTIN_APPS
    return api.compile(None, BUILTIN_APPS[app](**kwargs), store=store,
                       device="cpu", path="ref", n_lanes=4).run()


ARGS = {"pagerank": {"damping": 0.85, "max_iters": 16}, "wcc": {},
        "bfs": {"root": 5}, "sssp": {"root": 5}}


@pytest.mark.parametrize("app", sorted(ARGS))
def test_reference_matches_port(app):
    edges, store, raw = _port()
    kwargs = dict(ARGS[app])
    if "root" in kwargs:
        kwargs["root"] = int(gen.root_candidates(edges)[7])
    props, meta = _run(store, app, kwargs)
    mod = reference.load(app)
    sol = mod.solve(redges.Edges.from_numpy(*raw, device="cpu"), kwargs)
    numbers = mod.judge(props, meta["iterations"], sol)
    for name, value in numbers.items():
        assert value <= (1e-5 if name == "pagerank_rel_err" else 0), numbers
    if app in ("bfs", "sssp"):
        assert np.array_equal(props, mod.answer(sol))
        assert (props < 1e38).sum() > 1


def test_delta_chain_matches_port():
    from repro_torch.streaming import apply_delta, make_delta
    edges, store, raw = _port()
    g = gen.generator(SEED, 1, "cpu")
    ref = redges.Edges.from_numpy(*raw, device="cpu")
    fp = store.fingerprint()
    for _ in range(3):
        d = gen.skewed_churn(edges, 0.01, 0.05, CFG["weights"], g)
        assert d.add_src.numel() and d.rm_src.numel()
        host = [t.to(torch.int32).numpy() for t in (
            d.add_src, d.add_dst, d.rm_src, d.rm_dst)]
        res = apply_delta(store, make_delta(
            fp, add=(host[0], host[1], d.add_w.float().numpy()),
            remove=(host[2], host[3])))
        store, fp = res.store, res.fingerprint
        edges = gen.apply(edges, d)
        ref = redges.apply_delta(ref, d.add_src, d.add_dst, d.add_w,
                                 d.rm_src, d.rm_dst)
    n = ref.num_vertices
    assert torch.equal(torch.sort(ref.src * n + ref.dst).values, edges.keys)
    root = int(gen.root_candidates(edges)[3])
    for app, kwargs in (("pagerank", ARGS["pagerank"]),
                        ("bfs", {"root": root})):
        props, meta = _run(store, app, kwargs)
        mod = reference.load(app)
        numbers = mod.judge(props, meta["iterations"],
                            mod.solve(ref, kwargs))
        for name, value in numbers.items():
            assert value <= (1e-5 if name == "pagerank_rel_err" else 0)


def test_generated_graph_is_symmetric_and_simple():
    edges = gen.make_graph(CFG, SEED, "cpu")
    n, src, dst = edges.num_vertices, edges.src, edges.dst
    assert bool((src != dst).all())
    assert bool((edges.keys[1:] > edges.keys[:-1]).all())
    mirror = torch.sort(dst * n + src)
    assert torch.equal(mirror.values, edges.keys)
    assert torch.equal(edges.weights[mirror.indices], edges.weights)
    assert int(edges.weights.min()) >= 1 and int(edges.weights.max()) <= 255
    again = gen.make_graph(CFG, SEED, "cpu")
    assert torch.equal(again.keys, edges.keys)


def test_graph_seed_serves_one_graph_under_other_labels():
    a = gen.make_graph(CFG, 1, "cpu")
    b = gen.make_graph(CFG, 2, "cpu")
    assert a.num_edges == b.num_edges and not torch.equal(a.keys, b.keys)

    def shape(e):
        deg = torch.bincount(e.src, minlength=e.num_vertices)
        return (torch.sort(deg).values, torch.sort(e.weights).values,
                torch.sort(deg[e.src] * 1000 + e.weights).values)
    for x, y in zip(shape(a), shape(b)):
        assert torch.equal(x, y)

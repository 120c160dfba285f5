"""CPU tests of the replayed iteration (``repro_torch.core.replay``): when
a run may replay, the iteration key of the built-in apps, the replay
counts in ``Executor.dispatch_stats()``, the run loop over a stand-in
for the CUDA graphs, the GAS kernel's counters (exact edges among them)
live, recorded and replayed, and gbench's readers of the replayed share
and of the exact-edge share.

The graphs themselves run only on the card (``tests/test_torch_cuda.py``,
``-k replay``)."""
import contextlib
import dataclasses
import sys
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import replay
from repro_torch.core.gas import GASApp
from repro_torch.core.types import Geometry
from repro_torch.kernels import gas_kernel
from repro_torch.graphs.rmat import rmat

GEOM = Geometry(U=128, W=128, T=128, E_BLK=128, big_batch=2)
# Little and Big lanes on both layouts (the Big gather's cost set to 0)
CONFIG = api.PlanConfig(n_lanes=4, hw=api.DEFAULT_HW.clone(gather_b=0.0))
CUDA = torch.device("cuda")
APPS = ["pagerank", "bfs", "sssp", "wcc", "closeness"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run shares the CPU among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    return rmat(11, 8, seed=5, weighted=True)


@pytest.fixture(scope="module")
def root(graph):
    return int(np.argmax(np.bincount(graph.src, minlength=graph.num_vertices)))


def _store(graph, layout="padded"):
    return api.GraphStore(graph, geom=GEOM, layout=layout, device="cpu")


def _app(name, root=0, **kw):
    if name in ("bfs", "sssp"):
        kw["root"] = root
    return api.BUILTIN_APPS[name](**kw)


def _keyless(app):
    return dataclasses.replace(app, iteration_key=None)


def _totals():
    t = replay.totals()
    return tuple(t[key] for key in replay.COUNTS)


def _delta(before):
    return tuple(b - a for a, b in zip(before, _totals()))


# -- when a run may replay ---------------------------------------------

@pytest.mark.parametrize("case", ["card", "cpu", "ref", "per_entry",
                                  "lane_detail", "no_key"])
def test_eligible_only_on_the_card_path_with_a_key(case):
    """Every condition of the rule alone keeps the run eager."""
    kw = dict(device=CUDA, path="cuda", fuse_lanes=True, lane_detail=False,
              app=api.BUILTIN_APPS["bfs"](root=1))
    change = {"card": {}, "cpu": {"device": torch.device("cpu")},
              "ref": {"path": "ref"}, "per_entry": {"fuse_lanes": False},
              "lane_detail": {"lane_detail": True},
              "no_key": {"app": _keyless(kw["app"])}}[case]
    assert replay.eligible(**{**kw, **change}) is (case == "card")


@pytest.mark.parametrize("case", ["cpu", "ref", "per_entry", "lane_detail",
                                  "no_key"])
def test_runs_on_the_cpu_stay_eager(case, graph, root):
    """On the CPU no run captures or replays, and no run of an eligible
    kind counts as eager: the iterations only add to ``run_iterations``."""
    store = _store(graph)
    bundle = store.plan(CONFIG)
    app = _app("bfs", root)
    kw = {"device": "cpu"}
    if case == "ref":
        kw["path"] = "ref"
    if case == "per_entry":
        kw["fuse_lanes"] = False
    if case == "no_key":
        app = _keyless(app)
    ex = api.Executor(store, bundle, app, **kw)
    before = _totals()
    if case == "lane_detail":
        tracer = api.Tracer(lane_detail=True)
        root_span = tracer.start_trace("job")
        with tracer.activate(root_span.context):
            _, meta = ex.run()
        root_span.end()
    else:
        _, meta = ex.run()
    assert meta["iterations"] > 1
    assert _delta(before) == (0, 0, 0, meta["iterations"])
    assert bundle._captures == {}


# -- the iteration key ---------------------------------------------------

def test_iteration_key_leaves_out_root_and_max_iters():
    b = api.BUILTIN_APPS
    assert b["bfs"](root=1).iteration_key == \
        b["bfs"](root=7, max_iters=3).iteration_key
    assert b["sssp"](root=1).iteration_key == \
        b["sssp"](root=9, max_iters=5).iteration_key
    assert b["pagerank"]().iteration_key == \
        b["pagerank"](max_iters=4).iteration_key
    assert b["closeness"]().iteration_key == \
        b["closeness"](sources=np.arange(3)).iteration_key
    assert b["wcc"]().iteration_key == b["wcc"](max_iters=2).iteration_key


def test_iteration_key_keeps_damping_and_tells_apps_apart():
    b = api.BUILTIN_APPS
    assert b["pagerank"](damping=0.85).iteration_key != \
        b["pagerank"](damping=0.9).iteration_key
    assert 0.9 in b["pagerank"](damping=0.9).iteration_key
    keys = [b[name]().iteration_key for name in APPS]
    assert None not in keys and len(set(keys)) == len(APPS)
    for name in APPS:
        k = b[name]().iteration_key
        assert k[:2] == (name, b[name]().gather) and hash(k) is not None
    pr = b["pagerank"]()
    user = GASApp("mine", pr.gather, pr.scatter, pr.apply, pr.init,
                  pr.converged, scatter_op="copy")
    assert user.iteration_key is None


# -- the counts ------------------------------------------------------------

def test_replay_counts_in_dispatch_stats(graph, root):
    """``dispatch_stats()`` counts this executor's runs alone;
    ``replay.totals()`` adds every executor's."""
    store = _store(graph)
    bundle = store.plan(CONFIG)
    ex = api.Executor(store, bundle, _app("sssp", root), device="cpu")
    other = api.Executor(store, bundle, _app("bfs", root), device="cpu")
    assert {k: ex.dispatch_stats()[k] for k in replay.COUNTS} == \
        dict.fromkeys(replay.COUNTS, 0)
    before = _totals()
    _, meta = ex.run()
    _, meta_other = other.run()
    d1 = ex.dispatch_stats()
    for key in replay.COUNTS + ("capture_pool_bytes",):
        assert isinstance(d1[key], int) and d1[key] >= 0, key
    assert d1["run_iterations"] == meta["iterations"]
    assert other.dispatch_stats()["run_iterations"] == \
        meta_other["iterations"]
    assert _delta(before) == (0, 0, 0, meta["iterations"]
                              + meta_other["iterations"])
    assert d1["capture_pool_bytes"] == 0
    assert ex.stats()["run_iterations"] == d1["run_iterations"]


def test_issue_span_says_whether_it_replayed(graph, root):
    store = _store(graph)
    ex = api.Executor(store, store.plan(CONFIG), _app("bfs", root),
                      device="cpu")
    tracer = api.Tracer(lane_detail=False)
    root_span = tracer.start_trace("job")
    with tracer.activate(root_span.context):
        _, meta = ex.run()
    root_span.end()
    issues = [s for s in tracer.export(root_span.trace_id)
              if s["name"] == "executor.issue"]
    assert len(issues) == meta["iterations"]
    assert all(s["attrs"]["replayed"] is False for s in issues)


# -- the run loop over a stand-in for the graphs ---------------------------

class _Graph:
    """Stands in for a captured graph: replays the recorded function."""

    def __init__(self, fn):
        self.replay = fn


@pytest.fixture
def stand_in(monkeypatch):
    """Let CPU runs replay: eligible on the CPU, no streams, and each
    "graph" the recorded function run eagerly. Yields the count of
    recordings."""
    recorded = []

    def record(fn, pool):
        recorded.append(fn)
        return _Graph(fn)

    real = replay.eligible
    monkeypatch.setattr(replay, "eligible", lambda device, path, *a: real(
        CUDA, "cuda", *a))
    monkeypatch.setattr(replay, "_side_stream",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(replay, "_record", record)
    monkeypatch.setattr(replay, "_pool_bytes", lambda pool: 4096)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    yield recorded


@pytest.mark.parametrize("layout", ["padded", "stream"])
@pytest.mark.parametrize("name", APPS)
def test_replay_loop_equals_eager_run(name, layout, graph, root, stand_in):
    """The loop over the two buffers gives the eager run's properties,
    iterations and history bit for bit: the capturing run (its first
    iteration eager) and a later run (every iteration replayed)."""
    store = _store(graph, layout)
    bundle = store.plan(CONFIG)
    app = _app(name, root)
    want_p, want = api.Executor(store, bundle, _keyless(app),
                                device="cpu").run(collect_history=True)
    n = want["iterations"]
    assert n > 1
    ex = api.Executor(store, bundle, app, device="cpu")
    for run in range(2):
        before = _totals()
        got_p, got = ex.run(collect_history=True)
        assert got["iterations"] == n
        assert np.array_equal(got_p, want_p)
        assert all(np.array_equal(a, b)
                   for a, b in zip(got["history"], want["history"]))
        assert _delta(before) == ((1, n - 1, 1, n) if run == 0
                                  else (0, n, 0, n))
    assert len(stand_in) == 2 and len(bundle._captures) == 1
    assert ex.dispatch_stats()["capture_pool_bytes"] == 4096


def test_device_bytes_count_the_captures(graph, root, stand_in):
    """Each captured iteration's pool and its two static buffers are in
    the bundle's ``device_bytes()`` and so in the store's
    ``memory_footprint()``, which the store cache's budget reads."""
    store = _store(graph)
    bundle = store.plan(CONFIG)
    assert bundle.device_bytes()["capture_bytes"] == 0
    for name in ("bfs", "pagerank"):
        api.Executor(store, bundle, _app(name, root), device="cpu").run()
    assert len(bundle._captures) == 2
    props = 4 * store.V_pad                      # one float32 buffer
    db = bundle.device_bytes()
    assert db["capture_bytes"] == 2 * (4096 + 2 * props)
    assert db["total_bytes"] == sum(v for k, v in db.items()
                                    if k != "total_bytes")
    assert db["packed_bytes"] > 0
    assert store.memory_footprint()["plan_bytes"] == db["total_bytes"]


def test_roots_share_one_capture_and_a_busy_one_runs_eagerly(
        graph, root, stand_in):
    store = _store(graph)
    bundle = store.plan(CONFIG)
    for r in (root, 0):
        app = _app("bfs", r)
        want_p, want = api.Executor(store, bundle, _keyless(app),
                                    device="cpu").run()
        got_p, got = api.Executor(store, bundle, app, device="cpu").run()
        assert got["iterations"] == want["iterations"]
        assert np.array_equal(got_p, want_p)
    assert len(stand_in) == 2 and len(bundle._captures) == 1
    cap = bundle.iteration_capture(torch.device("cpu"),
                                   _app("bfs").iteration_key)
    assert cap.captured and cap.cur in (0, 1)

    # a run that finds the capture held by another runs eagerly
    inside, go, out = threading.Event(), threading.Event(), {}
    app = _app("bfs", root)

    def held(old, new, it):
        if it == 0:
            inside.set()
            assert go.wait(60)
        return app.converged(old, new, it)

    def first():
        out["first"] = api.Executor(
            store, bundle, dataclasses.replace(app, converged=held),
            device="cpu").run()

    t = threading.Thread(target=first)
    before = _totals()
    t.start()
    assert inside.wait(60)
    out["second"] = api.Executor(store, bundle, app, device="cpu").run()
    go.set()
    t.join(60)
    n = out["second"][1]["iterations"]
    assert out["first"][1]["iterations"] == n
    assert np.array_equal(out["first"][0], out["second"][0])
    assert _delta(before) == (0, n, n, 2 * n)


def test_threads_share_one_capture_under_stress(graph, root, stand_in):
    """Eight threads run one key over and over with a short switch
    interval: each run replays only with the capture held, so every
    answer equals the eager one, there is one capture, and every
    iteration counts as replayed or eager."""
    store = _store(graph)
    bundle = store.plan(CONFIG)
    apps = [_app("bfs", r) for r in (root, 0, 1, 2)]
    want = [api.Executor(store, bundle, _keyless(a), device="cpu").run()
            for a in apps]
    errors, interval = [], sys.getswitchinterval()

    def worker(i):
        try:
            for k in range(6):
                j = (i + k) % len(apps)
                got = api.Executor(store, bundle, apps[j],
                                   device="cpu").run()
                assert got[1]["iterations"] == want[j][1]["iterations"]
                assert np.array_equal(got[0], want[j][0])
        except BaseException as exc:        # noqa: BLE001 — reported
            errors.append(exc)

    before = _totals()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    captures, replayed, eager, run = _delta(before)
    assert captures == 1 and len(stand_in) == 2
    assert replayed + eager == run == 12 * sum(w[1]["iterations"]
                                               for w in want)
    assert replayed > 0


def test_failed_capture_leaves_the_key_eager(graph, root, stand_in,
                                             monkeypatch):
    def refuse(fn, pool):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(replay, "_record", refuse)
    store = _store(graph)
    bundle = store.plan(CONFIG)
    app = _app("wcc")
    want_p, want = api.Executor(store, bundle, _keyless(app),
                                device="cpu").run()
    for _ in range(2):
        before = _totals()
        got_p, got = api.Executor(store, bundle, app, device="cpu").run()
        n = want["iterations"]
        assert got["iterations"] == n and np.array_equal(got_p, want_p)
        assert _delta(before) == (0, 0, n, n)
    cap = bundle.iteration_capture(torch.device("cpu"), app.iteration_key)
    assert not cap.captured and "not permitted" in cap.broken


@pytest.mark.parametrize("fails", [False, True])
def test_replays_count_the_launches_their_graphs_recorded(
        fails, graph, root, stand_in, monkeypatch):
    """A replay adds to ``gas_tiles.launches`` and ``edges`` what the
    wrapper counted apart while its graph was recorded (here 3 launches
    of 100 edges; on the CPU the eager iterations launch nothing); a
    recording that fails halfway adds nothing to either."""
    def record(fn, pool):
        gas_kernel.gas_tiles.recorded_launches += 3
        gas_kernel.gas_tiles.recorded_edges += 300
        if fails:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return types.SimpleNamespace(replay=fn)

    monkeypatch.setattr(replay, "_record", record)
    monkeypatch.setattr(gas_kernel.gas_tiles, "launches", 0)
    monkeypatch.setattr(gas_kernel.gas_tiles, "edges", 0)
    monkeypatch.setattr(gas_kernel.gas_tiles, "recorded_launches", 0)
    monkeypatch.setattr(gas_kernel.gas_tiles, "recorded_edges", 0)
    store = _store(graph)
    ex = api.Executor(store, store.plan(CONFIG), _app("bfs", root),
                      device="cpu")
    _, meta = ex.run()
    n = meta["iterations"]
    replayed = 0 if fails else n - 1
    assert ex.dispatch_stats()["replayed_iterations"] == replayed
    assert (gas_kernel.gas_tiles.launches,
            gas_kernel.gas_tiles.edges) == (3 * replayed, 300 * replayed)


def _kernel_counts(prefix=""):
    return tuple(getattr(gas_kernel.gas_tiles, prefix + name)
                 for name in gas_kernel.COUNTS)


@pytest.fixture
def zeroed_counts(monkeypatch):
    """``gas_tiles``'s counters, live and recorded, set to 0."""
    for name in gas_kernel.COUNTS:
        monkeypatch.setattr(gas_kernel.gas_tiles, name, 0)
        monkeypatch.setattr(gas_kernel.gas_tiles, "recorded_" + name, 0)


@pytest.mark.parametrize("recording", [False, True])
@pytest.mark.parametrize("mode", sorted(gas_kernel.MODES))
def test_a_launch_counts_its_exact_edges(mode, recording, zeroed_counts):
    """A launch counts one launch and its edges and, in min, max and or
    (the order-free fold), its edges as exact too; a launch on a
    capturing stream counts into the recorded counters alone."""
    gas_kernel.count_launch(250, mode, recording)
    exact = 250 if mode in ("min", "max", "or") else 0
    counted = (1, 250, exact)
    assert _kernel_counts("recorded_" if recording else "") == counted
    assert _kernel_counts("" if recording else "recorded_") == (0, 0, 0)
    assert gas_kernel.recorded_counts() == dict(zip(
        gas_kernel.COUNTS, counted if recording else (0, 0, 0)))


@pytest.mark.parametrize("mode", sorted(gas_kernel.MODES))
def test_replays_add_the_exact_edges_their_graphs_recorded(
        mode, graph, root, stand_in, monkeypatch, zeroed_counts):
    """Each replay adds every count its graph recorded, exact edges
    included: here 3 launches of 100 edges in ``mode`` an iteration."""
    def record(fn, pool):
        for _ in range(3):
            gas_kernel.count_launch(100, mode, recording=True)
        return types.SimpleNamespace(replay=fn)

    monkeypatch.setattr(replay, "_record", record)
    store = _store(graph)
    ex = api.Executor(store, store.plan(CONFIG), _app("bfs", root),
                      device="cpu")
    _, meta = ex.run()
    replayed = meta["iterations"] - 1
    assert ex.dispatch_stats()["replayed_iterations"] == replayed
    exact = 300 if mode in gas_kernel.EXACT_MODES else 0
    assert _kernel_counts() == (3 * replayed, 300 * replayed,
                                exact * replayed)


# -- gbench's reader -------------------------------------------------------

def _reader():
    from gbench import harness
    return harness.load_reader("iter_replay_share")


def test_reader_gives_nothing_where_nothing_ran(graph, monkeypatch):
    """The reader reads the process totals after the window: None where no
    iteration ran or the program has no such counters."""
    mod = _reader()
    assert mod.read(types.SimpleNamespace(extra={})) is None
    with api.GraphService(device="cpu", default_geom=GEOM,
                          workers=1) as svc:
        fp = svc.register(graph)
        live = types.SimpleNamespace(svc=svc, fp=fp, config=CONFIG,
                                     device=svc.device)
        svc.run(fingerprint=fp, app="wcc", config=CONFIG, timeout=120)
        share = mod.after_window(live)
        t = replay.totals()
        assert t["run_iterations"] > 0
        assert share == t["replayed_iterations"] / t["run_iterations"]
        monkeypatch.setattr(replay, "totals",
                            lambda: dict.fromkeys(replay.COUNTS, 0))
        assert mod.after_window(live) is None        # nothing ran
        monkeypatch.setitem(sys.modules, "repro_torch.core.replay", None)
        assert mod.after_window(live) is None        # a program without
    assert mod.read(types.SimpleNamespace(
        extra={"iter_replay_share": share})) == share


def _exact_share_reader():
    from gbench import harness
    return harness.load_reader("gas_exact_edge_share")


@pytest.mark.parametrize("case", ["share", "no edges", "no counter",
                                  "no program"])
def test_exact_share_reader(case, monkeypatch, zeroed_counts):
    """``gas_exact_edge_share`` reads ``exact_edges / edges`` of the
    kernel's counters after the window; nothing where the kernel
    streamed no edge, where the program has no ``exact_edges`` counter
    (a program before the order-free fold) or no kernel module."""
    mod = _exact_share_reader()
    k = gas_kernel.gas_tiles
    k.edges, k.exact_edges = 400, 300
    if case == "no edges":
        k.edges = k.exact_edges = 0
    elif case == "no counter":
        monkeypatch.delattr(k, "exact_edges")
    elif case == "no program":
        monkeypatch.setitem(sys.modules, "repro_torch.kernels", None)
    share = mod.after_window(types.SimpleNamespace())
    assert share == (0.75 if case == "share" else None)
    assert mod.read(types.SimpleNamespace(
        extra={"gas_exact_edge_share": share})) == share
    assert mod.read(types.SimpleNamespace(extra={})) is None


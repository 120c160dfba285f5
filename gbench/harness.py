"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one configuration, traffic mix or metric is
found by name from ``BENCHMARK.json``:

* ``configs/<name>.json`` (the entry's ``file``): the deployment;
* ``traffic/<name>.json``: the mix, read by :mod:`.loadgen`; a mix that
  needs code adds ``traffic/<name>.py``, whose ``Session`` (a subclass of
  :class:`.loadgen.Session`) drives the window in its place;
* ``generators/<name>.py``: the graph generator a configuration names;
* ``metrics/<name>.py``: one reader per metric, end-to-end and per-layer.
  A reader has ``read(ctx)``, which returns the value (or a dict with
  ``value`` and extra keys such as ``samples``), or None where it finds
  nothing to read; and optionally ``after_window(live)``, run in traced
  runs after the window while the service is still up, whose return
  value ``read`` finds in ``ctx.extra[name]``.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "repro")


# -- lookup by name ------------------------------------------------------

def load_bench(base: Path = ROOT) -> dict:
    return json.loads((Path(base) / "BENCHMARK.json").read_text())


def _by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def find_cell(bench: dict, name: str) -> dict:
    return _by_name(bench["workloads"], name, "workload")


def load_config(bench: dict, name: str, base: Path = ROOT) -> dict:
    entry = _by_name(bench["configs"], name, "config")
    return json.loads((Path(base) / entry["file"]).read_text())


def load_module(folder: str, name: str, base: Path = ROOT):
    """The module ``gbench/<folder>/<name>.py`` under ``base``."""
    path = Path(base) / "gbench" / folder / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no {path}")
    spec = importlib.util.spec_from_file_location(
        f"gbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod          # as dataclasses need
    spec.loader.exec_module(mod)
    return mod


def load_traffic(name: str, base: Path = ROOT) -> dict:
    """The mix's data, ``traffic/<name>.json``; where the mix needs code,
    its module ``traffic/<name>.py`` under the key ``driver``."""
    folder = Path(base) / "gbench" / "traffic"
    mix = json.loads((folder / f"{name}.json").read_text())
    if (folder / f"{name}.py").exists():
        mix["driver"] = load_module("traffic", name, base)
    return mix


def load_reader(name: str, base: Path = ROOT):
    return load_module("metrics", name, base)


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def banned_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`BANNED`,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


# -- the run ---------------------------------------------------------------

def _program_graph(edges, name: str):
    """The generated edges as the program's ``Graph``: already sorted by
    (src, dst), so they are its canonical form."""
    import numpy as np
    import torch
    from repro_torch.graphs.formats import Graph, freeze

    src = edges.src.to(torch.int32).cpu().numpy()
    dst = edges.dst.to(torch.int32).cpu().numpy()
    w = edges.weights.to(torch.float32).cpu().numpy()
    g = Graph(num_vertices=edges.num_vertices, src=src, dst=dst,
              weights=w, name=name)
    return freeze(g), (edges.num_vertices, np.asarray(src),
                       np.asarray(dst), np.asarray(w))


def _warm(svc, fp, mix, args, config) -> list:
    """One request of each app of the mix, one after another; returns
    their request metrics (the first plans and packs)."""
    out, seen = [], set()
    for i, spec in enumerate(mix["clients"]):
        if spec["app"] in seen:
            continue
        seen.add(spec["app"])
        kwargs = next(args.stream(10_000 + i, spec))
        h = svc.submit(fingerprint=fp, app=spec["app"], app_kwargs=kwargs,
                       config=config)
        h.result(timeout=600)
        out.append(h.metrics)
    return out


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        base: Path = ROOT, device: str = "cuda", t_start: float = None,
        log=None) -> tuple:
    """Run one cell; returns ``(result line dict, check lines)``."""
    import torch
    from repro_torch.core.planner import PlanConfig
    from repro_torch.core.types import Geometry
    from repro_torch.serve_graph import GraphService

    from . import devtrace, gen, judge, loadgen
    from .reference import edges as redges

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = load_bench(base)
    cell = find_cell(bench, workload)
    cfg = load_config(bench, cell["config"], base)
    mix = load_traffic(cell["traffic"], base)
    kind = "per_layer" if trace else "end_to_end"
    readers = {m["name"]: (m, load_reader(m["name"], base))
               for m in cell_metrics(bench, workload, kind)}
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    profile = devtrace.Profile() if (trace and on_card) else None
    if profile is not None:
        profile.prime()
    edges = gen.make_graph(cfg, seed, dev, base)
    graph, raw = _program_graph(edges, cfg["name"])
    args = gen.RequestArgs(seed, gen.root_candidates(edges))
    config = PlanConfig(**cfg["plan"])
    svc = GraphService(device=dev, default_geom=Geometry(**cfg["geometry"]),
                       **cfg["service"])
    try:
        t0 = time.perf_counter()
        fp = svc.register(graph)
        prep_store_s = time.perf_counter() - t0
        warm = _warm(svc, fp, mix, args, config)
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s: V={graph.num_vertices} "
            f"E={graph.num_edges} store {prep_store_s:.3f} s")

        keeper = loadgen.Keeper(seed)
        driver = getattr(mix.get("driver"), "Session", loadgen.Session)
        session = driver(svc, mix, fp, edges, args, keeper, seed, config,
                         cfg["weights"])
        del edges
        session.run(seconds, profile=profile)
        session.drop_edges()
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        if profile is not None:
            log(f"trace: {profile.summary['events']} events, "
                f"{len(profile.summary['kernels'])} on the device, "
                f"{profile.summary['host_events']} on the host")
        live = types.SimpleNamespace(svc=svc, fp=session.fps[-1],
                                     config=config, device=svc.device)
        extra = {name: mod.after_window(live)
                 for name, (_, mod) in readers.items()
                 if trace and hasattr(mod, "after_window")}
    finally:
        svc.close()
    del svc, live, graph
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # -- the check, after the window and with the program's state freed
    t_check = time.perf_counter()
    base_edges = redges.Edges.from_numpy(*raw, device=dev)
    numbers, judged = judge.judge(keeper.judged(), base_edges,
                                  [u.delta for u in session.updates])
    lim = judge.limits(s["app"] for s in mix["clients"])
    in_window = [r for r in session.requests if r.t_submit < session.t_close]
    failed = ([r for r in in_window if r.error]
              + session.update_errors)
    apps = {s["app"] for s in mix["clients"]}
    correct = (not failed and set(judged) == apps
               and all(numbers[k] <= lim[k] for k in lim))
    log(f"check took {time.perf_counter() - t_check:.3f} s; answers "
        f"judged {json.dumps(judged, sort_keys=True)}")
    for r in failed[:5]:
        log(f"failed: {getattr(r, 'error', r)}")

    ctx = types.SimpleNamespace(
        requests=in_window, updates=session.updates, seconds=seconds,
        t_open=session.t_open, t_close=session.t_close, setup_s=setup_s,
        prep_store_s=prep_store_s, warm=warm, extra=extra,
        trace=profile.summary if profile else None,
        num_vertices=raw[0], edge_counts=session.edge_counts,
        device_kind=torch.cuda.get_device_name(dev) if on_card else "cpu")
    metrics = {}
    for name, (m, mod) in readers.items():
        v = mod.read(ctx)
        if v is None:
            continue
        v = v if isinstance(v, dict) else {"value": v}
        metrics[name] = {"value": v.pop("value"), "unit": m["unit"], **v}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": ctx.device_kind,
              "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(in_window)
           + len(session.updates) + len(session.update_errors),
           "failed": len(failed), "metrics": metrics, "device": device}
    if profile is not None:
        device["busy_s"] = profile.summary["busy_s"]
        device["window_s"] = profile.summary["window_s"]
        out["breakdown"] = {"device_ops": profile.summary["device_ops"],
                            "idle_gaps": profile.summary["idle_gaps"]}
    out["checks"] = {k: {"value": numbers[k], "limit": lim[k]}
                     for k in sorted(lim)}
    lines = [f"check {k} {numbers[k]!r} limit {lim[k]!r}" for k in sorted(lim)]
    return out, lines

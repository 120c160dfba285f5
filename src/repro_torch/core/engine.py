"""DEPRECATED monolithic facade over the layered API.

``HeterogeneousEngine`` fuses app-independent preparation, scheduling
and execution into one eager constructor. It is a thin shim over the
three layers in ``repro_torch.api``:

    GraphStore (graph prep, built once)  →  Planner (PlanConfig → plan)
        →  Executor (device payloads + the eager run loop)

New code should use ``repro_torch.api`` directly::

    from repro_torch import api
    store = api.GraphStore(graph, geom=geom)
    props, meta = api.compile(None, app, store=store).run()

The shim keeps the legacy attributes (``infos``, ``edges``, ``plan``,
``little_works`` …) and accepts the legacy ``plan_mode: str | tuple``
union (converted via ``PlanConfig.from_legacy``). Pass ``store=`` to
share one GraphStore across several engines. Like every entry point it
runs on ``cuda`` unless ``device="cpu"`` is passed, and raises when
there is no CUDA device. The reference's ``_build_iteration`` (a jit)
has no counterpart: the port's iteration runs eagerly.
"""
from __future__ import annotations

import warnings
from typing import Optional

from ..graphs.formats import Graph
from . import perf_model
from .executor import Executor
from .gas import GASApp
from .planner import PlanConfig
from .store import GraphStore
from .types import Geometry


class HeterogeneousEngine:
    def __init__(
        self,
        graph: Optional[Graph],
        app: GASApp,
        geom: Optional[Geometry] = None,
        n_lanes: int = 8,
        hw: perf_model.HW = perf_model.DEFAULT_HW,
        path: Optional[str] = None,
        use_dbg: Optional[bool] = None,
        plan_mode="model",
        store: Optional[GraphStore] = None,
        device=None,
    ):
        warnings.warn(
            "HeterogeneousEngine is deprecated; use the layered API in "
            "repro_torch.api (GraphStore → Planner → Executor, or "
            "repro_torch.api.compile).", DeprecationWarning, stacklevel=2)
        self.app = app
        self.n_lanes = n_lanes
        self.hw = hw
        if store is not None:
            # a shared store fixes graph/geometry/DBG — reject mismatches
            store.validate_compatible(graph=graph, geom=geom,
                                      use_dbg=use_dbg)
        else:
            if graph is None:
                raise ValueError("HeterogeneousEngine needs a graph when "
                                 "no store= is given")
            store = GraphStore(graph, geom=geom or Geometry(),
                               use_dbg=use_dbg if use_dbg is not None
                               else True)
        self.store = store
        self.geom = self.store.geom
        self.config = PlanConfig.from_legacy(plan_mode, n_lanes, hw)
        self.bundle = self.store.plan(self.config)
        self.executor = Executor(self.store, self.bundle, app, path=path,
                                 device=device)
        self.path = self.executor.path
        self.device = self.executor.device

    # --- legacy attribute surface (delegation) -------------------------
    @property
    def graph(self):
        return self.store.graph

    @property
    def perm(self):
        return self.store.perm

    @property
    def edges(self):
        return self.store.edges

    @property
    def V_pad(self):
        return self.store.V_pad

    @property
    def t_dbg(self):
        return self.store.t_dbg

    @property
    def t_schedule(self):
        # legacy: one timer over partition + classify + block + schedule
        return (self.store.t_partition + self.bundle.t_block
                + self.bundle.t_plan)

    @property
    def infos(self):
        return self.bundle.infos

    @property
    def little_works(self):
        return self.bundle.little_works

    @property
    def big_works(self):
        return self.bundle.big_works

    @property
    def big_ests(self):
        return self.bundle.big_ests

    @property
    def plan(self):
        return self.bundle.plan

    @property
    def lane_entries(self):
        return self.bundle.lane_entries(self.device)

    @property
    def aux(self):
        return self.executor.aux

    @property
    def accum_dtype(self):
        return self.executor.accum_dtype

    # --- legacy methods ------------------------------------------------
    def init_props(self):
        return self.executor.init_props()

    def run(self, max_iters: Optional[int] = None, collect_history=False):
        return self.executor.run(max_iters=max_iters,
                                 collect_history=collect_history)

    def time_iteration(self, repeats: int = 5) -> float:
        return self.executor.time_iteration(repeats=repeats)

    def time_lanes(self, repeats: int = 3):
        return self.executor.time_lanes(repeats=repeats)

    def stats(self) -> dict:
        return self.executor.stats()


def run_app(graph: Graph, app: GASApp, **kw):
    eng = HeterogeneousEngine(graph, app, **kw)
    return eng.run()

"""Executor — per-(plan, app, device) payloads and the eager run loop.

The Executor is the only layer that touches the device: it takes the
plan's lane payloads on its device, runs the iteration (GAS kernel
launches → tile merge → Apply) eagerly, and owns ``run`` /
``time_iteration`` / ``time_lanes``. The store's aux (out-degrees etc.)
is shared across every Executor on the same store and device.

Execution is FUSED by default: each lane is one packed payload run as a
single kernel launch (``kernels.ops.run_lane``) and the per-iteration
merge is one tile-indexed ``index_copy_`` over all lanes' output tiles,
so launches scale with the number of lanes, not the number of plan
entries. ``fuse_lanes=False`` launches once per plan entry instead. The
kernel gives every destination its edges in the same order either way,
so the two forms are bit-identical.

The reference's ``trace_stats`` counts jaxpr equations; eager PyTorch has
no traced program to count, so it has no counterpart here —
``dispatch_stats`` reports the launches instead.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from .. import obs
from ..kernels import ops
from . import perf_model
from .gas import GASApp, GATHER_IDENTITY
from .planner import PlanBundle


def init_props(store, app: GASApp, device):
    """Initial padded property vector for one app on a store (in DBG
    ids), on ``device``."""
    aux = store.aux_on(device)
    p = app.init(aux | {
        "outdeg": aux["outdeg"].cpu().numpy(),
        "perm": store.perm,
    })
    full = np.full(store.V_pad, GATHER_IDENTITY[app.gather],
                   np.int32 if app.gather == "or" else np.float32)
    full[:p.shape[0]] = p[:store.V_pad]
    if app.name == "pagerank":
        full[store.graph.num_vertices:] = 0.0
    return torch.from_numpy(full).to(device)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Executor:
    """Per-(plan, app, device) executor.

    Parameters
    ----------
    store:   the :class:`~.store.GraphStore` the plan was built on.
    bundle:  the (cached) :class:`~.planner.PlanBundle` to execute; its
             payloads are memoized on the bundle per device, so every
             app on the same plan and device shares them.
    app:     the :class:`~.gas.GASApp` to run.
    path:    "cuda" (the GAS kernel) or "ref" (the plain PyTorch
             version); default :func:`~repro_torch.kernels.ops.default_path`
             of the device.
    fuse_lanes: True (default) runs each lane as ONE packed kernel
             launch; False launches per plan entry (bit-identical).
    device:  default ``cuda``; raises when there is no CUDA device and
             ``device="cpu"`` was not passed.

    Invariants: ``run`` returns properties in ORIGINAL vertex ids; one
    iteration runs exactly one merge (``dispatch_stats``).
    """

    def __init__(self, store, bundle: PlanBundle, app: GASApp,
                 path: Optional[str] = None, fuse_lanes: bool = True,
                 device=None,
                 drift_parent: Optional[obs.DriftAccumulator] = None):
        self.store = store
        self.bundle = bundle
        self.app = app
        self.geom = store.geom
        self.device = ops.resolve_device(device)
        self.path = path or ops.default_path(self.device)
        if self.path not in ops.PATHS:
            raise ValueError(f"path must be one of {ops.PATHS}, got "
                             f"{self.path!r}")
        self.V_pad = store.V_pad
        self.fuse_lanes = bool(fuse_lanes)
        # measured-vs-model drift: whole iterations vs the plan's
        # estimated makespan, time_lanes samples vs lane estimates
        self.drift = obs.DriftAccumulator(parent=drift_parent)
        self._lane_est = perf_model.lane_estimates(bundle.plan)

        t0 = time.perf_counter()
        # shared across every app on this plan and device (memoized on
        # the bundle); only the form this executor runs is materialized
        self.lanes: List[List[dict]] = (
            bundle.packed_lanes(self.device) if self.fuse_lanes
            else bundle.lane_entries(self.device))
        self._payloads = [p for lane in self.lanes for p in lane]
        self.t_materialize = time.perf_counter() - t0
        self.aux = store.aux_on(self.device)

    @property
    def plan(self):
        return self.bundle.plan

    @property
    def accum_dtype(self):
        return torch.int32 if self.app.gather == "or" else torch.float32

    # ------------------------------------------------------------------
    def _run_payload(self, payload, vprops):
        """Run one device payload (packed lane or single entry)."""
        return ops.run_lane(payload, vprops, self.app.scatter,
                            self.app.gather, self.path,
                            scatter_op=self.app.scatter_op)

    def gather(self, vprops):
        """The Scatter+Gather half of one iteration: every payload's
        kernel launch and ONE tile-indexed merge into an identity-filled
        accumulator, before Apply. Returns the padded accumulator (the
        quantity the edge-list oracle computes)."""
        accum = torch.full((self.V_pad,),
                           float(GATHER_IDENTITY[self.app.gather]),
                           dtype=self.accum_dtype, device=self.device)
        outs = [self._run_payload(p, vprops) for p in self._payloads]
        return ops.merge_all(accum, outs, self.geom.T)

    def iteration(self, vprops, it: int):
        """One full iteration: launches → merge → Apply."""
        return self.app.apply(self.gather(vprops), vprops, self.aux, it)

    def init_props(self):
        return init_props(self.store, self.app, self.device)

    def run(self, max_iters: Optional[int] = None, collect_history=False):
        """Run to convergence; returns ``(props in ORIGINAL vertex ids
        (numpy), {"iterations", "history"})``. The convergence test runs
        on the host after every iteration, as in the reference."""
        vprops = self.init_props()
        iters = max_iters or self.app.max_iters
        history = []
        it_done = 0
        for it in range(iters):
            t_it = time.perf_counter()
            new = self.iteration(vprops, it)
            done = self.app.converged(vprops, new, it)   # syncs the device
            self.drift.add("makespan", self.plan.est_makespan,
                           time.perf_counter() - t_it)
            it_done = it + 1
            if collect_history:
                history.append(new.cpu().numpy())
            vprops = new
            if done:
                break
        out = vprops.cpu().numpy()[self.store.perm]  # back to original ids
        return out, {"iterations": it_done, "history": history}

    # ------------------------------------------------------------------
    def time_iteration(self, repeats: int = 5) -> float:
        """Median wall time (s) of one full iteration, device
        synchronized. Used by benchmarks."""
        vprops = self.init_props()
        self.iteration(vprops, 0)                          # warm-up
        _synchronize(self.device)
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            self.iteration(vprops, 0)
            _synchronize(self.device)
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    def time_lanes(self, repeats: int = 3):
        """Per-lane median wall times (s) — the quantity the scheduler
        balances. Lanes run one after another here; ``max()`` is the
        modelled makespan's analogue. Each lane sample also feeds the
        drift report."""
        vprops = self.init_props()
        out = []
        for i, lane in enumerate(self.lanes):
            if not lane:
                out.append(0.0)
                continue
            ts = []
            for r in range(repeats + 1):                   # 1 warm-up
                t0 = time.perf_counter()
                for p in lane:
                    self._run_payload(p, vprops)
                _synchronize(self.device)
                if r:
                    ts.append(time.perf_counter() - t0)
            med = float(np.median(ts))
            out.append(med)
            if i < len(self._lane_est):
                e_i, kind_i = self._lane_est[i]
                self.drift.add(kind_i, e_i, med)
        return out

    # ------------------------------------------------------------------
    def memory_footprint(self) -> int:
        """Device bytes pinned by this executor's payloads (shared with
        every executor on the same plan and device)."""
        return sum(ops.payload_nbytes(p) for p in self._payloads)

    def dispatch_stats(self) -> dict:
        """What one iteration launches: one kernel per payload and ONE
        merge; the per-entry count is reported alongside."""
        num_entries = sum(p["n_entries"] for p in self._payloads)
        return {
            "fuse_lanes": self.fuse_lanes,
            "num_entries": num_entries,
            "kernel_dispatches": len(self._payloads),
            "merge_dispatches": 1 if self._payloads else 0,
            "payload_bytes": self.memory_footprint(),
        }

    def stats(self) -> dict:
        b, store = self.bundle, self.store
        padded_edges = sum(p["n_blocks"] for p in self._payloads) \
            * self.geom.E_BLK
        real_edges = sum(p["num_real_edges"] for p in self._payloads)
        return {
            "V": store.graph.num_vertices, "E": store.graph.num_edges,
            "device": str(self.device), "path": self.path,
            "partitions": len(b.infos),
            "dense": len(b.dense), "sparse": len(b.sparse),
            "little_lanes": b.plan.num_little_lanes,
            "big_lanes": b.plan.num_big_lanes,
            "est_makespan": b.plan.est_makespan,
            "t_dbg_ms": store.t_dbg * 1e3,
            "t_partition_schedule_ms":
                (store.t_partition + b.t_block + b.t_plan) * 1e3,
            "t_plan_ms": b.t_plan * 1e3,
            "t_materialize_ms": self.t_materialize * 1e3,
            "num_real_edges": real_edges,
            "num_padded_edges": padded_edges,
            "padding_efficiency": (real_edges / padded_edges
                                   if padded_edges else 1.0),
            "drift": self.drift.report(),
            **self.dispatch_stats(),
        }

"""Executor — per-(plan, app, device) payloads and the eager run loop.

The Executor is the only layer that touches the device: it takes the
plan's lane payloads on its device, runs the iteration (GAS kernel
launches → tile merge → Apply) eagerly or, on the card, replays it from
the plan's captured iteration (``core/replay.py``), and owns ``run`` /
``time_iteration`` / ``time_lanes``. The store's aux (out-degrees etc.)
is shared across every Executor on the same store and device.
``time_lanes`` samples feed the perf-model drift report, the
utilization profiler (``utilization()``) and an attached autotune
calibrator, and so does a ``run`` under a tracer with lane detail (one
span and one device synchronization per lane); a ``run`` under a tracer
without it keeps the fused launches and adds spans only. The
multi-device counterpart is
:class:`repro_torch.sharding.executor.ShardedExecutor`.

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
from . import perf_model, replay
from .gas import GASApp, GATHER_IDENTITY
from .planner import PlanBundle


def _host_buffer(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """An empty host tensor for one copy to or from ``device``:
    page-locked where ``device`` is a card, so that the copy is one DMA
    and is not staged through pageable memory."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=torch.device(device).type == "cuda")


def init_props(store, app: GASApp, device):
    """Initial padded property vector for one app on a store (in DBG
    ids), on ``device``."""
    aux = store.aux_on(device)
    p = app.init(aux | {"outdeg": aux["outdeg_host"], "perm": store.perm})
    buf = _host_buffer(store.V_pad, torch.int32 if app.gather == "or"
                       else torch.float32, device)
    full = buf.numpy()
    full.fill(GATHER_IDENTITY[app.gather])
    full[:p.shape[0]] = p[:store.V_pad]
    if app.name == "pagerank":
        full[store.num_vertices:] = 0.0
    return buf.to(device)


def to_original_ids(vprops, aux) -> np.ndarray:
    """The properties in original vertex ids, on the host: gathered
    through the permutation on the device, then copied in one piece."""
    out = torch.index_select(vprops, 0, aux["perm"])
    host = _host_buffer(out.shape, out.dtype, out.device)
    return host.copy_(out).numpy()


def _synchronize(device: torch.device) -> None:
    """Wait for what this thread issued on ``device``: its current
    stream. A wait on the whole device fails, and breaks the capture,
    while another thread captures an iteration (``core/replay.py``)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


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
    drift_parent / util_parent: service-level accumulators the
             executor's drift and utilization samples also feed.
    calibrator: an optional :class:`~repro_torch.autotune.Calibrator`
             that every measured lane time (``time_lanes``, traced
             runs) feeds as a calibration sample.

    Invariants: ``run`` returns properties in ORIGINAL vertex ids; one
    iteration runs exactly one merge (``dispatch_stats``).
    """

    def __init__(self, store, bundle: PlanBundle, app: GASApp,
                 path: Optional[str] = None, fuse_lanes: bool = True,
                 device=None,
                 drift_parent: Optional[obs.DriftAccumulator] = None,
                 calibrator=None,
                 util_parent: Optional[obs.UtilizationAccumulator] = None):
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
        # measured-vs-model drift: whole iterations vs _est_iteration,
        # time_lanes samples vs lane estimates
        self.drift = obs.DriftAccumulator(parent=drift_parent)
        self._lane_est = perf_model.lane_estimates(bundle.plan)
        # the estimate a measured iteration is compared against for the
        # "makespan" drift kind: plan.est_makespan assumes lanes run in
        # parallel; under a serial calibration (combine == "sum", what
        # every fit returns) the lanes' times add, so the like-for-like
        # estimate is the SUM of lane estimates — otherwise a
        # perfectly-fitted model on a well-balanced plan would show
        # ~n_lanes of phantom drift and thrash the retuner
        if bundle.config.hw.combine == "sum":
            self._est_iteration = sum(e for e, _ in self._lane_est)
        else:
            self._est_iteration = bundle.plan.est_makespan
        # optional autotune sink: measured lane times land here as
        # (feature row, kind, seconds) calibration samples, from traced
        # runs and time_lanes sweeps alike (repro_torch.autotune)
        self._calibrator = calibrator
        self._lane_rows = None       # lazy perf_model.lane_feature_rows
        # pipeline utilization profiler (obs.profile): the bytes each
        # lane must move x measured lane times -> achieved GB/s and
        # %-of-peak of the card's rate (none on the CPU); derived lazily
        self.util = obs.UtilizationAccumulator(parent=util_parent)
        self._peak_bps = perf_model.peak_bandwidth_bps(bundle.config.hw,
                                                       self.device)
        self._footprints = None      # lazy obs.lane_footprints
        self._traffic = None         # lazy obs.lane_traffic per lane
        self._init = None            # lazy init_props on the device
        self._replay_counts = dict.fromkeys(replay.COUNTS, 0)

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

    def footprints(self):
        """Per-lane analytic :class:`~repro_torch.obs.profile.
        LaneFootprint` (None for snapped-away lanes) of the payloads this
        executor runs, derived once."""
        if self._footprints is None:
            self._footprints = obs.lane_footprints(self.lanes, self.V_pad)
        return self._footprints

    def lane_traffic(self):
        """Per-lane (bytes, operations) one run of the lane must move and
        do (:func:`~repro_torch.obs.profile.lane_traffic`; None for
        snapped-away lanes), derived once."""
        if self._traffic is None:
            self._traffic = [obs.lane_traffic(lane, self.app.scatter_op)
                             for lane in self.lanes]
        return self._traffic

    def _util_add(self, lane_idx: int, measured_s: float, span=None):
        """Fold one measured lane execution into the utilization
        accumulator, under its footprint's kind, and onto the live
        ``executor.lane`` span when one is open."""
        fp = self.footprints()[lane_idx]
        if fp is not None:
            nbytes, n_ops = self.lane_traffic()[lane_idx]
            if span is not None:
                gbps = nbytes / measured_s / 1e9 if measured_s > 0 else 0.0
                span.set(bytes=nbytes, ops=n_ops, gbps=round(gbps, 3))
            self.util.add(fp.kind, nbytes, n_ops, measured_s,
                          peak_bps=self._peak_bps, lane=lane_idx)

    # ------------------------------------------------------------------
    def _run_payload(self, payload, vprops):
        """Run one device payload (packed lane or single entry)."""
        return ops.run_lane(payload, vprops, self.app.scatter,
                            self.app.gather, self.path,
                            scatter_op=self.app.scatter_op)

    def _merge(self, outs):
        """ONE tile-indexed merge of every payload's output tiles into an
        identity-filled accumulator."""
        accum = torch.full((self.V_pad,),
                           float(GATHER_IDENTITY[self.app.gather]),
                           dtype=self.accum_dtype, device=self.device)
        return ops.merge_all(accum, outs, self.geom.T)

    def gather(self, vprops):
        """The Scatter+Gather half of one iteration: every payload's
        kernel launch and the merge, before Apply. Returns the padded
        accumulator (the quantity the edge-list oracle computes)."""
        return self._merge([self._run_payload(p, vprops)
                            for p in self._payloads])

    def iteration(self, vprops, it: int):
        """One full iteration: launches → merge → Apply."""
        return self.app.apply(self.gather(vprops), vprops, self.aux, it)

    def _initial(self):
        """The app's initial properties on the device, made once per
        executor: the app's ``init`` (host numpy) and the upload cost
        more host time on a large graph than a run's kernels."""
        if self._init is None:
            self._init = init_props(self.store, self.app, self.device)
        return self._init

    def init_props(self):
        """The app's initial properties, a fresh copy on the device for
        each run."""
        return self._initial().clone()

    def _take_capture(self):
        """The captured iteration this run replays, with its lock held,
        or None: another run holds it, or its capture failed."""
        cap = self.bundle.iteration_capture(self.device,
                                            self.app.iteration_key)
        if not cap.lock.acquire(blocking=False):
            return None
        if cap.broken is not None:
            cap.lock.release()
            return None
        return cap

    def _issue(self, cap, vprops, it: int):
        """One iteration's launches, merge and Apply: replayed from the
        capture, or eager (capturing it first where ``cap`` holds none
        yet). Returns ``(new props, replayed, captured)``."""
        if cap is None or cap.broken is not None:
            return self.iteration(vprops, it), False, False
        if cap.captured:
            return cap.replay(), True, False
        new = cap.capture(lambda v: self.iteration(v, it),
                          (self._payloads, self.aux))
        return new, False, cap.captured

    def _iteration_traced(self, vprops, it: int):
        """One iteration's launches, merge and Apply under an active
        tracer with lane detail: the lanes one at a time, each under an
        ``executor.lane`` span that carries its perf-model estimate and,
        once the device has finished it, its bytes and achieved rate;
        then the merge and Apply under ``executor.merge_apply``. The
        same payloads launch in the same order into the same single
        merge as :meth:`gather`, so the result equals the fused
        iteration's bit for bit."""
        est = self._lane_est
        outs = []
        for li, lane in enumerate(self.lanes):
            if not lane:
                continue
            e_i, kind_i = est[li] if li < len(est) else (0.0, "mixed")
            n_entries = (len(self.plan.lanes[li])
                         if li < len(self.plan.lanes) else 0)
            t0 = time.perf_counter()
            with obs.span("executor.lane", "executor", lane=li,
                          kind=kind_i, est_time=e_i,
                          n_entries=n_entries) as sp:
                outs.extend(self._run_payload(p, vprops) for p in lane)
                _synchronize(self.device)
                measured = time.perf_counter() - t0
                self._util_add(li, measured, span=sp)
            self.drift.add(kind_i, e_i, measured)
            self._calib_add(li, kind_i, measured)
        with obs.span("executor.merge_apply", "executor", it=it):
            new = self.app.apply(self._merge(outs), vprops, self.aux, it)
            _synchronize(self.device)
        return new

    def run(self, max_iters: Optional[int] = None, collect_history=False):
        """Run to convergence; returns ``(props in ORIGINAL vertex ids
        (numpy), {"iterations", "history"})``. The convergence test runs
        on the host after every iteration, as in the reference.

        Under an active tracer each iteration is an
        ``executor.iteration`` span and ends with an
        ``executor.converge`` span (``app.converged``: the host's
        convergence read), and the reorder to original ids is an
        ``executor.reorder`` span. With ``lane_detail`` the iteration
        runs its lanes one at a time with a span and a device
        synchronization per lane (:meth:`_iteration_traced`: more host
        waits, bit-identical results). Otherwise, traced or not, the
        lanes launch back to back (``executor.issue``: the host's issue
        of every launch, the merge and Apply) and the one
        synchronization of the iteration follows (``executor.wait``);
        only the per-iteration makespan drift sample is taken.

        Where :func:`~.replay.eligible` allows and the plan's captured
        iteration for the app's key is free, the iterations replay it
        (``core/replay.py``; ``executor.issue`` then spans the replay,
        its attribute ``replayed`` says which): the same kernels on the
        same payloads, bit for bit, into two static buffers, and the
        reorder reads the last of them before the capture is freed."""
        tracer = obs.current_tracer()
        lane_detail = (tracer is not None and tracer.lane_detail
                       and obs.current_ctx() is not None)
        eligible = replay.eligible(self.device, self.path, self.fuse_lanes,
                                   lane_detail, self.app)
        cap = self._take_capture() if eligible else None
        iters = max_iters or self.app.max_iters
        history = []
        it_done = n_replayed = n_captured = 0
        try:
            vprops = (self.init_props() if cap is None
                      else cap.start(self._initial()))
            for it in range(iters):
                with obs.span("executor.iteration", "executor", it=it):
                    t_it = time.perf_counter()
                    if lane_detail:
                        new = self._iteration_traced(vprops, it)
                        _synchronize(self.device)
                    else:
                        with obs.span("executor.issue", "executor",
                                      it=it) as sp:
                            new, replayed, captured = self._issue(
                                cap, vprops, it)
                            sp.set(replayed=replayed)
                        n_replayed += replayed
                        n_captured += captured
                        with obs.span("executor.wait", "executor", it=it):
                            _synchronize(self.device)
                    # the sample ends with the new properties on the
                    # device and before the convergence test, as the
                    # reference's
                    self.drift.add("makespan", self._est_iteration,
                                   time.perf_counter() - t_it)
                    with obs.span("executor.converge", "executor", it=it):
                        done = self.app.converged(vprops, new, it)
                it_done = it + 1
                if collect_history:     # a copy: a replay reuses `new`
                    history.append(new.to("cpu", copy=True).numpy())
                vprops = new
                if done:
                    break
            with obs.span("executor.reorder", "executor"):
                out = to_original_ids(vprops, self.aux)
        finally:
            if cap is not None:
                cap.lock.release()
            replay.count(self._replay_counts, iteration_captures=n_captured,
                         replayed_iterations=n_replayed,
                         eager_iterations=(it_done - n_replayed
                                           if eligible else 0),
                         run_iterations=it_done)
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
        modelled makespan's analogue. Each sample times what the
        reference's lane function does: the identity fill, the lane's
        launches and ``merge_all``, ended by a synchronize. Each lane
        sample also feeds the drift report and the utilization
        profiler."""
        vprops = self.init_props()
        out = []
        for i, lane in enumerate(self.lanes):
            if not lane:
                out.append(0.0)
                continue
            ts = []
            for r in range(repeats + 1):                   # 1 warm-up
                t0 = time.perf_counter()
                self._merge([self._run_payload(p, vprops) for p in lane])
                _synchronize(self.device)
                if r:
                    ts.append(time.perf_counter() - t0)
            med = float(np.median(ts))
            out.append(med)
            if i < len(self._lane_est):
                e_i, kind_i = self._lane_est[i]
                self.drift.add(kind_i, e_i, med)
                self._calib_add(i, kind_i, med)
            self._util_add(i, med)
        return out

    def _calib_add(self, lane_idx: int, kind: str, measured_s: float):
        """Forward one measured lane time to the attached Calibrator as a
        (feature row, kind, seconds) sample. Rows are per-lane sums of
        unit-coefficient model terms (perf_model.lane_feature_rows) and
        depend only on the plan and the base HW constants, so they are
        computed once per executor."""
        if self._calibrator is None:
            return
        if self._lane_rows is None:
            self._lane_rows = perf_model.lane_feature_rows(self.bundle)
        if lane_idx < len(self._lane_rows):
            self._calibrator.add_lane(self._lane_rows[lane_idx], kind,
                                      measured_s)

    # ------------------------------------------------------------------
    def memory_footprint(self) -> int:
        """Device bytes pinned by this executor's payloads (shared with
        every executor on the same plan and device)."""
        return sum(ops.payload_nbytes(p) for p in self._payloads)

    def utilization(self) -> dict:
        """The pipeline-utilization report: per-kind achieved GB/s (the
        bytes each lane must move, :meth:`lane_traffic`, over its
        host-clock time), %-of-peak (None without a known peak, as on
        the CPU) and operations per byte from the accumulator, plus this
        executor's per-lane analytic footprints (the reference's byte
        classes) and bandwidth ceiling (``peak_bandwidth_gbps``, None
        when unknown). Empty ``kinds``/``lanes`` until ``time_lanes``
        has measured."""
        rep = self.util.report()
        rep["peak_bandwidth_gbps"] = (self._peak_bps / 1e9
                                      if self._peak_bps > 0 else None)
        rep["footprints"] = [fp.as_dict() if fp is not None else None
                             for fp in self.footprints()]
        return rep

    def dispatch_stats(self) -> dict:
        """What one iteration launches: one kernel per payload and ONE
        merge; the per-entry count is reported alongside,
        ``kernel_edges``, the live edges the launches stream (against
        ``stats()["num_padded_edges"]``, the slots of the padded
        blocks), and ``big_gathered``, the sources the Big payloads'
        gathers ``vprops[unique_src]`` read (their tables' padded
        lengths). The replay counts (``core/replay.py``) are this
        executor's runs': ``iteration_captures`` (the captures they
        made), ``replayed_iterations``, ``eager_iterations`` (of runs
        that could replay) and ``run_iterations`` (every iteration
        ``run`` ran; ``replay.totals()`` sums them over the process);
        ``capture_pool_bytes`` is what this plan's captured iterations
        hold on this device."""
        num_entries = sum(p["n_entries"] for p in self._payloads)
        return {
            "fuse_lanes": self.fuse_lanes,
            "num_entries": num_entries,
            "kernel_dispatches": len(self._payloads),
            "kernel_edges": sum(int(p["edge_src"].numel())
                                for p in self._payloads),
            "big_gathered": sum(int(p["unique_src"].numel())
                                for p in self._payloads
                                if p["kind"] == "big"),
            "merge_dispatches": 1 if self._payloads else 0,
            "payload_bytes": self.memory_footprint(),
            **self._replay_counts,
            "capture_pool_bytes": self.bundle.capture_pool_bytes(
                self.device),
        }

    def stats(self) -> dict:
        b, store = self.bundle, self.store
        # every device payload carries its padded block count, from
        # either store layout (a stream work keeps per-tile block counts)
        padded_edges = sum(p["n_blocks"] for p in self._payloads) \
            * self.geom.E_BLK
        real_edges = sum(p["num_real_edges"] for p in self._payloads)
        return {
            "V": store.num_vertices, "E": store.num_edges,
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
            "utilization": self.utilization(),
            **self.dispatch_stats(),
        }

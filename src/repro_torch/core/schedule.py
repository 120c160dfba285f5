"""Model-guided task scheduling (paper §IV-B).

Inter-cluster: classify partitions dense/sparse by the perf model, then
choose the Little:Big lane split M:N minimising the worst cluster
finishing time. Intra-cluster: split work into equal-*time* chunks at
block granularity (the windowed equal-time cutting of the paper; our
"window" is the E_BLK block whose modelled time is uniform within a
partition), then LPT-pack chunks onto lanes.

Also provides the *monolithic* plan (ThunderGP-like homogeneous baseline:
every partition through the Big-style full pipeline) used by the
benchmarks as the state-of-the-art comparison point.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import perf_model
from .types import BlockedEdges, Geometry, PartitionInfo, PlanEntry, SchedulePlan


def batch_sparse(sparse: Sequence[PartitionInfo],
                 big_batch: int) -> List[List[PartitionInfo]]:
    """Group sparse partitions into Big-execution batches (paper: the Big
    pipelines process N_gpe partitions per execution)."""
    return [list(sparse[j:j + big_batch])
            for j in range(0, len(sparse), big_batch)]


def plan_from_config(
    infos: Sequence[PartitionInfo],
    little_works: Dict[int, BlockedEdges],
    big_works: List[BlockedEdges],
    big_work_ests: List[float],
    geom: Geometry,
    config,
) -> SchedulePlan:
    """Dispatch on a :class:`~.planner.PlanConfig` — the single entry
    point the Planner uses (replaces the engine's inline union switch)."""
    if config.mode == "model":
        return build_plan(infos, little_works, big_works, big_work_ests,
                          geom, config.n_lanes, config.hw)
    if config.mode == "monolithic":
        return monolithic_plan(infos, big_works, big_work_ests, geom,
                               config.n_lanes)
    return forced_split_plan(infos, little_works, big_works, big_work_ests,
                             geom, config.forced_little, config.forced_big,
                             config.hw)


def _lpt(items: List[Tuple[float, PlanEntry]], lanes: int) -> Tuple[List[List[PlanEntry]], float]:
    """Longest-processing-time-first packing; returns queues + makespan."""
    queues: List[List[PlanEntry]] = [[] for _ in range(lanes)]
    loads = np.zeros(lanes)
    for t, e in sorted(items, key=lambda x: -x[0]):
        k = int(np.argmin(loads))
        queues[k].append(e)
        loads[k] += t
    return queues, float(loads.max(initial=0.0))


def _split_entry(work: BlockedEdges, work_id: int, est: float,
                 n_chunks: int) -> List[Tuple[float, PlanEntry]]:
    """Equal-time splitting at block granularity (intra-cluster cutting)."""
    n_chunks = max(1, min(n_chunks, work.n_blocks or 1))
    bounds = np.linspace(0, work.n_blocks, n_chunks + 1).astype(int)
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi > lo:
            frac = (hi - lo) / max(1, work.n_blocks)
            out.append((est * frac, PlanEntry(
                kind=work.kind, work_id=work_id,
                block_lo=int(lo), block_hi=int(hi), est_time=est * frac)))
    return out


def build_plan(
    infos: Sequence[PartitionInfo],
    little_works: Dict[int, BlockedEdges],   # pid -> blocked (dense partitions)
    big_works: List[BlockedEdges],           # batched sparse partitions
    big_work_ests: List[float],
    geom: Geometry,
    n_lanes: int,
    hw: perf_model.HW = perf_model.DEFAULT_HW,
) -> SchedulePlan:
    """Inter+intra cluster scheduling given pre-blocked works."""
    dense = [i for i in infos if i.is_dense and i.num_edges > 0]
    sparse = [i for i in infos if not i.is_dense and i.num_edges > 0]
    t_dense = sum(i.t_little for i in dense)
    t_sparse = float(sum(big_work_ests))

    # --- inter-cluster: choose M (little lanes) in [0..n_lanes] -------------
    best = None
    for m in range(0, n_lanes + 1):
        n = n_lanes - m
        if (t_dense > 0 and m == 0) or (t_sparse > 0 and n == 0):
            continue
        tl = t_dense / m if m else 0.0
        tb = t_sparse / n if n else 0.0
        worst = max(tl, tb)
        if best is None or worst < best[0]:
            best = (worst, m, n)
    if best is None:
        # fewer lanes than pipeline classes: lanes run BOTH kinds
        # sequentially (a queue may mix Little and Big entries)
        items = []
        for i in dense:
            items += _split_entry(little_works[i.pid], i.pid, i.t_little, 1)
        for wid, (w, est) in enumerate(zip(big_works, big_work_ests)):
            items += _split_entry(w, wid, est, 1)
        q, mk = _lpt(items, n_lanes)
        return SchedulePlan(
            geometry=geom, num_little_lanes=n_lanes, num_big_lanes=0,
            lanes=q, dense_pids=[i.pid for i in dense],
            sparse_pids=[i.pid for i in sparse], est_makespan=mk)
    _, M, N = best

    # --- intra-cluster: equal-time splitting + LPT --------------------------
    little_items: List[Tuple[float, PlanEntry]] = []
    if M:
        per_lane = t_dense / M
        for i in dense:
            w = little_works[i.pid]
            # split partitions whose modelled time exceeds a lane share
            n_chunks = max(1, int(np.ceil(i.t_little / max(per_lane, 1e-12))))
            little_items += _split_entry(w, i.pid, i.t_little, n_chunks)
    big_items: List[Tuple[float, PlanEntry]] = []
    if N:
        per_lane = t_sparse / N if t_sparse else 0.0
        for wid, (w, est) in enumerate(zip(big_works, big_work_ests)):
            n_chunks = max(1, int(np.ceil(est / max(per_lane, 1e-12))))
            big_items += _split_entry(w, wid, est, n_chunks)

    lq, lmax = _lpt(little_items, M) if M else ([], 0.0)
    bq, bmax = _lpt(big_items, N) if N else ([], 0.0)
    return SchedulePlan(
        geometry=geom, num_little_lanes=M, num_big_lanes=N,
        lanes=list(lq) + list(bq),
        dense_pids=[i.pid for i in dense],
        sparse_pids=[i.pid for i in sparse],
        est_makespan=max(lmax, bmax),
    )


def monolithic_plan(
    infos: Sequence[PartitionInfo],
    big_works: List[BlockedEdges],
    big_work_ests: List[float],
    geom: Geometry,
    n_lanes: int,
) -> SchedulePlan:
    """Homogeneous baseline: ALL partitions on Big-style pipelines (the
    monolithic, worst-case-provisioned design of prior work)."""
    items: List[Tuple[float, PlanEntry]] = []
    tot = float(sum(big_work_ests))
    per_lane = tot / max(n_lanes, 1)
    for wid, (w, est) in enumerate(zip(big_works, big_work_ests)):
        n_chunks = max(1, int(np.ceil(est / max(per_lane, 1e-12))))
        items += _split_entry(w, wid, est, n_chunks)
    q, mk = _lpt(items, n_lanes)
    return SchedulePlan(
        geometry=geom, num_little_lanes=0, num_big_lanes=n_lanes, lanes=q,
        dense_pids=[], sparse_pids=[i.pid for i in infos if i.num_edges > 0],
        est_makespan=mk,
    )


def forced_split_plan(
    infos: Sequence[PartitionInfo],
    little_works: Dict[int, BlockedEdges],
    big_works: List[BlockedEdges],
    big_work_ests: List[float],
    geom: Geometry,
    m: int,
    n: int,
    hw: perf_model.HW = perf_model.DEFAULT_HW,
) -> SchedulePlan:
    """Fix M:N (paper Fig. 10 sweep). M==0 → all partitions via Big;
    N==0 → all via Little."""
    if m == 0:
        return monolithic_plan(infos, big_works, big_work_ests, geom, n)
    if n == 0:
        items = []
        for i in infos:
            if i.num_edges == 0 or i.pid not in little_works:
                continue
            w = little_works[i.pid]
            items += _split_entry(w, i.pid, i.t_little, 1)
        tot = sum(t for t, _ in items)
        per_lane = tot / m if m else 0.0
        items2 = []
        for t, e in items:
            n_chunks = max(1, int(np.ceil(t / max(per_lane, 1e-12))))
            w = little_works[e.work_id]
            items2 += _split_entry(w, e.work_id, t, n_chunks)
        q, mk = _lpt(items2, m)
        return SchedulePlan(geometry=geom, num_little_lanes=m, num_big_lanes=0,
                            lanes=q, dense_pids=[i.pid for i in infos],
                            sparse_pids=[], est_makespan=mk)
    # fixed mixed split: keep model classification, override lane counts
    dense = [i for i in infos if i.is_dense and i.num_edges > 0]
    plan = build_plan(infos, little_works, big_works, big_work_ests, geom,
                      m + n, hw)
    # rebuild with forced M:N
    t_dense = sum(i.t_little for i in dense)
    little_items = []
    per_lane = t_dense / m if m else 0.0
    for i in dense:
        w = little_works[i.pid]
        n_chunks = max(1, int(np.ceil(i.t_little / max(per_lane, 1e-12))))
        little_items += _split_entry(w, i.pid, i.t_little, n_chunks)
    t_sparse = float(sum(big_work_ests))
    big_items = []
    per_lane_b = t_sparse / n if n else 0.0
    for wid, (w, est) in enumerate(zip(big_works, big_work_ests)):
        n_chunks = max(1, int(np.ceil(est / max(per_lane_b, 1e-12))))
        big_items += _split_entry(w, wid, est, n_chunks)
    lq, lmax = _lpt(little_items, m)
    bq, bmax = _lpt(big_items, n)
    return SchedulePlan(geometry=geom, num_little_lanes=m, num_big_lanes=n,
                        lanes=list(lq) + list(bq),
                        dense_pids=[i.pid for i in dense],
                        sparse_pids=plan.sparse_pids,
                        est_makespan=max(lmax, bmax))

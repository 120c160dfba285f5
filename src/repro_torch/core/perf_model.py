"""Analytic performance model of the Big and Little pipelines.

Paper Eqs. (1)-(4) estimate per-partition execution cycles as
  C_p = sum_i max(C_acs_v, C_acs_e, C_proc) + C_store + C_const
with pipeline-specific vertex-access terms. The model keeps that skeleton
with bandwidth/issue-rate terms:

  T(p) = combine(T_edges, T_vertices, T_compute) + T_store + T_const

where combine = max(...) for pipelined, overlapped stages and
combine = sum(...) for serial execution. The Big vertex term keeps the
paper's linear a*x+b law with x = number of unique sources.

This module carries over the reference's model (``HW``, ``_terms``,
``_combine``, ``estimate``, ``classify``, ``estimate_big_batch``,
``lane_estimates``) and its calibration (``feature_row``, the guarded
``fit_terms``, ``calibrate_full``, ``calibrate``, ``lane_feature_rows``:
numpy, so fits equal the reference's on the same samples), and adds the
device-aware bandwidth ceiling the utilization profiler divides by
(``peak_bandwidth_bps``). The analytic prior of every fit is
:data:`DEFAULT_HW`.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

from .types import Geometry, PartitionInfo


@dataclasses.dataclass
class HW:
    """Planning constants of the perf model.

    The defaults are the reference package's uncalibrated planning
    constants, carried over unchanged so that the port classifies
    partitions and schedules lanes exactly as the reference does. They
    describe no measured device: an H100 profile comes from calibration
    on the card.
    """

    bw_hbm: float = 819e9          # B/s sequential stream
    mac_rate: float = 98.5e12      # MAC/s of the one-hot gather/router
    vpu_rate: float = 2.5e12       # elementwise ops/s
    gather_a: float = 64.0 / 819e9  # s per unique vertex (transaction-granular)
    gather_b: float = 2e-6         # base gather latency
    t_const: float = 5e-6          # kernel launch / partition switch
    combine: str = "max"           # "max" (overlapped) | "sum" (serial)
    # calibrated multipliers (unity for analytic mode)
    c_edges: float = 1.0
    c_edges_big: float = 0.0       # 0 -> share c_edges
    c_vertices: float = 1.0
    c_compute: float = 1.0
    c_store: float = 1.0
    # per-lane working-set budget in bytes; 0 = unlimited. A packed lane
    # whose estimated working set exceeds this is chunked into several
    # payloads at entry boundaries (kernels.ops.pack_lanes) —
    # bit-identical, just more launches.
    vmem_lane_budget: float = 0.0
    # achievable device bandwidth in GB/s; 0 = the card's data-sheet
    # rate where it is known (peak_bandwidth_bps; 0 on the CPU)
    peak_bandwidth_gbps: float = 0.0

    def clone(self, **kw) -> "HW":
        return dataclasses.replace(self, **kw)


DEFAULT_HW = HW()
S_EDGE = 12          # src + dst + weight, 4 B each
S_PROP = 4           # scalar f32/int32 property


def effective_peak_bandwidth_bps(hw: HW) -> float:
    """The bandwidth (bytes/s) a calibrated HW profile believes in, which
    :attr:`repro_torch.autotune.DeviceSpec.peak_bandwidth_gbps` reports:
    an explicitly calibrated ``peak_bandwidth_gbps`` wins; otherwise the
    base stream rate deflated by the calibrated edge-stream multiplier —
    ``c_edges`` scales modelled *time*, so the bandwidth the model
    believes this device sustains on the dominant (edge) stream is
    ``bw_hbm / c_edges``. The utilization profiler's %-of-peak
    denominator on the card is :func:`peak_bandwidth_bps`."""
    if hw.peak_bandwidth_gbps > 0:
        return hw.peak_bandwidth_gbps * 1e9
    return hw.bw_hbm / max(hw.c_edges, 1e-9)


# data-sheet HBM rate (GB/s) by CUDA device name: the utilization
# profiler's %-of-peak denominator when HW names none
DATASHEET_HBM_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}


def peak_bandwidth_bps(hw: HW, device) -> float:
    """The bandwidth ceiling (bytes/s) a CUDA ``device``'s utilization
    is a fraction of: an explicit ``hw.peak_bandwidth_gbps``, else the
    card's data-sheet rate from :data:`DATASHEET_HBM_GBPS`, else 0 (no
    peak known: utilization is reported as None). Always 0 on the CPU.
    The model's ``bw_hbm`` is a planning constant, never a device's
    rate."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0.0
    if hw.peak_bandwidth_gbps > 0:
        return hw.peak_bandwidth_gbps * 1e9
    return DATASHEET_HBM_GBPS.get(torch.cuda.get_device_name(device),
                                  0.0) * 1e9


def _terms(info: PartitionInfo, geom: Geometry, kind: str, hw: HW):
    """Return (t_edges, t_vertices, t_compute, t_store) for one partition,
    from the EXACT padded block count of each pipeline's brick layout."""
    exact = info.blocks_little if kind == "little" else info.blocks_big
    e_blocks = exact or -(-max(info.num_edges, 1) // geom.E_BLK)
    padded_e = e_blocks * geom.E_BLK
    t_edges = padded_e * S_EDGE / hw.bw_hbm
    if kind == "little":
        t_vertices = info.num_src_windows * geom.W * S_PROP / hw.bw_hbm
    else:
        t_vertices = hw.gather_a * info.num_unique_src + hw.gather_b
    # one-hot gather (E*W) + router (E*T) MACs per block
    macs = padded_e * (geom.W + geom.T)
    t_compute = macs / hw.mac_rate
    t_store = info.num_dst_tiles * geom.T * S_PROP / hw.bw_hbm
    ce = (hw.c_edges_big or hw.c_edges) if kind == "big" else hw.c_edges
    return (ce * t_edges, hw.c_vertices * t_vertices,
            hw.c_compute * t_compute, hw.c_store * t_store)


def _combine(te, tv, tc, hw: HW) -> float:
    """"max": edge and vertex streams SHARE the memory channel (they
    add), compute overlaps behind memory — max(te+tv, tc).
    "sum" (serial): everything adds."""
    if hw.combine == "max":
        return max(te + tv, tc)
    return te + tv + tc


def estimate(info: PartitionInfo, geom: Geometry, kind: str,
             hw: HW = DEFAULT_HW) -> float:
    te, tv, tc, ts = _terms(info, geom, kind, hw)
    return _combine(te, tv, tc, hw) + ts + hw.t_const


def estimate_big_batch(infos: Sequence[PartitionInfo], geom: Geometry,
                       hw: HW = DEFAULT_HW) -> float:
    """A Big execution covers a batch of sparse partitions: one t_const
    for the whole batch, unique sources approximated by the sum."""
    if not infos:
        return 0.0
    tot = 0.0
    for i in infos:
        te, tv, tc, ts = _terms(i, geom, "big", hw)
        tot += _combine(te, tv, tc, hw) + ts
    return tot + hw.t_const


def classify(infos: Iterable[PartitionInfo], geom: Geometry,
             hw: HW = DEFAULT_HW) -> List[PartitionInfo]:
    """Paper §IV-B step 1: dense iff modelled Little time < Big time.
    Annotates infos in place and returns them."""
    out = []
    for i in infos:
        i.t_little = estimate(i, geom, "little", hw)
        i.t_big = estimate(i, geom, "big", hw)
        i.is_dense = bool(i.t_little < i.t_big)
        out.append(i)
    return out


def feature_row(info: PartitionInfo, geom: Geometry, kind: str,
                hw: HW) -> List[float]:
    """The additive-model design row of one (partition, kind) sample:
    ``[te_little, te_big, tv, tc, ts, 1.0]`` with unit multipliers —
    the column order :func:`fit_terms` fits coefficients for. Rows
    depend only on the base rate constants (bw/mac/gather), not the
    multipliers, so they stay valid across recalibrations."""
    te, tv, tc, ts = _terms(info, geom, kind, hw.clone(
        c_edges=1, c_edges_big=0, c_vertices=1, c_compute=1, c_store=1))
    is_big = 1.0 if kind == "big" else 0.0
    return [te * (1 - is_big), te * is_big, tv, tc, ts, 1.0]


def fit_terms(rows: Sequence[Sequence[float]], ys: Sequence[float],
              hw: HW, min_per_class: int = 3, max_cond: float = 1e8,
              max_residual: float = 0.75) -> Tuple[HW, dict]:
    """Fit the five term multipliers + t_const from design rows (see
    :func:`feature_row`) against measured seconds. The guarded core of
    :func:`calibrate` — also fed directly by the autotune Calibrator
    with per-LANE rows (sums of entry rows).

    Guards (the un-guarded fit silently returned ~0 coefficients on
    underdetermined systems, collapsing every estimate of the starved
    term class):

    * a term class (Little edges / Big edges) with fewer than
      ``min_per_class`` samples keeps its PRIOR coefficient and its
      column is excluded from the solve;
    * fewer usable rows than active columns keeps the prior entirely;
    * the solve is weakly regularized toward the prior, so directions
      the data cannot identify (te and tc are exactly collinear within
      a kind: both scale with padded edges) stay at the prior instead
      of being zeroed arbitrarily;
    * a relative residual above ``max_residual`` (inconsistent
      timings) keeps the prior entirely.

    Returns ``(fitted HW (combine="sum"), diagnostics)`` — diagnostics
    carry n/n_little/n_big, the scaled design's condition number, the
    relative residual, which coefficients kept their prior, and a
    ``fallback`` reason (None when the fit was used).
    """
    A = np.asarray(rows, dtype=float)
    y = np.asarray(ys, dtype=float)
    diag = {"n": int(A.shape[0]) if A.ndim == 2 else 0,
            "n_little": 0, "n_big": 0, "cond": None,
            "residual_rel": None, "kept_prior": [], "fallback": None}
    if A.ndim != 2 or A.shape[0] == 0:
        diag["fallback"] = "no_samples"
        return hw, diag
    names = ["c_edges", "c_edges_big", "c_vertices", "c_compute",
             "c_store", "t_const"]
    prior = np.array([hw.c_edges, hw.c_edges_big or hw.c_edges,
                      hw.c_vertices, hw.c_compute, hw.c_store,
                      max(hw.t_const, 0.0)])
    diag["n_little"] = int(np.count_nonzero(A[:, 0] > 0))
    diag["n_big"] = int(np.count_nonzero(A[:, 1] > 0))

    active = []
    for j in range(6):
        if j == 0 and diag["n_little"] < min_per_class:
            continue
        if j == 1 and diag["n_big"] < min_per_class:
            continue
        if j < 5 and not np.any(A[:, j] > 0):
            continue
        active.append(j)
    inactive = [j for j in range(6) if j not in active]
    diag["kept_prior"] = [names[j] for j in inactive]
    if not active or A.shape[0] < len(active):
        diag["fallback"] = "insufficient_samples"
        return hw, diag

    Aa = A[:, active]
    # residual target: measured minus what the PRIOR attributes to the
    # frozen (inactive) columns
    ya = y - A[:, inactive] @ prior[inactive] if inactive else y.copy()
    norms = np.linalg.norm(Aa, axis=0)
    norms[norms == 0] = 1.0
    As = Aa / norms
    sv = np.linalg.svd(As, compute_uv=False)
    tiny = sv[0] * 1e-12 if sv.size else 0.0
    diag["cond"] = float(sv[0] / sv[-1]) if sv.size and sv[-1] > tiny \
        else float("inf")
    # weak Tikhonov pull toward the prior: negligible where the data
    # identifies a coefficient, decisive in null-space directions
    # (exactly-collinear te/tc) and near max_cond conditioning
    reg = 1e-3 if diag["cond"] <= max_cond else 3e-2
    prior_scaled = prior[active] * norms
    A_solve = np.vstack([As, reg * np.eye(len(active))])
    y_solve = np.concatenate([ya, reg * prior_scaled])
    try:
        from scipy.optimize import nnls
        coef_s, _ = nnls(A_solve, y_solve)
    except Exception:
        coef_s, *_ = np.linalg.lstsq(A_solve, y_solve, rcond=None)
        coef_s = np.clip(coef_s, 0.0, None)
    coef_active = coef_s / norms

    pred = Aa @ coef_active
    ref = np.linalg.norm(ya)
    diag["residual_rel"] = (float(np.linalg.norm(pred - ya) / ref)
                            if ref > 0 else 0.0)
    if diag["residual_rel"] is not None \
            and diag["residual_rel"] > max_residual:
        diag["fallback"] = "high_residual"
        return hw, diag

    coef = prior.copy()
    coef[active] = coef_active
    c = [float(max(x, 1e-12)) for x in coef[:5]]
    if 1 in inactive and hw.c_edges_big == 0.0:
        # preserve the "share c_edges" sentinel: a Big class that kept
        # its prior must track the FITTED little edge coefficient, not
        # a stale absolute value
        c[1] = 0.0
    return hw.clone(c_edges=c[0], c_edges_big=c[1], c_vertices=c[2],
                    c_compute=c[3], c_store=c[4],
                    t_const=float(max(coef[5], 0.0)),
                    combine="sum"), diag


def calibrate_full(samples: Sequence[tuple], hw: HW,
                   min_per_class: int = 3) -> Tuple[HW, dict]:
    """Fit per-term multipliers from measured (info, geom, kind, seconds)
    samples via guarded non-negative least squares on the additive form
    (see :func:`fit_terms`). Mirrors the paper's latency benchmarking
    used to fit Eq. (4)'s a and b. Returns ``(HW, fit diagnostics)`` —
    the diagnostics end up in the persisted DeviceSpec."""
    if not samples:
        return hw, {"n": 0, "fallback": "no_samples"}
    rows = [feature_row(info, geom, kind, hw)
            for info, geom, kind, _secs in samples]
    ys = [secs for *_ignored, secs in samples]
    return fit_terms(rows, ys, hw, min_per_class=min_per_class)


def calibrate(samples: Sequence[tuple], hw: HW) -> HW:
    """Back-compat wrapper over :func:`calibrate_full` (HW only)."""
    return calibrate_full(samples, hw)[0]


def lane_feature_rows(bundle) -> List[np.ndarray]:
    """Per-LANE design rows for a PlanBundle: each lane's row is the
    sum of its entries' :func:`feature_row` vectors, scaled by the
    entry's block fraction of its work (entries on one lane run
    serially, so their term contributions add), with the constant
    column counting kernel launches (one per (lane, kind) packed
    payload). Zipped against measured lane times (``time_lanes`` or
    traced runs) these feed the Calibrator's :func:`fit_terms`."""
    hw = bundle.config.hw
    infos_by_pid = {i.pid: i for i in bundle.infos}
    rows = []
    for lane in bundle.plan.lanes:
        row = np.zeros(6)
        kinds = set()
        for e in lane:
            work = (bundle.little_works[e.work_id] if e.kind == "little"
                    else bundle.big_works[e.work_id])
            batch = [infos_by_pid[p] for p in work.pids]
            n_blocks = max(int(work.n_blocks), 1)
            frac = (e.block_hi - e.block_lo) / n_blocks
            for info in batch:
                r = np.asarray(feature_row(info, work.geom, e.kind, hw))
                r[5] = 0.0           # const handled per payload below
                row += frac * r
            kinds.add(e.kind)
        row[5] = float(len(kinds))   # one launch per (lane, kind)
        rows.append(row)
    return rows


def lane_estimates(plan) -> List[tuple]:
    """Per-lane ``(estimated_seconds, kind)`` for a SchedulePlan: the sum
    of the lane's entry estimates; ``kind`` is the shared entry kind,
    ``"mixed"`` when a lane runs both pipelines, ``"idle"`` when empty."""
    out: List[tuple] = []
    for lane in plan.lanes:
        est = sum(e.est_time for e in lane)
        kinds = {e.kind for e in lane}
        if not kinds:
            kind = "idle"
        elif len(kinds) == 1:
            kind = kinds.pop()
        else:
            kind = "mixed"
        out.append((float(est), kind))
    return out

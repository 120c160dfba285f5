"""Analytic performance model of the Big and Little pipelines.

Paper Eqs. (1)-(4) estimate per-partition execution cycles as
  C_p = sum_i max(C_acs_v, C_acs_e, C_proc) + C_store + C_const
with pipeline-specific vertex-access terms. The model keeps that skeleton
with bandwidth/issue-rate terms:

  T(p) = combine(T_edges, T_vertices, T_compute) + T_store + T_const

where combine = max(...) for pipelined, overlapped stages and
combine = sum(...) for serial execution. The Big vertex term keeps the
paper's linear a*x+b law with x = number of unique sources.

This module carries over what the planner and executor use (``HW``,
``_terms``, ``_combine``, ``estimate``, ``classify``,
``estimate_big_batch``, ``lane_estimates``), and the device-aware
bandwidth ceiling the utilization profiler divides by
(``peak_bandwidth_bps``); calibration comes with the autotune slice of
the port.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence

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

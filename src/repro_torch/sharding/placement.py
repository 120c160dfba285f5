"""Plan-aware lane→device placement (the sharding layer's brain).

ReGraph's scaling argument — many lightweight specialized pipelines,
each owning its own memory channels — applies one level up: one DEVICE
per lane group, edges fully sharded. The packed lane payload (one
contiguous device payload per (lane, kind), see ``kernels.ops``) is the
natural shard unit: lanes are tile-disjoint by construction, so devices
never write the same output tile and the cross-device merge is a single
``psum``/``pmin``/``pmax`` per iteration.

Placement is LPT (longest-processing-time-first) over the perf model's
per-lane time estimates — the same greedy the intra-cluster scheduler
uses to pack entries onto lanes — run in TWO kind-grouped passes over a
SHARED load vector: Little lanes first, then Big lanes. Because each
pass assigns to the least-loaded device, devices that received more
Little work receive less Big work, so both pipeline types interleave
across devices and stay busy (GraphScale/ScalaBFS: multi-channel
scaling lives or dies on partition-to-channel placement).

Greedy min-load assignment guarantees the classical bound

    max_load  <=  total_est / n_devices + max_lane_est

regardless of arrival order (``tests/test_torch_sharding.py`` checks it
for 1-8 devices), so a fresh placement can never be
pathologically skewed. Streaming re-placement passes ``keep=`` — the
owners of clean (signature-matched, dirty-partition-free) lanes — and
only the remaining lanes are re-placed; kept lanes' resident device
payloads are then reused without re-transfer (see
``repro_torch.streaming.apply_delta`` and ``PlanBundle.sharded_lanes``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["LanePlacement", "lane_estimates", "place_lanes"]


def lane_estimates(plan) -> List[float]:
    """Modelled execution time of each lane: the sum of its entries'
    ``est_time`` (the equal-time splits the scheduler packed). Pure
    plan-derived — no device or payload needed."""
    return [float(sum(e.est_time for e in lane)) for lane in plan.lanes]


@dataclasses.dataclass(frozen=True)
class LanePlacement:
    """Immutable lane→device assignment plus its load accounting.

    Attributes
    ----------
    n_devices:       number of devices placed onto.
    num_little_lanes: the plan's M (lanes [0, M) are Little, [M, M+N) Big).
    device_of_lane:  owner device index per lane.
    lane_ests:       per-lane modelled times the placement balanced.

    Invariants: every lane has exactly one owner in ``[0, n_devices)``;
    fresh (keep-free) placements satisfy the greedy bound
    ``max(loads) <= sum(lane_ests)/n_devices + max(lane_ests)``.
    """

    n_devices: int
    num_little_lanes: int
    device_of_lane: Tuple[int, ...]
    lane_ests: Tuple[float, ...]

    def lanes_of(self, device: int) -> List[int]:
        """Lane indices owned by one device (ascending — Little lanes,
        being lower-indexed, come first: the interleaved queue order)."""
        return [i for i, d in enumerate(self.device_of_lane) if d == device]

    @property
    def loads(self) -> Tuple[float, ...]:
        """Per-device summed lane estimates (the balanced quantity)."""
        out = [0.0] * self.n_devices
        for i, d in enumerate(self.device_of_lane):
            out[d] += self.lane_ests[i]
        return tuple(out)

    @property
    def imbalance(self) -> float:
        """max/mean device load; 1.0 is perfect balance (and the value
        reported for an all-empty plan)."""
        loads = self.loads
        mean = sum(loads) / max(len(loads), 1)
        if mean <= 0.0:
            return 1.0
        return max(loads) / mean

    def lpt_bound(self) -> float:
        """The greedy guarantee: ``total/n + max_est``. Fresh placements
        never exceed it (property-tested); streaming re-placements with
        ``keep=`` may, by design — they trade balance for residency."""
        total = sum(self.lane_ests)
        return total / max(self.n_devices, 1) + max(self.lane_ests,
                                                    default=0.0)

    def needs_rebalance(self, threshold: float) -> bool:
        """Placement-drift trigger: True when the measured imbalance
        (max/mean load) exceeds ``threshold``. Across a delta chain,
        ``keep=``-pinned re-placements accumulate skew a fresh LPT
        would not have; the streaming layer uses this to decide when to
        drop the pins and re-place from scratch (see
        ``repro_torch.streaming.rebuild_plans``)."""
        return self.imbalance > float(threshold)

    def stats(self) -> dict:
        loads = self.loads
        return {
            "n_devices": self.n_devices,
            "lanes_per_device": [len(self.lanes_of(d))
                                 for d in range(self.n_devices)],
            "est_loads": list(loads),
            "imbalance": self.imbalance,
            "lpt_bound": self.lpt_bound(),
        }


def place_lanes(plan, n_devices: int,
                keep: Optional[Dict[int, int]] = None,
                lane_ests: Optional[Sequence[float]] = None
                ) -> LanePlacement:
    """LPT-place a plan's lanes onto ``n_devices`` devices.

    Parameters
    ----------
    plan:      a :class:`~repro_torch.core.types.SchedulePlan`.
    n_devices: target device count (>= 1). More devices than lanes is
               legal — the surplus devices simply receive no work.
    keep:      lane index -> device index assignments to preserve
               verbatim (streaming re-placement: clean lanes stay where
               their payloads are resident). Kept loads are charged
               before any free lane is placed.
    lane_ests: override per-lane estimates (defaults to
               :func:`lane_estimates`).

    Returns a :class:`LanePlacement`. Deterministic: ties in both the
    size ordering (stable sort on (-est, lane index)) and the min-load
    argmin (lowest device index) are broken by index.
    """
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    ests = list(lane_ests) if lane_ests is not None else lane_estimates(plan)
    n_lanes = len(plan.lanes)
    if len(ests) != n_lanes:
        raise ValueError(f"lane_ests has {len(ests)} entries for "
                         f"{n_lanes} lanes")
    keep = dict(keep or {})
    owner = [-1] * n_lanes
    loads = np.zeros(n_devices)
    for i, d in keep.items():
        if not (0 <= i < n_lanes) or not (0 <= d < n_devices):
            raise ValueError(f"keep maps lane {i} to device {d}, outside "
                             f"{n_lanes} lanes x {n_devices} devices")
        owner[i] = d
        loads[d] += ests[i]
    M = plan.num_little_lanes
    little = [i for i in range(min(M, n_lanes)) if owner[i] < 0]
    big = [i for i in range(M, n_lanes) if owner[i] < 0]
    # two kind-grouped LPT passes over ONE shared load vector: devices
    # loaded with Little work become preferred targets for Big work, so
    # kinds interleave per device
    for group in (little, big):
        for i in sorted(group, key=lambda i: (-ests[i], i)):
            d = int(np.argmin(loads))
            owner[i] = d
            loads[d] += ests[i]
    return LanePlacement(n_devices=n_devices, num_little_lanes=M,
                         device_of_lane=tuple(owner),
                         lane_ests=tuple(float(e) for e in ests))

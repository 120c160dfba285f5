"""Planner — model-guided scheduling over a GraphStore (paper §IV-B).

The planner is the cheap, per-configuration layer: it classifies
partitions with the analytic perf model (on a private copy of the
store's stats), pulls the memoized Little/Big blockings it needs from
the store, and builds the lane schedule.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Literal, Optional

from .. import obs
from . import perf_model, schedule
from .types import BlockedEdges, PartitionInfo, SchedulePlan

PlanMode = Literal["model", "monolithic", "fixed"]
_MODES = ("model", "monolithic", "fixed")


def _quantize_sig(x: float, sig: int = 3) -> float:
    """Round to ``sig`` significant digits (0.0 and non-finite pass
    through). Used to coarsen HW floats in plan cache keys."""
    if x == 0.0 or x != x or x in (float("inf"), float("-inf")):
        return x
    return float(f"{x:.{sig}g}")


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """Typed scheduling configuration.

    mode:
      "model"      — paper's model-guided heterogeneous plan (default)
      "monolithic" — homogeneous Big-only baseline (ThunderGP-like SOTA)
      "fixed"      — forced ``forced_little``:``forced_big`` lane split
                     (paper Fig. 10 sweep); must sum to ``n_lanes``
    """

    mode: PlanMode = "model"
    forced_little: int = 0
    forced_big: int = 0
    n_lanes: int = 8
    hw: perf_model.HW = dataclasses.field(
        default_factory=lambda: perf_model.DEFAULT_HW)

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got "
                             f"{self.mode!r}")
        if self.n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {self.n_lanes}")
        if self.forced_little < 0 or self.forced_big < 0:
            raise ValueError("forced lane counts must be >= 0, got "
                             f"{self.forced_little}:{self.forced_big}")
        if self.mode == "fixed":
            if self.forced_little + self.forced_big != self.n_lanes:
                raise ValueError(
                    "fixed split must cover all lanes: forced_little + "
                    f"forced_big = {self.forced_little + self.forced_big} "
                    f"!= n_lanes = {self.n_lanes}")
        elif self.forced_little or self.forced_big:
            raise ValueError(
                f"forced_little/forced_big require mode='fixed' "
                f"(got mode={self.mode!r})")

    def cache_key(self) -> tuple:
        """Hashable identity for the store's plan cache (HW floats
        quantized to 3 significant digits in the key only, so
        near-identical calibrations share one plan)."""
        hw_key = tuple(_quantize_sig(v) if isinstance(v, float) else v
                       for v in dataclasses.astuple(self.hw))
        return (self.mode, self.forced_little, self.forced_big,
                self.n_lanes, hw_key)

    @classmethod
    def from_legacy(cls, plan_mode, n_lanes: int,
                    hw: Optional[perf_model.HW] = None) -> "PlanConfig":
        """Convert the legacy ``plan_mode: str | tuple`` union of the
        deprecated ``HeterogeneousEngine``."""
        hw = hw or perf_model.DEFAULT_HW
        if plan_mode == "model":
            return cls(mode="model", n_lanes=n_lanes, hw=hw)
        if plan_mode == "monolithic":
            return cls(mode="monolithic", n_lanes=n_lanes, hw=hw)
        if isinstance(plan_mode, tuple) and len(plan_mode) == 3:
            _, m, n = plan_mode
            # legacy semantics: the tuple overrides n_lanes entirely
            return cls(mode="fixed", forced_little=int(m), forced_big=int(n),
                       n_lanes=int(m) + int(n), hw=hw)
        raise ValueError(f"unrecognized legacy plan_mode: {plan_mode!r}")


@dataclasses.dataclass
class PlanBundle:
    """A plan plus everything the Executor needs to materialize it:
    classified partition stats and the blocked works the lanes refer to.
    Device payloads are memoized per device (sharded forms per device
    tuple, captured iterations per device and iteration key), so every
    app executing this plan on one device shares them."""

    config: PlanConfig
    infos: List[PartitionInfo]               # classified copies
    little_works: Dict[int, BlockedEdges]    # pid -> Little blocking
    big_works: List[BlockedEdges]            # batched sparse blockings
    big_ests: List[float]                    # modelled batch times
    plan: SchedulePlan
    t_plan: float                            # planning wall time (s)
    t_block: float = 0.0                     # blocking paid BY this plan
    _lane_entries: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    _packed_lanes: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    _mat_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)
    # streaming carry-over counts (see packed_lanes(reuse=))
    packed_lanes_reused: int = dataclasses.field(
        default=0, repr=False, compare=False)
    packed_bytes_reused: int = dataclasses.field(
        default=0, repr=False, compare=False)
    # sharded (multi-device) materializations: device tuple ->
    # sharding.ShardedLanes (lane payloads resident on owner devices)
    _sharded: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    # (device, iteration key) -> replay.CapturedIteration
    _captures: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def dense(self) -> List[PartitionInfo]:
        return [i for i in self.infos if i.is_dense and i.num_edges > 0]

    @property
    def sparse(self) -> List[PartitionInfo]:
        return [i for i in self.infos if not i.is_dense and i.num_edges > 0]

    def lane_entries(self, device) -> list:
        """Per-entry payloads on ``device``, materialized once per device
        (lock-guarded so concurrent executors never double them)."""
        with self._mat_lock:
            lanes = self._lane_entries.get(device)
            if lanes is None:
                from ..kernels import ops
                lanes = ops.materialize_lanes(
                    self.plan, self.little_works, self.big_works, device)
                self._lane_entries[device] = lanes
            return lanes

    def packed_lanes(self, device, reuse=None) -> list:
        """Fused payloads on ``device``: one packed payload per
        (lane, kind) instead of one per entry (see
        ``kernels.ops.pack_lanes``), memoized per device. ``reuse``
        (lane idx -> packed payloads already on ``device``) carries
        structurally-unchanged lanes over from a pre-delta bundle
        (``repro_torch.streaming.rebuild_plans``) when the form is first
        materialized: they are spliced in instead of re-packed and
        re-uploaded (``packed_lanes_reused`` / ``packed_bytes_reused``
        count them, over every device)."""
        with self._mat_lock:
            lanes = self._packed_lanes.get(device)
            if lanes is None:
                from ..kernels import ops
                reuse = reuse or {}
                with obs.span("plan.pack", "planner",
                              lanes=len(self.plan.lanes),
                              reused=len(reuse)) as sp:
                    host = ops.pack_lanes_host(
                        self.plan, self.little_works, self.big_works,
                        reuse=reuse,
                        max_working_set=self.config.hw.vmem_lane_budget)
                    sp.set(**ops.lanes_volume(host))
                with obs.span("plan.upload", "planner") as sp:
                    lanes = ops.upload_lanes(host, reuse, device)
                    sp.set(**ops.lanes_volume(
                        [lane for lane, h in zip(lanes, host)
                         if h is not None]))
                if reuse:
                    self.packed_lanes_reused += len(reuse)
                    self.packed_bytes_reused += sum(
                        ops.payload_nbytes(p)
                        for lane in reuse.values() for p in lane)
                self._packed_lanes[device] = lanes
            return lanes

    def sharded_lanes(self, devices, keep=None, seed=None):
        """Multi-device lane payloads: each lane packed (as in
        :meth:`packed_lanes`) and uploaded to the OWNER device chosen by
        the LPT placement (see ``repro_torch.sharding``). Memoized per
        device tuple. When the form is first materialized, ``keep``
        (lane idx -> owner idx) pins clean lanes of a pre-delta form to
        their old owners and ``seed`` (lane idx -> resident payloads)
        splices their payloads in without re-transfer
        (``ShardedLanes.moved`` / ``reused`` account for it)."""
        from ..sharding.executor import materialize_sharded
        devices = tuple(devices)
        with self._mat_lock:
            sharded = self._sharded.get(devices)
            if sharded is None:
                with obs.span("plan.shard", "planner",
                              devices=len(devices),
                              reused=len(seed) if seed else 0):
                    sharded = materialize_sharded(self, devices,
                                                  keep=keep, seed=seed)
                self._sharded[devices] = sharded
            return sharded

    def iteration_capture(self, device, key):
        """The captured iteration (:class:`~.replay.CapturedIteration`)
        that every executor on this plan and ``device`` whose app has
        iteration key ``key`` shares; made once, empty until the first
        run that takes it captures."""
        with self._mat_lock:
            cap = self._captures.get((device, key))
            if cap is None:
                from .replay import CapturedIteration
                cap = CapturedIteration(device)
                self._captures[(device, key)] = cap
            return cap

    def capture_pool_bytes(self, device) -> int:
        """Device bytes held in the graph pools of this plan's captured
        iterations on ``device``."""
        return sum(cap.pool_bytes for (dev, _), cap
                   in list(self._captures.items()) if dev == device)

    def device_bytes(self) -> dict:
        """Device bytes pinned by the payload forms materialized so far
        and by the captured iterations (graph pools and static buffers),
        over every device (each sharded form counted once)."""
        from ..kernels import ops
        out = {}
        for key, forms in (("entry_bytes", self._lane_entries),
                           ("packed_bytes", self._packed_lanes)):
            out[key] = sum(ops.payload_nbytes(p)
                           for lanes in list(forms.values())
                           for lane in lanes for p in lane)
        out["sharded_bytes"] = sum(
            s.nbytes() for s in list(self._sharded.values()))
        out["capture_bytes"] = sum(
            cap.nbytes() for cap in list(self._captures.values()))
        out["total_bytes"] = sum(out.values())
        return out


class Planner:
    """Builds a PlanBundle from a GraphStore + PlanConfig. Stateless
    beyond its inputs; ``GraphStore.plan`` caches the result."""

    def __init__(self, store, config: PlanConfig):
        self.store = store
        self.config = config

    def build(self) -> PlanBundle:
        store, cfg = self.store, self.config
        geom = store.geom
        t0 = time.perf_counter()
        t_block0 = store.t_block

        with obs.span("plan.classify", "planner", mode=cfg.mode) as sp:
            infos = store.copy_infos()
            perf_model.classify(infos, geom, cfg.hw)
            if cfg.mode == "monolithic":
                for i in infos:
                    i.is_dense = False
            elif cfg.mode == "fixed":
                if cfg.forced_little == 0:  # all work through Big pipelines
                    for i in infos:
                        i.is_dense = False
                elif cfg.forced_big == 0:   # all through Little pipelines
                    for i in infos:
                        i.is_dense = True

            dense = [i for i in infos if i.is_dense and i.num_edges > 0]
            sparse = [i for i in infos
                      if not i.is_dense and i.num_edges > 0]
            sp.set(dense=len(dense), sparse=len(sparse))

        with obs.span("plan.blockings", "planner"):
            batches = schedule.batch_sparse(sparse, geom.big_batch)
            store.prepare_works([i.pid for i in dense],
                                [tuple(i.pid for i in b) for b in batches])
            little_works = {i.pid: store.little_work(i.pid) for i in dense}
            big_works, big_ests = [], []
            for batch in batches:
                big_works.append(
                    store.big_work(tuple(i.pid for i in batch)))
                big_ests.append(perf_model.estimate_big_batch(batch, geom,
                                                              cfg.hw))

        with obs.span("plan.schedule", "planner"):
            plan = schedule.plan_from_config(infos, little_works,
                                             big_works, big_ests, geom, cfg)
        t_block = store.t_block - t_block0
        return PlanBundle(config=cfg, infos=infos, little_works=little_works,
                          big_works=big_works, big_ests=big_ests, plan=plan,
                          t_plan=time.perf_counter() - t0 - t_block,
                          t_block=t_block)

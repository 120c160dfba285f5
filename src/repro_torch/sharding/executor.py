"""ShardedExecutor — per-device lane ownership over the layered API.

The shard unit is the packed lane payload (``kernels.ops.pack_lane``):
:func:`~repro_torch.sharding.placement.place_lanes` LPT-assigns lanes to
devices from the perf model's per-lane estimates (Little and Big lanes
interleaved per device), and each lane's packed tensors are uploaded to
their OWNER device. One iteration then runs each owner's lanes on its
own device (under ``torch.cuda.device(owner)``; launches are
asynchronous, so owners on different cards run concurrently), moves
each owner's output TILES and their global tile indices to the primary
device (``devices[0]``), and there runs ONE ``merge_all`` (identity
fill + ``index_copy_``) and the app's Apply.

Because lanes are globally tile-disjoint, that single ``index_copy_`` is
a complete cross-device merge, and the merge+apply region is the same
as the fused single-device iteration's (accumulator fill → ``merge_all``
→ Apply) — which, with the kernel giving each destination its edges in
one fixed order, is why sharded results are bit-identical to fused ones
for every gather mode (``tests/test_torch_sharding.py`` on the CPU,
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on the card).

vprops stays replicated: it is copied to each owner that is not the
primary every iteration (the property array is the small side; edges
dominate and are fully sharded).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.executor import _synchronize, init_props
from ..core.gas import GASApp, GATHER_IDENTITY
from ..kernels import ops
from .placement import LanePlacement, place_lanes

__all__ = ["ShardedExecutor", "ShardedLanes", "materialize_sharded",
           "resolve_devices"]


def resolve_devices(devices=None) -> tuple:
    """Normalize a ``shard=`` / ``devices=`` argument to a device tuple.

    ``None`` or ``True`` → every CUDA device; an ``int`` n → the first n
    CUDA devices (n must not exceed ``torch.cuda.device_count()``); a
    sequence of devices → itself, in order (repeats allowed: several
    owners may share one device). A CUDA device without an index names
    the current card. Raises, never falls back to the CPU, when CUDA is
    asked for and there is none.
    """
    if devices is None or devices is True:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "no CUDA device is available; pass an explicit device "
                "sequence (e.g. shard=['cpu', 'cpu']) to shard over the "
                "CPU")
        return tuple(torch.device("cuda", i) for i in range(n))
    if isinstance(devices, int):
        n = torch.cuda.device_count()
        if not 1 <= devices <= n:
            raise ValueError(f"shard={devices} devices requested but "
                             f"{n} CUDA device(s) available")
        return tuple(torch.device("cuda", i) for i in range(devices))
    devs = tuple(ops.resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("devices must name at least one device")
    return devs


@dataclasses.dataclass
class ShardedLanes:
    """One plan's lanes materialized onto a fixed device tuple.

    lanes[i] is lane i's packed payload list, RESIDENT on
    ``devices[placement.device_of_lane[i]]``. ``moved``/``bytes_moved``
    account the uploads this materialization performed;
    ``reused``/``bytes_reused`` the lanes carried over resident from a
    pre-delta bundle (streaming). Memoized on the owning
    :class:`~repro_torch.core.planner.PlanBundle` (one entry per device
    tuple), so every app executing the plan sharded shares one resident
    copy.
    """

    devices: tuple
    placement: LanePlacement
    lanes: List[List[dict]]
    moved: int = 0
    bytes_moved: int = 0
    reused: int = 0
    bytes_reused: int = 0

    def payloads_of(self, device_idx: int) -> List[dict]:
        """The owner's local queue: payloads of every lane it owns, in
        lane order (Little lanes first — interleaved kinds)."""
        return [p for i in self.placement.lanes_of(device_idx)
                for p in self.lanes[i]]

    def bytes_per_device(self) -> List[int]:
        out = [0] * self.placement.n_devices
        for i, lane in enumerate(self.lanes):
            out[self.placement.device_of_lane[i]] += sum(
                ops.payload_nbytes(p) for p in lane)
        return out

    def nbytes(self) -> int:
        return sum(self.bytes_per_device())

    def stats(self) -> dict:
        return {
            **self.placement.stats(),
            "lanes_per_device": [
                sum(1 for i in self.placement.lanes_of(d) if self.lanes[i])
                for d in range(self.placement.n_devices)],
            "bytes_per_device": self.bytes_per_device(),
            "shards_moved": self.moved,
            "shard_bytes_moved": self.bytes_moved,
            "shards_reused": self.reused,
            "shard_bytes_reused": self.bytes_reused,
        }


def materialize_sharded(bundle, devices: tuple,
                        keep: Optional[Dict[int, int]] = None,
                        seed: Optional[Dict[int, list]] = None
                        ) -> ShardedLanes:
    """Place a bundle's lanes and upload each to its owner device.

    ``keep`` pins lane→owner assignments (streaming: clean lanes stay
    where resident); ``seed`` maps kept lane indices to their resident
    payload lists, which are spliced in without packing or transfer.
    Callers normally go through
    :meth:`repro_torch.core.planner.PlanBundle.sharded_lanes`, which
    memoizes the result per device tuple.
    """
    placement = place_lanes(bundle.plan, len(devices), keep=keep)
    seed = seed or {}
    lanes, moved, bytes_moved = ops.pack_lanes_sharded(
        bundle.plan, bundle.little_works, bundle.big_works,
        placement.device_of_lane, devices, reuse=seed,
        max_working_set=bundle.config.hw.vmem_lane_budget)
    reused = sum(1 for ps in seed.values() if ps)
    bytes_reused = sum(ops.payload_nbytes(p)
                       for ps in seed.values() for p in ps)
    return ShardedLanes(devices=tuple(devices), placement=placement,
                        lanes=lanes, moved=moved, bytes_moved=bytes_moved,
                        reused=reused, bytes_reused=bytes_reused)


def _on(device: torch.device):
    """Make ``device`` current for the launches issued under it."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


class ShardedExecutor:
    """Multi-device counterpart of :class:`~repro_torch.core.executor.
    Executor`.

    Parameters
    ----------
    store:   the :class:`~repro_torch.core.store.GraphStore`.
    bundle:  the cached :class:`~repro_torch.core.planner.PlanBundle`.
    app:     the :class:`~repro_torch.core.gas.GASApp`.
    devices: anything :func:`resolve_devices` accepts (None = every CUDA
             device, int = the first n, or an explicit device sequence).
    path:    "cuda" (the GAS kernel, which raises on CPU tensors) or
             "ref" (the plain version); default from the primary device.

    Same run/time/stats surface as the Executor (``run`` returns props
    in ORIGINAL vertex ids plus a meta dict; ``time_lanes`` exists only
    on the single-device form). One iteration: vprops to each owner →
    each owner's lanes (one kernel launch per payload) → output tiles to
    the primary → ONE ``merge_all`` → Apply on the primary.
    :meth:`dispatch_stats` counts what the last iteration launched and
    merged. Results are bit-identical to the single-device fused path
    for every gather mode.
    """

    def __init__(self, store, bundle, app: GASApp, devices=None,
                 path: Optional[str] = None):
        store.require_padded("the sharded executor")
        self.store = store
        self.bundle = bundle
        self.app = app
        self.geom = store.geom
        self.devices = resolve_devices(devices)
        self.device = self.devices[0]           # the primary
        self.path = path or ops.default_path(self.device)
        if self.path not in ops.PATHS:
            raise ValueError(f"path must be one of {ops.PATHS}, got "
                             f"{self.path!r}")
        self.V_pad = store.V_pad

        t0 = time.perf_counter()
        self.sharded: ShardedLanes = bundle.sharded_lanes(self.devices)
        self.placement = self.sharded.placement
        # per-owner local queues (payloads resident on that device)
        self._dev_payloads = [self.sharded.payloads_of(d)
                              for d in range(len(self.devices))]
        self.t_materialize = time.perf_counter() - t0
        self.aux = store.aux_on(self.device)
        self._last = None            # what the last iteration dispatched

    @property
    def plan(self):
        return self.bundle.plan

    @property
    def accum_dtype(self):
        return torch.int32 if self.app.gather == "or" else torch.float32

    # ------------------------------------------------------------------
    def gather(self, vprops):
        """The Scatter+Gather half of one sharded iteration: each owner's
        lanes on its device, their output tiles on the primary, and ONE
        ``merge_all`` into an identity-filled accumulator there."""
        app = self.app
        outs, launches = [], []
        for dev, payloads in zip(self.devices, self._dev_payloads):
            launches.append(len(payloads))
            if not payloads:
                continue
            with _on(dev):
                vp = vprops.to(dev, non_blocking=True)
                local = [ops.run_lane(p, vp, app.scatter, app.gather,
                                      self.path, scatter_op=app.scatter_op)
                         for p in payloads]
                tiles = torch.cat([t for t, _ in local])
                idx = torch.cat([i for _, i in local])
            outs.append((tiles.to(self.device, non_blocking=True),
                         idx.to(self.device, non_blocking=True)))
        accum = torch.full((self.V_pad,), float(GATHER_IDENTITY[app.gather]),
                           dtype=self.accum_dtype, device=self.device)
        accum = ops.merge_all(accum, outs, self.geom.T)
        self._last = {"launches_per_device": launches,
                      "merges": 1 if outs else 0}
        return accum

    def iteration(self, vprops, it: int):
        """One full sharded iteration: launches → merge → Apply, all
        results on the primary device."""
        return self.app.apply(self.gather(vprops), vprops, self.aux, it)

    def init_props(self):
        return init_props(self.store, self.app, self.device)

    def run(self, max_iters: Optional[int] = None, collect_history=False):
        """Run to convergence; returns ``(props, meta)`` with props in
        ORIGINAL vertex ids — the same contract as ``Executor.run``."""
        vprops = self.init_props()
        iters = max_iters or self.app.max_iters
        history = []
        it_done = 0
        for it in range(iters):
            new = self.iteration(vprops, it)
            done = self.app.converged(vprops, new, it)   # syncs the device
            it_done = it + 1
            if collect_history:
                history.append(new.cpu().numpy())
            vprops = new
            if done:
                break
        out = vprops.cpu().numpy()[self.store.perm]
        return out, {"iterations": it_done, "history": history}

    def time_iteration(self, repeats: int = 5) -> float:
        """Median wall time (s) of one full sharded iteration, every
        device synchronized."""
        vprops = self.init_props()

        def sync():
            for d in set(self.devices):
                _synchronize(d)

        self.iteration(vprops, 0)                          # warm-up
        sync()
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            self.iteration(vprops, 0)
            sync()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    # ------------------------------------------------------------------
    def memory_footprint(self) -> int:
        """Device bytes pinned by the sharded payloads (summed over
        devices; shared with every executor on this bundle and device
        tuple)."""
        return self.sharded.nbytes()

    def dispatch_stats(self) -> dict:
        """Launch accounting of one iteration: kernel launches per owner
        (run on their devices) and exactly ONE merge. ``last_iteration``
        holds what the last :meth:`gather` actually launched per owner
        and how many merges it ran (None before the first)."""
        per_dev = [len(ps) for ps in self._dev_payloads]
        return {
            "shard": True,
            "n_devices": len(self.devices),
            "devices": [str(d) for d in self.devices],
            "num_entries": sum(p["n_entries"]
                               for ps in self._dev_payloads for p in ps),
            "kernel_dispatches": sum(per_dev),
            "kernel_dispatches_per_device": per_dev,
            "cross_device_merges": 1,
            "last_iteration": (dict(self._last) if self._last is not None
                               else None),
            "payload_bytes": self.memory_footprint(),
        }

    def stats(self) -> dict:
        b, store = self.bundle, self.store
        return {
            "V": store.num_vertices, "E": store.num_edges,
            "device": str(self.device), "path": self.path,
            "partitions": len(b.infos),
            "little_lanes": b.plan.num_little_lanes,
            "big_lanes": b.plan.num_big_lanes,
            "est_makespan": b.plan.est_makespan,
            "t_materialize_ms": self.t_materialize * 1e3,
            "placement": self.sharded.stats(),
            **self.dispatch_stats(),
        }

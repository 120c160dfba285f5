"""Pipeline utilization profiler: analytic lane footprints x measured
lane times -> achieved GB/s and %-of-peak.

The port of the reference package's ``obs/profile.py``:

* :class:`LaneFootprint` — per-lane byte and FLOP accounting derived
  analytically from the packed-lane payloads
  (``kernels.ops.payload_footprint``). Two totals matter:

  - ``hbm_bytes``: the traffic model (what the kernel streams, gathers
    and writes per execution) — the numerator of achieved GB/s;
  - ``total_bytes``: every tensor a device payload holds (its
    live-edge stream, ``tile_idx`` and Big table) + the full vprops
    operand + the outputs — held within 10 % of
    :func:`tensor_lane_bytes`.

* :func:`tensor_lane_bytes` — an independent count over the tensors one
  lane's launches take (the reference counts its traced program's
  operands instead; eager PyTorch has no traced program).

* :func:`lane_traffic` — the bytes and operations one run of a lane
  must at least move and do on the card, from its data as it stands.
  ``hbm_bytes`` and ``flops`` model the reference's TPU kernel, which
  streams every padded slot (weights too) through one-hot matmuls; the
  CUDA kernel reads the live-edge stream (no padded slot) and does one
  combine per real edge. The executor's utilization
  samples take :func:`lane_traffic`'s counts, so the share of peak they
  report is comparable to a launch's bound.

* :class:`UtilizationAccumulator` — thread-safe (bytes, flops, seconds)
  aggregator per pipeline kind with per-lane last samples, chained
  executor -> parent like :class:`~repro_torch.obs.drift.
  DriftAccumulator` and surfaced in ``Executor.stats()["utilization"]``.

The %-of-peak denominator is ``perf_model.peak_bandwidth_bps``: an
explicit ``HW.peak_bandwidth_gbps``, else the card's data-sheet HBM rate
(``perf_model.DATASHEET_HBM_GBPS``, keyed by the CUDA device name), else
0 — no peak, utilization reported as None (always so on the CPU).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["LaneFootprint", "UtilizationAccumulator", "lane_footprint",
           "lane_footprints", "lane_traffic", "launch_traffic",
           "tensor_lane_bytes"]


@dataclasses.dataclass(frozen=True)
class LaneFootprint:
    """Analytic byte/FLOP accounting of one lane's packed payloads.

    Byte classes (summed over the lane's payloads; see
    ``kernels.ops.payload_footprint`` for the per-payload derivation):
    ``edge_bytes`` padded edge slabs, ``index_bytes`` routing
    metadata (both the reference's, reckoned from block counts: the
    card holds neither), ``stream_bytes`` the live-edge streams the card
    holds and the CUDA kernel reads, ``table_bytes`` deduped Big
    compaction tables,
    ``vertex_bytes`` property values actually read (unique sources for
    Big, touched W-windows for Little), ``tile_bytes`` the merge
    scatter traffic, ``vprops_bytes`` the full padded property operand.
    """

    lane: int
    kind: str                  # "little" | "big" | "mixed" | "idle"
    n_payloads: int
    edge_bytes: int
    index_bytes: int
    stream_bytes: int
    table_bytes: int
    vertex_bytes: int
    tile_bytes: int
    vprops_bytes: int
    flops: int
    padded_edges: int
    real_edges: int

    @property
    def hbm_bytes(self) -> int:
        """Modelled memory traffic of one lane execution: edge stream +
        routing metadata + gather tables + gathered/streamed vertex
        values + merge scatter tiles. This is the achieved-GB/s
        numerator (the full vprops array is NOT included — only the
        values the kernel touches are). It models the reference's TPU
        kernel, so the live-edge stream is not in it."""
        return (self.edge_bytes + self.index_bytes + self.table_bytes
                + self.vertex_bytes + self.tile_bytes)

    @property
    def total_bytes(self) -> int:
        """Operand + result bytes of one lane execution on the card: the
        payload tensors (the live-edge stream, the Big table, and
        ``tile_idx``, which is also the result's tile index and is
        counted once, in ``tile_bytes``) + the padded vprops operand +
        the output tiles. Held within 10 % of :func:`tensor_lane_bytes`
        (``tests/test_torch_profile.py``)."""
        return (self.stream_bytes + self.table_bytes + self.vprops_bytes
                + self.tile_bytes)

    @property
    def intensity(self) -> float:
        """Arithmetic intensity (FLOPs per HBM byte) — the roofline
        x-coordinate of this lane."""
        b = self.hbm_bytes
        return self.flops / b if b else 0.0

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["hbm_bytes"] = self.hbm_bytes
        d["total_bytes"] = self.total_bytes
        d["intensity"] = self.intensity
        return d


def lane_footprint(payloads: List[dict], v_pad: int,
                   lane: int = 0) -> Optional["LaneFootprint"]:
    """Build one lane's :class:`LaneFootprint` from its (packed or
    per-entry) payload dicts. Returns None for an empty lane."""
    if not payloads:
        return None
    from ..kernels import ops
    parts = [ops.payload_footprint(p) for p in payloads]
    kinds = {p["kind"] for p in parts}
    kind = kinds.pop() if len(kinds) == 1 else "mixed"
    return LaneFootprint(
        lane=lane,
        kind=kind,
        n_payloads=len(parts),
        edge_bytes=sum(p["edge_bytes"] for p in parts),
        index_bytes=sum(p["index_bytes"] for p in parts),
        stream_bytes=sum(p["stream_bytes"] for p in parts),
        table_bytes=sum(p["table_bytes"] for p in parts),
        vertex_bytes=sum(p["vertex_bytes"] for p in parts),
        tile_bytes=sum(p["tile_bytes"] for p in parts),
        vprops_bytes=int(v_pad) * 4,
        flops=sum(p["flops"] for p in parts),
        padded_edges=sum(p["padded_edges"] for p in parts),
        real_edges=sum(p["real_edges"] for p in parts),
    )


def lane_footprints(lanes: List[List[dict]],
                    v_pad: int) -> List[Optional[LaneFootprint]]:
    """Footprints for every lane of an executor's payload structure
    (None entries for fully snapped-away lanes)."""
    return [lane_footprint(lane, v_pad, lane=i)
            for i, lane in enumerate(lanes)]


def launch_traffic(p: dict,
                   scatter_op: Optional[str]) -> Tuple[int, int]:
    """(bytes, operations) one GAS launch over payload ``p`` must at
    least move and do, from its live-edge stream as it stands: src and
    dst (and the weight, for ``add_weight``) of every live edge; the
    tile edge and chunk indices (``tile_edge_start``,
    ``tile_chunk_start``); each distinct source value the edges read,
    once; the output tiles. One combine per live edge, plus one add for
    ``add_weight``. No padded slot: the kernel reads none."""
    import torch

    geom = p["geom"]
    n_edges = int(p["edge_src"].numel())
    weighted = scatter_op == "add_weight"
    nbytes = (n_edges * (12 if weighted else 8)
              + p["tile_edge_start"].numel() * 4
              + p["tile_chunk_start"].numel() * 4
              + int(torch.unique(p["edge_src"]).numel()) * 4
              + int(p["n_out_tiles"]) * geom.T * 4)
    return nbytes, n_edges * (2 if weighted else 1)


def lane_traffic(payloads: List[dict],
                 scatter_op: Optional[str]) -> Optional[Tuple[int, int]]:
    """(bytes, operations) one run of a lane's device payloads must at
    least move and do: each Big payload's gather ``vprops[unique_src]``
    (table read, values read, window written), then each launch
    (:func:`launch_traffic`). None for an empty lane."""
    if not payloads:
        return None
    nbytes = n_ops = 0
    for p in payloads:
        if p["kind"] == "big":
            nbytes += 3 * 4 * int(p["unique_src"].numel())
        b, o = launch_traffic(p, scatter_op)
        nbytes, n_ops = nbytes + b, n_ops + o
    return nbytes, n_ops


def tensor_lane_bytes(executor, lane_idx: int) -> Optional[int]:
    """Byte count of one lane execution from the tensors it actually
    takes: every tensor of the lane's payloads, the padded vprops
    operand, and the outputs one run of the lane returns (tiles and
    their tile indices). Independent of :func:`lane_footprint`'s
    per-class sums, and held against ``total_bytes`` (within 10 %) as
    the reference holds its traced-program count. Runs the lane once on
    the executor's device; returns None for an empty lane. A
    validation aid, not a hot path."""
    import torch

    lanes = executor.lanes
    if lane_idx >= len(lanes) or not lanes[lane_idx]:
        return None

    def nbytes(t) -> int:
        return t.numel() * t.element_size()

    vprops = executor.init_props()
    total = nbytes(vprops)
    for p in lanes[lane_idx]:
        total += sum(nbytes(v) for v in p.values()
                     if isinstance(v, torch.Tensor))
        tiles, tile_idx = executor._run_payload(p, vprops)
        total += nbytes(tiles) + nbytes(tile_idx)
    return total


class UtilizationAccumulator:
    """Thread-safe (bytes, flops, seconds) aggregator per pipeline kind.

    Mirrors :class:`~repro_torch.obs.drift.DriftAccumulator`: executors
    feed per-lane samples (:func:`lane_traffic`'s bytes and operations ×
    measured seconds), an
    executor-local accumulator forwards to the service-level one via
    ``parent=``, and :meth:`report` renders the utilization block that
    ``stats()``, the Prometheus gauges and the dashboard read.

    A sample's ``peak_bps`` (the executor's HW-derived bandwidth
    ceiling) rides along so %-of-peak is computed against the spec the
    lane actually ran under, not a global constant.
    """

    # per-lane last-sample retention bound (lanes × kinds is small, but
    # a service-level accumulator sees every executor's lanes)
    _MAX_LANES = 128

    def __init__(self, parent: Optional["UtilizationAccumulator"] = None,
                 window: int = 512):
        self._parent = parent
        self._window = int(window)
        self._lock = threading.Lock()
        self._tot: Dict[str, Dict[str, float]] = {}
        self._recent: Dict[str, deque] = {}
        self._peak: Dict[str, float] = {}       # kind -> last peak_bps
        self._lanes: Dict[int, Dict[str, Any]] = {}

    def set_parent(self,
                   parent: Optional["UtilizationAccumulator"]) -> None:
        if parent is self:
            raise ValueError(
                "a UtilizationAccumulator cannot parent itself")
        self._parent = parent

    def add(self, kind: str, nbytes: float, flops: float,
            measured_s: float, peak_bps: float = 0.0,
            lane: Optional[int] = None) -> None:
        """Record one lane execution: analytic ``nbytes``/``flops``
        moved in ``measured_s`` wall seconds against a ``peak_bps``
        bandwidth ceiling (0 = unknown; utilization reported as None)."""
        nbytes = float(nbytes)
        flops = float(flops)
        measured_s = float(measured_s)
        gbps = (nbytes / measured_s / 1e9) if measured_s > 0 else 0.0
        with self._lock:
            tot = self._tot.get(kind)
            if tot is None:
                tot = self._tot[kind] = {"n": 0, "bytes": 0.0,
                                         "flops": 0.0, "seconds": 0.0}
                self._recent[kind] = deque(maxlen=self._window)
            tot["n"] += 1
            tot["bytes"] += max(0.0, nbytes)
            tot["flops"] += max(0.0, flops)
            tot["seconds"] += max(0.0, measured_s)
            if measured_s > 0:
                self._recent[kind].append(gbps)
            if peak_bps > 0:
                self._peak[kind] = float(peak_bps)
            if lane is not None:
                if (lane not in self._lanes
                        and len(self._lanes) >= self._MAX_LANES):
                    self._lanes.pop(next(iter(self._lanes)))
                self._lanes[lane] = {
                    "kind": kind, "bytes": nbytes, "flops": flops,
                    "measured_s": measured_s, "gbps": gbps,
                    "utilization": (gbps * 1e9 / peak_bps
                                    if peak_bps > 0 else None),
                }
        if self._parent is not None:
            self._parent.add(kind, nbytes, flops, measured_s,
                             peak_bps=peak_bps, lane=lane)

    def report(self) -> Dict[str, Any]:
        """``{"kinds": {kind: {...}}, "lanes": {lane: last sample},
        "peak_bandwidth_gbps": ...}``; empty sub-dicts before the first
        sample. Per-kind fields: n, bytes, seconds, gbps (aggregate
        bytes/seconds), gbps_p50 (median of recent per-sample rates),
        flops_per_s, intensity (flops/byte), utilization (gbps as a
        fraction of the last peak seen, None when no peak known)."""
        out: Dict[str, Any] = {"kinds": {}, "lanes": {}}
        with self._lock:
            peaks = [p for p in self._peak.values() if p > 0]
            out["peak_bandwidth_gbps"] = (max(peaks) / 1e9 if peaks
                                          else None)
            for kind, tot in self._tot.items():
                recent = sorted(self._recent[kind])
                secs = tot["seconds"]
                gbps = tot["bytes"] / secs / 1e9 if secs > 0 else 0.0
                peak = self._peak.get(kind, 0.0)
                entry: Dict[str, Any] = {
                    "n": int(tot["n"]),
                    "bytes": tot["bytes"],
                    "flops": tot["flops"],
                    "seconds": secs,
                    "gbps": gbps,
                    "flops_per_s": (tot["flops"] / secs
                                    if secs > 0 else 0.0),
                    "intensity": (tot["flops"] / tot["bytes"]
                                  if tot["bytes"] > 0 else 0.0),
                    "utilization": (gbps * 1e9 / peak
                                    if peak > 0 else None),
                }
                if recent:
                    entry["gbps_p50"] = recent[len(recent) // 2]
                out["kinds"][kind] = entry
            out["lanes"] = {lane: dict(s)
                            for lane, s in self._lanes.items()}
        return out

    def clear(self) -> None:
        with self._lock:
            self._tot.clear()
            self._recent.clear()
            self._peak.clear()
            self._lanes.clear()

"""Core datatypes for the heterogeneous Big/Little graph engine."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

# ---------------------------------------------------------------------------
# Tunable geometry (the reference's defaults; all multiples of 128).
#   U      — partition vertex-set size (paper: 32K-64K per Gather PE cluster)
#   W      — source-vertex window (Little ping-pong window / Big compact window)
#   T      — destination accumulator tile (one GAS-kernel output tile)
#   E_BLK  — edges per kernel grid step
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Geometry:
    U: int = 8192
    W: int = 512
    T: int = 512
    E_BLK: int = 256
    big_batch: int = 8  # paper: Big pipelines process N_gpe(=8) partitions/exec

    def __post_init__(self):
        assert self.U % self.T == 0 and self.U % self.W == 0
        assert self.W % 128 == 0 and self.T % 128 == 0 and self.E_BLK % 128 == 0


@dataclasses.dataclass
class PartitionInfo:
    """Stats of one dst-range partition (drives the perf model)."""

    pid: int
    dst_lo: int
    dst_hi: int
    edge_lo: int          # range into the partition-sorted edge arrays
    edge_hi: int
    num_edges: int
    num_unique_src: int
    num_src_windows: int  # distinct W-windows of raw vprops touched
    num_dst_tiles: int    # distinct T-tiles of the dst range touched
    blocks_little: int = 0  # exact padded E_BLK blocks in Little layout
    blocks_big: int = 0     # exact padded E_BLK blocks in Big layout

    # Filled in by the scheduler:
    is_dense: Optional[bool] = None
    t_little: float = 0.0
    t_big: float = 0.0


@dataclasses.dataclass
class BlockedEdges:
    """Edges of one Little partition (or one Big batch) in brick layout.

    Every block of E_BLK edges is homogeneous in (src window, dst tile).
    Blocks are sorted by dst tile so output-tile revisits are consecutive
    (one kernel CTA walks a tile's blocks in order).
    """

    geom: Geometry
    kind: str                      # "little" | "big"
    n_blocks: int
    src_local: np.ndarray          # (n_blocks, E_BLK) int32, offset in window
    dst_local: np.ndarray          # (n_blocks, E_BLK) int32, offset in tile
    weights: np.ndarray            # (n_blocks, E_BLK) float32
    valid: np.ndarray              # (n_blocks, E_BLK) bool
    window_id: np.ndarray          # (n_blocks,) int32 — W-window of source input
    tile_id: np.ndarray            # (n_blocks,) int32 — local output tile index
    tile_first: np.ndarray         # (n_blocks,) int32 — 1 on first block of a tile
    n_out_tiles: int
    tile_dst_start: np.ndarray     # (n_out_tiles,) int32 — global dst id of tile[0]
    unique_src: Optional[np.ndarray] = None  # big only: (n_unique_pad,) int32
    pids: tuple = ()               # partitions covered
    num_real_edges: int = 0

    @property
    def num_padded_edges(self) -> int:
        return self.n_blocks * self.geom.E_BLK


@dataclasses.dataclass
class PlanEntry:
    """A unit of work for one lane: a block-range of one BlockedEdges."""

    kind: str          # "little" | "big"
    work_id: int       # index into engine's list of BlockedEdges
    block_lo: int
    block_hi: int
    est_time: float


@dataclasses.dataclass
class SchedulePlan:
    """Static plan: per-lane queues (paper §IV-B, inter+intra cluster)."""

    geometry: Geometry
    num_little_lanes: int          # M
    num_big_lanes: int             # N
    lanes: List[List[PlanEntry]]   # len == M + N; little lanes first
    dense_pids: List[int]
    sparse_pids: List[int]
    est_makespan: float

    @property
    def num_lanes(self) -> int:
        return self.num_little_lanes + self.num_big_lanes

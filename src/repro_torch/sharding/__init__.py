"""Sharding: per-device lane ownership with plan-aware placement.

One DEVICE per lane group, edges fully sharded, the vertex property
array replicated (it is the small side). The shard unit is the packed
lane payload (``kernels.ops.pack_lane``): lanes are tile-disjoint by
construction, so the cross-device merge is one tile-indexed
``index_copy_`` per iteration on the primary device.

    placement  — LPT lane→device assignment from the perf model's
                 per-lane estimates (Little/Big interleaved per device),
                 with the greedy balance bound and keep= re-placement
                 for streaming (a framework-free copy of the reference's)
    executor   — ShardedLanes materialization (upload to owners,
                 move/reuse accounting) + ShardedExecutor (each owner's
                 lanes on its device, one merge, Apply)

Entry points: ``api.compile(..., shard=...)``,
``GraphStore.executor(app, shard=...)`` and ``GraphStore.shard()``.
Streaming deltas re-place only dirty lanes and reuse resident payloads
for clean ones (``shards_moved`` / ``shard_bytes_moved`` in the apply
stats). The LM side's partitioning rules (the reference's
``sharding/specs.py``: DeviceMesh specs, DTensor placements) are
:mod:`repro_torch.sharding.specs`, imported by name.
"""
from .executor import (ShardedExecutor, ShardedLanes, materialize_sharded,
                       resolve_devices)
from .placement import LanePlacement, lane_estimates, place_lanes

__all__ = [
    "LanePlacement", "ShardedExecutor", "ShardedLanes", "lane_estimates",
    "materialize_sharded", "place_lanes", "resolve_devices",
]

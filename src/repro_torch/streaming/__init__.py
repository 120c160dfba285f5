"""Streaming graphs: delta updates with dirty-range incremental rebuild.

The static layers (GraphStore → Planner → Executor) prepare a graph
once; this package is the sanctioned way a prepared graph CHANGES.
A :class:`GraphDelta` (validated add/remove/update edge lists against a
base fingerprint) applied with :func:`apply_delta` re-partitions and
re-blocks only the dirty dst-range partitions, splices them into a
derived store, chains the snapshot fingerprint from
``(base_fp, delta_fp)``, and carries over every clean blocking and
every structurally-unchanged lane's device tensors — the packed form on
each device and every sharded form — without re-packing or re-upload.

Deltas can also GROW the vertex set (adds to ids >= V extend the tail of
the frozen DBG id space), long chains compact into one equivalent delta
with the original lineage preserved (:func:`compact_deltas`), and
grouping-quality decay under churn is measured (:func:`grouping_drift`)
and repaired by a re-registration (:func:`reregister`).

The port of the reference package's ``streaming``; deltas, fingerprints,
derived stores and their plans equal the reference's.
"""
from .apply import (BULK_THRESHOLD, DeltaApplyResult, apply_delta,
                    rebuild_plans, splice_delta)
from .delta import (GraphDelta, apply_delta_to_graph, chain_fingerprint,
                    compact_deltas, compose_deltas, edge_keys,
                    grown_num_vertices, make_delta, random_delta)
from .regroup import RegroupPolicy, grouping_drift, reregister

__all__ = [
    "BULK_THRESHOLD", "DeltaApplyResult", "GraphDelta", "RegroupPolicy",
    "apply_delta", "apply_delta_to_graph", "chain_fingerprint",
    "compact_deltas", "compose_deltas", "edge_keys", "grouping_drift",
    "grown_num_vertices", "make_delta", "random_delta", "rebuild_plans",
    "reregister", "splice_delta",
]

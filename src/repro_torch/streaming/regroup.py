"""DBG re-registration: grouping-quality drift and the regroup policy.

The port of the reference package's ``streaming/regroup.py``; host numpy
throughout, so drift and the re-registered store equal the reference's.

The streaming layer freezes the DBG permutation across a delta chain
(recomputing it would dirty every partition), and vertex growth appends
new vertices to the TAIL of the id space regardless of their degree.
Both decisions trade grouping quality for incrementality: after enough
churn, high-degree vertices no longer concentrate in the first
partitions and the planner's dense/sparse classification drifts away
from what a fresh degree-based grouping would produce.

:func:`grouping_drift` measures that decay — the edge-weighted
dense/sparse misclassification rate of the store's partitions against a
fresh DBG pass over the SAME graph. Past :class:`RegroupPolicy`'s
threshold a caller re-registers: :func:`reregister` builds a fresh-DBG
store carrying the SAME chained fingerprint, ready to be swapped in for
the old one. Results are unaffected: executors return properties in
ORIGINAL vertex ids, so two stores over the same edge set are
interchangeable (bit-identical for min/max apps; sum apps may differ by
reduction order, the same 1-ULP caveat a cold DBG rebuild has).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ..core import partition as part
from ..core import perf_model
from ..core.store import GraphStore
from ..graphs.formats import relabel

__all__ = ["RegroupPolicy", "grouping_drift", "reregister"]


@dataclasses.dataclass(frozen=True)
class RegroupPolicy:
    """When to check grouping drift, and when drift forces a regroup.

    drift_threshold: edge-weighted misclassification rate (see
        :func:`grouping_drift`) above which re-registration triggers.
    min_churn_frac:  cumulative changed-edge fraction (changes since the
        last registration / current E) below which the drift metric is
        not even computed — a drift check costs a DBG pass plus a
        partition pass (O(E log E)), so it must not run on every small
        delta.
    cooldown_s:      minimum wall-clock seconds between drift checks on
        one store key.
    sync:            run the re-registration inline in ``update()``
        instead of on a background thread (deterministic tests; the
        default keeps the update path latency-flat).
    hw:              perf-model profile the drift check classifies
        with (``None`` = ``perf_model.DEFAULT_HW``, the reference's
        planning constants). Deployments should pass the SAME profile
        their plans are built with — dense/sparse classification, and
        therefore drift, is profile-relative.
    """

    drift_threshold: float = 0.15
    min_churn_frac: float = 0.25
    cooldown_s: float = 0.0
    sync: bool = False
    hw: Optional[perf_model.HW] = None

    def __post_init__(self):
        if not (0.0 < self.drift_threshold):
            raise ValueError(f"drift_threshold must be > 0, got "
                             f"{self.drift_threshold}")
        if self.min_churn_frac < 0:
            raise ValueError(f"min_churn_frac must be >= 0, got "
                             f"{self.min_churn_frac}")

    def churn_ready(self, churn_edges: int, num_edges: int) -> bool:
        """True once cumulative churn justifies paying for a drift
        check."""
        return churn_edges >= self.min_churn_frac * max(num_edges, 1)


def grouping_drift(store: GraphStore, hw=None) -> dict:
    """Edge-weighted dense/sparse misclassification of the store's
    partitions vs a fresh DBG pass over its current graph.

    Both the frozen-perm layout and a fresh regrouping are partitioned
    into the same number of dst-range partitions (same V, same U), and
    position is meaningful under DBG — partition p is the p-th
    highest-degree block. Comparing the perf model's dense/sparse class
    at each position measures how far the dense frontier has drifted;
    weighting by the store's resident edge counts makes the metric "the
    fraction of resident edges whose partition the planner now
    classifies differently than a fresh grouping would".
    """
    store.require_padded("a grouping-drift check")
    hw = hw or perf_model.DEFAULT_HW
    geom = store.geom
    t0 = time.perf_counter()
    g = store.graph                       # current (frozen-perm) id space
    fresh_perm = part.dbg_permutation(g)
    fresh_g = relabel(g, fresh_perm, name_suffix="_redbg")
    fresh_infos, _ = part.partition_graph(fresh_g, geom)
    cur_infos = perf_model.classify(store.copy_infos(), geom, hw)
    perf_model.classify(fresh_infos, geom, hw)

    total = sum(i.num_edges for i in cur_infos)
    mismatched = [p for p, (a, b) in enumerate(zip(cur_infos, fresh_infos))
                  if a.is_dense != b.is_dense]
    drifted_edges = sum(cur_infos[p].num_edges for p in mismatched)
    return {
        "drift": (drifted_edges / total) if total else 0.0,
        "partitions": len(cur_infos),
        "mismatched_partitions": len(mismatched),
        "dense_current": sum(1 for i in cur_infos if i.is_dense),
        "dense_fresh": sum(1 for i in fresh_infos if i.is_dense),
        "t_drift_ms": (time.perf_counter() - t0) * 1e3,
    }


def reregister(store: GraphStore,
               fingerprint: Optional[str] = None) -> GraphStore:
    """Rebuild a store from scratch with a FRESH degree-based grouping,
    preserving its (chained) identity.

    The store's graph is mapped back to original vertex ids through the
    inverse of the frozen permutation, then a cold ``GraphStore`` build
    recomputes DBG, partitions and (lazily) blockings. Every plan
    config cached on the old store is re-planned eagerly so the swapped
    store serves warm. The returned store answers ``fingerprint()``
    with the OLD store's identity (or ``fingerprint=`` if given) — re-
    registration changes layout, never the snapshot a key addresses.
    """
    store.require_padded("regrouping")
    V = store.graph.num_vertices
    inv = np.empty(V, np.int32)
    inv[store.perm] = np.arange(V, dtype=np.int32)
    orig = relabel(store.graph, inv, name_suffix="_orig")
    fresh = GraphStore(orig, store.geom, use_dbg=store.use_dbg,
                       max_plans=store.max_plans,
                       fingerprint=fingerprint or store.fingerprint())
    with store._plan_lock:
        configs = [b.config for b in store._plan_cache.values()]
    for cfg in configs:
        fresh.plan(cfg)
    return fresh

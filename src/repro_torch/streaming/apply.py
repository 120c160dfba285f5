"""Incremental GraphStore rebuild under a GraphDelta (dirty ranges only).

The port of the reference package's ``streaming/apply.py``: the host
steps (1-3, 5) are the reference's numpy, so a derived store's edges,
stats and blockings are array-for-array equal to the reference's; step
4 carries device TENSORS over — the packed form on every device it was
materialized on, and every sharded form.

A cold :class:`~repro_torch.core.store.GraphStore` build pays DBG, a full
edge lexsort, per-partition stats, and (through the first plans) the
Little/Big brick blockings. A delta touches few destination-range
partitions, so :func:`apply_delta` redoes only those:

  1. map the delta's edges through the store's FROZEN permutation and
     bucket them by dst-range partition — the touched set is "dirty";
  2. merge the delta into the dirty segments. Two interchangeable
     merge paths produce bit-identical edges, chosen by the dirty
     fraction:
     *splice* — per-partition searchsorted insert/mask, no sort of
     clean data, wins when few partitions are dirty; *bulk sort* — one
     global lexsort of (kept dirty edges + adds), wins when churn is
     uniform and most partitions are dirty (per-partition splices then
     degenerate into many small sorts' worth of passes and lose to the
     single lexsort a cold rebuild would do). Above
     ``bulk_threshold`` dirty fraction the bulk path is taken, so
     incremental apply is never slower than a rebuild; the chosen path
     lands in ``DeltaApplyResult.stats["path"]``. Either way each dirty
     partition's :class:`PartitionInfo` is recomputed via the same
     helper the cold build uses;
  3. splice the new segments between the untouched ones (one
     concatenate per array — memcpy, not sort) into a *derived* store
     that shares the base's permutation and every clean blocking;
  4. rebuild each cached plan against the new stats (clean partitions
     keep bit-identical stats, so re-classification and re-scheduling
     are milliseconds) and seed structurally-unchanged lanes with the
     pre-delta packed device payloads, per device — untouched lanes are
     neither re-packed nor re-uploaded: the derived bundle holds the
     very same tensors. Sharded materializations carry over the
     same way, with clean lanes additionally PINNED to their owner
     device (only dirty lanes are re-placed by LPT around them);
     ``shards_moved`` / ``shard_bytes_moved`` account what transferred;
  5. chain the new snapshot fingerprint from ``(base_fp, delta_fp)``.

Vertex growth rides the same machinery: add edges referencing ids >= V
extend the vertex set, with new vertices mapped identity-wise onto the
TAIL of the frozen DBG id space (so every clean partition and blocking
survives untouched). Grown tail partitions are built purely from the
delta's adds; the one V-dependent stat (the last old partition's
``dst_hi``) is patched; ``V_pad`` and the extended permutation land on
the derived store so the lazy aux rebuilds correctly.

The permutation is frozen across a delta chain (recomputing DBG would
dirty every partition); under heavy churn DBG quality decays slowly and
a full re-registration re-optimizes it (see ``repro_torch.streaming.regroup``
for the drift metric and policy trigger). Equivalence guarantee: the
derived store's edge arrays, partition stats, blockings, plans and app
results are bit-identical to a cold ``GraphStore(post_graph,
perm=base.perm)`` build (``tests/test_torch_streaming.py`` holds this
for all five builtin apps on the plain path; ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` on the GAS kernel). A cold build
that recomputes DBG from the post-delta degrees may instead differ by
reduction order (1-ULP drift in 'sum' apps) — identical for min/or/max.

A carried-over payload is its lane's live-edge stream (a device
payload holds no padded array), and a fresh pack of the same lane
derives the same stream, taken from ``valid`` slot by slot, so the two
give the same tiles.

The base store is never mutated: in-flight executors keep running
against the old snapshot.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import partition as part
from ..core.store import GraphStore
from ..graphs.formats import Graph, freeze
from .delta import (GraphDelta, _validate_against, chain_fingerprint,
                    edge_keys, grown_num_vertices, locate_edges)

__all__ = ["apply_delta", "splice_delta", "rebuild_plans",
           "DeltaApplyResult", "BULK_THRESHOLD"]

# dirty-partition fraction above which the one-shot bulk lexsort beats
# per-partition splices (measured crossover is broad — splices lose
# badly at ~100% dirty, win badly at ~5%; 0.5 splits the flat middle)
BULK_THRESHOLD = 0.5


@dataclasses.dataclass
class DeltaApplyResult:
    """Outcome of one incremental apply: the derived store, its chained
    snapshot fingerprint, and the reuse/invalidation accounting the
    serving metrics aggregate."""

    store: GraphStore
    fingerprint: str
    base_fingerprint: str
    dirty_pids: Tuple[int, ...]
    stats: dict


def _orig_edge(store: GraphStore, s_dbg: int, d_dbg: int) -> str:
    """Original-id rendering of a DBG-space edge (error messages).
    Grown tail ids sit beyond the frozen permutation and map to
    themselves (growth extends the id space identity-wise)."""
    inv = np.argsort(store.perm)

    def _orig(i: int) -> int:
        return int(inv[i]) if i < inv.shape[0] else int(i)

    return f"({_orig(s_dbg)} -> {_orig(d_dbg)})"


def _merge_segment(store: GraphStore, s, d, w,
                   adds, removes, updates, weighted: bool):
    """Merge one dirty partition's delta into its (src, dst)-sorted
    segment. Pure searchsorted/mask/insert — O(segment + changes), no
    sort of pre-existing edges. Validates existence/absence exactly."""
    key = edge_keys(s, d)

    def _missing(what, ks, kd):
        return lambda i: (f"delta {what} targets edge "
                          f"{_orig_edge(store, int(ks[i]), int(kd[i]))} "
                          f"which is not in the base graph")

    w = w.copy()
    u_src, u_dst, u_w = updates
    if u_src.size:
        pos = locate_edges(key, edge_keys(u_src, u_dst),
                           _missing("update", u_src, u_dst))
        w[pos] = u_w

    keep = np.ones(key.shape[0], dtype=bool)
    r_src, r_dst = removes
    if r_src.size:
        pos = locate_edges(key, edge_keys(r_src, r_dst),
                           _missing("remove", r_src, r_dst))
        keep[pos] = False

    s_k, d_k, w_k = s[keep], d[keep], w[keep]
    a_src, a_dst, a_w = adds
    if a_src.size:
        ka = edge_keys(a_src, a_dst)
        order = np.argsort(ka)       # np.insert keeps given order within
        a_src, a_dst, ka = a_src[order], a_dst[order], ka[order]
        a_w = a_w[order] if weighted else np.zeros(a_src.shape[0],
                                                   np.float32)
        kept_key = key[keep]
        ins = np.searchsorted(kept_key, ka)
        if kept_key.size:
            at = np.minimum(ins, kept_key.shape[0] - 1)
            present = kept_key[at] == ka
            if np.any(present):
                i = int(np.argmax(present))
                raise ValueError(
                    f"delta adds edge "
                    f"{_orig_edge(store, int(a_src[i]), int(a_dst[i]))} "
                    f"which already exists in the base graph (use an "
                    f"update to change its weight)")
        s_k = np.insert(s_k, ins, a_src)
        d_k = np.insert(d_k, ins, a_dst)
        w_k = np.insert(w_k, ins, a_w)
    return s_k, d_k, w_k


def _merge_dirty_bulk(store, dirty_pids, adds, removes, updates,
                      weighted: bool) -> Dict[int, tuple]:
    """High-churn merge path: validate removes/updates per dirty
    partition (identical checks to :func:`_merge_segment`), then build
    the post-delta dirty edges with ONE global ``np.lexsort`` over
    (partition, src, dst) instead of per-partition splices. Returns
    ``pid -> (src, dst, weights)`` segments bit-identical to what the
    splice path produces (keys are unique, so the sort order is exactly
    the splice order)."""
    a_src, a_dst, a_w = adds
    r_src, r_dst, r_pid = removes
    u_src, u_dst, u_w, u_pid = updates
    U = store.geom.U

    def _missing(what, ks, kd):
        return lambda i: (f"delta {what} targets edge "
                          f"{_orig_edge(store, int(ks[i]), int(kd[i]))} "
                          f"which is not in the base graph")

    kept_s, kept_d, kept_w = [], [], []
    for p in dirty_pids:
        info = store.infos[p]
        lo, hi = info.edge_lo, info.edge_hi
        s = store.edges["src"][lo:hi]
        d = store.edges["dst"][lo:hi]
        w = store.edges["weights"][lo:hi]
        key = edge_keys(s, d)
        m_u = u_pid == p
        if np.any(m_u):
            su, du = u_src[m_u], u_dst[m_u]
            pos = locate_edges(key, edge_keys(su, du),
                               _missing("update", su, du))
            w = w.copy()
            w[pos] = u_w[m_u]
        m_r = r_pid == p
        if np.any(m_r):
            sr, dr = r_src[m_r], r_dst[m_r]
            pos = locate_edges(key, edge_keys(sr, dr),
                               _missing("remove", sr, dr))
            keep = np.ones(key.shape[0], dtype=bool)
            keep[pos] = False
            s, d, w, key = s[keep], d[keep], w[keep], key[keep]
        kept_s.append(s)
        kept_d.append(d)
        kept_w.append(w)

    # adds validated against the post-remove kept keys, like the splice
    # path ("already exists" must fire for true duplicates but not for
    # a removed-then-referenced slot — removes cannot coexist with adds
    # on one edge by delta construction, so kept keys are the oracle)
    if a_src.size:
        kept_key = np.concatenate(
            [edge_keys(s, d) for s, d in zip(kept_s, kept_d)]
            or [np.zeros(0, np.int64)])
        kept_key.sort()
        ka = edge_keys(a_src, a_dst)
        if kept_key.size:
            at = np.minimum(np.searchsorted(kept_key, ka),
                            kept_key.shape[0] - 1)
            present = kept_key[at] == ka
            if np.any(present):
                i = int(np.argmax(present))
                raise ValueError(
                    f"delta adds edge "
                    f"{_orig_edge(store, int(a_src[i]), int(a_dst[i]))} "
                    f"which already exists in the base graph (use an "
                    f"update to change its weight)")
    add_w = (a_w if (weighted and a_src.size)
             else np.zeros(a_src.shape[0], np.float32))

    all_s = np.concatenate(kept_s + [a_src])
    all_d = np.concatenate(kept_d + [a_dst])
    all_w = np.concatenate(kept_w + [add_w])
    pid = all_d // U
    order = np.lexsort((all_d, all_s, pid))     # (pid, src, dst) asc
    all_s, all_d, all_w, pid = (all_s[order], all_d[order], all_w[order],
                                pid[order])
    dirty_arr = np.asarray(dirty_pids, dtype=pid.dtype)
    los = np.searchsorted(pid, dirty_arr)
    his = np.searchsorted(pid, dirty_arr + 1)
    return {int(p): (all_s[lo:hi], all_d[lo:hi], all_w[lo:hi])
            for p, lo, hi in zip(dirty_pids, los, his)}


def _lane_signature(lane, big_works) -> tuple:
    """Structural identity of one lane's packed payload: the entry
    list's (work identity, block range) sequence. Payload content is a
    pure function of this plus the underlying blockings, so a matching
    signature over clean partitions means the packed device arrays are
    bit-identical and can be carried over without re-upload."""
    return tuple(
        ((("little", e.work_id) if e.kind == "little"
          else ("big",) + tuple(big_works[e.work_id].pids)),
         e.block_lo, e.block_hi)
        for e in lane)


def _lane_pids(lane, big_works) -> set:
    pids = set()
    for e in lane:
        if e.kind == "little":
            pids.add(e.work_id)
        else:
            pids.update(big_works[e.work_id].pids)
    return pids


def splice_delta(store: GraphStore, delta: GraphDelta, *,
                 bulk_threshold=BULK_THRESHOLD) -> DeltaApplyResult:
    """Steps 1–3 + 5 of the apply: merge the delta into the dirty
    segments (splice or bulk-sort path by dirty fraction), build the
    derived store, chain the fingerprint. Plan rebuild (step 4) is NOT
    done here — call :func:`rebuild_plans` against the base afterwards,
    or use :func:`apply_delta` which composes both.

    Split out so the numpy-heavy merge can run apart from the plan
    rebuild, which must run in the process that owns the base store's
    plan cache and device-resident payloads.

    ``bulk_threshold=None`` forces the splice path regardless of dirty
    fraction (parity tests pin one path against the other).
    """
    store.require_padded("applying a delta")
    t0 = time.perf_counter()
    base_fp = store.fingerprint()
    if delta.base_fp != base_fp:
        raise ValueError(
            f"delta targets snapshot {delta.base_fp[:12]}… but the store's "
            f"fingerprint is {base_fp[:12]}…")

    g = store.graph
    V = g.num_vertices
    weighted = g.weights is not None
    _validate_against(g, delta)   # range + weights-shape, shared oracle
    new_V = grown_num_vertices(V, delta)
    grown = new_V - V

    # -- 1. relabel into the frozen DBG id space & bucket by partition --
    perm, U = store.perm, store.geom.U
    if grown:
        # new vertices take the TAIL of the frozen DBG id space,
        # identity-mapped — the same place a cold rebuild under the
        # extended permutation puts them, so the frozen-perm invariant
        # (and every clean blocking) survives growth untouched
        perm = np.concatenate([perm, np.arange(V, new_V, dtype=np.int32)])
        perm.setflags(write=False)
    a_src, a_dst = perm[delta.add_src], perm[delta.add_dst]
    r_src, r_dst = perm[delta.remove_src], perm[delta.remove_dst]
    u_src, u_dst = perm[delta.update_src], perm[delta.update_dst]
    a_pid, r_pid, u_pid = a_dst // U, r_dst // U, u_dst // U
    dirty = np.unique(np.concatenate([a_pid, r_pid, u_pid]))
    dirty_set = set(int(p) for p in dirty)

    # -- 2./3. merge dirty segments, splice, recompute dirty stats -----
    num_parts = len(store.infos)
    new_num_parts = max(1, -(-new_V // U))
    # the splice-vs-bulk choice is about merging BASE segments, so the
    # dirty fraction counts old partitions only; grown tail partitions
    # have no base segment (their edges are purely the delta's adds)
    dirty_old = [int(p) for p in dirty if p < num_parts]
    dirty_fraction = (len(dirty_old) / num_parts) if num_parts else 0.0
    use_bulk = (bulk_threshold is not None and dirty_old
                and dirty_fraction >= bulk_threshold)
    if use_bulk:
        bulk_segs = _merge_dirty_bulk(
            store, dirty_old,
            (a_src, a_dst,
             delta.add_weights if weighted and delta.num_adds else None),
            (r_src, r_dst, r_pid),
            (u_src, u_dst, delta.update_weights, u_pid),
            weighted)
    empty_i, empty_f = np.zeros(0, np.int32), np.zeros(0, np.float32)
    seg_src: List[np.ndarray] = []
    seg_dst: List[np.ndarray] = []
    seg_w: List[np.ndarray] = []
    new_infos = []
    off = 0
    for p in range(new_num_parts):
        info = store.infos[p] if p < num_parts else None
        if p in dirty_set:
            if info is None:
                # grown tail partition: its segment is purely the
                # delta's adds, in the (src, dst) order the cold
                # build's global lexsort would produce
                m_a = a_pid == p
                s, d = a_src[m_a], a_dst[m_a]
                w = (delta.add_weights[m_a] if weighted
                     else np.zeros(s.shape[0], np.float32))
                order = np.lexsort((d, s))
                s, d, w = s[order], d[order], w[order]
            elif use_bulk:
                s, d, w = bulk_segs[p]
            else:
                lo, hi = info.edge_lo, info.edge_hi
                m_a, m_r, m_u = a_pid == p, r_pid == p, u_pid == p
                s, d, w = _merge_segment(
                    store,
                    store.edges["src"][lo:hi], store.edges["dst"][lo:hi],
                    store.edges["weights"][lo:hi],
                    (a_src[m_a], a_dst[m_a],
                     delta.add_weights[m_a] if weighted and delta.num_adds
                     else None),
                    (r_src[m_r], r_dst[m_r]),
                    (u_src[m_u], u_dst[m_u], delta.update_weights[m_u]),
                    weighted)
            new_infos.append(part.partition_info(p, s, d, off, new_V,
                                                 store.geom))
        elif info is None:
            # grown id range with no edges yet (grow_to growth): the
            # cold build still emits an empty partition info for it
            s, d, w = empty_i, empty_i, empty_f
            new_infos.append(part.partition_info(p, s, d, off, new_V,
                                                 store.geom))
        else:
            lo, hi = info.edge_lo, info.edge_hi
            s = store.edges["src"][lo:hi]
            d = store.edges["dst"][lo:hi]
            w = store.edges["weights"][lo:hi]
            # dst_hi is the one V-dependent stat: the last old partition
            # widens when growth lands inside its dst range (blockings
            # never read it, so they carry over bit-identical)
            new_infos.append(dataclasses.replace(
                info, edge_lo=off, edge_hi=off + (hi - lo),
                dst_hi=min((p + 1) * U, new_V)))
        seg_src.append(s)
        seg_dst.append(d)
        seg_w.append(w)
        off += s.shape[0]

    if dirty_set:
        edges = {"src": np.concatenate(seg_src),
                 "dst": np.concatenate(seg_dst),
                 "weights": np.concatenate(seg_w)}
        infos = new_infos
    elif grown:                # grow_to-only: edges shared, infos grown
        edges = store.edges
        infos = new_infos
    else:                      # empty delta: share everything
        edges = store.edges
        infos = list(store.infos)

    # the derived graph aliases the partition-sorted edge arrays
    # (zero-copy; NOT canonical (src, dst) order — use
    # apply_delta_to_graph for a canonical post-delta Graph). The store
    # only consumes it for order-independent quantities (V/E, degree
    # counts, byte accounting).
    new_graph = freeze(Graph(
        num_vertices=new_V, src=edges["src"], dst=edges["dst"],
        weights=edges["weights"] if weighted else None,
        name=g.name + "+d"))

    new_fp = chain_fingerprint(base_fp, delta.fingerprint())
    # snapshot under the plan lock: workers planning on the leased base
    # store insert blockings into these dicts concurrently (Planner.build
    # runs under the same lock), and iterating them bare would race
    with store._plan_lock:
        little_carried = {pid: w for pid, w in store._little_cache.items()
                          if pid not in dirty_set}
        big_carried = {pids: w for pids, w in store._big_cache.items()
                       if not (set(pids) & dirty_set)}
        n_little_base = len(store._little_cache)
        n_big_base = len(store._big_cache)
    t_splice = time.perf_counter() - t0

    new_store = GraphStore._derived(
        store, graph=new_graph, infos=infos, edges=edges,
        little_cache=little_carried, big_cache=big_carried,
        fingerprint=new_fp, t_partition=t_splice,
        perm=perm if grown else None,
        V_pad=(part.padded_num_vertices(new_V, store.geom) if grown
               else None))

    stats = {
        "num_adds": delta.num_adds,
        "num_removes": delta.num_removes,
        "num_updates": delta.num_updates,
        "partitions": new_num_parts,
        "grown_vertices": grown,
        "new_partitions": new_num_parts - num_parts,
        "dirty_partitions": len(dirty_set),
        "dirty_fraction": dirty_fraction,
        "path": "bulk_sort" if use_bulk else "splice",
        "little_blockings_reused": len(little_carried),
        "little_blockings_dropped": n_little_base - len(little_carried),
        "big_blockings_reused": len(big_carried),
        "big_blockings_dropped": n_big_base - len(big_carried),
        "t_splice_ms": t_splice * 1e3,
    }
    return DeltaApplyResult(store=new_store, fingerprint=new_fp,
                            base_fingerprint=base_fp,
                            dirty_pids=tuple(int(p) for p in dirty),
                            stats=stats)


def rebuild_plans(base_store: GraphStore, new_store: GraphStore,
                  dirty_pids, *,
                  rebalance_threshold: Optional[float] = None) -> dict:
    """Step 4 of the apply: rebuild every plan cached on ``base_store``
    against ``new_store``'s stats, seeding structurally-unchanged clean
    lanes with the pre-delta packed device payloads (and, for sharded
    forms, pinning clean lanes to their owner devices). Runs in the
    process that owns the base store's plan cache — the device payloads
    it carries over never cross a process boundary. Returns the
    plan-side stats dict that :func:`apply_delta` merges into
    :attr:`DeltaApplyResult.stats`.

    ``rebalance_threshold`` is the placement-drift bound: ``keep=``
    pinning trades balance for zero-move carry-over, and across a long
    delta chain the pinned placement can drift arbitrarily far from
    what a fresh LPT would choose. When a rebuilt sharded form's
    measured imbalance (max/mean device load) exceeds the bound, its
    pins are dropped and the lanes are re-placed (and re-uploaded) from
    scratch — the same observe/threshold/swap shape the autotuner uses
    for plans. ``None`` keeps pinning unconditionally."""
    dirty_set = set(int(p) for p in dirty_pids)
    t1 = time.perf_counter()
    with base_store._plan_lock:
        old_bundles = list(base_store._plan_cache.values())
    plans_rebuilt = 0
    packed_reused = packed_repacked = 0
    packed_bytes_reused = 0
    shards_moved = shards_reused = 0
    shard_bytes_moved = shard_bytes_reused = 0
    placements_rebalanced = 0
    worst_imbalance = 0.0
    for old in old_bundles:
        bundle = new_store.plan(old.config)
        plans_rebuilt += 1
        old_packed = dict(old._packed_lanes)  # device -> packed lanes
        old_sharded = dict(old._sharded)
        if not old_packed and not old_sharded:
            continue                          # base never materialized any
        sig_to_lane = {}
        for j, lane in enumerate(old.plan.lanes):
            sig = _lane_signature(lane, old.big_works)
            if sig:                           # empty lanes pack for free
                sig_to_lane.setdefault(sig, j)

        # (new lane idx, old lane idx) pairs whose entry structure
        # survived re-scheduling and touch no dirty partition — the
        # lanes whose device payloads are bit-identical pre/post.
        # Computed once; the packed and every sharded form reuse it.
        matches = []
        for i, lane in enumerate(bundle.plan.lanes):
            sig = _lane_signature(lane, bundle.big_works)
            j = sig_to_lane.get(sig)
            if (j is not None
                    and not (_lane_pids(lane, bundle.big_works)
                             & dirty_set)):
                matches.append((i, j))

        # packed forms, one per device: each device's seed holds only
        # that device's tensors
        for dev, old_lanes in old_packed.items():
            n0 = bundle.packed_lanes_reused
            b0 = bundle.packed_bytes_reused
            packed = bundle.packed_lanes(    # eager: keep serving warm
                dev, reuse={i: old_lanes[j] for i, j in matches} or None)
            n_reused = bundle.packed_lanes_reused - n0
            packed_reused += n_reused
            packed_bytes_reused += bundle.packed_bytes_reused - b0
            packed_repacked += sum(1 for lane in packed if lane) - n_reused
        # sharded forms: clean lanes KEEP their owner device (only dirty
        # lanes are re-placed by LPT around them) and their resident
        # per-device payloads are spliced in without re-transfer
        for devices, old_sh in old_sharded.items():
            keep, sseed = {}, {}
            for i, j in matches:
                keep[i] = old_sh.placement.device_of_lane[j]
                sseed[i] = old_sh.lanes[j]
            new_sh = bundle.sharded_lanes(         # eager, like packed
                devices, keep=keep, seed=sseed)
            if (rebalance_threshold is not None
                    and new_sh.placement.needs_rebalance(
                        rebalance_threshold)):
                # pinned placement drifted past the bound: drop the
                # memoized form and re-place every lane by fresh LPT
                # (payloads re-upload — the cost rebalancing amortizes)
                with bundle._mat_lock:
                    bundle._sharded.pop(devices, None)
                new_sh = bundle.sharded_lanes(devices)   # no pins, no seed
                placements_rebalanced += 1
            worst_imbalance = max(worst_imbalance,
                                  new_sh.placement.imbalance)
            shards_moved += new_sh.moved
            shard_bytes_moved += new_sh.bytes_moved
            shards_reused += new_sh.reused
            shard_bytes_reused += new_sh.bytes_reused
    t_replan = time.perf_counter() - t1

    return {
        "plans_rebuilt": plans_rebuilt,
        "packed_lanes_reused": packed_reused,
        "packed_lanes_repacked": packed_repacked,
        "packed_bytes_reused": int(packed_bytes_reused),
        "shards_moved": shards_moved,
        "shard_bytes_moved": int(shard_bytes_moved),
        "shards_reused": shards_reused,
        "shard_bytes_reused": int(shard_bytes_reused),
        "placements_rebalanced": placements_rebalanced,
        "placement_imbalance": float(worst_imbalance),
        "t_replan_ms": t_replan * 1e3,
    }


def apply_delta(store: GraphStore, delta: GraphDelta, *,
                bulk_threshold=BULK_THRESHOLD,
                rebalance_threshold: Optional[float] = None
                ) -> DeltaApplyResult:
    """Apply a :class:`GraphDelta` to a prepared store incrementally.

    Returns a :class:`DeltaApplyResult` whose ``store`` is a NEW
    derived :class:`GraphStore` (the base is left untouched as the old
    snapshot) and whose ``stats`` record the merge path taken
    (``"splice"`` vs ``"bulk_sort"``, by dirty fraction against
    ``bulk_threshold``) and exactly what was reused: blockings and
    per-partition stats of clean partitions, and — for every plan
    cached on the base — the packed device payloads of lanes whose
    structure survived re-scheduling.
    """
    t0 = time.perf_counter()
    res = splice_delta(store, delta, bulk_threshold=bulk_threshold)
    res.stats.update(rebuild_plans(
        store, res.store, res.dirty_pids,
        rebalance_threshold=rebalance_threshold))
    res.stats["t_apply_ms"] = (time.perf_counter() - t0) * 1e3
    return res

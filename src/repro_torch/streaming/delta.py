"""GraphDelta — the validated edge-update format for streaming graphs.

A framework-free copy of the reference package's ``streaming/delta.py``:
deltas, their fingerprints and chained snapshot fingerprints are
byte-equal to the reference's, so the two packages name one lineage.

A delta names the snapshot it applies to (``base_fp``) and carries three
strictly-disjoint edge lists in ORIGINAL vertex ids:

  * adds     — edges that must NOT exist in the base graph,
  * removes  — edges that MUST exist,
  * updates  — weight changes to edges that MUST exist (weighted only).

Strictness is the point: a delta is a claim about a specific snapshot,
so applying it anywhere else (wrong fingerprint, missing edge, already-
present edge) fails loudly instead of silently diverging replicas. The
same-edge-in-two-lists case is rejected at construction — a weight
change is an ``update``, never a remove+add pair — which keeps apply
order-independent.

Snapshot identities chain: ``chain_fingerprint(base_fp, delta_fp)``
names the post-delta snapshot WITHOUT re-hashing the full edge list.
Chained fingerprints live in the same namespace the serving layer keys
stores on, but differ from the content hash of the materialized
post-delta graph — a delta chain is an identity lineage, not a content
address (two different edit paths to the same edge set get different
fingerprints, exactly like git commits).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

import numpy as np

from ..graphs.formats import Graph

__all__ = ["GraphDelta", "make_delta", "chain_fingerprint",
           "apply_delta_to_graph", "random_delta", "edge_keys",
           "grown_num_vertices", "compose_deltas", "compact_deltas"]


def edge_keys(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Combined int64 key ``(src << 32) | dst`` — order-isomorphic to
    (src, dst) lexicographic order for non-negative int32 ids, so a
    (src, dst)-sorted edge list has strictly-increasing keys and
    ``np.searchsorted`` locates edges exactly."""
    return (src.astype(np.int64) << 32) | dst.astype(np.int64)


def locate_edges(key: np.ndarray, k: np.ndarray, describe) -> np.ndarray:
    """Positions of every key in ``k`` within the strictly-ascending
    ``key`` array; raises ``ValueError(describe(i))`` naming the first
    key that is absent. The single existence-check used by BOTH apply
    paths (oracle removes/updates and the incremental per-partition
    merge), so the boundary handling can never diverge between them."""
    pos = np.searchsorted(key, k)
    ok = ((pos < key.shape[0])
          & (key[np.minimum(pos, max(key.shape[0] - 1, 0))] == k)
          if key.size else np.zeros(k.shape[0], dtype=bool))
    if not np.all(ok):
        raise ValueError(describe(int(np.argmin(ok))))
    return pos


def _own(a, dtype) -> np.ndarray:
    """Contiguous COPY of the input: make_delta freezes its arrays, and
    freezing must never reach back into a caller-owned buffer (an
    ascontiguousarray that happens to be a no-op would)."""
    return np.array(a, dtype=dtype, copy=True)


def _as_edge_arrays(edges, what: str) -> Tuple[np.ndarray, np.ndarray]:
    src = _own(edges[0], np.int32)
    dst = _own(edges[1], np.int32)
    if src.ndim != 1 or src.shape != dst.shape:
        raise ValueError(f"{what} src/dst must be equal-length 1-D arrays, "
                         f"got shapes {src.shape} and {dst.shape}")
    if src.size and (src.min() < 0 or dst.min() < 0):
        raise ValueError(f"{what} contains negative vertex ids")
    return src, dst


@dataclasses.dataclass(frozen=True, eq=False)
class GraphDelta:
    """A validated set of edge changes against one base snapshot.

    Construct via :func:`make_delta` (which normalizes dtypes, checks
    the disjointness invariants and freezes the arrays); the raw
    dataclass exists so deltas can be serialized/deserialized
    field-by-field. ``eq=False``: dataclass-generated equality would
    compare ndarray fields elementwise (raising on bool coercion) —
    deltas compare by identity; use :meth:`fingerprint` for value
    comparison (it is also the hashable stand-in for dict/set keys).
    """

    base_fp: str
    add_src: np.ndarray
    add_dst: np.ndarray
    add_weights: Optional[np.ndarray]
    remove_src: np.ndarray
    remove_dst: np.ndarray
    update_src: np.ndarray
    update_dst: np.ndarray
    update_weights: np.ndarray
    # vertex-growth floor: the post-delta graph has at least this many
    # vertices even when no surviving add references them (a composed
    # grow-then-remove must still grow V). None = growth is implied by
    # the add lists alone (ids >= base V extend the vertex set).
    grow_to: Optional[int] = None

    @property
    def num_adds(self) -> int:
        return int(self.add_src.shape[0])

    @property
    def num_removes(self) -> int:
        return int(self.remove_src.shape[0])

    @property
    def num_updates(self) -> int:
        return int(self.update_src.shape[0])

    @property
    def num_changes(self) -> int:
        return self.num_adds + self.num_removes + self.num_updates

    def max_vertex(self) -> int:
        """Largest vertex id referenced (-1 when empty)."""
        return int(max(
            (int(a.max()) for a in (self.add_src, self.add_dst,
                                    self.remove_src, self.remove_dst,
                                    self.update_src, self.update_dst)
             if a.size), default=-1))

    def fingerprint(self) -> str:
        """Stable content hash of the delta (base_fp included, so the
        same edit against two snapshots hashes differently)."""
        cached = getattr(self, "_fp_cache", None)
        if cached is not None:
            return cached
        h = hashlib.blake2b(digest_size=16)
        h.update(f"delta;base={self.base_fp};"
                 f"a={self.num_adds};r={self.num_removes};"
                 f"u={self.num_updates};".encode())
        for a in (self.add_src, self.add_dst, self.remove_src,
                  self.remove_dst, self.update_src, self.update_dst):
            h.update(a.tobytes())
        h.update(b";aw=" + (b"none" if self.add_weights is None
                            else self.add_weights.tobytes()))
        h.update(b";uw=" + self.update_weights.tobytes())
        if self.grow_to is not None:   # absent -> legacy digest unchanged
            h.update(f";g={self.grow_to}".encode())
        fp = h.hexdigest()
        object.__setattr__(self, "_fp_cache", fp)
        return fp


def make_delta(base_fp: str, add=None, remove=None, update=None,
               grow_to: Optional[int] = None) -> GraphDelta:
    """Build a validated :class:`GraphDelta`.

    Parameters
    ----------
    base_fp: fingerprint of the snapshot this delta applies to (a graph
        content hash or a chained streaming fingerprint).
    add:    ``(src, dst)`` or ``(src, dst, weights)`` arrays of edges to
        insert. Weights are required iff the base graph is weighted
        (checked at apply time — the delta itself doesn't see the base).
        Ids at or beyond the base vertex count GROW the vertex set (new
        vertices extend the tail of the frozen DBG id space).
    remove: ``(src, dst)`` arrays of edges to delete.
    update: ``(src, dst, weights)`` arrays of weight changes.
    grow_to: optional floor on the post-delta vertex count (see
        :attr:`GraphDelta.grow_to`); ids below the base count are
        harmless — the apply takes ``max(V, ...)``.

    Raises ``ValueError`` on duplicate edges within a list or the same
    edge appearing in two lists (remove+add of one edge is expressed as
    an ``update``).
    """
    if not isinstance(base_fp, str) or not base_fp:
        raise ValueError(f"base_fp must be a non-empty fingerprint string, "
                         f"got {base_fp!r}")
    if grow_to is not None:
        grow_to = int(grow_to)
        if grow_to < 0:
            raise ValueError(f"grow_to must be >= 0, got {grow_to}")
    empty_i = np.zeros(0, np.int32)
    empty_f = np.zeros(0, np.float32)

    a_src, a_dst, a_w = empty_i, empty_i, None
    if add is not None:
        a_src, a_dst = _as_edge_arrays(add, "add")
        if len(add) > 2 and add[2] is not None:
            a_w = _own(add[2], np.float32)
            if a_w.shape != a_src.shape:
                raise ValueError("add weights must match add src/dst length")
    r_src, r_dst = (_as_edge_arrays(remove, "remove") if remove is not None
                    else (empty_i, empty_i))
    if update is not None:
        if len(update) < 3:
            raise ValueError("update needs (src, dst, weights)")
        u_src, u_dst = _as_edge_arrays(update[:2], "update")
        u_w = _own(update[2], np.float32)
        if u_w.shape != u_src.shape:
            raise ValueError("update weights must match update src/dst "
                             "length")
    else:
        u_src, u_dst, u_w = empty_i, empty_i, empty_f

    ka, kr, ku = (edge_keys(a_src, a_dst), edge_keys(r_src, r_dst),
                  edge_keys(u_src, u_dst))
    for name, k in (("add", ka), ("remove", kr), ("update", ku)):
        if np.unique(k).shape[0] != k.shape[0]:
            raise ValueError(f"duplicate edges in the {name} list")
    for (na, A), (nb, B) in ((("add", ka), ("remove", kr)),
                             (("add", ka), ("update", ku)),
                             (("remove", kr), ("update", ku))):
        if A.size and B.size and np.intersect1d(A, B).size:
            raise ValueError(
                f"the same edge appears in both the {na} and {nb} lists "
                f"(express a weight change as an update, not remove+add)")

    for a in (a_src, a_dst, r_src, r_dst, u_src, u_dst, u_w):
        a.setflags(write=False)
    if a_w is not None:
        a_w.setflags(write=False)
    return GraphDelta(base_fp=base_fp, add_src=a_src, add_dst=a_dst,
                      add_weights=a_w, remove_src=r_src, remove_dst=r_dst,
                      update_src=u_src, update_dst=u_dst, update_weights=u_w,
                      grow_to=grow_to)


def chain_fingerprint(base_fp: str, delta_fp: str) -> str:
    """Fingerprint of the post-delta snapshot, chained from the base
    identity and the delta's content hash — O(1), no re-hash of the
    full edge list. Same digest width as graph content fingerprints, so
    the serving layer keys stores on either interchangeably."""
    h = hashlib.blake2b(digest_size=16)
    h.update(f"chain;{base_fp};{delta_fp}".encode())
    return h.hexdigest()


def grown_num_vertices(num_vertices: int, delta: GraphDelta) -> int:
    """Vertex count of the post-delta graph. Add edges referencing ids
    at or beyond the base count grow the vertex set (intermediate ids
    materialize as zero-degree vertices), and :attr:`GraphDelta.grow_to`
    floors the result so a composed grow-then-remove still grows.
    Removes and updates can never grow (enforced by
    :func:`_validate_against`)."""
    mv = -1
    if delta.add_src.size:
        mv = max(int(delta.add_src.max()), int(delta.add_dst.max()))
    return max(int(num_vertices), mv + 1, int(delta.grow_to or 0))


def _validate_against(graph: Graph, delta: GraphDelta) -> None:
    """Weights-shape and vertex-range checks shared by both apply paths
    (per-edge existence checks happen inside each path, where the keyed
    arrays already exist). Adds may reference ids >= the base vertex
    count — that is the vertex-growth path — but removes/updates target
    edges that MUST already exist, so out-of-range ids there are
    errors."""
    mv = max((int(a.max()) for a in (delta.remove_src, delta.remove_dst,
                                     delta.update_src, delta.update_dst)
              if a.size), default=-1)
    if mv >= graph.num_vertices:
        raise ValueError(
            f"delta remove/update references vertex {mv} but the base "
            f"graph has only {graph.num_vertices} vertices (vertex growth "
            f"happens through the add list — or grow_to= — and only adds "
            f"may reference new ids)")
    weighted = graph.weights is not None
    if weighted and delta.num_adds and delta.add_weights is None:
        raise ValueError("base graph is weighted: adds must carry weights")
    if not weighted and delta.add_weights is not None:
        raise ValueError("base graph is unweighted: adds must not carry "
                         "weights")
    if not weighted and delta.num_updates:
        raise ValueError("base graph is unweighted: weight updates are "
                         "invalid")


def apply_delta_to_graph(graph: Graph, delta: GraphDelta,
                         check_fp: bool = True) -> Graph:
    """Plain (non-incremental) application: returns the canonical
    post-delta :class:`Graph`. This is the semantic oracle the
    incremental store path (:func:`repro_torch.streaming.apply_delta`) is
    tested against, and what the serving layer replays to rebuild an
    evicted store from a delta chain.

    ``check_fp=False`` skips the base-fingerprint match — chain
    replays track identity themselves (a chained fp never equals the
    materialized graph's content hash).
    """
    if check_fp and delta.base_fp != graph.fingerprint():
        raise ValueError(
            f"delta targets snapshot {delta.base_fp[:12]}… but the graph's "
            f"fingerprint is {graph.fingerprint()[:12]}…")
    _validate_against(graph, delta)
    weighted = graph.weights is not None

    key = edge_keys(graph.src, graph.dst)   # canonical order -> ascending
    kr = edge_keys(delta.remove_src, delta.remove_dst)
    ku = edge_keys(delta.update_src, delta.update_dst)
    ka = edge_keys(delta.add_src, delta.add_dst)

    def _locate(k: np.ndarray, what: str) -> np.ndarray:
        return locate_edges(key, k, lambda i: (
            f"delta {what} targets edge "
            f"({int(k[i] >> 32)} -> {int(k[i] & 0xFFFFFFFF)}) which is "
            f"not in the base graph"))

    weights = graph.weights.copy() if weighted else None
    if ku.size:
        weights[_locate(ku, "update")] = delta.update_weights
    keep = np.ones(key.shape[0], dtype=bool)
    if kr.size:
        keep[_locate(kr, "remove")] = False
    if ka.size and key.size:
        pos = np.minimum(np.searchsorted(key, ka), key.shape[0] - 1)
        present = (key[pos] == ka) & keep[pos]
        if np.any(present):
            i = int(np.argmax(present))
            raise ValueError(
                f"delta adds edge ({int(ka[i] >> 32)} -> "
                f"{int(ka[i] & 0xFFFFFFFF)}) which already exists in the "
                f"base graph (use an update to change its weight)")

    src = np.concatenate([graph.src[keep], delta.add_src])
    dst = np.concatenate([graph.dst[keep], delta.add_dst])
    aw = (delta.add_weights if delta.add_weights is not None
          else np.zeros(delta.num_adds, np.float32))   # add-free delta
    w = np.concatenate([weights[keep], aw]) if weighted else None
    from ..graphs.formats import from_edges
    return from_edges(src, dst,
                      num_vertices=grown_num_vertices(graph.num_vertices,
                                                      delta),
                      weights=w, name=graph.name, dedup=False)


def random_delta(graph: Graph, churn: float = 0.01, seed: int = 0,
                 base_fp: Optional[str] = None,
                 update_frac: float = 0.0,
                 hot_frac: Optional[float] = None,
                 grow_frac: float = 0.0) -> GraphDelta:
    """Synthesize an edge-churn delta: ``churn * E`` total changes,
    half removals of existing edges and half insertions of non-edges
    (plus optionally ``update_frac * E`` weight updates on a weighted
    graph). ``base_fp`` defaults to the graph's content fingerprint;
    pass the chained fingerprint when generating churn against a
    streamed snapshot.

    ``hot_frac`` models how evolving power-law graphs actually churn:
    preferential attachment concentrates new/retired edges on the top
    ``hot_frac`` fraction of vertices by in-degree. Because DBG groups
    exactly those vertices into the first dst-range partitions, skewed
    churn keeps the dirty partition set small — the locality
    :func:`~repro_torch.streaming.apply_delta` exploits. ``None`` = uniform
    destinations (the no-locality worst case: every partition goes
    dirty once changes outnumber partitions).

    ``grow_frac`` emits ``grow_frac * E`` additional edges to
    OUT-OF-RANGE vertex ids (ids >= V), exercising the vertex-growth
    path: new vertices take the tail of the id space and attach
    preferentially — sources are drawn by out-degree (sampling edge
    endpoints), and later growth edges concentrate on the earlier new
    vertices, the usual rich-get-richer arrival model."""
    rng = np.random.default_rng(seed)
    E, V = graph.num_edges, graph.num_vertices
    n_half = max(1, int(E * churn / 2))
    weighted = graph.weights is not None

    if hot_frac:
        k = max(1, int(V * hot_frac))
        ind = graph.in_degrees()
        hot = np.argpartition(ind, -k)[-k:]        # top-k by in-degree
        rm_pool = np.flatnonzero(np.isin(graph.dst, hot))
    else:
        hot = None
        rm_pool = np.arange(E)

    rm_idx = rng.choice(rm_pool, size=min(n_half, rm_pool.shape[0]),
                        replace=False)
    remove = (graph.src[rm_idx], graph.dst[rm_idx])

    # vectorized non-edge sampling: membership via searchsorted on the
    # sorted key array (no O(E) Python set). Bounded: a (near-)saturated
    # candidate space (e.g. a star hub already fed by every vertex)
    # yields fewer adds instead of spinning forever — the delta stays
    # valid either way.
    base_keys = np.sort(edge_keys(graph.src, graph.dst))
    got_s, got_d = [], []
    picked_keys = np.zeros(0, np.int64)
    stalled, n_picked = 0, 0
    while n_picked < n_half and stalled < 16:
        cs = rng.integers(0, V, size=4 * n_half)
        cd = (rng.choice(hot, size=4 * n_half) if hot is not None
              else rng.integers(0, V, size=4 * n_half))
        ok = cs != cd
        cand_s = cs[ok].astype(np.int32)
        cand_d = cd[ok].astype(np.int32)
        k, first = np.unique(edge_keys(cand_s, cand_d),
                             return_index=True)
        cand_s, cand_d = cand_s[first], cand_d[first]
        pos = np.minimum(np.searchsorted(base_keys, k),
                         max(base_keys.size - 1, 0))
        fresh = (base_keys[pos] != k if base_keys.size
                 else np.ones(k.shape[0], dtype=bool))
        if picked_keys.size:
            fresh &= ~np.isin(k, picked_keys)
        sel = np.flatnonzero(fresh)[:n_half - n_picked]
        if sel.size:
            got_s.append(cand_s[sel])
            got_d.append(cand_d[sel])
            picked_keys = np.concatenate([picked_keys, k[sel]])
            n_picked += sel.size
            stalled = 0
        else:
            stalled += 1
    a_src = (np.concatenate(got_s) if got_s else np.zeros(0, np.int32))
    a_dst = (np.concatenate(got_d) if got_d else np.zeros(0, np.int32))

    grow_to = None
    if grow_frac > 0 and E:
        n_grow = max(1, int(E * grow_frac))
        n_new = max(1, n_grow // 2)
        new_ids = np.arange(V, V + n_new, dtype=np.int32)
        # sources by preferential attachment: sampling edge slots picks
        # a vertex with probability proportional to its out-degree
        g_src = graph.src[rng.integers(0, E, size=n_grow)].astype(np.int32)
        # every new vertex gets at least one in-edge; the surplus lands
        # on the earliest arrivals (rich-get-richer within the batch)
        extra = (new_ids[rng.integers(0, max(1, n_new // 2),
                                      size=n_grow - n_new)]
                 if n_grow > n_new else np.zeros(0, np.int32))
        g_dst = np.concatenate([new_ids, extra])
        _, first = np.unique(edge_keys(g_src, g_dst), return_index=True)
        sel = np.sort(first)                  # dedupe, keep arrival order
        a_src = np.concatenate([a_src, g_src[sel]])
        a_dst = np.concatenate([a_dst, g_dst[sel]])
        grow_to = V + n_new
    add = ((a_src, a_dst, rng.random(a_src.shape[0]).astype(np.float32))
           if weighted else (a_src, a_dst))

    update = None
    if weighted and update_frac > 0:
        candidates = np.setdiff1d(rm_pool, rm_idx)
        n_upd = min(max(1, int(E * update_frac)), candidates.shape[0])
        if n_upd:
            up_idx = rng.choice(candidates, size=n_upd, replace=False)
            update = (graph.src[up_idx], graph.dst[up_idx],
                      rng.random(n_upd).astype(np.float32))

    return make_delta(base_fp or graph.fingerprint(), add=add,
                      remove=remove, update=update, grow_to=grow_to)


def compose_deltas(first: GraphDelta, second: GraphDelta) -> GraphDelta:
    """One delta equivalent to applying ``first`` then ``second``.

    Per-edge-key resolution against the shared base snapshot:
    add+remove cancels, add+update keeps the add with the new weight,
    remove+add becomes an update (weighted) or cancels (unweighted —
    the identical edge is restored), update+update keeps the last
    weight, update+remove collapses to the remove. Combinations that
    could never have applied in sequence (adding an edge that exists
    post-``first``, removing/updating one that doesn't) raise — the
    inputs are assumed to be a VALID chain, and composition surfaces
    corruption instead of hiding it.

    The composed ``grow_to`` covers every vertex either delta could
    have created, so grow-then-remove still grows the vertex set (the
    floor is taken under ``max`` with the base count, so ids below it
    are harmless). ``base_fp`` is ``first``'s — the composed delta
    applies where ``first`` did. Its chained fingerprint differs from
    the original chain's tip (a different edit path); callers that
    compact a chain keep the ORIGINAL tip identity (see
    :func:`compact_deltas`).
    """
    weighted = (first.add_weights is not None
                or second.add_weights is not None
                or first.num_updates > 0 or second.num_updates > 0)

    state = {}   # edge key -> ("A"|"R"|"U", weight) relative to the base
    aw1 = (first.add_weights if first.add_weights is not None
           else np.zeros(first.num_adds, np.float32))
    for k, w in zip(edge_keys(first.add_src, first.add_dst), aw1):
        state[int(k)] = ("A", float(w))
    for k in edge_keys(first.remove_src, first.remove_dst):
        state[int(k)] = ("R", 0.0)
    for k, w in zip(edge_keys(first.update_src, first.update_dst),
                    first.update_weights):
        state[int(k)] = ("U", float(w))

    def _edge(k):
        return f"({k >> 32} -> {k & 0xFFFFFFFF})"

    aw2 = (second.add_weights if second.add_weights is not None
           else np.zeros(second.num_adds, np.float32))
    for k, w in zip(edge_keys(second.add_src, second.add_dst), aw2):
        k = int(k)
        prev = state.get(k)
        if prev is None:
            state[k] = ("A", float(w))
        elif prev[0] == "R":
            if weighted:
                state[k] = ("U", float(w))   # remove+re-add = weight change
            else:
                del state[k]                 # identical edge restored
        else:
            raise ValueError(f"compose: second delta adds edge {_edge(k)} "
                             f"which exists after the first delta")
    for k in edge_keys(second.remove_src, second.remove_dst):
        k = int(k)
        prev = state.get(k)
        if prev is None:
            state[k] = ("R", 0.0)
        elif prev[0] == "A":
            del state[k]                     # added then removed: no-op
        elif prev[0] == "U":
            state[k] = ("R", 0.0)
        else:
            raise ValueError(f"compose: second delta removes edge "
                             f"{_edge(k)} which the first already removed")
    for k, w in zip(edge_keys(second.update_src, second.update_dst),
                    second.update_weights):
        k = int(k)
        prev = state.get(k)
        if prev is None or prev[0] == "U":
            state[k] = ("U", float(w))
        elif prev[0] == "A":
            state[k] = ("A", float(w))
        else:
            raise ValueError(f"compose: second delta updates edge "
                             f"{_edge(k)} which the first removed")

    adds, removes, updates = [], [], []
    for k in sorted(state):
        op, w = state[k]
        (adds if op == "A" else removes if op == "R" else updates).append(
            (k >> 32, k & 0xFFFFFFFF, w))

    def _cols(rows):
        s = np.array([r[0] for r in rows], np.int32)
        d = np.array([r[1] for r in rows], np.int32)
        w = np.array([r[2] for r in rows], np.float32)
        return s, d, w

    a_s, a_d, a_w = _cols(adds)
    r_s, r_d, _ = _cols(removes)
    u_s, u_d, u_w = _cols(updates)
    grow_to = max(int(first.grow_to or 0), int(second.grow_to or 0),
                  first.max_vertex() + 1, second.max_vertex() + 1)
    return make_delta(
        first.base_fp,
        add=((a_s, a_d, a_w) if weighted else (a_s, a_d)),
        remove=(r_s, r_d),
        update=((u_s, u_d, u_w) if len(updates) else None),
        grow_to=(grow_to if grow_to > 0 else None))


def compact_deltas(deltas, strict: bool = True):
    """Squash a contiguous delta chain into ONE equivalent delta.

    Returns ``(composed, tip_fp)`` where ``tip_fp`` is the chain's
    ORIGINAL tip fingerprint — ``chain_fingerprint`` folded over the
    input deltas. Compaction changes the replay (one delta instead of
    N) but must not change the snapshot's identity, so callers keep
    addressing the compacted snapshot by ``tip_fp``, never by
    re-chaining the composed delta.

    ``strict`` verifies lineage: every delta's ``base_fp`` must equal
    the chained fingerprint its predecessor produced.
    """
    deltas = list(deltas)
    if not deltas:
        raise ValueError("compact_deltas needs at least one delta")
    out = deltas[0]
    tip = chain_fingerprint(out.base_fp, out.fingerprint())
    for d in deltas[1:]:
        if strict and d.base_fp != tip:
            raise ValueError(
                f"delta chain is not contiguous: delta targets snapshot "
                f"{d.base_fp[:12]}… but the chain's tip is {tip[:12]}…")
        out = compose_deltas(out, d)
        tip = chain_fingerprint(tip, d.fingerprint())
    return out, tip

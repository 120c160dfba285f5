"""Graph partitioning, degree-based grouping, and brick blocking.

Mirrors ReGraph §II-A (dst-range partitioning of src-sorted COO + DBG) and
the reference package's brick layout: edges are re-sorted per partition by
(dst-tile, src-window, src) and padded into E_BLK blocks that are
homogeneous in (src window, dst tile), so every block feeds exactly one
output tile of the GAS kernel. Host numpy, copied from the reference so
blockings stay array-for-array equal. Complexity O(E log E) (sorts).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..graphs.formats import Graph, relabel
from .types import BlockedEdges, Geometry, PartitionInfo


# ---------------------------------------------------------------------------
# Degree-based grouping (DBG) — Faldu et al. [12], used by the paper to
# concentrate high-in-degree vertices into the first (dense) partitions.
# ---------------------------------------------------------------------------

def dbg_permutation(g: Graph) -> np.ndarray:
    """perm[old_id] = new_id. Vertices grouped by floor(log2(in_deg+1)),
    groups ordered by descending degree, original order kept inside a group
    (stable → preserves whatever locality the original ids had)."""
    ind = g.in_degrees()
    group = np.floor(np.log2(ind + 1)).astype(np.int64)
    # stable argsort on descending group
    order = np.argsort(-group, kind="stable")
    perm = np.empty(g.num_vertices, dtype=np.int32)
    perm[order] = np.arange(g.num_vertices, dtype=np.int32)
    return perm


def apply_dbg(g: Graph) -> Tuple[Graph, np.ndarray]:
    perm = dbg_permutation(g)
    return relabel(g, perm), perm


# ---------------------------------------------------------------------------
# Destination-range partitioning (paper Fig. 1): partition i owns dst in
# [i*U, (i+1)*U); edge lists kept src-sorted inside each partition.
# ---------------------------------------------------------------------------

def partition_info(pid: int, s: np.ndarray, d: np.ndarray, edge_lo: int,
                   num_vertices: int, geom: Geometry) -> PartitionInfo:
    """Stats of one dst-range partition from its (src, dst)-sorted
    segment arrays. The single source of truth for partition stats:
    both the cold build (:func:`partition_graph`) and the streaming
    dirty-partition rebuild of the reference's streaming layer go through here, so
    the two paths produce bit-identical :class:`PartitionInfo`."""
    U, W, T, E_BLK = geom.U, geom.W, geom.T, geom.E_BLK
    lo = int(edge_lo)
    hi = lo + int(s.shape[0])
    n_uniq = int(np.unique(s).shape[0]) if hi > lo else 0
    n_win = int(np.unique(s // W).shape[0]) if hi > lo else 0
    n_tile = int(np.unique((d - pid * U) // T).shape[0]) if hi > lo else 0
    # exact padded block counts per pipeline kind (brick group-by)
    if hi > lo:
        tile = (d // T).astype(np.int64)
        bricks_l = tile * (1 + int(s.max()) // W) + s // W
        _, cnt_l = np.unique(bricks_l, return_counts=True)
        blocks_l = int((-(-cnt_l // E_BLK)).sum())
        uniq, cidx = np.unique(s, return_inverse=True)
        bricks_b = tile * (1 + uniq.shape[0] // W) + cidx // W
        _, cnt_b = np.unique(bricks_b, return_counts=True)
        blocks_b = int((-(-cnt_b // E_BLK)).sum())
    else:
        blocks_l = blocks_b = 0
    return PartitionInfo(
        pid=pid, dst_lo=pid * U, dst_hi=min((pid + 1) * U, num_vertices),
        edge_lo=lo, edge_hi=hi, num_edges=hi - lo,
        num_unique_src=n_uniq, num_src_windows=n_win, num_dst_tiles=n_tile,
        blocks_little=blocks_l, blocks_big=blocks_b,
    )


def partition_graph(g: Graph, geom: Geometry) -> Tuple[List[PartitionInfo], dict]:
    """Return per-partition infos plus partition-sorted edge arrays.

    The returned dict has 'src','dst','weights' arrays sorted by
    (partition, src, dst) — the canonical order all blocking starts from.
    """
    U = geom.U
    num_parts = max(1, -(-g.num_vertices // U))
    pids = g.dst // U
    order = np.lexsort((g.dst, g.src, pids))
    src = g.src[order]
    dst = g.dst[order]
    wts = (g.weights[order] if g.weights is not None
           else np.zeros(src.shape[0], dtype=np.float32))
    bounds = np.searchsorted(pids[order], np.arange(num_parts + 1))
    infos: List[PartitionInfo] = []
    for p in range(num_parts):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        infos.append(partition_info(p, src[lo:hi], dst[lo:hi], lo,
                                    g.num_vertices, geom))
    edges = {"src": src, "dst": dst, "weights": wts}
    return infos, edges


# ---------------------------------------------------------------------------
# Brick blocking
# ---------------------------------------------------------------------------

def _block_groups(src_sorted, dst_sorted, w_sorted, win_of_edge, tile_of_edge,
                  src_local_fn, dst_local_fn, geom: Geometry):
    """Given edges already sorted by (tile, window, src), emit padded blocks."""
    E_BLK = geom.E_BLK
    n = src_sorted.shape[0]
    if n == 0:
        z = np.zeros((0, E_BLK), np.int32)
        return (z, z.copy(), np.zeros((0, E_BLK), np.float32),
                np.zeros((0, E_BLK), bool), np.zeros(0, np.int32),
                np.zeros(0, np.int32))
    # group key changes where (tile, window) changes
    key_change = np.ones(n, dtype=bool)
    key_change[1:] = (tile_of_edge[1:] != tile_of_edge[:-1]) | (
        win_of_edge[1:] != win_of_edge[:-1])
    group_id = np.cumsum(key_change) - 1
    n_groups = int(group_id[-1]) + 1
    counts = np.bincount(group_id, minlength=n_groups)
    blocks_per_group = -(-counts // E_BLK)
    n_blocks = int(blocks_per_group.sum())
    tot = n_blocks * E_BLK

    src_l = np.zeros(tot, np.int32)
    dst_l = np.zeros(tot, np.int32)
    wts = np.zeros(tot, np.float32)
    valid = np.zeros(tot, bool)
    # destination offset of each edge in the padded layout
    grp_starts_pad = np.concatenate([[0], np.cumsum(blocks_per_group) * E_BLK])[:-1]
    grp_starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    pos = grp_starts_pad[group_id] + (np.arange(n) - grp_starts[group_id])
    src_l[pos] = src_local_fn(src_sorted)
    dst_l[pos] = dst_local_fn(dst_sorted)
    wts[pos] = w_sorted
    valid[pos] = True

    blk_win = np.zeros(n_blocks, np.int32)
    blk_tile = np.zeros(n_blocks, np.int32)
    # block index of the first block of each group
    grp_blk_start = np.concatenate([[0], np.cumsum(blocks_per_group)])[:-1]
    for gi in range(n_groups):
        b0, nb = int(grp_blk_start[gi]), int(blocks_per_group[gi])
        e0 = int(grp_starts[gi])
        blk_win[b0:b0 + nb] = win_of_edge[e0]
        blk_tile[b0:b0 + nb] = tile_of_edge[e0]
    return (src_l.reshape(n_blocks, E_BLK), dst_l.reshape(n_blocks, E_BLK),
            wts.reshape(n_blocks, E_BLK), valid.reshape(n_blocks, E_BLK),
            blk_win, blk_tile)


def _finalize(blk_win, blk_tile, geom, kind, pids, n_real,
              src_l, dst_l, wts, valid, unique_src=None,
              tile_global_base=None):
    """Compress touched tiles to a dense local index & compute metadata."""
    n_blocks = blk_win.shape[0]
    if n_blocks:
        touched, tile_local = np.unique(blk_tile, return_inverse=True)
    else:
        touched = np.zeros(0, np.int64)
        tile_local = np.zeros(0, np.int64)
    tile_local = tile_local.astype(np.int32)
    tile_first = np.ones(n_blocks, np.int32)
    tile_first[1:] = (tile_local[1:] != tile_local[:-1]).astype(np.int32)
    tile_dst_start = (tile_global_base(touched) if tile_global_base is not None
                      else touched * geom.T).astype(np.int32)
    return BlockedEdges(
        geom=geom, kind=kind, n_blocks=n_blocks,
        src_local=src_l, dst_local=dst_l, weights=wts, valid=valid,
        window_id=blk_win.astype(np.int32), tile_id=tile_local,
        tile_first=tile_first, n_out_tiles=int(touched.shape[0]),
        tile_dst_start=tile_dst_start, unique_src=unique_src,
        pids=tuple(pids), num_real_edges=n_real,
    )


def block_little(edges: dict, info: PartitionInfo, geom: Geometry) -> BlockedEdges:
    """Blocking for the Little pipeline: src windows index the RAW vprops
    array (streamed windows, the ping-pong-buffer analogue)."""
    W, T, U = geom.W, geom.T, geom.U
    lo, hi = info.edge_lo, info.edge_hi
    s = edges["src"][lo:hi]
    d = edges["dst"][lo:hi]
    w = edges["weights"][lo:hi]
    tile = d // T  # global tile id (dst already global)
    win = s // W
    order = np.lexsort((s, win, tile))
    s, d, w, tile, win = s[order], d[order], w[order], tile[order], win[order]
    out = _block_groups(s, d, w, win, tile,
                        lambda x: x % W, lambda x: x % T, geom)
    return _finalize(out[4], out[5], geom, "little", [info.pid], s.shape[0],
                     out[0], out[1], out[2], out[3])


def block_big(edges: dict, infos: Sequence[PartitionInfo],
              geom: Geometry) -> BlockedEdges:
    """Blocking for the Big pipeline: a *batch* of sparse partitions.

    Unique sources across the batch are compacted (the Vertex Loader's
    request-dedup moved to preprocessing); src windows index the compact
    array which ops.big_pipeline gathers once per execution.
    """
    W, T = geom.W, geom.T
    segs = [(edges["src"][i.edge_lo:i.edge_hi],
             edges["dst"][i.edge_lo:i.edge_hi],
             edges["weights"][i.edge_lo:i.edge_hi]) for i in infos]
    if segs:
        s = np.concatenate([x[0] for x in segs])
        d = np.concatenate([x[1] for x in segs])
        w = np.concatenate([x[2] for x in segs])
    else:
        s = np.zeros(0, np.int32); d = np.zeros(0, np.int32)
        w = np.zeros(0, np.float32)
    uniq, inv = np.unique(s, return_inverse=True)
    n_uniq_pad = max(W, int(-(-max(1, uniq.shape[0]) // W) * W))
    unique_src = np.zeros(n_uniq_pad, np.int32)
    unique_src[:uniq.shape[0]] = uniq
    cidx = inv.astype(np.int32)           # compact src index
    tile = d // T                          # global dst tile
    win = cidx // W                        # compact window
    order = np.lexsort((cidx, win, tile))
    s2, d2, w2 = cidx[order], d[order], w[order]
    tile, win = tile[order], win[order]
    out = _block_groups(s2, d2, w2, win, tile,
                        lambda x: x % W, lambda x: x % T, geom)
    return _finalize(out[4], out[5], geom, "big",
                     [i.pid for i in infos], s.shape[0],
                     out[0], out[1], out[2], out[3], unique_src=unique_src)


def padded_num_vertices(num_vertices: int, geom: Geometry) -> int:
    return int(-(-num_vertices // geom.U) * geom.U)

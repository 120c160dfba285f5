"""The live-edge store layout: a graph's edges kept as the GAS kernel reads
them, built with torch on a device.

A :class:`~.store.GraphStore` of layout ``"stream"`` materialises no
padded slot, on the host or on the card. It keeps every edge once, in
*tile-major* order: sorted by (destination tile, source, destination),
ties in the graph's order. That is the order of both pipelines'
blockings (``partition.block_little`` sorts a partition by (tile,
window, source), ``partition.block_big`` a batch by (tile, compact
window, compact source), and a window or a compact index grows with the
source), and a group's live slots are a prefix of its padded blocks, so a
padded work's live-edge stream (``ops.edge_stream``) is a contiguous
run of this order:

* a Little work (one dense partition) is its partition's edge range;
  ``edge_src`` is the source itself (``window_id * W + src_local``);
* a Big work (a batch of sparse partitions) is its partitions' ranges
  one after another; ``edge_src`` is the source's rank among the
  batch's distinct sources (its index in ``unique_src``).

Block counts are kept per tile, not as blocks: the perf model's exact
``blocks_little`` / ``blocks_big`` of each partition, and each work's
``tile_block_start`` (a tile's first padded block), which is all the
planner's block-granular cuts and ``ops.snap_down`` need.

:func:`build` runs the DBG permutation, the partition sort, the
partition stats and the tile-major sort on ``device`` with stable sorts
on composite int64 keys, so every array equals what the padded store
computes from the same graph, bit for bit; the edges then go to host
memory (12 B an edge), from which plans pack their payloads.
:func:`big_works` builds a plan's Big works on ``device`` in a few
batched passes.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..graphs.formats import Graph
from .types import Geometry, PartitionInfo

# Big edges a batched pass of :func:`big_works` takes at most (bounds its
# device temporaries: about 40 B an edge)
BIG_PASS_EDGES = 1 << 27


@dataclasses.dataclass
class StreamEdges:
    """Every edge of a store in tile-major order, on the host.

    ``src`` (int32, DBG ids), ``dst_local`` (int32, the destination's
    slot in its tile, ``dst % T``) and ``weights`` (float32) are torch
    tensors; ``tile_edge_start`` (``n_tiles + 1`` int64) gives global
    tile ``k``'s edges ``[start[k], start[k + 1])``, and
    ``tile_blocks_little`` (``n_tiles`` int64) its padded Little blocks."""

    num_vertices: int
    src: torch.Tensor
    dst_local: torch.Tensor
    weights: torch.Tensor
    tile_edge_start: np.ndarray
    tile_blocks_little: np.ndarray
    out_degrees: np.ndarray

    @property
    def num_edges(self) -> int:
        return int(self.src.numel())

    def nbytes(self) -> int:
        return (_tensor_bytes(self.src, self.dst_local, self.weights)
                + self.tile_edge_start.nbytes
                + self.tile_blocks_little.nbytes + self.out_degrees.nbytes)


@dataclasses.dataclass
class StreamWork:
    """One Little partition or Big batch as its live edges: the stream a
    padded work's payloads derive (``ops.edge_stream``), without the
    blocks.

    ``edge_src``, ``edge_dst`` and ``edge_w`` (host tensors) hold its
    edges in slot order; tile ``k`` of the work (global destination
    ``tile_dst_start[k]``) owns edges ``tile_edge_start[k]:
    tile_edge_start[k + 1]`` and padded blocks ``tile_block_start[k]:
    tile_block_start[k + 1]``; ``n_blocks`` is the padded block count,
    equal to the padded work's."""

    geom: Geometry
    kind: str                      # "little" | "big"
    n_blocks: int
    n_out_tiles: int
    tile_dst_start: np.ndarray     # (n_out_tiles,) int32
    tile_block_start: np.ndarray   # (n_out_tiles + 1,) int64
    tile_edge_start: np.ndarray    # (n_out_tiles + 1,) int64
    edge_src: torch.Tensor         # int32
    edge_dst: torch.Tensor         # int32
    edge_w: torch.Tensor           # float32
    unique_src: Optional[np.ndarray] = None  # big only: (n_unique_pad,)
    pids: tuple = ()
    num_real_edges: int = 0

    @property
    def num_padded_edges(self) -> int:
        return self.n_blocks * self.geom.E_BLK

    def nbytes(self) -> int:
        """Host bytes of the work's arrays (its edges counted even where
        they are a view of the store's)."""
        arrays = (self.tile_dst_start, self.tile_block_start,
                  self.tile_edge_start, self.unique_src)
        return (_tensor_bytes(self.edge_src, self.edge_dst, self.edge_w)
                + sum(a.nbytes for a in arrays if a is not None))

    def owned_nbytes(self) -> int:
        """Host bytes only this work holds: a Little work's edges are a
        view of the store's, a Big work's its own."""
        if self.kind == "big":
            return self.nbytes()
        return self.nbytes() - _tensor_bytes(self.edge_src, self.edge_dst,
                                             self.edge_w)


def _tensor_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """``a`` as a tensor on ``device``; a frozen (read-only) array is
    only read."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(a).to(device)


def _starts(change: torch.Tensor) -> torch.Tensor:
    """Positions where ``change`` is set (int64)."""
    return torch.nonzero(change).squeeze(1)


def _run_lengths(starts: torch.Tensor, n: int) -> torch.Tensor:
    return torch.diff(starts, append=starts.new_tensor([n]))


def _blocks(counts: torch.Tensor, e_blk: int) -> torch.Tensor:
    return (counts + e_blk - 1) // e_blk


def _changes(*keys: torch.Tensor) -> torch.Tensor:
    """True where any key differs from the element before (and at 0)."""
    n = keys[0].numel()
    out = torch.ones(n, dtype=torch.bool, device=keys[0].device)
    if n > 1:
        diff = keys[0][1:] != keys[0][:-1]
        for k in keys[1:]:
            diff |= k[1:] != k[:-1]
        out[1:] = diff
    return out


def dbg_permutation(dst: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """``partition.dbg_permutation`` on ``dst``'s device: vertices grouped
    by floor(log2(in-degree + 1)), groups by descending degree, ids kept
    in order inside a group. int32 ``perm[old_id] = new_id``."""
    dev = dst.device
    indeg = torch.bincount(dst, minlength=num_vertices)
    # frexp's exponent is exact where log2's floor could round
    _, exp = torch.frexp((indeg + 1).to(torch.float64))
    group = (exp - 1).to(torch.int64)
    key = (group.max() - group) * num_vertices + torch.arange(
        num_vertices, device=dev)
    order = torch.argsort(key)                  # keys are distinct
    perm = torch.empty(num_vertices, dtype=torch.int32, device=dev)
    perm[order] = torch.arange(num_vertices, dtype=torch.int32, device=dev)
    return perm


def _stable_order(keys: Sequence[Tuple[torch.Tensor, int]]) -> torch.Tensor:
    """The permutation that sorts by ``keys`` (most significant first,
    each ``(values, bound)`` with values in ``[0, bound)``), ties in
    input order: one stable sort of a composite int64 key where the
    bounds' product fits, else one stable sort per key from the least
    significant."""
    span = 1
    for _, bound in keys:
        span *= max(1, int(bound))
    if span < 2 ** 62:
        comp = keys[0][0].to(torch.int64)
        for vals, bound in keys[1:]:
            comp.mul_(int(bound)).add_(vals)
        return torch.sort(comp, stable=True).indices
    order = None
    for vals, _ in reversed(keys):
        v = vals if order is None else vals[order]
        step = torch.sort(v.to(torch.int64), stable=True).indices
        order = step if order is None else order[step]
    return order


def build(graph: Graph, geom: Geometry, use_dbg: bool,
          perm: Optional[np.ndarray], device):
    """DBG, partitions and the tile-major edges of ``graph`` on
    ``device``. Returns ``(perm (host int32), infos, StreamEdges)``;
    ``perm`` overrides the DBG computation as in the padded store."""
    dev = torch.device(device)
    V, U, W, T, E_BLK = (graph.num_vertices, geom.U, geom.W, geom.T,
                         geom.E_BLK)
    n_parts = max(1, -(-V // U))
    n_tiles = n_parts * (U // T)
    src = _upload(graph.src, dev)
    dst = _upload(graph.dst, dev)
    if perm is not None:
        perm_t = _upload(np.asarray(perm, dtype=np.int32), dev)
    elif use_dbg:
        perm_t = dbg_permutation(dst, V)
    else:
        perm_t = torch.arange(V, dtype=torch.int32, device=dev)
    s = torch.index_select(perm_t, 0, src)
    d = torch.index_select(perm_t, 0, dst)
    del src, dst
    w = (_upload(graph.weights, dev) if graph.weights is not None
         else torch.zeros(s.numel(), dtype=torch.float32, device=dev))
    perm_host = perm_t.cpu().numpy()
    del perm_t

    # partition order: (partition, src, dst), ties in graph order
    pid = torch.div(d, U, rounding_mode="floor")
    order = _stable_order([(pid, n_parts), (s, V), (d, V)])
    s, d, w = s[order], d[order], w[order]
    del order
    pid = torch.div(d, U, rounding_mode="floor")
    E = s.numel()
    bounds = torch.searchsorted(
        pid, torch.arange(n_parts + 1, dtype=pid.dtype, device=dev))
    new_src = _changes(pid, s)
    n_uniq = torch.bincount(pid[new_src], minlength=n_parts)
    n_win = torch.bincount(pid[_changes(pid, torch.div(
        s, W, rounding_mode="floor"))], minlength=n_parts)
    tile = torch.div(d, T, rounding_mode="floor")
    touched = torch.zeros(n_tiles, dtype=torch.bool, device=dev)
    touched[tile] = True
    n_tile = touched.view(n_parts, U // T).sum(1)
    # each source's rank among its partition's distinct sources
    rank = torch.cumsum(new_src, 0) - 1
    first = rank[bounds[:-1].clamp(max=max(E - 1, 0))] if E else rank
    cidx = (rank - torch.index_select(first, 0, pid)).to(torch.int32)
    del rank, new_src

    # tile-major order: a stable sort by tile keeps (src, dst) within it
    order = torch.sort(tile, stable=True).indices
    s, d, w, cidx, tile = s[order], d[order], w[order], cidx[order], \
        tile[order]
    del order
    tile_count = torch.bincount(tile, minlength=n_tiles)
    per_tile_blocks = []
    for win in (torch.div(s, W, rounding_mode="floor"),
                torch.div(cidx, W, rounding_mode="floor")):
        # groups (tile, window) of the Little blocking and (tile, compact
        # window) of a Big blocking of the partition alone
        starts = _starts(_changes(tile, win))
        per_tile = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
        per_tile.index_add_(0, tile[starts].to(torch.int64),
                            _blocks(_run_lengths(starts, E), E_BLK))
        per_tile_blocks.append(per_tile)
    del cidx, tile
    tile_blocks_little, tile_blocks_big = per_tile_blocks
    outdeg = torch.bincount(s, minlength=V).to(torch.int32)

    stats = torch.stack([
        bounds[:-1], bounds[1:], n_uniq, n_win, n_tile,
        tile_blocks_little.view(n_parts, -1).sum(1),
        tile_blocks_big.view(n_parts, -1).sum(1)]).cpu().numpy()
    infos = [PartitionInfo(
        pid=p, dst_lo=p * U, dst_hi=min((p + 1) * U, V),
        edge_lo=int(lo), edge_hi=int(hi), num_edges=int(hi - lo),
        num_unique_src=int(nu), num_src_windows=int(nw),
        num_dst_tiles=int(nt), blocks_little=int(bl), blocks_big=int(bb))
        for p, (lo, hi, nu, nw, nt, bl, bb) in enumerate(stats.T)]
    edges = StreamEdges(
        num_vertices=V, src=s.cpu(),
        dst_local=torch.remainder(d, T).cpu(), weights=w.cpu(),
        tile_edge_start=_cumsum0(tile_count.cpu().numpy()),
        tile_blocks_little=tile_blocks_little.cpu().numpy(),
        out_degrees=outdeg.cpu().numpy())
    return perm_host, infos, edges


def _touched(edges: StreamEdges, info: PartitionInfo,
             geom: Geometry) -> np.ndarray:
    """Global tiles of partition ``info`` that hold an edge."""
    per = geom.U // geom.T
    lo = info.pid * per
    counts = np.diff(edges.tile_edge_start[lo:lo + per + 1])
    return lo + np.nonzero(counts)[0]


def _cumsum0(x: np.ndarray) -> np.ndarray:
    out = np.zeros(x.shape[0] + 1, np.int64)
    np.cumsum(x, out=out[1:])
    return out


def little_work(edges: StreamEdges, info: PartitionInfo,
                geom: Geometry) -> StreamWork:
    """The Little work of one partition: its edge range of the store's
    edges (views), with its tiles' padded Little blocks."""
    tiles = _touched(edges, info, geom)
    e0, e1 = info.edge_lo, info.edge_hi
    tbs = _cumsum0(edges.tile_blocks_little[tiles])
    # untouched tiles hold no edge: the last touched one ends at e1
    tes = np.append(edges.tile_edge_start[tiles], e1) - e0
    return StreamWork(
        geom=geom, kind="little", n_blocks=int(tbs[-1]),
        n_out_tiles=int(tiles.shape[0]),
        tile_dst_start=(tiles * geom.T).astype(np.int32),
        tile_block_start=tbs, tile_edge_start=tes,
        edge_src=edges.src[e0:e1], edge_dst=edges.dst_local[e0:e1],
        edge_w=edges.weights[e0:e1], pids=(info.pid,),
        num_real_edges=e1 - e0)


def _concat(t: torch.Tensor, ranges: List[Tuple[int, int]]) -> torch.Tensor:
    """A copy of ``t``'s ranges one after another."""
    return torch.cat([t[lo:hi] for lo, hi in ranges])


def big_works(edges: StreamEdges, infos: Sequence[PartitionInfo],
              geom: Geometry, batches: Sequence[Tuple[int, ...]],
              device) -> Dict[Tuple[int, ...], StreamWork]:
    """The Big works of ``batches`` (tuples of partition ids), built on
    ``device`` in passes of at most :data:`BIG_PASS_EDGES` edges: each
    batch's distinct sources (``unique_src``, padded with zeros to a
    multiple of W), each edge's rank among them, and the padded blocks
    of each tile's (tile, compact window) groups."""
    dev = torch.device(device)
    out: Dict[Tuple[int, ...], StreamWork] = {}
    group: List[tuple] = []
    n = 0
    for b in batches:
        size = sum(infos[p].num_edges for p in b)
        if group and n + size > BIG_PASS_EDGES:
            out.update(_big_pass(edges, infos, geom, group, dev))
            group, n = [], 0
        group.append(tuple(b))
        n += size
    if group:
        out.update(_big_pass(edges, infos, geom, group, dev))
    return out


def _big_pass(edges, infos, geom, batches, dev):
    V, W, T, E_BLK = edges.num_vertices, geom.W, geom.T, geom.E_BLK
    ranges = [[(infos[p].edge_lo, infos[p].edge_hi) for p in b]
              for b in batches]
    tiles = [np.concatenate([_touched(edges, infos[p], geom) for p in b])
             for b in batches]
    per_tile = np.diff(edges.tile_edge_start)
    tile_counts = [per_tile[t] for t in tiles]
    sizes = np.array([int(c.sum()) for c in tile_counts], np.int64)
    src = torch.cat([_concat(edges.src, r) for r in ranges]).to(dev)
    bid = torch.repeat_interleave(
        torch.arange(len(batches), device=dev),
        torch.from_numpy(sizes).to(dev))
    uniq, inv = torch.unique(bid * V + src, sorted=True, return_inverse=True)
    per_batch = torch.bincount(torch.div(uniq, V, rounding_mode="floor"),
                               minlength=len(batches))
    first = torch.cumsum(per_batch, 0) - per_batch
    cidx = (inv - first[bid]).to(torch.int32)
    del inv, bid, src
    all_counts = torch.from_numpy(np.concatenate(tile_counts)).to(dev)
    tord = torch.repeat_interleave(
        torch.arange(all_counts.numel(), device=dev), all_counts)
    starts = _starts(_changes(tord, torch.div(cidx, W,
                                              rounding_mode="floor")))
    blocks = torch.zeros(all_counts.numel(), dtype=torch.int64, device=dev)
    blocks.index_add_(0, tord[starts],
                      _blocks(_run_lengths(starts, cidx.numel()), E_BLK))
    del tord, starts
    cidx, blocks = cidx.cpu(), blocks.cpu().numpy()
    uniq_src = torch.remainder(uniq, V).to(torch.int32).cpu().numpy()
    per_batch = per_batch.cpu().numpy()

    out = {}
    e_off = t_off = u_off = 0
    for b, r, t, c, size, nu in zip(batches, ranges, tiles, tile_counts,
                                    sizes, per_batch):
        table = np.zeros(max(W, -(-max(1, int(nu)) // W) * W), np.int32)
        table[:nu] = uniq_src[u_off:u_off + nu]
        tbs = _cumsum0(blocks[t_off:t_off + t.shape[0]])
        out[b] = StreamWork(
            geom=geom, kind="big", n_blocks=int(tbs[-1]),
            n_out_tiles=int(t.shape[0]),
            tile_dst_start=(t * T).astype(np.int32), tile_block_start=tbs,
            tile_edge_start=_cumsum0(c),
            edge_src=cidx[e_off:e_off + size],
            edge_dst=_concat(edges.dst_local, r),
            edge_w=_concat(edges.weights, r), unique_src=table,
            pids=tuple(b), num_real_edges=int(size))
        e_off, t_off, u_off = e_off + int(size), t_off + t.shape[0], \
            u_off + int(nu)
    return out

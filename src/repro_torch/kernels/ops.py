"""Payloads and dispatch for the GAS kernel.

``materialize_entry`` turns a (work, block-range) plan entry into device
tensors with tile indices rebased to the slice, after snapping the range
to tile boundaries — so every destination tile is written by exactly one
entry and the executor can merge with a plain tile-indexed copy
whatever the gather mode.

``pack_lanes`` builds the FUSED representation: all same-kind entries of
a lane concatenated host-side into one payload (per-segment tile ids
rebased to a global tile map, Big window ids rebased against the packed
unique-source tables), uploaded in one shot. ``run_lane`` then runs a
whole lane as ONE kernel launch instead of one per entry.
``pack_lanes_sharded`` uploads each lane to its owner device instead,
and both splice in lanes carried over from before a streaming delta.

A device payload has one form whatever made it: the counts
(:data:`_COUNT_KEYS`), the live-edge stream the GAS kernel reads (the
live slots alone, in slot order, with each tile's first edge and first
chunk of :data:`.gas_kernel.CHUNK_EDGES` edges), ``tile_idx``, and for
Big its compacted ``unique_src`` (:data:`_DEVICE_KEYS`). The host
layout is known only here, and the device never holds a padded array.
Host payloads of the padded store layout are padded blocks (the
reference's arrays, byte for byte, plus ``tile_block_start``, the first
block of each output tile); :func:`_upload_payload`, which every payload
passes through, derives their stream on the payload's device
(:func:`edge_stream`), moving the padded arrays a slice at a time.
Works of the ``"stream"`` layout
(:class:`~repro_torch.core.stream.StreamWork`) are live edges already:
their host payloads are slices of the works' streams
(:func:`_entry_stream`, :func:`_pack_stream_group`), uploaded as they
are.

``default_path`` follows the device: ``"cuda"`` (the kernel) on a CUDA
device, ``"ref"`` (the plain PyTorch version over the same stream) on
``device="cpu"``. With no CUDA and no explicit device it raises.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.stream import StreamWork
from ..core.types import BlockedEdges, Geometry
from . import ref as ref_mod
from .big_pipeline import big_pipeline
from .gas_kernel import tile_chunk_start
from .little_pipeline import little_pipeline

# the counts every payload carries, host and device alike
_COUNT_KEYS = ("kind", "geom", "n_out_tiles", "n_blocks", "n_entries",
               "num_real_edges")
# the live-edge stream the GAS kernel reads
_STREAM_KEYS = ("edge_src", "edge_dst", "edge_w", "tile_edge_start",
                "tile_chunk_start")
# the tensors a device payload holds: the stream, the output tiles'
# global indices and (Big only) the compacted unique-source table
_DEVICE_KEYS = _STREAM_KEYS + ("tile_idx", "unique_src")
# bytes of a padded slot (src_local, dst_local, weights, valid) and of a
# block's routing fields (window_id, tile_id, tile_first) in a host
# payload, all 4-byte: the reference's footprint classes, reckoned from
# the counts a device payload keeps
_SLOT_BYTES = 16
_BLOCK_BYTES = 12
PATHS = ("cuda", "ref")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another. Raises when CUDA is asked for (explicitly or by
    default) and there is none — the port never falls back to the CPU
    on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        if dev.index is None:       # one key per card for memoized state
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_path(device=None) -> str:
    """``"cuda"`` on a CUDA device, ``"ref"`` on the CPU."""
    return "cuda" if resolve_device(device).type == "cuda" else "ref"


def snap_down(blocked: BlockedEdges, x: int) -> int:
    """Largest tile boundary <= x (x == n_blocks allowed). Applying this
    one rule to both endpoints keeps adjacent slices exactly abutting."""
    n = blocked.n_blocks
    x = max(0, min(x, n))
    if x >= n:
        return n
    if isinstance(blocked, StreamWork):
        tbs = blocked.tile_block_start
        return int(tbs[np.searchsorted(tbs, x, side="right") - 1])
    tf = blocked.tile_first
    while x > 0 and tf[x] != 1:
        x -= 1
    return x


def snap_to_tiles(blocked: BlockedEdges, lo: int, hi: int):
    """Snap [lo, hi) to tile boundaries; may return an empty range, which
    the executor drops (the work is covered by the neighbouring slice)."""
    return snap_down(blocked, lo), snap_down(blocked, hi)


def tile_block_start(tile_id: np.ndarray, n_out_tiles: int) -> np.ndarray:
    """First block of each output tile, ``n_out_tiles + 1`` int32, from a
    dense non-decreasing ``tile_id``: tile ``k`` owns blocks
    ``[start[k], start[k + 1])``."""
    return np.searchsorted(tile_id, np.arange(n_out_tiles + 1)).astype(
        np.int32)


def _entry_np(blocked: BlockedEdges, lo: int, hi: int) -> Optional[dict]:
    """Host-side payload for one plan entry (tile-snapped). Returns None
    when the snapped range is empty. ``unique_src`` stays a reference to
    the work's shared compaction table so packing can deduplicate tables
    across entries of the same Big work."""
    lo, hi = snap_to_tiles(blocked, lo, hi)
    if hi <= lo:
        return None
    t0 = int(blocked.tile_id[lo])
    t1 = int(blocked.tile_id[hi - 1]) + 1
    tf = blocked.tile_first[lo:hi].copy()
    tf[0] = 1
    tile_id = blocked.tile_id[lo:hi] - t0
    tbs = tile_block_start(tile_id, t1 - t0)
    return {
        "kind": blocked.kind,
        "geom": blocked.geom,
        "n_out_tiles": t1 - t0,
        "n_blocks": hi - lo,
        "n_entries": 1,
        "src_local": blocked.src_local[lo:hi],
        "dst_local": blocked.dst_local[lo:hi],
        "weights": blocked.weights[lo:hi],
        "valid": blocked.valid[lo:hi].astype(np.int32),
        "window_id": blocked.window_id[lo:hi],
        "tile_id": tile_id,
        "tile_first": tf,
        "tile_idx": (blocked.tile_dst_start[t0:t1]
                     // blocked.geom.T).astype(np.int32),
        "unique_src": blocked.unique_src,
        "num_real_edges": int(blocked.valid[lo:hi].sum()),
        "tile_block_start": tbs,
    }


def _entry_stream(work: StreamWork, lo: int, hi: int) -> Optional[dict]:
    """Host payload of one plan entry of a live-edge work (tile-snapped;
    None when empty): the edges of its tiles, as views of the work's
    stream, and the same per-tile fields a padded entry's upload gives.
    """
    lo, hi = snap_to_tiles(work, lo, hi)
    if hi <= lo:
        return None
    tbs = work.tile_block_start
    t0, t1 = int(np.searchsorted(tbs, lo)), int(np.searchsorted(tbs, hi))
    e0, e1 = int(work.tile_edge_start[t0]), int(work.tile_edge_start[t1])
    return {
        "kind": work.kind,
        "geom": work.geom,
        "n_out_tiles": t1 - t0,
        "n_blocks": hi - lo,
        "n_entries": 1,
        "edge_src": work.edge_src[e0:e1],
        "edge_dst": work.edge_dst[e0:e1],
        "edge_w": work.edge_w[e0:e1],
        "tile_edge_start": work.tile_edge_start[t0:t1 + 1] - e0,
        "tile_idx": (work.tile_dst_start[t0:t1]
                     // work.geom.T).astype(np.int32),
        "unique_src": work.unique_src,
        "num_real_edges": e1 - e0,
    }


def _entry(work, lo: int, hi: int) -> Optional[dict]:
    """Host payload of one plan entry of either layout's work."""
    if isinstance(work, StreamWork):
        return _entry_stream(work, lo, hi)
    return _entry_np(work, lo, hi)


# padded blocks the stream is derived from at a time: bounds what the
# derivation holds on the device beside the stream (the slice's padded
# arrays, a flag a slot, 8 B a live slot) to 16 M slots at E_BLK 256
STREAM_SLICE_BLOCKS = 1 << 16


def _tensor(v, device, copy: bool = False) -> torch.Tensor:
    """``v`` (a numpy array or a tensor) as a tensor on ``device``: a
    copy with ``copy``, else ``v``'s own memory where it is already
    there."""
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(np.ascontiguousarray(v))
    return v.to(device, copy=copy)


def edge_stream(p: dict, device) -> dict:
    """The live-edge stream of a padded payload ``p`` (numpy arrays or
    tensors), derived with tensor ops on ``device``: every slot whose
    ``valid`` is not 0, slot by slot (a block's live slots need not be a
    prefix), in slot order. ``edge_src`` (int32) is ``window_id[b] * W +
    src_local[b, e]``, an index into the kernel's ``vwin`` (raw vprops
    for Little, the payload's compacted table for Big); ``edge_dst``
    (int32) the slot in the tile; ``edge_w`` (float32) the weight;
    ``tile_edge_start`` (``n_out_tiles + 1`` int32) tile ``k``'s edges
    ``[start[k], start[k + 1])``; ``tile_chunk_start`` its chunks of
    :data:`.gas_kernel.CHUNK_EDGES` (:func:`.gas_kernel.tile_chunk_start`).
    The padded arrays move to ``device`` :data:`STREAM_SLICE_BLOCKS`
    blocks at a time, each slice dropped once its edges are written, into
    tensors sized once from ``num_real_edges``."""
    valid = p["valid"]
    n_blocks, e_blk = valid.shape
    n_edges, w = int(p["num_real_edges"]), p["geom"].W
    block_edge_start = torch.zeros(n_blocks + 1, dtype=torch.int64,
                                   device=device)
    edge_src = torch.empty(n_edges, dtype=torch.int32, device=device)
    edge_dst = torch.empty_like(edge_src)
    edge_w = torch.empty(n_edges, dtype=torch.float32, device=device)
    e0 = 0
    for b0 in range(0, n_blocks, STREAM_SLICE_BLOCKS):
        b1 = min(b0 + STREAM_SLICE_BLOCKS, n_blocks)
        keep = _tensor(valid[b0:b1], device) != 0
        block_edge_start[b0 + 1:b1 + 1] = keep.sum(1)
        slot = torch.nonzero(keep.reshape(-1)).squeeze(1)
        e1 = e0 + slot.numel()
        assert e1 <= n_edges, "num_real_edges does not count the live slots"
        block = torch.div(slot, e_blk, rounding_mode="floor")
        window = _tensor(p["window_id"][b0:b1], device).to(torch.int64)
        edge_src[e0:e1] = window[block] * w + _tensor(
            p["src_local"][b0:b1], device).reshape(-1)[slot]
        edge_dst[e0:e1] = _tensor(p["dst_local"][b0:b1],
                                  device).reshape(-1)[slot]
        edge_w[e0:e1] = _tensor(p["weights"][b0:b1],
                                device).reshape(-1)[slot]
        e0 = e1
    assert e0 == n_edges, "num_real_edges does not count the live slots"
    torch.cumsum(block_edge_start, 0, out=block_edge_start)
    tile_edge_start = block_edge_start[_tensor(
        p["tile_block_start"], device).to(torch.int64)].to(torch.int32)
    return {
        "edge_src": edge_src,
        "edge_dst": edge_dst,
        "edge_w": edge_w,
        "tile_edge_start": tile_edge_start,
        "tile_chunk_start": tile_chunk_start(tile_edge_start),
    }


def _upload_payload(p: dict, device) -> dict:
    """The device payload of host payload ``p``: its counts, and as
    tensors on ``device`` its live-edge stream, ``tile_idx`` and (Big)
    ``unique_src``. The one place that knows the host layout: a padded
    payload's stream is derived on ``device`` (:func:`edge_stream`) and
    none of its padded arrays is kept; a live-edge payload's stream is
    copied as it is, with its chunk index computed on ``device``."""
    out = {k: p[k] for k in _COUNT_KEYS}
    if "valid" in p:
        out.update(edge_stream(p, device))
    else:
        for k in ("edge_src", "edge_dst", "edge_w"):
            out[k] = _tensor(p[k], device, copy=True)
        tes = _tensor(p["tile_edge_start"], device, copy=True).to(
            torch.int32)
        out["tile_edge_start"] = tes
        out["tile_chunk_start"] = tile_chunk_start(tes)
    out["tile_idx"] = _tensor(p["tile_idx"], device, copy=True)
    if p["kind"] == "big":
        out["unique_src"] = _tensor(p["unique_src"], device, copy=True)
    return out


def materialize_entry(blocked: BlockedEdges, lo: int, hi: int, device):
    """Build the device payload for one plan entry (tile-snapped).
    Returns None when the snapped range is empty."""
    p = _entry(blocked, lo, hi)
    return None if p is None else _upload_payload(p, device)


def materialize_lanes(plan, little_works, big_works, device):
    """Materialize every plan entry, preserving the plan's lane
    structure. Empty (fully snapped-away) entries are dropped."""
    lanes = []
    for lane in plan.lanes:
        mat = []
        for e in lane:
            work = (little_works[e.work_id] if e.kind == "little"
                    else big_works[e.work_id])
            p = materialize_entry(work, e.block_lo, e.block_hi, device)
            if p is not None:
                mat.append(p)
        lanes.append(mat)
    return lanes


# ---------------------------------------------------------------------------
# Packed (fused) lane payloads
# ---------------------------------------------------------------------------

def _pack_group(entries: List[dict]) -> dict:
    """Concatenate same-kind host entry payloads into one packed payload.

    Per-segment rebasing:
      * ``tile_id`` shifts by the running tile count, so packed local
        tile ids are strictly increasing across segments and the global
        ``tile_idx`` map is a plain concatenation;
      * Big ``window_id`` shifts by its work's offset in the packed
        unique-source table (tables shared by split entries of the same
        work are packed once); Little window ids index raw vprops
        windows and need no rebase.
    """
    if "valid" not in entries[0]:
        return _pack_stream_group(entries)
    kind, geom = entries[0]["kind"], entries[0]["geom"]
    tile_off = 0
    win_parts, tid_parts = [], []
    tables: List[np.ndarray] = []        # distinct tables, first-use order
    table_off: dict = {}                 # id(table) -> window offset
    n_windows = 0
    for e in entries:
        assert e["kind"] == kind and e["geom"] == geom
        tid_parts.append(e["tile_id"] + tile_off)
        tile_off += e["n_out_tiles"]
        if kind == "big":
            tab = e["unique_src"]
            off = table_off.get(id(tab))
            if off is None:
                off = n_windows
                table_off[id(tab)] = off
                tables.append(tab)
                n_windows += tab.shape[0] // geom.W
            win_parts.append(e["window_id"] + off)
        else:
            win_parts.append(e["window_id"])
    tile_id = np.concatenate(tid_parts).astype(np.int32)
    tbs = tile_block_start(tile_id, tile_off)
    packed = {
        "kind": kind,
        "geom": geom,
        "n_out_tiles": tile_off,
        "n_blocks": int(sum(e["n_blocks"] for e in entries)),
        "n_entries": len(entries),
        "segment_starts": np.cumsum(
            [0] + [e["n_blocks"] for e in entries])[:-1].astype(np.int64),
        "tile_id": tile_id,
        "window_id": np.concatenate(win_parts).astype(np.int32),
        "unique_src": (np.concatenate(tables) if kind == "big" else None),
        "num_real_edges": int(sum(e["num_real_edges"] for e in entries)),
        "tile_block_start": tbs,
    }
    for k in ("src_local", "dst_local", "weights", "valid", "tile_first",
              "tile_idx"):
        packed[k] = np.concatenate([e[k] for e in entries])
    _validate_packed(packed)
    return packed


def _pack_stream_group(entries: List[dict]) -> dict:
    """:func:`_pack_group` for live-edge entries: their streams
    concatenated on the host, each tile's edge index shifted by the edges
    before it, Big sources shifted by their work's offset in the packed
    unique-source tables (a table shared by split entries of one work is
    packed once)."""
    kind, geom = entries[0]["kind"], entries[0]["geom"]
    tables: List[np.ndarray] = []
    table_off: dict = {}
    n_windows = edge_off = 0
    src_parts, tes_parts = [], []
    for e in entries:
        assert e["kind"] == kind and e["geom"] == geom
        src = e["edge_src"]
        if kind == "big":
            tab = e["unique_src"]
            off = table_off.get(id(tab))
            if off is None:
                off = table_off[id(tab)] = n_windows
                tables.append(tab)
                n_windows += tab.shape[0] // geom.W
            if off:
                src = src + off * geom.W
        src_parts.append(src)
        tes_parts.append(e["tile_edge_start"][:-1] + edge_off)
        edge_off += e["num_real_edges"]
    packed = {
        "kind": kind,
        "geom": geom,
        "n_out_tiles": int(sum(e["n_out_tiles"] for e in entries)),
        "n_blocks": int(sum(e["n_blocks"] for e in entries)),
        "n_entries": len(entries),
        "edge_src": torch.cat(src_parts),
        "edge_dst": torch.cat([e["edge_dst"] for e in entries]),
        "edge_w": torch.cat([e["edge_w"] for e in entries]),
        "tile_edge_start": np.concatenate(
            tes_parts + [np.array([edge_off], np.int64)]).astype(np.int32),
        "tile_idx": np.concatenate([e["tile_idx"] for e in entries]),
        "unique_src": np.concatenate(tables) if kind == "big" else None,
        "num_real_edges": edge_off,
    }
    _validate_stream_packed(packed)
    return packed


def _validate_stream_packed(p: dict) -> None:
    """Pack-time invariants of a live-edge payload (host arrays)."""
    tes = p["tile_edge_start"]
    assert tes.shape[0] == p["n_out_tiles"] + 1 and tes[0] == 0 \
        and tes[-1] == p["edge_src"].numel() and np.all(np.diff(tes) > 0), \
        "tile_edge_start does not cover the edges, a tile at least one"
    idx = p["tile_idx"]
    assert np.unique(idx).shape[0] == idx.shape[0] == p["n_out_tiles"], \
        "packed entries write overlapping destination tiles"


def _validate_packed(p: dict) -> None:
    """Pack-time invariants the kernel relies on (host numpy — zero
    device cost). Violations mean a scheduling/packing bug, not bad user
    input, hence asserts."""
    starts = p["segment_starts"]
    # every segment opens a fresh tile
    assert np.all(p["tile_first"][starts] == 1), \
        "packed segment does not start on a tile boundary"
    # local tile ids are a 0..n_out_tiles-1 relabeling, non-decreasing
    tid = p["tile_id"]
    assert tid.shape[0] == 0 or (
        tid[0] == 0 and np.all(np.diff(tid) >= 0)
        and int(tid[-1]) + 1 == p["n_out_tiles"]), \
        "packed tile ids are not a dense non-decreasing relabeling"
    # tile k's blocks are exactly [start[k], start[k + 1])
    tbs = p["tile_block_start"]
    assert tbs[0] == 0 and tbs[-1] == p["n_blocks"] and np.all(
        np.diff(tbs) > 0), "tile_block_start does not cover the blocks"
    # entries write disjoint output tiles -> one tile-indexed copy is safe
    idx = p["tile_idx"]
    assert np.unique(idx).shape[0] == idx.shape[0], \
        "packed entries write overlapping destination tiles"


def estimate_working_set(entries: List[dict], geom: Geometry) -> int:
    """Estimated working set, in bytes, of packing these same-kind host
    entries into ONE payload: the full output-tile accumulator, the
    gathered unique-source table (Big; distinct tables counted once,
    matching :func:`_pack_group`'s dedup) or one source window (Little),
    plus one edge-block slab."""
    ws = geom.E_BLK * 16                     # src+dst+weights+valid slab
    ws += sum(e["n_out_tiles"] for e in entries) * geom.T * 4
    if entries and entries[0]["kind"] == "big":
        seen, tot = set(), 0
        for e in entries:
            tab = e["unique_src"]
            if id(tab) not in seen:
                seen.add(id(tab))
                tot += int(tab.shape[0])
        ws += tot * 4
    else:
        ws += geom.W * 4
    return int(ws)


def _nbytes(x) -> int:
    if x is None:
        return 0
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(x.nbytes) if hasattr(x, "nbytes") else 0


def payload_footprint(p: dict) -> dict:
    """Byte/FLOP accounting of ONE (packed or single-entry) device
    payload, by traffic class. The classes the reference counts from its
    padded arrays are reckoned from the payload's counts, so either store
    layout gives the same values for the same graph:

    ``edge_bytes``     the padded edge slab (src/dst/weights/valid)
    ``index_bytes``    per-block routing metadata (window/tile ids,
                       tile_first flags) and the global tile_idx map
    ``stream_bytes``   the live-edge stream the card holds and the
                       kernel reads (src, dst and weight of every real
                       edge, the tile edge and chunk indices)
    ``table_bytes``    the deduped unique-source compaction table (Big)
    ``vertex_bytes``   property values the kernel reads: the gathered
                       unique sources (Big) or the touched source
                       windows (Little — W values per distinct window
                       its edges read)
    ``tile_bytes``     the merge traffic: output tiles plus tile_idx
    ``flops``          the reference's one-hot gather (E·W) + router
                       (E·T) MACs over padded edges, ×2
    """
    geom: Geometry = p["geom"]
    n_blocks, n_tiles = int(p["n_blocks"]), int(p["n_out_tiles"])
    tile_idx = _nbytes(p["tile_idx"])
    real = int(p["num_real_edges"])
    if p["kind"] == "big":
        # vwin = vprops[unique_src]: one property per table slot
        vertex = int(p["unique_src"].numel()) * 4
    else:
        n_win = int(torch.unique(torch.div(
            p["edge_src"], geom.W, rounding_mode="floor")).numel())
        vertex = n_win * geom.W * 4
    padded_e = n_blocks * geom.E_BLK
    return {
        "kind": p["kind"],
        "edge_bytes": padded_e * _SLOT_BYTES,
        "index_bytes": n_blocks * _BLOCK_BYTES + tile_idx,
        "stream_bytes": sum(_nbytes(p[k]) for k in _STREAM_KEYS),
        "table_bytes": _nbytes(p.get("unique_src")),
        "vertex_bytes": vertex,
        "tile_bytes": n_tiles * geom.T * 4 + tile_idx,
        "flops": 2 * padded_e * (geom.W + geom.T),
        "padded_edges": padded_e,
        "real_edges": real,
    }


def _chunk_entries(entries: List[dict], geom: Geometry,
                   budget: float) -> List[List[dict]]:
    """Greedily split a same-kind entry list so each chunk's estimated
    working set stays under ``budget`` bytes (0/negative = no limit).
    Chunk boundaries fall on ENTRY boundaries, which are tile-snapped
    already — each chunk is a valid packed payload and results stay
    bit-identical; only the launch count changes."""
    if budget <= 0 or not entries:
        return [entries] if entries else []
    chunks, cur = [], []
    for e in entries:
        if cur and estimate_working_set(cur + [e], geom) > budget:
            chunks.append(cur)
            cur = []
        cur.append(e)
    if cur:
        chunks.append(cur)
    return chunks


def _pack_lane_np(lane, little_works, big_works,
                  max_working_set: float = 0.0) -> List[dict]:
    """Host-side packed payloads for one lane: at most one per kind,
    more when ``max_working_set`` (bytes) forces chunking. Returns [] for
    a fully snapped-away lane."""
    groups = {"little": [], "big": []}
    geom = None
    for e in lane:
        work = (little_works[e.work_id] if e.kind == "little"
                else big_works[e.work_id])
        geom = work.geom
        p = _entry(work, e.block_lo, e.block_hi)
        if p is not None:
            groups[e.kind].append(p)
    return [_pack_group(chunk)
            for g in (groups["little"], groups["big"]) if g
            for chunk in _chunk_entries(g, geom, max_working_set)]


def pack_lane(lane, little_works, big_works, device,
              max_working_set: float = 0.0) -> List[dict]:
    """Pack one lane's plan entries into at most two payloads (more
    under working-set chunking): built host-side, concatenated,
    validated, uploaded once to ``device``."""
    return [_upload_payload(p, device)
            for p in _pack_lane_np(lane, little_works, big_works,
                                   max_working_set)]


def _check_lanes_disjoint(host, reuse) -> None:
    """Global tile disjointness ACROSS lanes: the single
    ``index_copy_`` of :func:`merge_all` (fused and sharded alike)
    relies on every destination tile being written by exactly one
    payload. ``_validate_packed`` covers one payload; this covers all.
    ``host[i]`` is lane i's host payloads, or None for a lane taken
    from ``reuse`` (its device ``tile_idx`` is read back: tiny per-tile
    arrays), checked before anything new is uploaded."""
    idx = []
    for i, lane in enumerate(host):
        if lane is None:
            idx += [p["tile_idx"].cpu().numpy() for p in reuse[i]]
        else:
            idx += [p["tile_idx"] for p in lane]
    all_idx = np.concatenate(idx) if idx else np.zeros(0, np.int32)
    assert np.unique(all_idx).shape[0] == all_idx.shape[0], \
        "plan assigns the same destination tile to multiple lanes"


def pack_lanes_host(plan, little_works, big_works, reuse,
                    max_working_set) -> list:
    """The host half of :func:`pack_lanes`: the packed host payloads of
    every lane not in ``reuse`` (None for those), checked for global
    tile disjointness with the reused ones."""
    host = [None if i in reuse
            else _pack_lane_np(lane, little_works, big_works,
                               max_working_set)
            for i, lane in enumerate(plan.lanes)]
    _check_lanes_disjoint(host, reuse)
    return host


def upload_lanes(host: list, reuse: Optional[dict], device) -> list:
    """The device half of :func:`pack_lanes`: upload each lane of
    ``host``, and splice in ``reuse[i]`` where ``host[i]`` is None."""
    return [reuse[i] if lane is None
            else [_upload_payload(p, device) for p in lane]
            for i, lane in enumerate(host)]


def lanes_volume(lanes) -> dict:
    """``edges`` (live) and ``bytes`` (every array the payloads hold:
    a host payload's, or a device payload's :func:`payload_nbytes`) of
    lanes of payloads; None lanes count nothing."""
    ps = [p for lane in lanes if lane for p in lane]
    return {"edges": int(sum(p["num_real_edges"] for p in ps)),
            "bytes": int(sum(_nbytes(v) for p in ps for v in p.values()))}


def pack_lanes(plan, little_works, big_works, device,
               reuse: Optional[dict] = None,
               max_working_set: float = 0.0) -> List[List[dict]]:
    """Fused counterpart of :func:`materialize_lanes`: one packed payload
    per (lane, kind) instead of one payload per entry, uploaded to
    ``device``.

    ``reuse`` maps lane index -> payload list already on ``device`` (the
    streaming layer seeds it with payloads carried over from a
    pre-delta bundle whose lane is structurally unchanged). Reused lanes
    skip host-side packing AND the upload: the same tensors are spliced
    in. ``max_working_set`` (bytes; 0 = off) chunks a lane's packed
    segments — bit-identical results, more launches."""
    reuse = reuse or {}
    host = pack_lanes_host(plan, little_works, big_works, reuse,
                           max_working_set)
    return upload_lanes(host, reuse, device)


def pack_lanes_sharded(plan, little_works, big_works, owners, devices,
                       reuse: Optional[dict] = None,
                       max_working_set: float = 0.0):
    """Sharded counterpart of :func:`pack_lanes`: pack each lane
    host-side and upload its payloads to its OWNER device
    (``devices[owners[i]]`` for lane ``i``).

    ``reuse`` maps lane index -> payload list already RESIDENT on its
    owner (streaming carry-over of clean, placement-pinned lanes);
    reused lanes skip packing and the transfer entirely but still take
    part in the global disjointness check.

    Returns ``(lanes, moved, bytes_moved)``: ``moved`` counts the
    non-empty lanes uploaded by this call and ``bytes_moved`` their
    device bytes.
    """
    reuse = reuse or {}
    host = pack_lanes_host(plan, little_works, big_works, reuse,
                       max_working_set)
    lanes, moved, bytes_moved = [], 0, 0
    for i, lane in enumerate(host):
        if lane is None:
            lanes.append(reuse[i])
            continue
        up = [_upload_payload(p, devices[owners[i]]) for p in lane]
        if up:
            moved += 1
            bytes_moved += sum(payload_nbytes(p) for p in up)
        lanes.append(up)
    return lanes, moved, bytes_moved


def payload_nbytes(payload: dict) -> int:
    """Device bytes pinned by one (entry or packed) device payload."""
    return sum(_nbytes(payload.get(k)) for k in _DEVICE_KEYS)


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------

def run_lane(packed: dict, vprops_padded, scatter_fn, mode: str,
             path: Optional[str] = None, scatter_op: Optional[str] = None):
    """Run one payload (a packed lane, or a single entry: the same
    launch). ``path="cuda"`` goes through the kernel wrapper, which
    raises on CPU tensors: the variant of the named ``scatter_op``, or
    with ``scatter_op=None`` the one generated for ``scatter_fn``.
    ``path="ref"`` runs the plain version over the same stream
    (:func:`.ref.gas_stream_ref`), and this is the one place that picks
    it. Returns
    ``(tiles (n_out_tiles, T), tile_idx (n_out_tiles,))``."""
    path = path or default_path(vprops_padded.device)
    if path == "ref":
        geom: Geometry = packed["geom"]
        if packed["kind"] == "big":
            vwin = vprops_padded[packed["unique_src"]].view(-1, geom.W)
        else:
            vwin = vprops_padded.view(-1, geom.W)
        tiles = ref_mod.gas_stream_ref(
            vwin, packed["edge_src"], packed["edge_dst"], packed["edge_w"],
            packed["tile_edge_start"], scatter_fn=scatter_fn, mode=mode,
            t=geom.T, n_out_tiles=packed["n_out_tiles"])
    elif path == "cuda":
        pipeline = big_pipeline if packed["kind"] == "big" else \
            little_pipeline
        tiles = pipeline(vprops_padded, packed, scatter_op=scatter_op,
                         mode=mode, scatter_fn=scatter_fn)
    else:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    return tiles, packed["tile_idx"]


def run_entry(entry: dict, vprops_padded, scatter_fn, mode: str,
              path: Optional[str] = None, scatter_op: Optional[str] = None):
    """Run one single-entry payload; the same launch as :func:`run_lane`
    (a packed lane is a payload like any other)."""
    return run_lane(entry, vprops_padded, scatter_fn, mode, path, scatter_op)


def merge_tiles(accum_padded, tiles, tile_idx, t: int):
    """Copy payload tiles into the global accumulator, in place. Tiles
    are disjoint across payloads by construction (snap_to_tiles)."""
    accum_padded.view(-1, t).index_copy_(0, tile_idx.to(torch.int64),
                                         tiles.to(accum_padded.dtype))
    return accum_padded


def merge_all(accum_padded, outputs, t: int):
    """Fused merge: one tile-indexed ``index_copy_`` over ALL payloads'
    output tiles (``outputs`` is a list of (tiles, tile_idx) pairs,
    globally tile-disjoint by construction)."""
    if not outputs:
        return accum_padded
    tiles = torch.cat([o[0] for o in outputs])
    idx = torch.cat([o[1] for o in outputs])
    return merge_tiles(accum_padded, tiles, idx, t)

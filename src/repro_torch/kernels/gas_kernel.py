"""The GAS kernel for Hopper: its wrapper, launch count and design note.

Replaces ``repro/kernels/gas_kernel.py::make_gas_kernel`` of the
reference package (the Pallas body behind ``gas_pallas_call`` and
``gas_pallas_call_segmented``). Source: ``csrc/gas_kernel.cu``, CUDA C++
for ``sm_90a``, built at first use by :mod:`._build` and bound with
``ctypes``.

What it computes: for every live edge of a payload, gather its source
value from ``vwin``, apply the scatter op with the edge weight (a named
op, or the app's own scatter UDF traced into C++ by :mod:`.udf_codegen`,
one library per UDF), and combine into its slot of its output tile in
mode sum, min, max (float32) or or (int32). The output is
``(n_out_tiles, T)``.

What it reads: the payload's live-edge stream, which is all a device
payload holds of its edges. A host payload of the padded store layout
holds each edge at slot ``e`` of block ``b`` (``src_local``,
``dst_local``, ``weights``, with ``valid == 0`` on pads, ``window_id[b]``
naming the source window); :func:`.ops.edge_stream` derives its stream
on the payload's device when it is uploaded, and the padded blocks stay
on the host. The stream keeps the live slots alone, in slot order:
``edge_src = window_id[b] * W + src_local[b, e]`` (an index into
``vwin``: raw vprops for Little, the lane's compacted table for Big),
``edge_dst = dst_local[b, e]``, ``edge_w = weights[b, e]``, and tile
``k`` owns edges ``tile_edge_start[k]:tile_edge_start[k + 1]``. A store
of the ``"stream"`` layout builds the same stream with no padded block.
On a uniform graph a Big block is 3.6 % live (one compacted window and
one tile a block), so the padded layout made the kernel walk 27 slots
for every edge it folded.

Bound. A launch must read src and dst (and the weight, for
``add_weight``) of every live edge, the tile's edge and chunk indices,
each distinct source value once, and write ``n_out_tiles * T`` results;
it does one combine per live edge (two operations with ``add_weight``).
``obs.launch_traffic`` counts these bytes and operations; on an H100
(3.35 TB/s, 67 TFLOP/s fp32) the bytes bound it.

Design. The Pallas body runs its grid in order on one core and carries a
tile accumulator across grid steps; a CUDA grid has no order. The first
design gave each tile one CTA that walked its blocks in order; the
second cut tiles into chunks of padded blocks. This one answers the
limits both met:

1. Too few CTAs, and skew. Each tile's live edges are cut into chunks of
   :data:`CHUNK_EDGES`, counted from the tile's first live edge, and
   each CTA takes one chunk; ``tile_chunk_start`` (``n_out_tiles + 1``
   int32) gives each tile's first chunk, and a CTA finds its tile by
   binary search in it. A tile with no live edge has one empty chunk,
   which writes the identity. A tile of one chunk is written straight
   to the output. In sum mode the chunks of a larger tile write partial
   tiles to scratch, and a second, ordered pass combines those slot by
   slot in chunk order; in the exact modes (2.) the launch first sets
   such a tile's row to the identity, and each chunk folds its touched
   slots into it with one atomic each.
2. Every thread read every staged edge. In sum mode a warp combines its
   32 edges of a step at once: each lane tags its slot in shared memory,
   and a slot no other lane shares is folded by its own lane. Lanes that
   share a slot are grouped (``__match_any_sync``) and reduce over a
   fixed lane-order tree of shuffles (a long run to a hub slot takes
   five steps, not 32); the group's lowest lane folds the total into the
   warp's own accumulator in shared memory. The warps' accumulators
   merge in warp order at the end of the chunk, after one barrier. The
   exact modes (:data:`EXACT_MODES`: min, max, or) give the same bits in
   any order, so they skip that ordering: the CTA keeps one accumulator
   of ``T`` int32 in shared memory, and each live edge is one
   shared-memory ``atomicMin`` / ``atomicMax`` / ``atomicOr`` of its
   value, a float as its order-preserving int image (its bits with the
   low 31 flipped where the sign is set). A step whose 32 live lanes all
   share one slot (a hub) reduces in the warp (``__reduce_*_sync``) and
   issues one atomic. The stream's slots are in no order within a tile,
   so lanes rarely collide.
3. Pads. The kernel reads no ``valid`` and no padded slot: a thread
   loads four consecutive edges of its chunk (16-byte loads where the
   chunk's start is aligned, the same edges in four loads where it is
   not), and the edge stream is read with streaming loads, so the
   source values stay in L2.

Sum uses no float atomics: the order of every fp32 combine depends only
on the tile's live edges and their tile-relative positions, never on
scheduling or on where the tile lies in its payload, so results are
bit-stable and the fused, per-entry and sharded launch forms (whose
entries are tile-snapped) agree bit for bit. min, max and or fold with
integer atomics on an order-preserving image, whose result is the same
bits in any order. The image differs from ``fminf`` / ``fmaxf`` on two
inputs no app gives: -0 sorts below +0, and a NaN sorts beyond the
infinity of its sign (``fminf`` drops a NaN).
"""
from __future__ import annotations

import ctypes
import weakref
from typing import Optional

import torch

from . import _build, udf_codegen

MODES = {"sum": 0, "min": 1, "max": 2, "or": 3}
# the gather modes whose result does not depend on the order of the fold:
# the kernel folds them with atomics (the module's note)
EXACT_MODES = frozenset({"min", "max", "or"})
KERNEL_SCATTER_OPS = {"copy": 0, "add_weight": 1}
SCATTER_CUSTOM = 2        # the kernel's code for a generated UDF variant
# live edges per CTA chunk; chosen on the card from {2048, 4096, 8192}
# (PERF.md)
CHUNK_EDGES = 4096
EDGES_PER_THREAD = 4      # a chunk's size must be a multiple of it
N_WARPS = 8               # sum: a 4-byte accumulator and a 1-byte tag a slot each
MAX_SMEM = 232448         # a CTA's shared memory on sm_90
MAX_T = MAX_SMEM // (N_WARPS * 5)

_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 8 + [
    ctypes.c_int] * 4 + [ctypes.c_void_p]


def scatter_udf(scatter_fn, mode: str) -> udf_codegen.ScatterUdf:
    """``scatter_fn`` traced for ``mode``'s property type (cached per
    function); raises ``NotImplementedError`` for a UDF the code
    generator does not take."""
    return udf_codegen.compile_scatter(
        scatter_fn, "int32" if mode == "or" else "float32")


def udf_prelude(scatter_fn, mode: str) -> str:
    """The build prelude of ``scatter_fn``'s variant in ``mode``: the
    macros ``csrc/gas_kernel.cu`` reads for scatter op ``kCustom``."""
    udf = scatter_udf(scatter_fn, mode)
    return (f"#define GAS_SCATTER_EXPR(p, w) ({udf.expr})\n"
            f"#define GAS_SCATTER_MODE {MODES[mode]}\n"
            f"#define GAS_SCATTER_USES_W {int(udf.uses_weight)}\n")


def _library(prelude: str = ""):
    lib = _build.load("gas_kernel", prelude)
    if lib.gas_launch.argtypes is None:
        lib.gas_launch.argtypes = _ARGTYPES
        lib.gas_launch.restype = ctypes.c_int
    return lib


_named_lib = None                        # the named ops' library
# scatter_fn -> {mode: library}, while scatter_fn lives
_udf_libs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _cached_library(scatter_fn, mode: str):
    """The library of a launch if an earlier one loaded it, else None:
    the named ops' (``scatter_fn`` None) or ``scatter_fn``'s variant in
    ``mode``; one dict lookup per launch."""
    if scatter_fn is None:
        return _named_lib
    try:
        return _udf_libs.get(scatter_fn, {}).get(mode)
    except TypeError:                 # not weak-referenceable: no cache
        return None


def _load_library(scatter_fn, mode: str):
    """Build or load the library :func:`_cached_library` lacks, and
    cache it."""
    global _named_lib
    if scatter_fn is None:
        _named_lib = _library()
        return _named_lib
    lib = _library(udf_prelude(scatter_fn, mode))
    try:
        _udf_libs.setdefault(scatter_fn, {})[mode] = lib
    except TypeError:
        pass
    return lib


def build(scatter_fn=None, mode: Optional[str] = None) -> None:
    """Build and load the kernel library now (it is built at first
    launch otherwise): the named ops' library, or with ``scatter_fn``
    the variant generated for that UDF in ``mode``."""
    _library("" if scatter_fn is None else udf_prelude(scatter_fn, mode))


def tile_chunk_start(tile_edge_start: torch.Tensor,
                     chunk_edges: int = CHUNK_EDGES) -> torch.Tensor:
    """First chunk of each output tile, ``n_out_tiles + 1`` int32 on
    ``tile_edge_start``'s device: tile ``k``'s live edges, counted from
    its first, make ``max(1, ceil(edges / chunk_edges))`` chunks,
    ``[start[k], start[k + 1])``."""
    edges = torch.diff(tile_edge_start.to(torch.int64))
    chunks = torch.clamp((edges + chunk_edges - 1) // chunk_edges, min=1)
    out = torch.zeros(edges.shape[0] + 1, dtype=torch.int64,
                      device=tile_edge_start.device)
    torch.cumsum(chunks, 0, out=out[1:])
    return out.to(torch.int32)


def max_chunks(n_edges: int, n_out_tiles: int,
               chunk_edges: int = CHUNK_EDGES) -> int:
    """The most chunks ``n_edges`` live edges in ``n_out_tiles`` tiles
    can make (each tile at least one): the grid of the kernel's first
    pass, known without reading ``tile_chunk_start`` back from the
    card."""
    return n_out_tiles + n_edges // chunk_edges


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or x.device != device or not x.is_contiguous():
        raise ValueError(
            f"gas kernel: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}; got {x.dtype} "
            f"{tuple(x.shape)} on {x.device} (contiguous="
            f"{x.is_contiguous()})")


def gas_tiles(vwin, edge_src, edge_dst, edge_w, tile_edge_start,
              tile_chunk_start, *, scatter_op: Optional[str], mode: str,
              t: int, chunk_edges: int = CHUNK_EDGES,
              scatter_fn=None) -> torch.Tensor:
    """Run the GAS kernel over one payload's live-edge stream (a single
    plan entry or a packed lane of tile-disjoint segments: the same
    launch). Output tile ``k`` combines edges ``tile_edge_start[k]:
    tile_edge_start[k + 1]``, cut into the chunks ``tile_chunk_start``
    counts with ``chunk_edges`` (the sweep that chose
    :data:`CHUNK_EDGES` is the only caller of another). ``scatter_op``
    names a built-in op; ``None`` launches the variant generated for
    ``scatter_fn`` (traced once per function, its library built at first
    use), and a UDF outside the code generator's ops raises
    ``NotImplementedError``: there is no fallback.

    Tensors must lie on one CUDA device: it launches the kernel or
    raises, and raises on CPU tensors (the plain version over the same
    stream, :func:`.ref.gas_stream_ref`, is ``ops.run_lane(...,
    path="ref")``).
    Returns ``(n_out_tiles, t)`` tiles in vwin's dtype. Each call counts
    itself (:func:`count_launch`): one launch per payload, although the
    kernel takes two device launches, the stream's length in edges and,
    in an exact mode, in ``exact_edges``.
    """
    if mode not in MODES:
        raise ValueError(f"unknown gather mode {mode!r}")
    if scatter_op is None:
        if scatter_fn is None:
            raise ValueError("gas kernel: scatter_op=None needs the "
                             "scatter_fn to generate a variant from")
        op_code = SCATTER_CUSTOM
    elif scatter_op not in KERNEL_SCATTER_OPS or (
            mode == "or" and scatter_op != "copy"):
        raise NotImplementedError(
            f"the CUDA GAS kernel has no scatter op {scatter_op!r} for mode "
            f"{mode!r}; it names {sorted(KERNEL_SCATTER_OPS)} ('copy' only "
            "for 'or'), and scatter_op=None generates one from scatter_fn")
    else:
        scatter_fn, op_code = None, KERNEL_SCATTER_OPS[scatter_op]
    lib = _cached_library(scatter_fn, mode)
    if lib is None and scatter_fn is not None:
        scatter_udf(scatter_fn, mode)     # an untraceable UDF raises here
    if not vwin.is_cuda:
        raise ValueError(
            f"gas kernel: tensors must lie on a CUDA device, got "
            f"{vwin.device}; the plain version is ops.run_lane(..., "
            f"path='ref')")
    n_out_tiles = tile_edge_start.shape[0] - 1
    n_edges = edge_src.shape[0]
    if not 0 < t <= MAX_T or chunk_edges <= 0 \
            or chunk_edges % EDGES_PER_THREAD:
        raise ValueError(f"gas kernel takes T <= {MAX_T} ({N_WARPS} "
                         f"accumulators and tags of T slots in {MAX_SMEM} B "
                         f"of shared memory) and chunks of a positive "
                         f"multiple of {EDGES_PER_THREAD} edges; got T={t}, "
                         f"chunk_edges={chunk_edges}")
    dev = vwin.device
    vdt = torch.int32 if mode == "or" else torch.float32
    _check("vwin", vwin, vdt, vwin.shape, dev)
    for name, x in (("edge_src", edge_src), ("edge_dst", edge_dst)):
        _check(name, x, torch.int32, (n_edges,), dev)
    _check("edge_w", edge_w, torch.float32, (n_edges,), dev)
    for name, x in (("tile_edge_start", tile_edge_start),
                    ("tile_chunk_start", tile_chunk_start)):
        _check(name, x, torch.int32, (n_out_tiles + 1,), dev)
    out = torch.empty((n_out_tiles, t), dtype=vdt, device=dev)
    if n_out_tiles == 0:
        return out
    n_chunks = max_chunks(n_edges, n_out_tiles, chunk_edges)
    # the partial tiles of sum's ordered combine (the exact modes fold
    # into out)
    scratch = (None if mode in EXACT_MODES else
               torch.empty((n_chunks, t), dtype=vdt, device=dev))
    lib = lib or _load_library(scatter_fn, mode)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        recording = torch.cuda.is_current_stream_capturing()
        err = lib.gas_launch(
            MODES[mode], op_code, vwin.data_ptr(), edge_src.data_ptr(),
            edge_dst.data_ptr(), edge_w.data_ptr(),
            tile_edge_start.data_ptr(), tile_chunk_start.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            n_out_tiles, n_chunks, chunk_edges, t, stream)
    if err != 0:
        raise RuntimeError(f"gas kernel launch failed: CUDA error {err} "
                           f"(mode={mode}, op={scatter_op or 'custom'}, "
                           f"T={t}, edges={n_edges}, tiles={n_out_tiles}, "
                           f"chunks<={n_chunks})")
    count_launch(n_edges, mode, recording)
    return out


# what gas_tiles counts: its calls, the live edges they streamed, and those
# of the exact modes (the order-free fold)
COUNTS = ("launches", "edges", "exact_edges")


def count_launch(n_edges: int, mode: str, recording: bool = False) -> None:
    """Count one call of :func:`gas_tiles` over ``n_edges`` live edges in
    ``mode``: one in ``gas_tiles.launches``, ``n_edges`` in ``edges`` and,
    for an exact mode, in ``exact_edges``. A call on a stream that is
    capturing a CUDA graph launches nothing then, so it counts into
    ``recorded_launches``, ``recorded_edges`` and ``recorded_exact_edges``
    instead; each replay of the graph adds what it recorded
    (:func:`recorded_counts`, :func:`add_counts`; ``core/replay.py``)."""
    add = {"launches": 1, "edges": n_edges,
           "exact_edges": n_edges if mode in EXACT_MODES else 0}
    add_counts(add, "recorded_" if recording else "")


def add_counts(add: dict, prefix: str = "") -> None:
    """Add ``add`` (counts of :data:`COUNTS`) to ``gas_tiles``'s
    counters whose names start with ``prefix``."""
    for name, n in add.items():
        setattr(gas_tiles, prefix + name, getattr(gas_tiles, prefix + name)
                + n)


def recorded_counts() -> dict:
    """The counts recorded into CUDA graphs so far, by :data:`COUNTS`."""
    return {name: getattr(gas_tiles, "recorded_" + name) for name in COUNTS}


gas_tiles.launches = gas_tiles.edges = gas_tiles.exact_edges = 0
gas_tiles.recorded_launches = gas_tiles.recorded_edges = 0
gas_tiles.recorded_exact_edges = 0

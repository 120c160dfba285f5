"""The GAS kernel for Hopper: its wrapper, launch count and design note.

Replaces ``repro/kernels/gas_kernel.py::make_gas_kernel`` of the
reference package (the Pallas body behind ``gas_pallas_call`` and
``gas_pallas_call_segmented``). Source: ``csrc/gas_kernel.cu``, CUDA C++
for ``sm_90a``, built at first use by :mod:`._build` and bound with
``ctypes``.

What it computes: for every E_BLK-edge block ``b`` and edge ``e``, gather
``vwin[window_id[b], src_local[b, e]]``, apply the scatter op with the
edge weight (a named op, or the app's own scatter UDF traced into C++
by :mod:`.udf_codegen`, one library per UDF), and combine into slot
``dst_local[b, e]`` of the block's output tile in mode sum, min, max
(float32) or or (int32). Tile ``k``
owns blocks ``tile_block_start[k]:tile_block_start[k + 1]``. Pads
(``valid == 0``) contribute nothing. The output is ``(n_out_tiles, T)``.

Bound. A launch must read ``valid`` for every padded edge slot, src and
dst (and the weight, for ``add_weight``) of every real edge, the
per-block window ids, the tile index, each distinct source value the
real edges read once, and write ``n_out_tiles * T`` results; it does one
combine per real edge (two operations with ``add_weight``).
``chip_smoke.py`` (``_kernel_traffic``) counts these bytes and
operations; on an H100 (3.35 TB/s, 67 TFLOP/s fp32) the bytes bound it.

Design. The Pallas body runs its grid in order on one core and carries a
tile accumulator across grid steps; a CUDA grid has no order. The first
design gave each tile one CTA that walked its blocks in order, and lost
to three limits, each of which this design answers:

1. Too few CTAs, and skew: a launch took its heaviest tile's blocks one
   after another. Now each tile's blocks are cut into chunks of
   :data:`CHUNK_BLOCKS`, counted from the tile's first block, and each
   CTA takes one chunk; the pack-time index ``tile_chunk_start``
   (``n_out_tiles + 1`` int32, beside ``tile_block_start``) gives each
   tile's first chunk, and a CTA finds its tile by binary search in it.
   A tile of one chunk is written straight to the output; the chunks of
   a larger tile write partial tiles to scratch, and a second, ordered
   pass combines those slot by slot in chunk order.
2. Every thread read every staged edge. Now a warp combines its 32 edge
   slots at once: each live lane tags its slot in shared memory, and a
   slot no other lane shares (most Big steps) is folded by its own
   lane. Lanes that share a slot are grouped (``__match_any_sync``) and
   reduce over a fixed lane-order tree of shuffles (a long run to a hub
   slot takes five steps, not 32); the group's lowest lane folds the
   total into the warp's own accumulator in shared memory. The warps'
   accumulators merge in warp order at the end of the chunk.
3. Pads cost a scan step. Now a pad slot is one ``valid`` load: it
   gathers nothing and takes no shared-memory step, and a warp whose 32
   slots are all pads skips the step after its ballot. ``valid`` is
   read slot by slot, never assumed to be a prefix of the block. A
   chunk takes one barrier.

No atomics anywhere: the order of every fp32 combine depends only on the
tile's blocks and their tile-relative positions, never on scheduling, so
results are bit-stable and the fused and per-entry launch forms (whose
entries are tile-snapped) agree bit for bit.
"""
from __future__ import annotations

import ctypes
import weakref
from typing import Optional

import numpy as np
import torch

from . import _build, udf_codegen

MODES = {"sum": 0, "min": 1, "max": 2, "or": 3}
KERNEL_SCATTER_OPS = {"copy": 0, "add_weight": 1}
SCATTER_CUSTOM = 2        # the kernel's code for a generated UDF variant
# blocks per CTA chunk; chosen on the card from {16, 32, 64} (PERF.md)
CHUNK_BLOCKS = 16
MAX_E_BLK = 1024          # edge slots of a block the kernel takes
N_WARPS = 8               # a 4-byte accumulator and a 1-byte tag per slot each
MAX_SMEM = 232448         # a CTA's shared memory on sm_90
MAX_T = MAX_SMEM // (N_WARPS * 5)

_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 10 + [
    ctypes.c_int] * 5 + [ctypes.c_void_p]


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


def _library(chunk_blocks: int = CHUNK_BLOCKS, prelude: str = ""):
    lib = _build.load("gas_kernel", prelude, GAS_CHUNK_BLOCKS=chunk_blocks)
    if lib.gas_launch.argtypes is None:
        lib.gas_chunk_blocks.argtypes = []
        lib.gas_chunk_blocks.restype = ctypes.c_int
        if lib.gas_chunk_blocks() != chunk_blocks:
            raise RuntimeError(f"gas kernel library counts chunks of "
                               f"{lib.gas_chunk_blocks()} blocks, not "
                               f"{chunk_blocks}")
        lib.gas_launch.argtypes = _ARGTYPES
        lib.gas_launch.restype = ctypes.c_int
    return lib


_named_libs: dict = {}                   # chunk_blocks -> library
# scatter_fn -> {(mode, chunk_blocks): library}, while scatter_fn lives
_udf_libs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _cached_library(scatter_fn, mode: str, chunk_blocks: int):
    """The library of a launch if an earlier one loaded it, else None:
    the named ops' (``scatter_fn`` None) or ``scatter_fn``'s variant in
    ``mode``; one dict lookup per launch."""
    if scatter_fn is None:
        return _named_libs.get(chunk_blocks)
    try:
        return _udf_libs.get(scatter_fn, {}).get((mode, chunk_blocks))
    except TypeError:                 # not weak-referenceable: no cache
        return None


def _load_library(scatter_fn, mode: str, chunk_blocks: int):
    """Build or load the library :func:`_cached_library` lacks, and
    cache it."""
    if scatter_fn is None:
        lib = _named_libs[chunk_blocks] = _library(chunk_blocks)
        return lib
    lib = _library(chunk_blocks, udf_prelude(scatter_fn, mode))
    try:
        _udf_libs.setdefault(scatter_fn, {})[(mode, chunk_blocks)] = lib
    except TypeError:
        pass
    return lib


def build(chunk_blocks: int = CHUNK_BLOCKS, scatter_fn=None,
          mode: Optional[str] = None) -> None:
    """Build and load the kernel library now (it is built at first
    launch otherwise): the named ops' library, or with ``scatter_fn``
    the variant generated for that UDF in ``mode``."""
    _library(chunk_blocks,
             "" if scatter_fn is None else udf_prelude(scatter_fn, mode))


def tile_chunk_start(tile_block_start: np.ndarray,
                     chunk_blocks: int = CHUNK_BLOCKS) -> np.ndarray:
    """First chunk of each output tile, ``n_out_tiles + 1`` int32: tile
    ``k``'s blocks, counted from its first, make ``ceil(blocks /
    chunk_blocks)`` chunks, ``[start[k], start[k + 1])``."""
    blocks = np.diff(np.asarray(tile_block_start, np.int64))
    return np.concatenate(
        [[0], np.cumsum(-(-blocks // chunk_blocks))]).astype(np.int32)


def max_chunks(n_blocks: int, n_out_tiles: int,
               chunk_blocks: int = CHUNK_BLOCKS) -> int:
    """The most chunks ``n_blocks`` blocks in ``n_out_tiles`` non-empty
    tiles can make: the grid of the kernel's first pass, known without
    reading ``tile_chunk_start`` back from the card."""
    return n_out_tiles + max(0, n_blocks - n_out_tiles) // chunk_blocks


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or x.device != device or not x.is_contiguous():
        raise ValueError(
            f"gas kernel: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}; got {x.dtype} "
            f"{tuple(x.shape)} on {x.device} (contiguous="
            f"{x.is_contiguous()})")


def gas_tiles(vwin, src_local, dst_local, weights, valid, window_id,
              tile_block_start, tile_chunk_start, *,
              scatter_op: Optional[str], mode: str, t: int,
              chunk_blocks: int = CHUNK_BLOCKS,
              scatter_fn=None) -> torch.Tensor:
    """Run the GAS kernel over one payload (a single plan entry or a
    packed lane of tile-disjoint segments: the same launch). Takes only
    the arrays the kernel reads; output tile ``k`` combines blocks
    ``tile_block_start[k]:tile_block_start[k + 1]``, cut into the
    chunks ``tile_chunk_start`` counts with ``chunk_blocks`` (the sweep
    that chose :data:`CHUNK_BLOCKS` is the only caller of another).
    ``scatter_op`` names a built-in op; ``None`` launches the variant
    generated for ``scatter_fn`` (traced once per function, its library
    built at first use), and a UDF outside the code generator's ops
    raises ``NotImplementedError``: there is no fallback.

    Tensors must lie on one CUDA device: it launches the kernel or
    raises, and raises on CPU tensors (the plain version,
    :func:`.ref.gas_ref`, is ``ops.run_lane(..., path="ref")``).
    Returns ``(n_out_tiles, t)`` tiles in vwin's dtype. Each call adds
    one to ``gas_tiles.launches``: one per payload, although the kernel
    takes two device launches (chunks, then the ordered combine).
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
    lib = _cached_library(scatter_fn, mode, chunk_blocks)
    if lib is None and scatter_fn is not None:
        scatter_udf(scatter_fn, mode)     # an untraceable UDF raises here
    if not vwin.is_cuda:
        raise ValueError(
            f"gas kernel: tensors must lie on a CUDA device, got "
            f"{vwin.device}; the plain version is ops.run_lane(..., "
            f"path='ref')")
    n_out_tiles = tile_block_start.shape[0] - 1
    n_blocks, e_blk = src_local.shape
    w = vwin.shape[1]
    if not 0 < e_blk <= MAX_E_BLK or not 0 < t <= MAX_T:
        raise ValueError(f"gas kernel takes E_BLK <= {MAX_E_BLK} and "
                         f"T <= {MAX_T} ({N_WARPS} accumulators and tags "
                         f"of T slots in {MAX_SMEM} B of shared memory); "
                         f"got E_BLK={e_blk}, T={t}")
    dev = vwin.device
    vdt = torch.int32 if mode == "or" else torch.float32
    _check("vwin", vwin, vdt, vwin.shape, dev)
    for name, x in (("src_local", src_local), ("dst_local", dst_local),
                    ("valid", valid)):
        _check(name, x, torch.int32, (n_blocks, e_blk), dev)
    _check("weights", weights, torch.float32, (n_blocks, e_blk), dev)
    _check("window_id", window_id, torch.int32, (n_blocks,), dev)
    for name, x in (("tile_block_start", tile_block_start),
                    ("tile_chunk_start", tile_chunk_start)):
        _check(name, x, torch.int32, (n_out_tiles + 1,), dev)
    out = torch.empty((n_out_tiles, t), dtype=vdt, device=dev)
    if n_out_tiles == 0:
        return out
    n_chunks = max_chunks(n_blocks, n_out_tiles, chunk_blocks)
    scratch = torch.empty((n_chunks, t), dtype=vdt, device=dev)
    lib = lib or _load_library(scatter_fn, mode, chunk_blocks)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gas_launch(
            MODES[mode], op_code, vwin.data_ptr(),
            src_local.data_ptr(), dst_local.data_ptr(), weights.data_ptr(),
            valid.data_ptr(), window_id.data_ptr(),
            tile_block_start.data_ptr(), tile_chunk_start.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), n_out_tiles, n_chunks,
            e_blk, w, t, stream)
    if err != 0:
        raise RuntimeError(f"gas kernel launch failed: CUDA error {err} "
                           f"(mode={mode}, op={scatter_op or 'custom'}, "
                           f"E_BLK={e_blk}, W={w}, T={t}, "
                           f"tiles={n_out_tiles}, chunks<={n_chunks})")
    gas_tiles.launches += 1
    return out


gas_tiles.launches = 0

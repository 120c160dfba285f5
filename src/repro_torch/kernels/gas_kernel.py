"""The GAS kernel for Hopper: its wrapper, launch count and design note.

Replaces ``repro/kernels/gas_kernel.py::make_gas_kernel`` of the
reference package (the Pallas body behind ``gas_pallas_call`` and
``gas_pallas_call_segmented``). Source: ``csrc/gas_kernel.cu``, CUDA C++
for ``sm_90a``, built at first use by :mod:`._build` and bound with
``ctypes``.

What it computes: for every E_BLK-edge block ``b`` and edge ``e``, gather
``vwin[window_id[b], src_local[b, e]]``, apply the scatter op with the
edge weight, and combine into slot ``dst_local[b, e]`` of output tile
``tile_id[b]`` in mode sum, min, max (float32) or or (int32). Pads
(``valid == 0``) contribute the identity. The output is
``(n_out_tiles, T)``.

Design. The Pallas body runs its grid in order on one core and carries a
tile accumulator across grid steps; a CUDA grid has no order. So one CTA
owns one output tile and walks that tile's blocks in order, from the
per-payload index ``tile_block_start`` (``n_out_tiles + 1`` entries,
built at pack time from ``tile_id``), which replaces the Pallas body's
sequential ``tile_first`` re-init and flush check. The one-hot MXU
products of the Pallas body have no place here: the gather is a direct
indexed load, and the combine is owner-computes in shared memory (slot
``d`` belongs to thread ``d % 256``, which scans the staged edges in
order). There are no float atomics, so every run sums in the same
order: kernel results are bit-stable, and the fused and per-entry paths
agree bit for bit.

Bound. The kernel must read ``valid`` for every padded edge slot, src
and dst (and the weight, for ``add_weight``) of every real edge, the
per-block window ids, the tile index and the property windows it
touches, and write ``n_out_tiles * T`` results; it does one combine
(two operations with ``add_weight``) per real edge. On an H100
(3.35 TB/s, 67 TFLOP/s fp32) the bytes bound it by far
(``chip_smoke.py`` computes the bound). This first design is far from it:
one CTA per tile gives a launch fewer CTAs than the card has SMs, every
thread of a CTA reads every staged edge, and a tile's blocks run one
after another. Splitting heavy tiles across CTAs is the first step
towards the bound (ROADMAP Queue 3).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.gas import SCATTER_OPS
from . import _build
from .ref import gas_ref

MODES = {"sum": 0, "min": 1, "max": 2, "or": 3}
KERNEL_SCATTER_OPS = {"copy": 0, "add_weight": 1}
MAX_E_BLK = 1024          # 256 threads x 4 staged edges each
MAX_T = 1 << 22           # slot ids must fit the kernel's owner key

_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 8 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _library():
    lib = _build.load("gas_kernel")
    if lib.gas_launch.argtypes is None:
        lib.gas_launch.argtypes = _ARGTYPES
        lib.gas_launch.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build and load the kernel library now (it is built at first
    launch otherwise)."""
    _library()


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or x.device != device or not x.is_contiguous():
        raise ValueError(
            f"gas kernel: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}; got {x.dtype} "
            f"{tuple(x.shape)} on {x.device} (contiguous="
            f"{x.is_contiguous()})")


def gas_tiles(vwin, src_local, dst_local, weights, valid, window_id,
              tile_block_start, *, scatter_op: Optional[str], mode: str,
              t: int) -> torch.Tensor:
    """Run the GAS kernel over one payload (a single plan entry or a
    packed lane of tile-disjoint segments: the same launch). Takes only
    the arrays the kernel reads; output tile ``k`` combines blocks
    ``tile_block_start[k]:tile_block_start[k + 1]``.

    On CUDA tensors it launches the kernel or raises. On CPU tensors it
    runs the plain version, :func:`.ref.gas_ref`, on the same arrays.
    Returns ``(n_out_tiles, t)`` tiles in vwin's dtype. Each launch adds
    one to ``gas_tiles.launches``.
    """
    if mode not in MODES:
        raise ValueError(f"unknown gather mode {mode!r}")
    if scatter_op not in KERNEL_SCATTER_OPS or (
            mode == "or" and scatter_op != "copy"):
        raise NotImplementedError(
            f"the CUDA GAS kernel has no scatter op {scatter_op!r} for mode "
            f"{mode!r}; it implements {sorted(KERNEL_SCATTER_OPS)} "
            "('copy' only for 'or')")
    n_out_tiles = tile_block_start.shape[0] - 1
    if not vwin.is_cuda:
        tile_id = torch.repeat_interleave(
            torch.arange(n_out_tiles, device=vwin.device),
            torch.diff(tile_block_start).to(torch.int64))
        return gas_ref(vwin, src_local, dst_local, weights, valid,
                       window_id, tile_id, scatter_fn=SCATTER_OPS[scatter_op],
                       mode=mode, t=t, n_out_tiles=n_out_tiles)
    n_blocks, e_blk = src_local.shape
    w = vwin.shape[1]
    if not 0 < e_blk <= MAX_E_BLK or not 0 < t < MAX_T:
        raise ValueError(f"gas kernel takes E_BLK <= {MAX_E_BLK} and "
                         f"T < {MAX_T}; got E_BLK={e_blk}, T={t}")
    dev = vwin.device
    vdt = torch.int32 if mode == "or" else torch.float32
    _check("vwin", vwin, vdt, vwin.shape, dev)
    for name, x in (("src_local", src_local), ("dst_local", dst_local),
                    ("valid", valid)):
        _check(name, x, torch.int32, (n_blocks, e_blk), dev)
    _check("weights", weights, torch.float32, (n_blocks, e_blk), dev)
    _check("window_id", window_id, torch.int32, (n_blocks,), dev)
    _check("tile_block_start", tile_block_start, torch.int32,
           (n_out_tiles + 1,), dev)
    out = torch.empty((n_out_tiles, t), dtype=vdt, device=dev)
    if n_out_tiles == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gas_launch(
            MODES[mode], KERNEL_SCATTER_OPS[scatter_op], vwin.data_ptr(),
            src_local.data_ptr(), dst_local.data_ptr(), weights.data_ptr(),
            valid.data_ptr(), window_id.data_ptr(),
            tile_block_start.data_ptr(), out.data_ptr(), n_out_tiles, e_blk,
            w, t, stream)
    if err != 0:
        raise RuntimeError(f"gas kernel launch failed: CUDA error {err} "
                           f"(mode={mode}, E_BLK={e_blk}, W={w}, T={t}, "
                           f"tiles={n_out_tiles})")
    gas_tiles.launches += 1
    return out


gas_tiles.launches = 0

"""Carry state across from the reference package's host form.

The reference's graphs, host payloads and (through ``np.asarray``) LM
parameter trees and decode caches are numpy, so the port takes them
without importing the reference: the tests use these helpers to feed
both packages the same graph, the same blocked inputs and the same
weights.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.types import Geometry
from .graphs.formats import Graph, canonicalize
from .kernels import ops


def graph_from_arrays(num_vertices: int, src, dst, weights=None,
                      name: str = "graph") -> Graph:
    """A port :class:`Graph` from COO arrays (copied; canonicalized, not
    deduplicated)."""
    g = Graph(num_vertices=int(num_vertices),
              src=np.array(src, dtype=np.int32),
              dst=np.array(dst, dtype=np.int32),
              weights=(None if weights is None
                       else np.array(weights, dtype=np.float32)),
              name=name)
    return canonicalize(g)


def geometry_from(geom) -> Geometry:
    """A port :class:`Geometry` with the same fields as ``geom``."""
    return Geometry(U=geom.U, W=geom.W, T=geom.T, E_BLK=geom.E_BLK,
                    big_batch=geom.big_batch)


def payload_from_numpy(p: dict, device) -> dict:
    """A port device payload from a reference host payload dict (numpy
    arrays, as ``_entry_np``/``_pack_group`` build them). Adds
    ``tile_block_start``, from which the upload derives the live-edge
    stream; the device payload keeps no padded array."""
    p = dict(p)
    p["geom"] = geometry_from(p["geom"])
    p["tile_block_start"] = ops.tile_block_start(
        np.asarray(p["tile_id"]), int(p["n_out_tiles"]))
    return ops._upload_payload(p, ops.resolve_device(device))


# numpy dtypes without a torch twin for from_numpy (ml_dtypes' bfloat16
# and float8, which the reference's bf16 / f8 arrays carry), found by
# name: the same-width unsigned view crosses, then re-views as the
# torch dtype
_BITCAST = {"bfloat16": (np.uint16, torch.bfloat16),
            "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)                 # a writable, contiguous copy
    if a.dtype.name in _BITCAST:
        view, dt = _BITCAST[a.dtype.name]
        return torch.from_numpy(a.view(view)).view(dt).to(device)
    return torch.from_numpy(a).to(device)


def lm_params_from_numpy(tree, device):
    """A port LM tree from the reference's, leaf for leaf: nested dicts
    (lists, tuples) of numpy arrays, e.g. ``jax.tree.map(np.asarray,
    params)`` or a decode cache, become the same nesting of tensors on
    ``device`` with the same shapes and dtypes (bf16 and f8 included)."""
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(lm_params_from_numpy(v, device) for v in tree)
    return _leaf_from_numpy(np.asarray(tree), device)

"""Carry state across from the reference package's host form.

The reference's graphs and host payloads are numpy, so the port takes
them without importing the reference: the tests use these helpers to
feed both packages the same graph and the same blocked inputs.
"""
from __future__ import annotations

import numpy as np

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
    arrays, as ``_entry_np``/``_pack_group`` build them). Adds the
    kernel's ``tile_block_start`` and ``tile_chunk_start``."""
    p = dict(p)
    p["geom"] = geometry_from(p["geom"])
    p["tile_block_start"] = ops.tile_block_start(
        np.asarray(p["tile_id"]), int(p["n_out_tiles"]))
    p["tile_chunk_start"] = ops.tile_chunk_start(p["tile_block_start"])
    return ops._upload_payload(p, ops.resolve_device(device))

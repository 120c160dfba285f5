"""Graph/store identity for the serving layer.

A served GraphStore is identified by ``(graph fingerprint, geometry,
use_dbg)`` — everything :class:`~repro_torch.core.store.GraphStore` is a pure
function of. The content hash itself lives in
:func:`repro_torch.graphs.formats.fingerprint` (next to the COO container);
this module builds the composite cache key and normalizes the
"graph-or-fingerprint" argument the service accepts.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

from ..core.types import Geometry
from ..graphs.formats import Graph
from ..graphs.formats import fingerprint as graph_fingerprint

__all__ = ["StoreKey", "graph_fingerprint", "store_key", "resolve_fingerprint"]

# (graph fingerprint hex, geometry, use_dbg) — hashable, order-stable
StoreKey = Tuple[str, Geometry, bool]


def store_key(fp: str, geom: Geometry, use_dbg: bool) -> StoreKey:
    """Composite identity of one GraphStore in the serving cache."""
    if not isinstance(fp, str) or not fp:
        raise ValueError(f"fingerprint must be a non-empty hex string, "
                         f"got {fp!r}")
    return (fp, geom, bool(use_dbg))


def resolve_fingerprint(graph_or_fp: Union[Graph, str, None],
                        fingerprint: Optional[str] = None) -> str:
    """Normalize the service's ``(graph | fingerprint)`` submission
    argument to a fingerprint string. Exactly one identity source must
    be present."""
    if isinstance(graph_or_fp, str):
        if fingerprint is not None and fingerprint != graph_or_fp:
            raise ValueError("two different fingerprints given")
        return graph_or_fp
    if graph_or_fp is not None:
        fp = graph_or_fp.fingerprint()
        if fingerprint is not None and fingerprint != fp:
            raise ValueError(f"fingerprint= {fingerprint!r} does not match "
                             f"the graph's own fingerprint {fp!r}")
        return fp
    if fingerprint is None:
        raise ValueError("submit() needs a graph or a fingerprint")
    return fingerprint

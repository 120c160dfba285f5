"""COO graph container and basic format utilities (numpy; a copy of the
reference package's ``graphs/formats.py`` so fingerprints stay byte-equal).

The paper (ReGraph §II-A) uses the standard COO representation with row
indices (source vertices) in ascending order. We keep the same canonical
form and add the degree statistics that drive degree-based grouping (DBG)
and the performance model.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Graph:
    """A directed graph in COO format.

    Invariants (enforced by :func:`canonicalize`):
      * ``src``/``dst`` are int32 arrays of equal length E.
      * edges sorted by (src, dst).
      * ``num_vertices`` >= max(src.max(), dst.max()) + 1.
    """

    num_vertices: int
    src: np.ndarray
    dst: np.ndarray
    weights: Optional[np.ndarray] = None
    name: str = "graph"

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def avg_degree(self) -> float:
        return self.num_edges / max(1, self.num_vertices)

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.num_vertices).astype(np.int32)

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.num_vertices).astype(np.int32)

    def fingerprint(self, refresh: bool = False) -> str:
        """Stable content hash of the graph (see :func:`fingerprint`).

        The digest is cached on the instance; rebinding ``weights`` (or
        any array attribute) to a *new* array invalidates it. Canonical
        graphs carry read-only arrays (see :func:`canonicalize`), so the
        cached digest can never go silently stale via in-place edits —
        structural change builds a new Graph (and a new fingerprint)
        instead.
        ``refresh=True`` forces a re-hash anyway (escape hatch for
        hand-built, still-writable Graphs).
        """
        cached = getattr(self, "_fp_cache", None)
        if (not refresh and cached is not None
                and cached[0] == self.num_vertices
                and cached[1] is self.src and cached[2] is self.dst
                and cached[3] is self.weights):
            return cached[4]
        fp = fingerprint(self)
        object.__setattr__(
            self, "_fp_cache",
            (self.num_vertices, self.src, self.dst, self.weights, fp))
        return fp

    def reversed(self) -> "Graph":
        """Transpose (used by pull-based execution: edges point dst->src)."""
        g = Graph(
            num_vertices=self.num_vertices,
            src=self.dst.copy(),
            dst=self.src.copy(),
            weights=None if self.weights is None else self.weights.copy(),
            name=self.name + "_T",
        )
        return canonicalize(g)


def _raw(a: np.ndarray, dtype) -> memoryview:
    """The bytes of ``a`` as ``dtype``, without the copy ``tobytes``
    makes (the same bytes, so the same digest)."""
    return memoryview(np.ascontiguousarray(a, dtype=dtype)).cast("B")


def fingerprint(g: Graph) -> str:
    """Stable content hash of a graph: vertex count + edge arrays (+
    weights when present). The ``name`` field is cosmetic and excluded,
    so the same edges loaded under two names share one fingerprint —
    this is the identity the serving layer keys GraphStores on.
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(f"V={g.num_vertices};E={g.num_edges};".encode())
    h.update(_raw(g.src, np.int32))
    h.update(_raw(g.dst, np.int32))
    if g.weights is None:
        h.update(b";w=none")
    else:
        h.update(b";w=f32;")
        h.update(_raw(g.weights, np.float32))
    return h.hexdigest()


def freeze(g: Graph) -> Graph:
    """Mark the graph's arrays read-only. Every canonical Graph is
    frozen: the cached :meth:`Graph.fingerprint` (and every store /
    plan / packed-payload cache keyed on it) relies on edge arrays
    never mutating in place. Structural change builds a new Graph.
    The arrays here are always fresh copies (fancy indexing), so this
    never freezes caller-owned buffers."""
    g.src.setflags(write=False)
    g.dst.setflags(write=False)
    if g.weights is not None:
        g.weights.setflags(write=False)
    return g


def canonicalize(g: Graph) -> Graph:
    """Sort edges by (src, dst) — the paper's ascending-row COO form.
    The sorted arrays are frozen (see :func:`freeze`)."""
    order = np.lexsort((g.dst, g.src))
    g.src = np.ascontiguousarray(g.src[order], dtype=np.int32)
    g.dst = np.ascontiguousarray(g.dst[order], dtype=np.int32)
    if g.weights is not None:
        g.weights = np.ascontiguousarray(g.weights[order], dtype=np.float32)
    return freeze(g)


def from_edges(
    src, dst, num_vertices: Optional[int] = None, weights=None, name: str = "graph",
    dedup: bool = True,
) -> Graph:
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    if num_vertices is None:
        num_vertices = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
    if dedup and src.size:
        key = src.astype(np.int64) * num_vertices + dst.astype(np.int64)
        _, idx = np.unique(key, return_index=True)
        src, dst = src[idx], dst[idx]
        if weights is not None:
            weights = np.asarray(weights, dtype=np.float32)[idx]
    g = Graph(num_vertices=num_vertices, src=src, dst=dst,
              weights=None if weights is None else np.asarray(weights, np.float32),
              name=name)
    return canonicalize(g)


def to_csr(g: Graph):
    """Return (indptr, indices[, weights]) CSR of the canonical COO."""
    indptr = np.zeros(g.num_vertices + 1, dtype=np.int64)
    np.add.at(indptr, g.src + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, g.dst.copy(), (None if g.weights is None else g.weights.copy())


def relabel(g: Graph, perm: np.ndarray, name_suffix: str = "_dbg") -> Graph:
    """Relabel vertices: new_id = perm[old_id]; re-canonicalize."""
    assert perm.shape[0] == g.num_vertices
    g2 = Graph(
        num_vertices=g.num_vertices,
        src=perm[g.src].astype(np.int32),
        dst=perm[g.dst].astype(np.int32),
        weights=None if g.weights is None else g.weights.copy(),
        name=g.name + name_suffix,
    )
    return canonicalize(g2)


def degree_stats(g: Graph) -> dict:
    ind = g.in_degrees()
    outd = g.out_degrees()
    return {
        "V": g.num_vertices,
        "E": g.num_edges,
        "avg_deg": g.avg_degree,
        "max_in": int(ind.max(initial=0)),
        "max_out": int(outd.max(initial=0)),
        "p99_in": int(np.percentile(ind, 99)) if g.num_vertices else 0,
        "zero_in_frac": float((ind == 0).mean()) if g.num_vertices else 0.0,
    }

"""R-MAT / Kronecker graph generator (Leskovec et al., JMLR'10).

The paper's synthetic datasets (rmat-19-32 etc.) use the Graph500 R-MAT
parameters (a,b,c,d) = (0.57, 0.19, 0.19, 0.05). We generate the same
family at CPU-feasible scales. Fully vectorised with numpy; O(E log V).
"""
from __future__ import annotations

import numpy as np

from .formats import Graph, from_edges

G500 = (0.57, 0.19, 0.19, 0.05)


def rmat(
    scale: int,
    edge_factor: int,
    params=G500,
    seed: int = 0,
    weighted: bool = False,
    name: str | None = None,
) -> Graph:
    """Generate an R-MAT graph with 2**scale vertices, edge_factor*V edges."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    num_edges = n * edge_factor
    a, b, c, d = params
    # Per-bit quadrant draws, vectorised over all edges at once.
    src = np.zeros(num_edges, dtype=np.int64)
    dst = np.zeros(num_edges, dtype=np.int64)
    ab = a + b
    a_norm = a / ab
    c_norm = c / (c + d)
    for bit in range(scale):
        r_row = rng.random(num_edges)
        go_down = r_row >= ab  # lower half of the adjacency quadrant
        r_col = rng.random(num_edges)
        right_top = r_col >= a_norm
        right_bot = r_col >= c_norm
        go_right = np.where(go_down, right_bot, right_top)
        src = (src << 1) | go_down
        dst = (dst << 1) | go_right
    # Random permutation of vertex labels to avoid artificial id-locality
    # beyond what DBG later re-creates deliberately.
    perm = rng.permutation(n)
    src = perm[src]
    dst = perm[dst]
    # Drop self loops.
    keep = src != dst
    src, dst = src[keep], dst[keep]
    weights = rng.random(src.shape[0]).astype(np.float32) if weighted else None
    gname = name or f"rmat-{scale}-{edge_factor}"
    return from_edges(src, dst, num_vertices=n, weights=weights, name=gname)


def uniform_random(scale: int, edge_factor: int, seed: int = 0,
                   name: str | None = None) -> Graph:
    """Erdos-Renyi-ish uniform graph — the 'no skew' control."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    return from_edges(src[keep], dst[keep], num_vertices=n,
                      name=name or f"uniform-{scale}-{edge_factor}")

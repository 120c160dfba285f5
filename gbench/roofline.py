"""The yardstick's peaks and byte counts.

Peaks are data-sheet rates at the full power limit (NVIDIA H100 data
sheet: SXM 3.35 TB/s of HBM3, PCIe 2.0 TB/s, NVL 3.9 TB/s), matched
against ``torch.cuda.get_device_name()``.
"""
from __future__ import annotations

from typing import Optional

HBM_BYTES_PER_S = (("H100 80GB HBM3", 3.35e12), ("H100 PCIe", 2.0e12),
                   ("H100 NVL", 3.9e12))


def hbm_bytes_per_s(kind: str) -> Optional[float]:
    """The card's memory rate, or None for a card not in the table."""
    for name, rate in HBM_BYTES_PER_S:
        if name in kind:
            return rate
    return None


def pagerank_bytes(num_vertices: int, num_edges: int,
                   iterations: int) -> int:
    """The least bytes PageRank's Scatter+Gather moves over
    ``iterations`` iterations, counted from the graph and not from the
    port's layout. Every iteration needs every edge, so per iteration:
    one 4 B vertex id per edge (the other end implied by edges grouped
    by vertex, with a 4 B offset per vertex), each vertex value read
    once and each output written once (4 B each).

    Only PageRank is counted: BFS, SSSP and WCC need only the edges of
    their active vertices, which change from iteration to iteration, so
    a count of every edge would exceed what they need and let a kernel
    that skips inactive edges read above its roofline."""
    return iterations * (4 * num_edges + 12 * num_vertices)

"""Single-source shortest paths from a root, in plain PyTorch.

Bellman-Ford over the active set: each round relaxes the out-edges of
the vertices whose distance fell in the round before, until none falls.
Weights are integers, so the exact distances are int64 sums; the port
holds them in float32, which is exact below 2**24. ``INF`` marks an
unreached vertex.
"""
from __future__ import annotations

import numpy as np
import torch

INF = np.float32(3.0e38)
LIMITS = {"sssp_mismatch": 0}         # exact


def solve(g, kwargs: dict, dtype=None) -> torch.Tensor:
    """Distances as int64 (-1 unreached); with a floating ``dtype`` the
    distances and weights are held and added in that type (the
    control), and unreached vertices hold ``INF`` of that type."""
    n, dev = g.num_vertices, g.src.device
    root = int(kwargs["root"])
    if dtype is None:
        big = torch.iinfo(torch.int64).max // 4
        dist = torch.full((n,), big, dtype=torch.int64, device=dev)
        w = g.w
    else:
        big = float(INF)
        dist = torch.full((n,), big, dtype=dtype, device=dev)
        w = g.w.to(dtype)
    dist[root] = 0
    active = torch.zeros(n, dtype=torch.bool, device=dev)
    active[root] = True
    while bool(active.any()):
        m = active[g.src]
        cand = dist[g.src[m]] + w[m]
        new = dist.clone().scatter_reduce_(0, g.dst[m], cand, reduce="amin")
        active = new < dist
        dist = new
    if dtype is None:
        dist = torch.where(dist == big, -1, dist)
    return dist


def answer(dist: torch.Tensor) -> np.ndarray:
    if dist.is_floating_point():
        return dist.to(torch.float32).cpu().numpy()
    out = dist.to(torch.float32)
    out[dist < 0] = float(INF)
    return out.cpu().numpy()


def judge(got: np.ndarray, iterations: int, dist: torch.Tensor) -> dict:
    """How many vertices' distances differ from the reference's."""
    ref = torch.from_numpy(answer(dist))
    return {"sssp_mismatch": int((torch.from_numpy(np.asarray(got)) != ref)
                                 .sum())}

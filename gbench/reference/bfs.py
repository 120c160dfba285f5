"""Breadth-first search levels from a root, in plain PyTorch.

A level-synchronous push search along edge direction: the answer holds
each vertex's hop count from the root, and ``INF`` where it is not
reached (the value the port's apps hold for "unreached").
"""
from __future__ import annotations

import numpy as np
import torch

INF = np.float32(3.0e38)
LIMITS = {"bfs_mismatch": 0}          # exact


def solve(g, kwargs: dict, dtype=None) -> torch.Tensor:
    """Levels as int64 (-1 unreached); with ``dtype`` the level counter
    is kept in that type instead (the control)."""
    n, dev = g.num_vertices, g.src.device
    root = int(kwargs["root"])
    level = torch.full((n,), -1, dtype=torch.int64, device=dev)
    level[root] = 0
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    frontier[root] = True
    depth = torch.zeros((), dtype=dtype or torch.int64, device=dev)
    while True:
        nxt = g.dst[frontier[g.src]]
        nxt = nxt[level[nxt] < 0].unique()
        if nxt.numel() == 0:
            break
        depth = depth + 1
        level[nxt] = depth.to(torch.int64)
        frontier = torch.zeros(n, dtype=torch.bool, device=dev)
        frontier[nxt] = True
    return level


def answer(level: torch.Tensor) -> np.ndarray:
    out = level.to(torch.float32)
    out[level < 0] = float(INF)
    return out.cpu().numpy()


def judge(got: np.ndarray, iterations: int, level: torch.Tensor) -> dict:
    """How many vertices' levels differ from the reference's."""
    ref = torch.from_numpy(answer(level))
    return {"bfs_mismatch": int((torch.from_numpy(np.asarray(got)) != ref)
                                .sum())}

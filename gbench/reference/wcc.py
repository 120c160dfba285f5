"""Weakly connected components of a symmetric graph, in plain PyTorch.

Minimum-label propagation with pointer jumping: every vertex starts with
its own id, takes the least label among its in-neighbours' and its
label's own label, until nothing changes. On a symmetric graph that is
the least id of each component. The port labels components by ids of its
own internal order, so an answer is judged as a partition: two vertices
share a label exactly when they share a component.
"""
from __future__ import annotations

import numpy as np
import torch

LIMITS = {"wcc_mismatch": 0}          # exact


def solve(g, kwargs: dict, dtype=None) -> torch.Tensor:
    """Component labels (int64, the least id of each component); with a
    floating ``dtype`` the labels are held in that type and propagated
    without pointer jumping (the control)."""
    n, dev = g.num_vertices, g.src.device
    labels = torch.arange(n, device=dev)
    if dtype is not None:
        labels = labels.to(dtype)
    while True:
        new = labels.clone().scatter_reduce_(0, g.dst, labels[g.src],
                                             reduce="amin")
        if dtype is None:
            new = torch.minimum(new, new[new])
        if torch.equal(new, labels):
            return labels
        labels = new


def answer(labels: torch.Tensor) -> np.ndarray:
    return labels.to(torch.float32).cpu().numpy()


def judge(got: np.ndarray, iterations: int, labels: torch.Tensor) -> dict:
    """How many vertices are in a component that the answer splits, or
    merges with another."""
    ref = labels.cpu()
    got_t = torch.from_numpy(np.asarray(got))
    canon = got_t[ref]                     # the label of each component's root
    split = got_t != canon
    roots = torch.unique(ref)
    root_labels = got_t[roots]
    vals, counts = torch.unique(root_labels, return_counts=True)
    merged = torch.isin(canon, vals[counts > 1])
    return {"wcc_mismatch": int((split | merged).sum())}

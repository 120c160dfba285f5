"""The reference's edge list and its own application of a delta."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Edges:
    """Directed edges ``src[i] -> dst[i]`` with integer weights ``w[i]``,
    in original vertex ids, on one device (any order)."""

    num_vertices: int
    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor

    @classmethod
    def from_numpy(cls, num_vertices: int, src: np.ndarray, dst: np.ndarray,
                   w: np.ndarray, device) -> "Edges":
        def t(a):
            return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)
        return cls(int(num_vertices), t(src), t(dst), t(w))


def apply_delta(g: Edges, add_src, add_dst, add_w, rm_src, rm_dst) -> Edges:
    """The edge list after removing ``rm`` and inserting ``add`` (int64
    tensors on ``g``'s device). Every removed edge must exist and no
    inserted edge may, as the delta format requires."""
    n = g.num_vertices
    keys = g.src * n + g.dst
    rm = rm_src * n + rm_dst
    add = add_src * n + add_dst
    if not bool(torch.isin(rm, keys).all()):
        raise ValueError("delta removes an edge the snapshot lacks")
    if (bool(torch.isin(add, keys).any())
            or add.unique().numel() != add.numel()):
        raise ValueError("delta inserts an edge the snapshot has")
    keep = ~torch.isin(keys, rm)
    return Edges(n, torch.cat([g.src[keep], add_src]),
                 torch.cat([g.dst[keep], add_dst]),
                 torch.cat([g.w[keep], add_w]))

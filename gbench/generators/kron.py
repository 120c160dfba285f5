"""The Graph500 Kronecker generator (GAP's ``kron``): each of ``scale``
bits of an edge's two ends drawn by quadrant with probabilities A, B, C
and 1 - A - B - C, then the vertex labels permuted at random."""
import torch


def edges(cfg: dict, n_edges: int, gen: torch.Generator, device):
    scale = int(cfg["scale"])
    a, b, c = cfg["A"], cfg["B"], cfg["C"]
    src = torch.zeros(n_edges, dtype=torch.int64, device=device)
    dst = torch.zeros_like(src)
    ab = a + b
    a_norm, c_norm = a / ab, c / (1.0 - ab)
    for bit in range(scale):
        r = torch.rand(2, n_edges, generator=gen, device=device)
        down = r[0] > ab
        right = r[1] > torch.where(down, c_norm, a_norm)
        src |= down.to(torch.int64) << bit
        dst |= right.to(torch.int64) << bit
    perm = torch.randperm(1 << scale, generator=gen, device=device)
    return perm[src], perm[dst]

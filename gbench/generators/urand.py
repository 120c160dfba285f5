"""The uniform random graph (GAP's ``urand``, Erdos-Renyi): both ends of
every edge drawn uniformly."""
import torch


def edges(cfg: dict, n_edges: int, gen: torch.Generator, device):
    n = 1 << int(cfg["scale"])
    return torch.randint(0, n, (2, n_edges), generator=gen, device=device)

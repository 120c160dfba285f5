"""The benchmark's frozen input makers: graphs, request arguments and deltas.

Everything here is made from the run's seed with a ``torch.Generator`` on
the device the run uses, in a few large calls, so the same seed gives the
same inputs. The arrays go to the program (as its ``Graph`` and
``GraphDelta``) and, unchanged, to the plain reference.

Graphs follow the GAP Benchmark Suite (Beamer et al., arXiv:1508.03619).
A configuration names its generator, a module ``generators/<name>.py``
whose ``edges(cfg, n_edges, gen, device)`` draws the endpoints of
``edge_factor * 2**scale`` edges (``kron``: the Graph500 Kronecker
generator; ``urand``: uniform). As GAP generates one graph, the edges and
weights come from one fixed seed, :data:`GAP_SEED`; the run's seed only
permutes the vertex labels, so every seed serves the same graph under
other labels and the same work.

Graphs are made undirected and stored as both directions, without self
loops or duplicate edges. Each undirected edge carries one integer weight
from ``weights[0]`` to ``weights[1]``, drawn per generated edge as GAP does
(the least draw where an edge was generated more than once), the same in
both directions.

Deltas are a torch copy of ``random_delta``'s skewed churn (the port's
``streaming/delta.py``): ``churn * E`` changes, half removals of existing
edges and half insertions of new ones, all on the top ``hot_frac`` of
vertices by in-degree, with no vertex growth. Inserted edges are directed,
as ``random_delta``'s are, and get weights from the same range.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from .harness import ROOT, load_module

GAP_SEED = 27491095          # the seed GAP's generator uses by default


def generator(seed: int, stream: int, device) -> torch.Generator:
    """One generator per input stream of a run: the same ``(seed,
    stream)`` gives the same draws, and streams do not share draws."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


@dataclasses.dataclass
class EdgeSet:
    """A directed edge list sorted by (src, dst), on one device.

    ``keys`` are ``src * num_vertices + dst`` (int64, strictly ascending),
    ``weights`` int64 in the configuration's range."""

    num_vertices: int
    keys: torch.Tensor
    weights: torch.Tensor

    @property
    def num_edges(self) -> int:
        return int(self.keys.numel())

    @property
    def src(self) -> torch.Tensor:
        return self.keys // self.num_vertices

    @property
    def dst(self) -> torch.Tensor:
        return self.keys % self.num_vertices


def make_graph(cfg: dict, seed: int, device, base: Path = ROOT) -> EdgeSet:
    """The configuration's graph under ``seed``'s labels (see the module
    docstring)."""
    gen = generator(GAP_SEED, 0, device)
    n = 1 << int(cfg["scale"])
    n_edges = int(cfg["edge_factor"]) * n
    src, dst = load_module("generators", cfg["generator"], base).edges(
        cfg, n_edges, gen, device)
    w_lo, w_hi = cfg["weights"]
    w = torch.randint(w_lo, w_hi + 1, (n_edges,), generator=gen,
                      device=device)
    perm = torch.randperm(n, generator=generator(seed, 2, device),
                          device=device)
    src, dst = perm[src], perm[dst]
    keep = src != dst
    lo = torch.minimum(src, dst)[keep]
    hi = torch.maximum(src, dst)[keep]
    ukeys, inv = torch.unique(lo * n + hi, return_inverse=True)
    uw = torch.full((ukeys.numel(),), w_hi + 1, dtype=torch.int64,
                    device=device)
    uw.scatter_reduce_(0, inv, w[keep], reduce="amin")
    lo, hi = ukeys // n, ukeys % n
    keys = torch.cat([lo * n + hi, hi * n + lo])
    keys, order = torch.sort(keys)
    return EdgeSet(n, keys, torch.cat([uw, uw])[order])


def root_candidates(edges: EdgeSet) -> np.ndarray:
    """Vertices of non-zero degree, from which GAP draws its sources."""
    deg = torch.bincount(edges.src, minlength=edges.num_vertices)
    return torch.nonzero(deg > 0).flatten().cpu().numpy()


class RequestArgs:
    """Per-client streams of request arguments: client ``i``'s ``k``-th
    request gets the same arguments for a given seed, whatever the
    timing."""

    def __init__(self, seed: int, candidates: np.ndarray):
        self.seed = int(seed)
        self.candidates = candidates

    def stream(self, client: int, spec: dict):
        rng = np.random.default_rng([self.seed % (2 ** 63), 7, client])
        kwargs = dict(spec.get("app_kwargs", {}))
        while True:
            if spec.get("root") == "nonzero_degree":
                kwargs["root"] = int(
                    self.candidates[rng.integers(self.candidates.size)])
            yield dict(kwargs)


@dataclasses.dataclass
class Delta:
    """One delta's edges (int64 on the generator's device)."""

    add_src: torch.Tensor
    add_dst: torch.Tensor
    add_w: torch.Tensor
    rm_src: torch.Tensor
    rm_dst: torch.Tensor


def _member(sorted_keys: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    pos = torch.searchsorted(sorted_keys, k).clamp_max(
        max(sorted_keys.numel() - 1, 0))
    if sorted_keys.numel() == 0:
        return torch.zeros_like(k, dtype=torch.bool)
    return sorted_keys[pos] == k


def skewed_churn(edges: EdgeSet, churn: float, hot_frac: float,
                 weights, gen: torch.Generator) -> Delta:
    """One delta against ``edges`` (see the module docstring)."""
    n, dev = edges.num_vertices, edges.keys.device
    n_half = max(1, int(edges.num_edges * churn / 2))
    src, dst = edges.src, edges.dst
    k = max(1, int(n * hot_frac))
    indeg = torch.bincount(dst, minlength=n)
    hot = torch.sort(indeg, descending=True, stable=True).indices[:k]
    is_hot = torch.zeros(n, dtype=torch.bool, device=dev)
    is_hot[hot] = True
    pool = torch.nonzero(is_hot[dst]).flatten()
    rm = pool[torch.randperm(pool.numel(), generator=gen,
                             device=dev)[:n_half]]
    picked = torch.zeros(0, dtype=torch.int64, device=dev)
    stalled = 0
    while picked.numel() < n_half and stalled < 16:
        cs = torch.randint(0, n, (4 * n_half,), generator=gen, device=dev)
        cd = hot[torch.randint(0, k, (4 * n_half,), generator=gen,
                               device=dev)]
        cand = torch.unique((cs * n + cd)[cs != cd])
        fresh = cand[~_member(edges.keys, cand) & ~torch.isin(cand, picked)]
        fresh = fresh[torch.randperm(fresh.numel(), generator=gen,
                                     device=dev)[:n_half - picked.numel()]]
        stalled = 0 if fresh.numel() else stalled + 1
        picked = torch.cat([picked, fresh])
    w_lo, w_hi = weights
    add_w = torch.randint(w_lo, w_hi + 1, (picked.numel(),), generator=gen,
                          device=dev)
    return Delta(picked // n, picked % n, add_w, src[rm], dst[rm])


def apply(edges: EdgeSet, delta: Delta) -> EdgeSet:
    """The edge set after ``delta``: the generator's own running state, so
    that each delta is drawn against the snapshot it applies to."""
    n = edges.num_vertices
    gone = torch.isin(edges.keys, delta.rm_src * n + delta.rm_dst)
    keys = torch.cat([edges.keys[~gone], delta.add_src * n + delta.add_dst])
    w = torch.cat([edges.weights[~gone], delta.add_w])
    keys, order = torch.sort(keys)
    return EdgeSet(n, keys, w[order])

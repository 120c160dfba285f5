"""PageRank as the port's builtin app defines it, in plain PyTorch.

Each vertex holds ``rank / max(out_degree, 1)``, starting from ``1 / V``.
An iteration sums that over each vertex's in-edges and sets ``rank = (1 -
damping) / V + damping * sum``; no dangling mass is redistributed. The
run stops after the first iteration whose largest change of the held
value is under ``TOL``, or after ``max_iters``. The answer is the held
value.
"""
from __future__ import annotations

import numpy as np
import torch

TOL = 1e-7              # the app's convergence rule
BORDER = 1e-3           # a change this close to TOL may stop either side
LIMITS = {"pagerank_rel_err": 1e-4}   # set in PERF.md from the readings


def solve(g, kwargs: dict, dtype=torch.float64) -> dict:
    """Every iterate up to ``max_iters`` (the run goes on past the stop,
    so that an answer that stopped one iteration later on a change at
    the border can be judged), each iterate's largest change, and the
    iteration the rule stops at."""
    d = float(kwargs["damping"])
    n = g.num_vertices
    outdeg = torch.bincount(g.src, minlength=n).to(dtype).clamp_min(1)
    prop = torch.full((n,), 1.0 / n, dtype=dtype, device=g.src.device) / outdeg
    iterates, changes, stop = [], [], None
    for it in range(int(kwargs["max_iters"])):
        acc = torch.zeros(n, dtype=dtype, device=prop.device)
        acc.index_add_(0, g.dst, prop[g.src])
        new = ((1.0 - d) / n + d * acc) / outdeg
        changes.append(float((new - prop).abs().max()))
        iterates.append(new)
        prop = new
        if stop is None and changes[-1] < TOL:
            stop = it + 1
    return {"iterates": iterates, "changes": changes,
            "stop": stop or len(iterates)}


def answer(sol: dict) -> np.ndarray:
    """The answer the reference itself gives (the control's answer)."""
    return sol["iterates"][sol["stop"] - 1].float().cpu().numpy()


def judge(got: np.ndarray, iterations: int, sol: dict) -> dict:
    """The largest relative gap of any vertex from the reference's
    iterate at the rule's stop; at the program's own count of
    iterations instead where the two stops differ on a change within
    ``BORDER`` of ``TOL``."""
    k = sol["stop"]
    if iterations != k and 1 <= iterations <= len(sol["iterates"]):
        edge = sol["changes"][min(iterations, k) - 1]
        if abs(edge - TOL) <= BORDER * TOL:
            k = iterations
    ref = sol["iterates"][k - 1]
    got_t = torch.from_numpy(np.asarray(got)).to(ref.device, torch.float64)
    rel = (got_t - ref.double()).abs() / ref.double().abs()
    return {"pagerank_rel_err": float(rel.max())}

"""Model-guided big-little expert scheduling (the paper's §IV for MoE).

Expert load under learned top-k routing is empirically Zipf-like — the
same skew ReGraph exploits in graph partitions. Given the expert count,
top-k, token count and a Zipf exponent (measurable online; default from
published MoE load traces), choose (n_hot, C_hot, C_cold) minimising the
padded-token compute volume subject to an expected-drop-rate budget —
the analogue of minimising the worst cluster time in Eq. (5)-(6).

The split is *static* per deployment (experts are offline-relabelled by
historical load — the DBG analogue), so the dispatch stays shape-static.
"""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def zipf_loads(num_experts: int, exponent: float = 0.8) -> tuple:
    """Expected per-expert load fractions, descending (relabelled)."""
    r = np.arange(1, num_experts + 1, dtype=np.float64)
    w = r ** (-exponent)
    return tuple(w / w.sum())


@functools.lru_cache(maxsize=None)
def biglittle_split(num_experts: int, top_k: int, tokens: int,
                    capacity_factor: float = 1.25,
                    zipf_exponent: float = 0.8,
                    drop_budget: float = 0.02,
                    round_to: int = 1) -> tuple:
    """Return (n_hot, C_hot, C_cold).

    Uniform dispatch pads every expert to C_uni = T*k/E * cf. With skewed
    load, hot experts need MORE than C_uni (they drop tokens) while cold
    experts waste padding. We pick the split minimising total buffer size
    n_hot*C_hot + (E-n_hot)*C_cold with C_hot sized for the max hot load
    and C_cold for the max cold load (both + cf headroom), subject to the
    expected drop fraction staying under budget.

    ``round_to``: n_hot is rounded UP to a multiple (the model-axis size)
    so hot experts interleave evenly across expert-sharded ranks and every
    rank gets an identical static (hot, cold) buffer layout.
    """
    loads = np.asarray(zipf_loads(num_experts, zipf_exponent))
    total_assign = tokens * top_k
    best = None
    c_uni = max(1, int(total_assign / num_experts * capacity_factor))
    for n_hot in range(round_to, num_experts, round_to):
        c_hot = int(np.ceil(loads[0] * total_assign * capacity_factor))
        c_cold = max(1, int(np.ceil(loads[n_hot] * total_assign
                                    * capacity_factor)))
        # expected drops: load beyond capacity
        exp_tok = loads * total_assign
        cap = np.where(np.arange(num_experts) < n_hot, c_hot, c_cold)
        dropped = np.maximum(exp_tok - cap, 0.0).sum() / total_assign
        if dropped > drop_budget:
            continue
        size = n_hot * c_hot + (num_experts - n_hot) * c_cold
        if best is None or size < best[0]:
            best = (size, n_hot, c_hot, c_cold)
    if best is None:  # fall back to uniform
        return num_experts, c_uni, c_uni
    _, n_hot, c_hot, c_cold = best
    # round capacities to multiples of 8 (matrix-unit tile friendly)
    rnd = lambda c: max(8, int(-(-c // 8) * 8))
    return n_hot, rnd(c_hot), rnd(c_cold)


def padded_flops_ratio(num_experts: int, top_k: int, tokens: int,
                       capacity_factor: float = 1.25,
                       zipf_exponent: float = 0.8,
                       drop_budget: float = 0.02) -> dict:
    """Napkin-math comparison used by benchmarks and EXPERIMENTS.md.

    The fair baseline is uniform capacity sized for the SAME drop budget
    (i.e. every expert provisioned like the hottest one — exactly the
    paper's monolithic-pipeline over-provisioning argument). The cheap
    uniform (cf * mean load) is also reported with its drop rate.
    """
    loads = np.asarray(zipf_loads(num_experts, zipf_exponent))
    total = tokens * top_k
    n_hot, c_hot, c_cold = biglittle_split(
        num_experts, top_k, tokens, capacity_factor, zipf_exponent,
        drop_budget)
    uni_cheap = max(1, int(total / num_experts * capacity_factor))
    drop_cheap = float(np.maximum(loads * total - uni_cheap, 0).sum()
                       / total)
    uni_matched = int(np.ceil(loads[0] * total * capacity_factor))
    size_uni_matched = num_experts * uni_matched
    size_bl = n_hot * c_hot + (num_experts - n_hot) * c_cold
    drop_bl = float(np.maximum(
        loads * total - np.where(np.arange(num_experts) < n_hot,
                                 c_hot, c_cold), 0).sum() / total)
    return {
        "n_hot": n_hot, "c_hot": c_hot, "c_cold": c_cold,
        "uniform_capacity_cheap": uni_cheap,
        "uniform_cheap_drop_rate": drop_cheap,
        "uniform_capacity_drop_matched": uni_matched,
        "padded_tokens_uniform_matched": size_uni_matched,
        "padded_tokens_biglittle": size_bl,
        "biglittle_drop_rate": drop_bl,
        "flops_ratio_vs_matched": size_bl / size_uni_matched,
    }

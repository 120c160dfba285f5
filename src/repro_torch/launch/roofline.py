"""Roofline terms of a dry-run cell (the reference's
``src/repro/launch/roofline.py``).

Terms, per rank:
  compute    = FLOPs_per_rank / peak_flops
  memory     = bytes_per_rank / hbm_bw
  collective = collective_bytes_per_rank / link_bw

The workload model (``analytic_costs``, ``model_flops``, ``param_count``,
``roofline_terms``, ``cpu_upcast_estimate``) is the reference's
framework-free arithmetic, held to it exactly by the tests.

:data:`HW` is the NVIDIA H100 SXM5 80GB's data sheet at its 700 W power
limit (bf16 dense tensor-core peak, HBM3 rate, NVLink 4 per direction),
not a measurement. A 16-wide "model" dim spans two 8-GPU nodes, whose
traffic crosses the slower inter-node network, so with such a mesh the
collective term computed at the NVLink rate is a lower bound.

The reference parses collectives out of compiled HLO text; a torch
program has no HLO. :class:`CollectiveCounter` is its twin: a dispatch
mode that sees every functional collective
(``torch.ops._c10d_functional.*``, which DTensor and the port's model
code emit) and adds its input bytes under the reference's names
(``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
``collective-permute``, ``count``, ``total``). A traced program is the
per-rank program with every loop unrolled, so no trip-count correction
is needed.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

HW = {
    "name": "NVIDIA H100 SXM5 80GB (data sheet, 700 W)",
    "peak_flops": 989.4e12,   # bf16 dense, tensor cores, per GPU
    "hbm_bw": 3.35e12,        # HBM3, B/s per GPU
    "link_bw": 450e9,         # NVLink 4, B/s per direction per GPU
    "hbm_bytes": 80e9,        # HBM3 capacity
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# functional collective op name -> the reference's collective name
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


class CollectiveCounter(TorchDispatchMode):
    """Counts the functional collectives dispatched while it is active:
    ``counts`` has the input bytes per collective name (as the
    reference's ``collective_bytes``) and ``count``; :meth:`result` adds
    ``total``."""

    def __init__(self):
        super().__init__()
        self.counts: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
        self.counts["count"] = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "_c10d_functional":
            name = _FUNCTIONAL.get(func.__name__.split(".")[0])
            if name is not None:
                self.counts[name] += _nbytes(args[0])
                self.counts["count"] += 1
        return func(*args, **kwargs)

    def result(self) -> Dict[str, float]:
        out = dict(self.counts)
        out["total"] = sum(out[c] for c in _COLLECTIVES)
        return out


def cpu_upcast_estimate(cfg, chips: int) -> int:
    """XLA:CPU has no native bf16 dot, so it hoists f32 copies of every
    bf16 weight out of the layer loop (visible as convert(param) ops in
    the HLO) — a backend artifact absent on TPU (native bf16 MXU). The
    hoisted copies are ~2x the per-chip bf16 param bytes. Used to derive
    peak_tpu_estimate_bytes; instruction-level summing is wrong because
    XLA reuses buffers (liveness != sum of outputs). Kept for parity: a
    meta-device trace keeps every dtype, so the port's dry run subtracts
    nothing."""
    return int(2 * param_count(cfg) * 2 / chips)


def roofline_terms(cost: dict, coll: dict, chips: int, cfg=None, shape=None,
                   hw: dict = HW) -> dict:
    """Three-term roofline. compute/memory use the ANALYTIC workload model
    (the reference's choice: XLA's cost_analysis counts scan bodies once;
    ``cost``'s raw numbers are recorded beside it). collective uses the
    per-rank collective bytes ``coll`` (the port: counted by
    :class:`CollectiveCounter`)."""
    hlo_flops = float(cost.get("flops", 0.0))
    hlo_bytes = float(cost.get("bytes accessed", 0.0))
    cb = float(coll.get("total", 0.0))
    an = analytic_costs(cfg, shape) if cfg is not None else None
    flops_chip = (an["flops_exec"] / chips) if an else hlo_flops
    bytes_chip = (an["hbm_bytes"] / chips) if an else hlo_bytes
    t_compute = flops_chip / hw["peak_flops"]
    t_memory = bytes_chip / hw["hbm_bw"]
    t_collective = cb / hw["link_bw"]
    dominant = max(
        [("compute", t_compute), ("memory", t_memory),
         ("collective", t_collective)], key=lambda kv: kv[1])[0]
    tot = max(t_compute, t_memory, t_collective)
    out = {
        "flops_per_chip": flops_chip,
        "bytes_per_chip": bytes_chip,
        "collective_bytes_per_chip": cb,
        "hlo_flops_per_chip_raw": hlo_flops,
        "hlo_bytes_per_chip_raw": hlo_bytes,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "roofline_bound_s": tot,
    }
    if an:
        out["analytic"] = an
        # useful fraction: model (6N D) flops vs executed (remat, padding)
        out["mfu_upper_bound"] = (an["flops_model"] / chips
                                  / hw["peak_flops"]) / tot if tot else 0.0
    return out


def analytic_costs(cfg, shape) -> dict:
    """Global FLOPs and HBM bytes from the workload's structure.

    flops_model — the 'useful' count (6·N_active·tokens train,
                  2·N_active·tokens inference) + exact attention term.
    flops_exec  — what actually executes: remat multiplies the forward
                  by ~2x in train (fwd + bwd(2x fwd) + remat fwd = 8N·T),
                  MoE padding multiplies expert FFN flops by
                  padded/used capacity.
    hbm_bytes   — params read/written (+optimizer state traffic in train),
                  activations through HBM between remat blocks, KV-cache
                  traffic for decode.
    """
    B, S = shape.batch, shape.seq
    train = shape.kind == "train"
    tokens = B * S if shape.kind != "decode" else B
    n_active = param_count(cfg, active_only=True)
    n_total = param_count(cfg, active_only=False)
    p_bytes = 2.0  # bf16

    # attention flops (fwd): 4·B·S·ctx·H·hd x 0.5 causal
    H, hd, L = cfg.num_heads, cfg.hd, cfg.num_layers
    if shape.kind == "decode":
        ctx = S
        attn_fwd = 4.0 * B * 1 * min(ctx, cfg.sliding_window or ctx) \
            * H * hd * L
    else:
        eff_ctx = min(S, cfg.sliding_window or S)
        attn_fwd = 4.0 * B * S * eff_ctx * 0.5 * H * hd * L
    if cfg.family == "ssm":
        attn_fwd = 0.0

    mm_fwd = 2.0 * n_active * tokens
    fwd = mm_fwd + attn_fwd
    if train:
        flops_model = 3.0 * fwd                      # fwd + 2x bwd
        flops_exec = (4.0 if cfg.remat else 3.0) * fwd
    else:
        flops_model = fwd
        flops_exec = fwd
    # MoE capacity padding overhead on the expert-FFN share
    if cfg.family == "moe":
        from ..models.moe_schedule import biglittle_split
        E, K = cfg.num_experts_padded, cfg.top_k
        Fm = cfg.moe_d_ff or cfg.d_ff
        used = tokens * K
        if cfg.moe_dispatch == "biglittle":
            n_hot, c_hot, c_cold = biglittle_split(E, K, max(tokens, 1),
                                                   round_to=16)
            padded = n_hot * c_hot + (E - n_hot) * c_cold
        else:
            padded = E * max(8, int(used / E * 1.25))
        ffn_share = 6.0 * cfg.d_model * Fm * K * tokens  # 3 mats x 2
        overhead = ffn_share * max(padded / max(used, 1) - 1.0, 0.0)
        flops_exec += overhead * (3.0 if train else 1.0)

    # HBM bytes (global)
    if train:
        opt_mult = {"adamw": 3.0, "adafactor": 1.1}.get(cfg.optimizer, 3.0)
        # params: read fwd + read bwd + grad write + opt read/write
        param_traffic = n_total * p_bytes * (3.0 + opt_mult)
        act_bytes = tokens * cfg.d_model * p_bytes * L * 2.0  # remat edges
        hbm = param_traffic + act_bytes
    elif shape.kind == "prefill":
        hbm = n_active * p_bytes + tokens * cfg.d_model * p_bytes * L * 2.0
    else:  # decode: weights + full KV cache read per token
        kvb = 0.0
        if cfg.num_kv_heads:
            ctx = min(S, cfg.sliding_window or S)
            kv_bytes = 1.0 if "8" in (cfg.kv_cache_dtype or "") else p_bytes
            kvb = 2.0 * B * L * ctx * cfg.num_kv_heads * cfg.hd * kv_bytes
        if cfg.family in ("ssm", "hybrid"):
            din = cfg.din
            Hs = din // cfg.ssm_head_dim
            kvb += B * L * Hs * cfg.ssm_head_dim * cfg.ssm_state * 4.0 * 2
        hbm = n_active * p_bytes + kvb
    return {
        "flops_model": flops_model,
        "flops_exec": flops_exec,
        "hbm_bytes": hbm,
        "tokens": tokens,
        "n_active": n_active,
        "n_total": n_total,
    }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); D = tokens.
    Decode counts one token per sequence."""
    tokens = (shape.batch * shape.seq if shape.kind != "decode"
              else shape.batch)
    n = param_count(cfg, active_only=True)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens


def param_count(cfg, active_only: bool = False) -> float:
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_padded
    L = cfg.num_layers
    n = V * D                           # lm_head matmul (embed is a gather)
    if cfg.family in ("ssm",):
        din, N = cfg.din, cfg.ssm_state
        H = din // cfg.ssm_head_dim
        per = D * (2 * din + 2 * N + H) + din * D
        return n + L * per
    hd, Hh, KH = cfg.hd, cfg.num_heads, cfg.num_kv_heads
    attn = D * Hh * hd + 2 * D * KH * hd + Hh * hd * D
    if cfg.family == "moe":
        Fm = cfg.moe_d_ff or F
        e = cfg.top_k if active_only else cfg.num_experts
        ffn = 3 * D * Fm * e + D * cfg.num_experts  # experts + router
    elif cfg.mlp == "gelu":
        ffn = 2 * D * F
    else:
        ffn = 3 * D * F
    per = attn + ffn
    if cfg.family == "hybrid":
        din, N = cfg.din, cfg.ssm_state
        H = din // cfg.ssm_head_dim
        per += D * (2 * din + 2 * N + H) + din * D
    total = n + L * per
    if cfg.is_encoder_decoder:
        total += cfg.encoder_layers * (attn + ffn) + L * (attn)  # cross attn
    return total

"""Mixture-of-Experts transformer (kimi-k2 / granite-moe).

Attention blocks are shared with models.transformer; the FFN is a top-k
routed expert layer with sort-based (one-hot-free) dispatch.

Two dispatch modes:
  * "dense"     — uniform capacity per expert (GShard/Switch style).
  * "biglittle" — the paper's heterogeneous-pipeline idea applied to
    experts: expert load under top-k routing is power-law (same skew the
    paper exploits in graph partitions). Experts are offline-relabelled
    by historical load (the DBG analogue), the first n_hot experts get
    Little treatment (large capacity, long regular batches) and the tail
    gets Big treatment (small capacity, compacted batch), cutting padded
    FLOPs/memory vs. provisioning every expert for the worst case. The
    split (n_hot, C_hot, C_cold) comes from models.moe_schedule — the
    model-guided scheduling analogue.

On a mesh (``common.use_mesh``) whose "model" dim is larger than 1,
``moe_ffn`` takes the reference's ``shard_map`` branch: each model rank
dispatches its data shard's tokens against its slice of the experts
(``E_pad / n_model`` of them) or, where "model" does not divide E_pad,
against every expert with its slice of the FFN dim; the partial outputs
are summed over "model" (reduce-scattered to each rank's rows or
positions where the batch or the positions are split over "model" and
the group's were gathered for the dispatch) and the aux loss averaged over the data dims and "model". The
combine adds each token's expert rows in the reference's order without
float atomics (``_combine``), so results repeat bit for bit on the
card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs import torch_dtype
from . import common as c
from . import transformer as tfm
from .moe_schedule import biglittle_split


def init_layer_params(cfg, gen):
    dt = c.dtype_of(cfg)
    D, E, Fd = cfg.d_model, cfg.num_experts_padded, cfg.moe_d_ff or cfg.d_ff
    p = tfm.init_layer_params(cfg, gen)
    for nm in ("w_gate", "w_up", "w_down", "b_up", "b_down"):
        p.pop(nm, None)
    p["router"] = c.dense_init(gen, D, E, torch.float32)
    # as the reference: one matrix per projection, broadcast to every expert
    p["we_gate"] = c.dense_init(gen, D, Fd, dt).expand(E, D, Fd).clone()
    p["we_up"] = c.dense_init(gen, D, Fd, dt).expand(E, D, Fd).clone()
    p["we_down"] = c.dense_init(gen, Fd, D, dt).expand(E, Fd, D).clone()
    return p


def init_params(cfg, gen):
    return tfm.init_params(cfg, gen, init_layer_params)


# ---------------------------------------------------------------------------
# sort-based dispatch
# ---------------------------------------------------------------------------

def _ranks_in_expert(sorted_e):
    """rank of each sorted element within its expert segment."""
    n = sorted_e.shape[0]
    ar = torch.arange(n, dtype=torch.int64, device=sorted_e.device)
    is_start = torch.ones(n, dtype=torch.bool, device=sorted_e.device)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    start = torch.where(is_start, ar, 0)
    start = torch.cummax(start, dim=0).values
    return ar - start


def _route(x, router_w, top_k, e_real=None, e_pad=None):
    """(gate weights, expert ids, aux loss) of the tokens ``x``; under
    the columns split ``router_w`` is this rank's columns of the
    ``e_pad`` experts, and the logits are gathered."""
    logits = c.gather_columns(x.float() @ router_w,     # (T, E_pad)
                              e_pad or router_w.shape[1])
    if e_real is not None and e_real < logits.shape[1]:
        eid = torch.arange(logits.shape[1], device=logits.device)
        logits = torch.where(eid < e_real, logits, -1e30)
    gw, gi = torch.topk(logits, top_k, dim=-1)
    gw = torch.softmax(gw, dim=-1)
    # aux load-balance loss (Switch): E * mean(frac_tokens * frac_router)
    probs = torch.softmax(logits, dim=-1)
    E = logits.shape[1]
    frac_router = probs.mean(dim=0)
    hard = torch.zeros(E, device=x.device).index_add_(
        0, gi.reshape(-1), torch.ones(gi.numel(), device=x.device)) \
        / gi.numel()
    aux = E * torch.sum(hard * frac_router)
    return gw, gi, aux


def _expert_ffn(buf, wg, wu, wd, d_ff):
    """The experts' gated MLP on their buffers. Under the columns split
    each weight is as the rules placed it (``common.split_matmul``):
    the gate and up products give this rank's columns of the ``d_ff``
    FFN dim, whose ``h`` is all-gathered once, and the result is this
    rank's columns of d_model where ``wd`` holds them (gathered after
    the combine, which adds column by column)."""
    h = c.silu(c.split_matmul(buf, wg, wg.shape[-1])) \
        * c.split_matmul(buf, wu, wu.shape[-1])
    h = c.gather_columns(h, d_ff)
    return c.split_matmul(h, wd, wd.shape[-1])


def _scatter_rows(x_rows, slot, size):
    """buf[slot[i]] = x_rows[i] for slot < size; slot == size is dropped
    (the reference's ``.at[slot].set(..., mode="drop")``): one spare row
    takes every dropped write and is cut off."""
    buf = torch.zeros((size + 1, x_rows.shape[1]), dtype=x_rows.dtype,
                      device=x_rows.device)
    buf[slot] = x_rows
    return buf[:size]


def _combine(x, tok_id, keep, slot, y, gatew):
    """out[t] = the sum over token t's assignments of gate * expert row
    (zero where dropped), added one at a time in the sorted (expert)
    order with a rounding to x's dtype after each add: the reference's
    ``.at[tok_id].add``, a scatter-add in update order, without float
    atomics, so the card's result is reproducible. Every token has
    exactly ``top_k`` assignments."""
    size = y.shape[0]
    rows = torch.where(keep[:, None], y[torch.clamp(slot, max=size - 1)],
                       0.0) * gatew[:, None]
    by_token = rows[torch.argsort(tok_id, stable=True)].view(
        x.shape[0], -1, y.shape[1])
    out = x.new_zeros((x.shape[0], y.shape[1]))
    for j in range(by_token.shape[1]):
        out = out + by_token[:, j]
    return out


def _dispatch_group(x, tok_id, sorted_e, rank, gatew, group_lo, group_hi,
                    cap, wg, wu, wd):
    """Dispatch+compute+combine for experts in [group_lo, group_hi) with
    uniform capacity ``cap``. The weight slices wg/wu/wd cover EXACTLY
    the group. Returns the (T, D) contribution."""
    T, D = x.shape
    n_exp = group_hi - group_lo
    in_group = (sorted_e >= group_lo) & (sorted_e < group_hi)
    keep = in_group & (rank < cap)
    slot = torch.where(keep, (sorted_e - group_lo) * cap + rank, n_exp * cap)
    buf = _scatter_rows(x[tok_id], slot, n_exp * cap)
    y = _expert_ffn(buf.reshape(n_exp, cap, D), wg, wu, wd, wg.shape[-1])
    y = y.reshape(n_exp * cap, -1)
    return _combine(x, tok_id, keep, slot, y, gatew)


def _moe_ffn_tokens(cfg, router, wg, wu, wd, x, r, e_per, n_model,
                    capacity_factor):
    """Dispatch a (T, D) token block against rank ``r``'s ``e_per``
    experts (the single-device path: r=0, e_per=E_pad, n_model=1).

    Storage order is the offline load-based relabel (the DBG analogue)
    INTERLEAVED across ranks; the buffer layout is

        [ h_per experts x C_hot | (e_per - h_per) experts x C_cold ]

    Hot experts ("Little": few, long regular batches) and cold experts
    ("Big": many, compact batches) each get their own batched product —
    the paper's two pipeline types at the expert level.
    """
    T, D = x.shape
    E, K = cfg.num_experts_padded, cfg.top_k
    gw, gi, aux = _route(x, router, K, cfg.num_experts, E)
    flat_e = gi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    rank = _ranks_in_expert(sorted_e)
    tok_id = order // K
    gatew = gw.reshape(-1)[order].to(x.dtype)

    if cfg.moe_dispatch == "biglittle":
        n_hot, c_hot, c_cold = biglittle_split(
            E, K, T, capacity_factor, round_to=n_model)
    else:
        n_hot, c_hot = 0, 8
        c_cold = max(8, int(T * K / E * capacity_factor))
    h_per = n_hot // n_model
    e_lo = r * e_per
    j = sorted_e - e_lo                      # local expert index
    in_rank = (j >= 0) & (j < e_per)
    is_hot = j < h_per
    cap_j = torch.where(is_hot, c_hot, c_cold)
    off_j = torch.where(is_hot, j * c_hot,
                        h_per * c_hot + (j - h_per) * c_cold)
    keep = in_rank & (rank < cap_j)
    bufsize = h_per * c_hot + (e_per - h_per) * c_cold
    slot = torch.where(keep, off_j + rank, bufsize)
    buf = _scatter_rows(x[tok_id], slot, bufsize)
    hb = h_per * c_hot
    F = cfg.moe_d_ff or cfg.d_ff
    parts = []
    if h_per > 0:                            # Little: hot experts
        parts.append(_expert_ffn(
            buf[:hb].reshape(h_per, c_hot, D),
            wg[:h_per], wu[:h_per], wd[:h_per], F).reshape(hb, -1))
    if e_per > h_per:                        # Big: cold experts
        parts.append(_expert_ffn(
            buf[hb:].reshape(e_per - h_per, c_cold, D),
            wg[h_per:], wu[h_per:], wd[h_per:], F).reshape(bufsize - hb, -1))
    y = torch.cat(parts)
    out = _combine(x, tok_id, keep, slot, y, gatew)
    return c.gather_columns(out, D), aux


# ---------------------------------------------------------------------------
# the expert-sharded branch (the reference's shard_map)
# ---------------------------------------------------------------------------

def _split(w, dim, whole, r, n, enter):
    """Rank ``r``'s ``1 / n`` of ``w`` on ``dim``: cut from ``w`` when it
    is whole (``whole`` long there; where ``enter``, its gradient enters
    the region with a sum over "model"), or ``w`` as it is when it is
    that share already, as ``shards`` gathers an expert weight to its
    compute layout (``specs.compute_spec``)."""
    if w.shape[dim] != whole:
        return w
    per = whole // n
    return c.enter_model(w, enter).narrow(dim, r * per, per)


def _moe_ffn_sharded(cfg, lp, h, mesh, capacity_factor):
    """This rank's share of the MoE FFN over its tokens ``h`` (B, S, D),
    summed over "model": the reference's ``shard_map`` body. Returns
    (out, aux) with ``aux`` averaged over the data dims and "model".

    ``h`` (B, S, D) is the rank's data shard, the same on every model
    rank, or, where the batch or the positions are split over "model"
    too (the context's data dims name it), the rank's rows or positions
    of it: the model group's are then gathered first (on the rows' dim,
    or the positions' in global order, ``common.gather_positions``, so
    that the tokens come in the reference's order, which the
    capacities' drops depend on), so that the dispatch
    and its capacities are the data shard's, and each rank gets its own
    rows or positions of the sum back (a reduce-scatter). There nothing
    enters the region: every gradient is partial over "model", as the
    step's batch-split gradients are, and ``shards`` sums it (an expert weight it gathered to this rank's
    share excepted: that gradient is whole over the group's tokens)."""
    from ..sharding.specs import mesh_sizes
    n_model, E = mesh_sizes(mesh)["model"], cfg.num_experts_padded
    F = cfg.moe_d_ff or cfg.d_ff
    r = mesh.get_local_rank("model")
    rows = "model" in c._data_dims()
    seq = c.model_split().sequence
    if rows:
        h = c.gather_positions(h) if seq else c._GatherRows.apply(h, mesh, 0)
        router = lp["router"]
    else:
        h, router = (c.enter_model(t) for t in (h, lp["router"]))
    B, S, D = h.shape
    x = h.reshape(B * S, D)
    if E % n_model == 0:                     # experts on "model"
        wg, wu, wd = (_split(lp[k], 0, E, r, n_model, not rows)
                      for k in ("we_gate", "we_up", "we_down"))
        out, aux = _moe_ffn_tokens(cfg, router, wg, wu, wd, x, r,
                                   E // n_model, n_model, capacity_factor)
    else:                                    # the FFN dim on "model"
        wg, wu = (_split(lp[k], 2, F, r, n_model, not rows)
                  for k in ("we_gate", "we_up"))
        wd = _split(lp["we_down"], 1, F, r, n_model, not rows)
        out, aux = _moe_ffn_tokens(cfg, router, wg, wu, wd, x, 0, E, 1,
                                   capacity_factor)
    out = out.reshape(B, S, D)
    if not rows:
        out = c.model_sum(out)
    else:
        out = c.scatter_positions(out) if seq else c._ScatterRows.apply(
            out, mesh, 0)
    aux = c._ReduceOver.apply(aux, mesh, ("model",), 1 / n_model,
                              1 / n_model)
    dp = tuple(a for a in c._data_dims() if a != "model")
    if dp:
        n_dp = int(np.prod([mesh.size(mesh.mesh_dim_names.index(a))
                            for a in dp]))
        aux = c._ReduceOver.apply(aux, mesh, dp, 1 / n_dp, 1 / n_dp)
    return out, aux


def moe_ffn(cfg, lp, h, capacity_factor=None):
    """h: (B, S, D) -> (out, aux_loss).

    With no mesh (``common.use_mesh``), a "model" dim of 1, or neither
    the experts nor the FFN dim dividing over "model", the
    single-device dispatch. Otherwise the reference's distribution:
    dispatch runs PER DATA SHARD (sort, ranks, scatter stay local),
    experts shard on "model" (each rank computes its expert slice for
    its data shard's tokens, then a sum over "model"; no all-to-all).
    ``h`` is this rank's data shard, or its rows (its positions) of it
    where the batch (the positions) is split over "model" too: the model
    group's rows (positions) are gathered for the dispatch and the sum
    is reduce-scattered back to each rank's own. The expert weights are whole or this rank's share already.

    Under the columns split of a decode step the expert weights come as
    the rules placed them: where that is the experts on "model", the
    expert-sharded branch; else the single-device dispatch (its
    capacities and drops), each product split as ``_expert_ffn`` says,
    so that no expert weight crosses "model".
    """
    capacity_factor = (cfg.capacity_factor if capacity_factor is None
                       else capacity_factor)
    B, S, D = h.shape
    mesh = c._context_mesh()
    from ..sharding.specs import mesh_sizes
    n_model = mesh_sizes(mesh).get("model", 1) if mesh is not None else 1
    E, F = cfg.num_experts_padded, cfg.moe_d_ff or cfg.d_ff
    columns = c.model_split().columns and lp["we_gate"].shape[0] == E
    if n_model == 1 or (E % n_model and F % n_model) or columns:
        # every rank computes everything: nothing to sum (the
        # reference's psum over "model" would add n_model equal outputs)
        if n_model > 1 and "model" in c._data_dims():
            raise NotImplementedError(
                f"the {c.model_split().name} split over {n_model} model "
                f"ranks dispatches the group's tokens over a split of the "
                f"experts ({E}) or the FFN dim ({F}), and neither divides")
        out, aux = _moe_ffn_tokens(
            cfg, lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"],
            h.reshape(B * S, D), 0, E, 1, capacity_factor)
        return out.reshape(B, S, D), aux
    return _moe_ffn_sharded(cfg, lp, h, mesh, capacity_factor)


def _layer(cfg, x, lp, positions, inv_freq):
    h = tfm._norm(cfg, x, lp, "ln1")
    attn_out, k, v = tfm._attention(cfg, lp, h, positions, inv_freq)
    x = x + c.model_sum(attn_out, c.model_split().heads)
    h2 = tfm._norm(cfg, x, lp, "ln2")
    y, aux = moe_ffn(cfg, lp, h2)
    return x + y, aux, k, v


def backbone(cfg, params, x, positions, collect_kv=False):
    inv_freq = tfm._inv_freq(cfg, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for lp in tfm.layers(params):
        x, a, k, v = c.remat(cfg, _layer, cfg, x, lp, positions, inv_freq)
        aux = aux + a
        if collect_kv:              # as ``transformer.backbone``'s
            ks.append(c.keep_decode_positions(k))
            vs.append(c.keep_decode_positions(v))
        del k, v
    x = tfm._norm(cfg, x, params, "ln_f")
    return x, aux, ((torch.stack(ks), torch.stack(vs)) if collect_kv
                    else None)


def forward(cfg, params, batch):
    x = tfm.embed_input(cfg, params, batch)
    x, aux, _ = backbone(cfg, params, x, tfm._positions(x))
    return c.logits(cfg, x, params["lm_head"]), aux


def loss_fn(cfg, params, batch, aux_weight=0.01):
    logits, aux = forward(cfg, params, batch)
    return c.cross_entropy(logits, batch["labels"], cfg.vocab_size,
                           cfg.vocab_padded) \
        + aux_weight * aux / cfg.num_layers


def prefill(cfg, params, batch):
    x = tfm.embed_input(cfg, params, batch)
    x, _, (k, v) = backbone(cfg, params, x, tfm._positions(x),
                            collect_kv=True)
    cdt = torch_dtype(cfg.kv_cache_dtype or cfg.dtype)
    return ({"k": k.to(cdt), "v": v.to(cdt)},
            c.logits(cfg, c.last_position(x), params["lm_head"]))


def decode_step(cfg, params, cache, token, length):
    """One token with a KV cache (written at position ``length``; the
    cache's leaves are updated in place and returned). As the
    reference, the decode attention takes no sliding window here. Under
    the columns split, attention as ``transformer.decode_step``'s and
    the MoE FFN as :func:`moe_ffn` says."""
    length = int(length)
    x = c.gather_columns(params["embed"][token], cfg.d_model)
    B = x.shape[0]
    inv_freq = tfm._inv_freq(cfg, x.device)
    split = tfm.self_attention_split()
    pos = torch.full((B, 1), length, dtype=torch.int32, device=x.device)
    for i, lp in enumerate(tfm.layers(params)):
        kc, vc = cache["k"][i], cache["v"][i]
        h = tfm._norm(cfg, x, lp, "ln1")
        q, k, v = tfm._qkv(cfg, lp, h, pos, inv_freq)
        tfm.write_kv(kc, vc, k, v, length)
        attn = c.decode_attention(q, kc, vc, length + 1, split=split)
        x = x + c.split_matmul(attn.reshape(B, 1, -1), lp["wo"],
                               cfg.d_model)
        h2 = tfm._norm(cfg, x, lp, "ln2")
        y, _ = moe_ffn(cfg, lp, h2)
        x = x + y
    x = tfm._norm(cfg, x, params, "ln_f")
    return c.logits(cfg, x, params["lm_head"]), cache

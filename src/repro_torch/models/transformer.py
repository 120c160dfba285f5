"""Dense decoder-only transformer (qwen2 / internlm2 / chatglm3 /
command-r / llava-mistral backbone).

Covers: GQA with arbitrary H:KH ratios, optional QKV bias, full/partial
RoPE, sliding-window attention, command-r parallel attn+FFN blocks,
RMSNorm/LayerNorm, gated-SiLU or GELU MLPs. The parameter tree is the
reference's (``src/repro/models/transformer.py``) leaf for leaf: every
leaf of ``layers`` carries a leading L axis, and a Python loop over the
layers' views (:func:`layers`) runs where the reference scans. Exposes
init/forward/loss/prefill/decode_step used by the serving engine.
"""
from __future__ import annotations

import torch

from ..configs import torch_dtype
from . import common as c
from .shards import ShardedStack


def _norm(cfg, x, lp, name):
    if cfg.norm == "layernorm":
        return c.layernorm(x, lp[name + "_g"], lp[name + "_b"], cfg.norm_eps)
    return c.rmsnorm(x, lp[name + "_g"], cfg.norm_eps)


def _norm_params(cfg):
    out = {"_g": torch.ones((cfg.d_model,), dtype=c.dtype_of(cfg))}
    if cfg.norm == "layernorm":
        out["_b"] = torch.zeros((cfg.d_model,), dtype=c.dtype_of(cfg))
    return out


def init_layer_params(cfg, gen):
    dt = c.dtype_of(cfg)
    D, H, KH, hd, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                       cfg.d_ff)
    p = {
        "wq": c.dense_init(gen, D, H * hd, dt),
        "wk": c.dense_init(gen, D, KH * hd, dt),
        "wv": c.dense_init(gen, D, KH * hd, dt),
        "wo": c.dense_init(gen, H * hd, D, dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dt)
        p["bk"] = torch.zeros((KH * hd,), dtype=dt)
        p["bv"] = torch.zeros((KH * hd,), dtype=dt)
    if cfg.mlp == "gelu":
        p["w_up"] = c.dense_init(gen, D, F, dt)
        p["b_up"] = torch.zeros((F,), dtype=dt)
        p["w_down"] = c.dense_init(gen, F, D, dt)
        p["b_down"] = torch.zeros((D,), dtype=dt)
    else:
        p["w_gate"] = c.dense_init(gen, D, F, dt)
        p["w_up"] = c.dense_init(gen, D, F, dt)
        p["w_down"] = c.dense_init(gen, F, D, dt)
    for suffix, v in _norm_params(cfg).items():
        p["ln1" + suffix] = v
    if not cfg.parallel_block:
        for suffix, v in _norm_params(cfg).items():
            p["ln2" + suffix] = v
    return p


def stack_layers(per_layer):
    """[{name: leaf}] * L -> {name: (L, ...) leaf}, one leaf at a time."""
    return {k: torch.stack([lp.pop(k) for lp in per_layer])
            for k in list(per_layer[0])}


def init_params(cfg, gen, layer_init=None):
    """embed, lm_head, the stacked layers (``layer_init``, this module's
    ``init_layer_params`` by default) and the final norm."""
    dt = c.dtype_of(cfg)
    layer_init = layer_init or init_layer_params
    p = {
        "embed": c.embed_init(gen, cfg.vocab_padded, cfg.d_model, dt),
        "lm_head": c.dense_init(gen, cfg.d_model, cfg.vocab_padded, dt),
        "layers": stack_layers([layer_init(cfg, gen)
                                for _ in range(cfg.num_layers)]),
    }
    for suffix, v in _norm_params(cfg).items():
        p["ln_f" + suffix] = v
    return p


def layers(params, key: str = "layers"):
    """Each layer's leaves, as views into the stacked tree: one
    ``unbind`` per stacked leaf, so autograd gathers the layers'
    gradients into each stacked leaf with one stack (indexing layer by
    layer would give every layer a zero-filled gradient of the whole
    stacked leaf: O(L^2) work in the backward). A stack of shards
    (``shards.ShardedStack``) yields its layers one at a time."""
    if isinstance(params[key], ShardedStack):
        return params[key].layers()
    cols = {k: v.unbind(0) for k, v in params[key].items()}
    return [dict(zip(cols, vals)) for vals in zip(*cols.values())]


def _rotary_dim(cfg):
    rd = int(cfg.hd * cfg.rotary_pct)
    return rd - (rd % 2)


def _inv_freq(cfg, device):
    return c.rope_freqs(cfg.hd, cfg.rope_base, _rotary_dim(cfg) or None,
                        device=torch.device(device))


def _kv_weights(cfg, lp):
    """(wk, wv, bk, bv) this rank computes K and V with: as gathered, or,
    where each rank computes the one KV head its query heads read
    (``model_split().kv == "pick"``), that head's columns of the whole
    weights, which enter the model region (each rank's gradient of them
    is partial)."""
    names = ("wk", "wv") + (("bk", "bv") if cfg.qkv_bias else ())
    ws = [lp[k] for k in names]
    sp = c.model_split()
    if sp.kv == "pick":
        hd = cfg.hd
        kv = c._context_mesh().get_local_rank("model") \
            * cfg.num_kv_heads // sp.n
        ws = [c.enter_model(w).narrow(-1, kv * hd, hd) for w in ws]
    return ws + [None] * (4 - len(ws))


def _qkv(cfg, lp, h, positions, inv_freq):
    """q, k, v of ``h``: every head, or under the heads split
    (``common.model_split``) this rank's query heads and the KV heads
    they read, from the column slices ``shards`` gathers; under the
    columns split every head, on every rank."""
    B, S, D = h.shape
    hd = cfg.hd
    wk, wv, bk, bv = _kv_weights(cfg, lp)
    q = c.split_matmul(h, lp["wq"], cfg.num_heads * hd)
    k = c.split_matmul(h, wk, cfg.num_kv_heads * hd)
    v = c.split_matmul(h, wv, cfg.num_kv_heads * hd)
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + bk, v + bv
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    rd = _rotary_dim(cfg)
    if rd:
        q = c.apply_rope(q, positions, inv_freq, rd)
        k = c.apply_rope(k, positions, inv_freq, rd)
    return q, k, v


def self_attention(q, k, v, window=None, causal=True, total=None):
    """Self-attention of the step's queries ``q`` over its keys and
    values: (output, k, v at every position). Under the sequence split
    ``q``, ``k`` and ``v`` are this rank's positions: the keys and
    values of every position are gathered over "model" in global order
    (``common.gather_positions``; cut to the first ``total`` where the
    positions were padded to divide), and each of the rank's spans
    (``common.step_spans``) attends to them with its queries numbered
    from the span's first position; autograd sums the spans' dk and
    dv."""
    k, v = c.gather_positions(k, total), c.gather_positions(v, total)
    outs, at = [], 0
    for lo, n in c.step_spans(q.shape[1])[0]:
        outs.append(c.blockwise_attention(q[:, at:at + n], k, v,
                                          causal=causal, window=window,
                                          q_offset=lo))
        at += n
    return (outs[0] if len(outs) == 1 else torch.cat(outs, 1)), k, v


def _attention(cfg, lp, h, positions, inv_freq):
    """(attention output before the residual, k, v). Under the heads
    split ``h`` enters the model region and the output is this rank's
    heads' partial sum (``wo``'s rows), to be summed over "model"."""
    h = c.enter_model(h, c.model_split().heads)
    q, k, v = _qkv(cfg, lp, h, positions, inv_freq)
    attn, k, v = self_attention(q, k, v, cfg.sliding_window or None)
    B, S = h.shape[:2]
    return c.matmul(attn.reshape(B, S, -1), lp["wo"]), k, v


def _ffn(cfg, lp, h):
    """The MLP of ``h`` before ``b_down``. Under the FFN split ``h``
    enters the model region and the result is this rank's FFN columns'
    partial sum (``w_down``'s rows), to be summed over "model"."""
    h = c.enter_model(h, c.model_split().ffn)
    if cfg.mlp == "gelu":
        return c.split_matmul(c.gelu(c.split_matmul(h, lp["w_up"], cfg.d_ff)
                                     + lp["b_up"]), lp["w_down"], cfg.d_model)
    return c.gated_mlp(h, lp["w_gate"], lp["w_up"], lp["w_down"], cfg.d_ff)


def _mlp(cfg, lp, h):
    y = c.model_sum(_ffn(cfg, lp, h), c.model_split().ffn)
    return y + lp["b_down"] if cfg.mlp == "gelu" else y


def _layer(cfg, x, lp, positions, inv_freq):
    sp = c.model_split()
    h = _norm(cfg, x, lp, "ln1")
    attn_out, k, v = _attention(cfg, lp, h, positions, inv_freq)
    if cfg.parallel_block:            # command-r: attn & FFN from same norm
        if sp.heads and sp.ffn:       # both partial: one sum over "model"
            y = c.model_sum(attn_out + _ffn(cfg, lp, h))
            x = x + (y + lp["b_down"] if cfg.mlp == "gelu" else y)
        else:
            x = x + c.model_sum(attn_out, sp.heads) + _mlp(cfg, lp, h)
    else:
        x = x + c.model_sum(attn_out, sp.heads)
        h2 = _norm(cfg, x, lp, "ln2")
        x = x + _mlp(cfg, lp, h2)
    return x, k, v


def backbone(cfg, params, x, positions, collect_kv=False):
    """The layer loop and the final norm; with ``collect_kv`` also the
    per-layer (k, v), stacked to (L, B, S, KH, hd): every position, or,
    where the context's prefill hands its cache off to the split decode
    (``common.keep_decode_positions``), this rank's decode positions,
    cut as each layer ends."""
    inv_freq = _inv_freq(cfg, x.device)
    ks, vs = [], []
    for lp in layers(params):
        x, k, v = c.remat(cfg, _layer, cfg, x, lp, positions, inv_freq)
        if collect_kv:
            ks.append(c.keep_decode_positions(k))
            vs.append(c.keep_decode_positions(v))
        del k, v                    # the layer's gathered keys and values
    x = _norm(cfg, x, params, "ln_f")
    return x, ((torch.stack(ks), torch.stack(vs)) if collect_kv else None)


def embed_input(cfg, params, batch):
    if "embeds" in batch:
        return c.constrain_act(batch["embeds"].to(c.dtype_of(cfg)))
    return c.constrain_act(params["embed"][batch["tokens"]])


def _positions(x):
    """(B, S) global positions of ``x``'s (B, S, ...) rows: those of
    this rank's spans under the sequence split (``common.step_spans``),
    else 0 to S."""
    B, S = x.shape[:2]
    return torch.cat([torch.arange(lo, lo + n, dtype=torch.int32,
                                   device=x.device)
                      for lo, n in c.step_spans(S)[0]]).expand(B, S)


def forward(cfg, params, batch):
    x = embed_input(cfg, params, batch)
    x, _ = backbone(cfg, params, x, _positions(x))
    return c.logits(cfg, x, params["lm_head"])


def loss_fn(cfg, params, batch):
    logits = forward(cfg, params, batch)
    return c.cross_entropy(logits, batch["labels"], cfg.vocab_size,
                           cfg.vocab_padded)


def prefill(cfg, params, batch):
    """Full-sequence pass collecting the KV cache and the last position's
    logits (under the sequence split from the rank that holds that
    position). The cache is every position's, on every rank under the
    sequence split too; or, where ``shards.sharded_prefill`` is given a
    ``cache_len``, this rank's slice of the decode cache
    (``common.keep_decode_positions``)."""
    x = embed_input(cfg, params, batch)
    x, (k, v) = backbone(cfg, params, x, _positions(x), collect_kv=True)
    cdt = torch_dtype(cfg.kv_cache_dtype or cfg.dtype)
    logits_last = c.logits(cfg, c.last_position(x), params["lm_head"])
    return {"k": k.to(cdt), "v": v.to(cdt)}, logits_last


def write_kv(kc, vc, k, v, length: int):
    """Write one position of layer caches (B, S, KH, hd) in place: all
    the positions, or under the columns split this "model" rank's share
    of them (``common.cache_positions``), which it writes only where
    ``length`` falls in it. The reference's ``dynamic_update_slice``
    clamps a start past the end; here that is an error."""
    lo, total = c.cache_positions(kc.shape[1])
    if not 0 <= length < total:
        raise IndexError(f"decode position {length} outside a cache of "
                         f"{total} positions")
    j = length - lo
    if 0 <= j < kc.shape[1]:
        kc[:, j:j + 1] = k.to(kc.dtype)
        vc[:, j:j + 1] = v.to(vc.dtype)


def self_attention_split():
    """How a decode step's self-attention reads its KV cache
    (``common.decode_attention``'s ``split``): by this rank's positions
    under the columns split, else whole."""
    return "positions" if c.model_split().columns else None


def decode_step(cfg, params, cache, token, length):
    """One token with a KV cache (written at position ``length``).
    The cache's leaves are updated in place and returned. Under the
    columns split (``common.model_split``) each product is
    ``common.split_matmul``'s and the cache holds this rank's positions
    (``specs.decode_cache_spec``); the logits are this rank's slice of
    the vocabulary where ``lm_head`` is split."""
    length = int(length)
    x = c.gather_columns(params["embed"][token], cfg.d_model)  # (B,1,D)
    B = x.shape[0]
    inv_freq = _inv_freq(cfg, x.device)
    window = cfg.sliding_window or None
    split = self_attention_split()
    pos = torch.full((B, 1), length, dtype=torch.int32, device=x.device)
    for i, lp in enumerate(layers(params)):
        kc, vc = cache["k"][i], cache["v"][i]
        h = _norm(cfg, x, lp, "ln1")
        q, k, v = _qkv(cfg, lp, h, pos, inv_freq)
        write_kv(kc, vc, k, v, length)
        attn = c.decode_attention(q, kc, vc, length + 1, window=window,
                                  split=split)
        attn_out = c.split_matmul(attn.reshape(B, 1, -1), lp["wo"],
                                  cfg.d_model)
        if cfg.parallel_block:
            x = x + attn_out + _mlp(cfg, lp, h)
        else:
            x = x + attn_out
            h2 = _norm(cfg, x, lp, "ln2")
            x = x + _mlp(cfg, lp, h2)
    x = _norm(cfg, x, params, "ln_f")
    return c.logits(cfg, x, params["lm_head"]), cache

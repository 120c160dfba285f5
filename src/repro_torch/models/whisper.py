"""Whisper (enc-dec, arXiv:2212.04356) — transformer backbone only.

The conv frontend is a stub, as in the reference: inputs carry
precomputed frame embeddings (B, S_enc, d_model); the encoder is
non-causal self-attention over them, the decoder is causal self-attention
+ cross-attention. LayerNorm + GELU MLPs, sinusoidal positions. The
parameter tree is the reference's (``src/repro/models/whisper.py``) leaf
for leaf.

The reference's ``ServeEngine`` cannot serve this family (its waves pass
only tokens, and its cache growth would pad the cross-attention cache),
so neither does the port's: drive it with ``prefill`` and
``decode_step``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import common as c
from . import shards
from . import transformer as tfm


@functools.lru_cache(maxsize=32)
def sinusoid_pos(S, D, dtype, device=None):
    """(S, D) sinusoidal positions, computed in numpy f32 as the
    reference does and cast to ``dtype``; one tensor per (shape, dtype,
    device), shared and never written."""
    pos = np.arange(S)[:, None]
    dim = np.arange(0, D, 2)[None, :]
    ang = pos / np.power(10000.0, dim / D)
    out = np.zeros((S, D), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang[:, : out[:, 1::2].shape[1]])
    with torch.inference_mode(False):     # usable where autograd records
        return torch.from_numpy(out).to(device=device, dtype=dtype)


def init_dec_layer(cfg, gen):
    dt = c.dtype_of(cfg)
    D, H, KH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = tfm.init_layer_params(cfg, gen)
    p.update({
        "xq": c.dense_init(gen, D, H * hd, dt),
        "xk": c.dense_init(gen, D, KH * hd, dt),
        "xv": c.dense_init(gen, D, KH * hd, dt),
        "xo": c.dense_init(gen, H * hd, D, dt),
        "lnx_g": torch.ones((D,), dtype=dt),
        "lnx_b": torch.zeros((D,), dtype=dt),
    })
    return p


def init_params(cfg, gen):
    dt = c.dtype_of(cfg)
    p = {
        "embed": c.embed_init(gen, cfg.vocab_padded, cfg.d_model, dt),
        "lm_head": c.dense_init(gen, cfg.d_model, cfg.vocab_padded, dt),
        "enc_layers": tfm.stack_layers([tfm.init_layer_params(cfg, gen)
                                        for _ in range(cfg.encoder_layers)]),
        "layers": tfm.stack_layers([init_dec_layer(cfg, gen)
                                    for _ in range(cfg.num_layers)]),
    }
    for nm in ("ln_enc", "ln_f"):
        p[nm + "_g"] = torch.ones((cfg.d_model,), dtype=dt)
        p[nm + "_b"] = torch.zeros((cfg.d_model,), dtype=dt)
    return p


def _ln(cfg, x, lp, name):
    return c.layernorm(x, lp[name + "_g"], lp[name + "_b"], cfg.norm_eps)


def _mlp(cfg, lp, h):
    return c.gelu_mlp(h, lp["w_up"], lp["b_up"], lp["w_down"], lp["b_down"],
                      cfg.d_ff)


def _self_attn(cfg, lp, h, causal, frames=None):
    """(output, (k, v) at every position): under the sequence split
    ``h`` is this rank's positions (``transformer.self_attention``;
    ``frames`` the encoder's real frames, where they were padded)."""
    B, S, D = h.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = c.matmul(h, lp["wq"]).reshape(B, S, H, hd)
    k = c.matmul(h, lp["wk"]).reshape(B, S, KH, hd)
    v = c.matmul(h, lp["wv"]).reshape(B, S, KH, hd)
    o, k, v = tfm.self_attention(q, k, v, causal=causal, total=frames)
    return c.matmul(o.reshape(B, S, -1), lp["wo"]), (k, v)


def _enc_layer(cfg, x, lp, frames=None):
    a, _ = _self_attn(cfg, lp, _ln(cfg, x, lp, "ln1"), causal=False,
                      frames=frames)
    x = x + a
    return x + _mlp(cfg, lp, _ln(cfg, x, lp, "ln2"))


def encode(cfg, params, enc_embeds):
    """The encoder's output (B, S_enc, D) for every frame. Under the
    sequence split each "model" rank encodes its contiguous share of the
    frames (:func:`common.contiguous_positions`, whatever the decoder's
    layout), padded with zero frames to a multiple of n (the padded
    frames are masked as keys, and cut from the output, which is
    gathered over "model"); the encoder is not repeated on every
    rank."""
    with c.contiguous_positions():
        dt = c.dtype_of(cfg)
        B, S, D = enc_embeds.shape
        lo, per, total = c.position_share(S)
        x = enc_embeds if total == S else F.pad(enc_embeds,
                                                  (0, 0, 0, total - S))
        x = x[:, lo:lo + per].to(dt) \
            + sinusoid_pos(total, D, dt, enc_embeds.device)[lo:lo + per]
        for lp in tfm.layers(params, "enc_layers"):
            x = c.remat(cfg, _enc_layer, cfg, x, lp, S)
        return c.gather_positions(
            c.layernorm(x, params["ln_enc_g"], params["ln_enc_b"],
                        cfg.norm_eps), S)


def _cross_kv(cfg, lp, enc_out):
    B, Se, D = enc_out.shape
    KH, hd = cfg.num_kv_heads, cfg.hd
    xk = c.matmul(enc_out, lp["xk"]).reshape(B, Se, KH, hd)
    xv = c.matmul(enc_out, lp["xv"]).reshape(B, Se, KH, hd)
    return xk, xv


def _dec_layer(cfg, x, lp, enc_out):
    B, S = x.shape[:2]
    a, (k, v) = _self_attn(cfg, lp, _ln(cfg, x, lp, "ln1"), causal=True)
    x = x + a
    hx = _ln(cfg, x, lp, "lnx")
    q = c.matmul(hx, lp["xq"]).reshape(B, S, cfg.num_heads, cfg.hd)
    xk, xv = _cross_kv(cfg, lp, enc_out)
    o = c.blockwise_attention(q, xk, xv, causal=False)
    x = x + c.matmul(o.reshape(B, S, -1), lp["xo"])
    return x + _mlp(cfg, lp, _ln(cfg, x, lp, "ln2")), (k, v, xk, xv)


def decode_stack(cfg, params, tokens, enc_out, collect_kv=False):
    """The decoder layers and the final norm; with ``collect_kv`` also
    the per-layer (k, v, cross_k, cross_v), stacked on a leading L
    axis (k and v cut to this rank's decode positions as each layer
    ends where the prefill hands its cache off,
    ``common.keep_decode_positions``). Under the sequence split
    ``tokens`` are this rank's positions (their sinusoid rows its
    spans') and ``enc_out`` every frame: a rank's queries cross-attend
    to the whole encoder output."""
    dt = c.dtype_of(cfg)
    spans, total = c.step_spans(tokens.shape[1])
    x = params["embed"][tokens] + shards.take_spans(
        sinusoid_pos(total, cfg.d_model, dt, tokens.device), spans, 0)
    kvs = []
    for lp in tfm.layers(params):
        x, (k, v, xk, xv) = c.remat(cfg, _dec_layer, cfg, x, lp, enc_out)
        if collect_kv:
            kvs.append((c.keep_decode_positions(k),
                        c.keep_decode_positions(v), xk, xv))
        del k, v
    x = c.layernorm(x, params["ln_f_g"], params["ln_f_b"], cfg.norm_eps)
    return x, (tuple(torch.stack(t) for t in zip(*kvs)) if collect_kv
               else None)


def forward(cfg, params, batch):
    enc_out = encode(cfg, params, batch["enc_embeds"])
    x, _ = decode_stack(cfg, params, batch["tokens"], enc_out)
    return c.logits(cfg, x, params["lm_head"])


def loss_fn(cfg, params, batch):
    return c.cross_entropy(forward(cfg, params, batch), batch["labels"],
                           cfg.vocab_size, cfg.vocab_padded)


def prefill(cfg, params, batch):
    enc_out = encode(cfg, params, batch["enc_embeds"])
    x, (k, v, xk, xv) = decode_stack(cfg, params, batch["tokens"], enc_out,
                                     collect_kv=True)
    cache = {"k": k, "v": v, "cross_k": xk, "cross_v": xv}
    return cache, c.logits(cfg, c.last_position(x), params["lm_head"])


def decode_step(cfg, params, cache, token, length):
    """One token: self-attention against the cache (written at position
    ``length``, in place) and cross-attention over every encoder frame.
    The position row is the reference's, from a table of the cache's
    length + 1 rows. Under the columns split each product is
    ``common.split_matmul``'s, the self-attention cache holds this
    rank's positions (as ``transformer.decode_step``'s) and the cross
    cache, in the reference's layout, its slice of the head dim."""
    length = int(length)
    dt = c.dtype_of(cfg)
    B = token.shape[0]
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    split = tfm.self_attention_split()
    _, positions = c.cache_positions(cache["k"].shape[2])
    pos_tab = sinusoid_pos(positions + 1, cfg.d_model, dt, token.device)
    x = c.gather_columns(params["embed"][token], cfg.d_model) \
        + pos_tab[length:length + 1][None]
    for i, lp in enumerate(tfm.layers(params)):
        kc, vc = cache["k"][i], cache["v"][i]
        xk, xv = cache["cross_k"][i], cache["cross_v"][i]
        h = _ln(cfg, x, lp, "ln1")
        q = c.split_matmul(h, lp["wq"], H * hd).reshape(B, 1, H, hd)
        k = c.split_matmul(h, lp["wk"], KH * hd).reshape(B, 1, KH, hd)
        v = c.split_matmul(h, lp["wv"], KH * hd).reshape(B, 1, KH, hd)
        tfm.write_kv(kc, vc, k, v, length)
        a = c.decode_attention(q, kc, vc, length + 1, split=split)
        x = x + c.split_matmul(a.reshape(B, 1, -1), lp["wo"], cfg.d_model)
        hx = _ln(cfg, x, lp, "lnx")
        qx = c.split_matmul(hx, lp["xq"], H * hd).reshape(B, 1, H, hd)
        ox = c.decode_attention(qx, xk, xv, xk.shape[1],
                                split="head_dim" if xk.shape[-1] != hd
                                else None)
        x = x + c.split_matmul(ox.reshape(B, 1, -1), lp["xo"], cfg.d_model)
        x = x + _mlp(cfg, lp, _ln(cfg, x, lp, "ln2"))
    x = c.layernorm(x, params["ln_f_g"], params["ln_f_b"], cfg.norm_eps)
    return c.logits(cfg, x, params["lm_head"]), cache

"""Hymba — hybrid-head architecture (arXiv:2411.13676).

Each layer runs attention heads and SSM (mamba2-style) heads in
*parallel* on the same normed input and fuses their outputs (here: mean
of the two projected streams — the paper fuses with learned per-head
scaling; the reference's documented simplification). Attention is
sliding-window everywhere, the SSM path is a conv-free SSD.

Decode state: right-aligned sliding KV window (pre-rotated keys) + SSM
state per layer. The parameter tree is the reference's
(``src/repro/models/hymba.py``) leaf for leaf.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import common as c
from . import mamba2
from . import transformer as tfm


def _dims(cfg):
    din = cfg.din
    return din, din // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state


def init_layer_params(cfg, gen):
    dt = c.dtype_of(cfg)
    D = cfg.d_model
    din, H, P, N = _dims(cfg)
    p = tfm.init_layer_params(cfg, gen)   # attn + mlp + norms
    A_log, Dd, dt_bias = mamba2.ssm_scalars(H)
    p.update({
        "ssm_in": c.dense_init(gen, D, 2 * din + 2 * N + H, dt),
        "ssm_out": c.dense_init(gen, din, D, dt),
        "ssm_norm_g": torch.ones((din,), dtype=dt),
        "A_log": A_log,
        "Dd": Dd,
        "dt_bias": dt_bias,
    })
    return p


def init_params(cfg, gen):
    return tfm.init_params(cfg, gen, init_layer_params)


def _ssm_in(cfg, lp, h):
    """The SSM branch's projection, split: (z, silu(xBC), dt_raw)."""
    din, H, P, N = _dims(cfg)
    zxbcdt = c.split_matmul(h, lp["ssm_in"], 2 * din + 2 * N + H)
    return (zxbcdt[..., :din], c.silu(zxbcdt[..., din:2 * din + 2 * N]),
            zxbcdt[..., 2 * din + 2 * N:])


def _ssm_out(cfg, lp, y, z, dtype):
    B, S = y.shape[:2]
    y = y.reshape(B, S, cfg.din).to(dtype)
    y = c.rmsnorm(y, lp["ssm_norm_g"], cfg.norm_eps) * c.silu(z)
    return c.split_matmul(y, lp["ssm_out"], cfg.d_model)


def _ssm_branch(cfg, lp, h):
    """Returns (out, final SSM state)."""
    din, H, P, N = _dims(cfg)
    B, S, _ = h.shape
    z, xBC, dt_raw = _ssm_in(cfg, lp, h)
    xs = xBC[..., :din].reshape(B, S, H, P)
    Bm = xBC[..., din:din + N]
    Cm = xBC[..., din + N:]
    dt = mamba2.softplus(dt_raw.float() + lp["dt_bias"])
    A = -torch.exp(lp["A_log"])
    y, h_fin = mamba2.ssd_span(cfg, xs, Bm, Cm, dt, A, lp["Dd"])
    return _ssm_out(cfg, lp, y, z, h.dtype), h_fin


def _window(t, W):
    """The last W positions of (B, S, KH, hd), left-padded with zeros
    when S < W."""
    S = t.shape[1]
    return t[:, -W:] if S >= W else F.pad(t, (0, 0, 0, 0, W - S, 0))


def _layer(cfg, x, lp, positions, inv_freq, collect_state=False):
    W = cfg.sliding_window
    h = tfm._norm(cfg, x, lp, "ln1")
    q, k, v = tfm._qkv(cfg, lp, h, positions, inv_freq)
    attn, k, v = tfm.self_attention(q, k, v, W)
    B, S = x.shape[:2]
    attn_out = c.matmul(attn.reshape(B, S, -1), lp["wo"])
    ssm_out, h_fin = _ssm_branch(cfg, lp, h)
    x = x + 0.5 * (attn_out + ssm_out)     # parallel-head fusion
    h2 = tfm._norm(cfg, x, lp, "ln2")
    x = x + tfm._mlp(cfg, lp, h2)
    if collect_state:
        return x, (_window(k, W), _window(v, W), h_fin)
    return x


def backbone(cfg, params, x, positions, collect_state=False):
    inv_freq = tfm._inv_freq(cfg, x.device)
    states = []
    for lp in tfm.layers(params):
        if collect_state:
            x, st = _layer(cfg, x, lp, positions, inv_freq, True)
            states.append(st)
        else:
            x = c.remat(cfg, _layer, cfg, x, lp, positions, inv_freq)
    x = tfm._norm(cfg, x, params, "ln_f")
    if not collect_state:
        return x, None
    return x, tuple(torch.stack(s) for s in zip(*states))


def forward(cfg, params, batch):
    x = params["embed"][batch["tokens"]]
    x, _ = backbone(cfg, params, x, tfm._positions(x))
    return c.logits(cfg, x, params["lm_head"])


def loss_fn(cfg, params, batch):
    return c.cross_entropy(forward(cfg, params, batch), batch["labels"],
                           cfg.vocab_size, cfg.vocab_padded)


def prefill(cfg, params, batch):
    """The window of the last positions' k / v (gathered over "model"
    under the sequence split, so every rank's), the final SSM state and
    the last position's logits (the last "model" rank's under it)."""
    x = params["embed"][batch["tokens"]]
    x, (k, v, h) = backbone(cfg, params, x, tfm._positions(x),
                            collect_state=True)
    return ({"k": k, "v": v, "ssm_state": c.from_last_rank(h)},
            c.logits(cfg, c.last_position(x), params["lm_head"]))


def _window_attention(cfg, q, kc, vc, length):
    """One query against the right-aligned window: entry i holds
    absolute position length-(W-1-i), valid where that is >= 0. Unlike
    ``common.decode_attention``, the softmax weights stay f32 for the
    product with v, as the reference's.

    Under the columns split the window keeps the reference's layout,
    this "model" rank's slice of the head dim (its first entry would
    otherwise come from its neighbour every step): the scores' partial
    products are summed over "model", ``p`` is whole on every rank, and
    each rank's slice of the output is all-gathered."""
    W, hd_loc = kc.shape[1], kc.shape[-1]
    hd = cfg.hd
    valid = torch.arange(W, device=q.device) >= (W - 1 - length)
    rep = cfg.num_heads // cfg.num_kv_heads
    kk = c._repeat_kv(kc, rep).float()
    vv = c._repeat_kv(vc, rep).float()
    q = mamba2.state_slice(q, hd, hd_loc)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk)
    if hd_loc != hd:
        s = c._all_reduce(s, c._context_mesh(), ("model",))
    s = torch.where(valid[None, None, None, :], s / np.sqrt(hd), -1e30)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vv)
    return c.gather_columns(o, hd)


def decode_step(cfg, params, cache, token, length):
    """Sliding-window KV (right-aligned, newest last) + O(1) SSM step.
    The cache's leaves are updated in place and returned. Under the
    columns split each product is ``common.split_matmul``'s, the window
    holds this rank's slice of the head dim (:func:`_window_attention`)
    and the SSM state its slice of N (``mamba2.ssm_step``)."""
    length = int(length)
    din, H, P, N = _dims(cfg)
    inv_freq = tfm._inv_freq(cfg, params["embed"].device)
    x = c.gather_columns(params["embed"][token], cfg.d_model)
    B = x.shape[0]
    pos = torch.full((B, 1), length, dtype=torch.int32, device=x.device)
    for i, lp in enumerate(tfm.layers(params)):
        kc, vc = cache["k"][i], cache["v"][i]
        hn = tfm._norm(cfg, x, lp, "ln1")
        q, k, v = tfm._qkv(cfg, lp, hn, pos, inv_freq)
        k, v = (mamba2.state_slice(t, cfg.hd, kc.shape[-1]) for t in (k, v))
        kc.copy_(torch.cat([kc[:, 1:], k.to(kc.dtype)], dim=1))
        vc.copy_(torch.cat([vc[:, 1:], v.to(vc.dtype)], dim=1))
        attn = _window_attention(cfg, q, kc, vc, length).to(x.dtype)
        attn_out = c.split_matmul(attn.reshape(B, 1, -1), lp["wo"],
                                  cfg.d_model)
        # SSM single step (conv-free)
        z, xBC, dt_raw = _ssm_in(cfg, lp, hn)
        xs = xBC[:, 0, :din].reshape(B, H, P)
        n_loc = cache["ssm_state"].shape[-1]
        dtv = mamba2.softplus(dt_raw[:, 0].float() + lp["dt_bias"])
        A = -torch.exp(lp["A_log"])
        y, h = mamba2.ssm_step(
            cache["ssm_state"][i], xs,
            mamba2.state_slice(xBC[:, 0, din:din + N], N, n_loc),
            mamba2.state_slice(xBC[:, 0, din + N:], N, n_loc),
            dtv, A, lp["Dd"], mamba2.ssm_sum())
        cache["ssm_state"][i] = h
        ssm_out = _ssm_out(cfg, lp, y.reshape(B, 1, din), z, x.dtype)
        x = x + 0.5 * (attn_out + ssm_out)
        h2 = tfm._norm(cfg, x, lp, "ln2")
        x = x + tfm._mlp(cfg, lp, h2)
    x = tfm._norm(cfg, x, params, "ln_f")
    return c.logits(cfg, x, params["lm_head"]), cache

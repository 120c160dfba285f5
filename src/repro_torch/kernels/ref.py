"""Plain PyTorch versions of the GAS kernel, and the LM oracles.

Each computes the same function as :mod:`.gas_kernel` from the same
blocked inputs with stock tensor ops only (index gather +
``scatter_reduce``). The CPU path and the tests run them; on the card
they are the port's plain path and the yardstick the kernel is held
against.

torch has no bitwise-or reduction, so 'or' mode splits each int32 value
into its 32 bits, takes a per-bit ``amax`` and packs the bits again —
bit 31 included, because closeness masks are signed.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.gas import GATHER_IDENTITY
from ..models.common import silu

_REDUCE = {"sum": "sum", "min": "amin", "max": "amax"}


def _scatter_combine(idx, vals, size: int, mode: str):
    """out[i] = combine over {vals[k] : idx[k] == i} (identity where no
    k), for int64 ``idx`` in [0, size)."""
    if mode == "or":
        bits = torch.arange(32, device=vals.device, dtype=torch.int32)
        per_bit = (vals[:, None] >> bits) & 1                  # (n, 32)
        acc = torch.zeros((size, 32), dtype=torch.int32, device=vals.device)
        acc.scatter_reduce_(0, idx[:, None].expand(-1, 32), per_bit,
                            reduce="amax", include_self=True)
        packed = (acc.to(torch.int64) << bits.to(torch.int64)).sum(dim=1)
        # [0, 2**32) -> signed int32 two's complement
        packed = torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed)
        return packed.to(torch.int32)
    if mode not in _REDUCE:
        raise ValueError(mode)
    out = torch.full((size,), float(GATHER_IDENTITY[mode]), dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce_(0, idx, vals, reduce=_REDUCE[mode],
                               include_self=True)


def gas_ref(vwin, src_local, dst_local, weights, valid, window_id, tile_id,
            *, scatter_fn, mode, t, n_out_tiles):
    """Plain version of the GAS kernel: for every edge of every block,
    gather ``vwin[window_id[b], src_local[b, e]]``, apply ``scatter_fn``
    with the edge weight and combine into tile ``tile_id[b]`` at slot
    ``dst_local[b, e]``. Pads (``valid == 0``) are dropped. Returns
    ``(n_out_tiles, t)`` in vwin's dtype."""
    w = vwin.shape[1]
    keep = valid != 0
    src = window_id.to(torch.int64)[:, None] * w + src_local
    props = vwin.reshape(-1)[src[keep]]
    vals = scatter_fn(props, weights[keep]).to(vwin.dtype)
    flat = (tile_id.to(torch.int64)[:, None] * t + dst_local)[keep]
    return _scatter_combine(flat, vals, n_out_tiles * t,
                            mode).reshape(n_out_tiles, t)


def gas_stream_ref(vwin, edge_src, edge_dst, edge_w, tile_edge_start, *,
                   scatter_fn, mode, t, n_out_tiles):
    """Plain version of the GAS kernel over a live-edge stream: tile
    ``k`` takes edges ``tile_edge_start[k]:tile_edge_start[k + 1]``,
    each gathering ``vwin.reshape(-1)[edge_src]`` and combining at slot
    ``edge_dst``, in one ``scatter_reduce`` of every edge into its tile.
    Returns ``(n_out_tiles, t)`` in vwin's dtype."""
    counts = torch.diff(tile_edge_start.to(torch.int64))
    tile = torch.repeat_interleave(
        torch.arange(n_out_tiles, device=vwin.device), counts)
    props = vwin.reshape(-1)[edge_src.to(torch.int64)]
    vals = scatter_fn(props, edge_w).to(vwin.dtype)
    flat = tile * t + edge_dst.to(torch.int64)
    return _scatter_combine(flat, vals, n_out_tiles * t,
                            mode).reshape(n_out_tiles, t)


def edge_ref(graph_src, graph_dst, graph_w, vprops, scatter_fn, mode,
             num_vertices):
    """Ground truth straight from the edge list (no blocking) — the
    end-to-end oracle."""
    vals = scatter_fn(vprops[graph_src], graph_w).to(vprops.dtype)
    return _scatter_combine(graph_dst.to(torch.int64), vals, num_vertices,
                            mode)


def moe_dispatch_ref(tokens, router_logits, w_gate, w_up, w_down, top_k):
    """Oracle for the heterogeneous MoE dispatch: exact top-k gated
    mixture-of-experts FFN (no capacity drop), one top-k rank at a time
    over each token's own expert weights."""
    weights, idx = torch.topk(router_logits, top_k, dim=-1)   # (n_tok, k)
    weights = torch.softmax(weights, dim=-1)
    out = torch.zeros_like(tokens)
    for k in range(top_k):
        e = idx[:, k]                                          # (n_tok,)
        h = silu(torch.einsum("td,tdf->tf", tokens, w_gate[e])) \
            * torch.einsum("td,tdf->tf", tokens, w_up[e])
        y = torch.einsum("tf,tfd->td", h, w_down[e])
        out = out + weights[:, k:k + 1] * y
    return out


def flash_attention_ref(q, k, v, causal=True, window=None):
    """Oracle for the blockwise attention: exact softmax attention.
    q,k,v: (heads, seq, head_dim). Optional sliding window."""
    h, s, d = q.shape
    scale = 1.0 / np.sqrt(d)
    logits = torch.einsum("hqd,hkd->hqk", q, k) * scale
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    logits = torch.where(mask[None], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, v)

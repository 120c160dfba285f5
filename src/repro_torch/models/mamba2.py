"""Mamba-2 (SSD, state-space duality — arXiv:2405.21060).

Chunked SSD forward: the sequence is split into chunks; within a chunk
the quadratic dual form runs as batched products, between chunks the
SSM state (B, H, P, N) is carried by a Python loop over the chunks (the
reference's ``lax.scan``) — O(S) memory, O(S·Q) compute. Under the
sequence split each "model" rank scans its span of positions and the
spans' states are folded across ranks (:func:`ssd_span`); the causal
conv takes the previous rank's last rows (:func:`rows_before`). Decode
is the O(1) recurrent step. Attention-free (no KV cache).

Shapes: d_inner = expansion (cfg.din), P = ssm_head_dim, H = din/P heads,
N = ssm_state. B/C are shared across heads (ngroups=1, as in the paper).
The parameter tree is the reference's (``src/repro/models/mamba2.py``)
leaf for leaf; the layer loop takes each layer's views of the stacked
leaves (``transformer.layers``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import common as c
from . import transformer as tfm

CONV_K = 4
CHUNK = 128


def _dims(cfg):
    din = cfg.din
    H = din // cfg.ssm_head_dim
    return din, H, cfg.ssm_head_dim, cfg.ssm_state


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere (``F.softplus``
    switches to ``x`` above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssm_scalars(H):
    """The per-head A_log, D and dt_bias leaves at init (f32)."""
    return (torch.log(torch.linspace(1.0, 16.0, H)), torch.ones((H,)),
            torch.zeros((H,)))


def init_layer_params(cfg, gen):
    dt = c.dtype_of(cfg)
    D = cfg.d_model
    din, H, P, N = _dims(cfg)
    conv_dim = din + 2 * N
    A_log, Dd, dt_bias = ssm_scalars(H)
    return {
        "in_proj": c.dense_init(gen, D, 2 * din + 2 * N + H, dt),
        "conv_w": (torch.randn((CONV_K, conv_dim), generator=gen) * 0.2
                   ).to(dt),
        "conv_b": torch.zeros((conv_dim,), dtype=dt),
        "A_log": A_log,
        "D": Dd,
        "dt_bias": dt_bias,
        "norm_g": torch.ones((din,), dtype=dt),
        "ln_g": torch.ones((D,), dtype=dt),
        "out_proj": c.dense_init(gen, din, D, dt),
    }


def init_params(cfg, gen):
    dt = c.dtype_of(cfg)
    return {
        "embed": c.embed_init(gen, cfg.vocab_padded, cfg.d_model, dt),
        "lm_head": c.dense_init(gen, cfg.d_model, cfg.vocab_padded, dt),
        "ln_f_g": torch.ones((cfg.d_model,), dtype=dt),
        "layers": tfm.stack_layers([init_layer_params(cfg, gen)
                                    for _ in range(cfg.num_layers)]),
    }


def _split_proj(cfg, zxbcdt):
    din, H, P, N = _dims(cfg)
    z = zxbcdt[..., :din]
    xBC = zxbcdt[..., din:2 * din + 2 * N]
    dt_raw = zxbcdt[..., 2 * din + 2 * N:]
    return z, xBC, dt_raw


def _causal_conv(xBC, w, b, left=None):
    """Depthwise causal conv, kernel CONV_K. xBC: (B, S, C); ``left``
    (B, CONV_K - 1, C) the rows before it (zeros by default). A Python
    ``sum`` of the CONV_K products, each rounded to xBC's dtype, as the
    reference adds them."""
    S = xBC.shape[1]
    pads = (F.pad(xBC, (0, 0, CONV_K - 1, 0)) if left is None
            else torch.cat([left, xBC], dim=1))
    out = sum(pads[:, i:i + S] * w[i] for i in range(CONV_K))
    return c.silu(out + b)


def ssd_chunked(cfg, x, Bm, Cm, dt, A, D, h0=None):
    """Chunked SSD scan.
    x: (B,S,H,P); Bm,Cm: (B,S,N); dt: (B,S,H) (post-softplus); A: (H,)<0.
    Returns y (B,S,H,P) in f32, final state (B,H,P,N) in f32."""
    b, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(CHUNK, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    f32 = torch.float32
    xs = F.pad(x, (0, 0, 0, 0, 0, pad)).float().reshape(b, nc, Q, H, P)
    Bc = F.pad(Bm, (0, 0, 0, pad)).float().reshape(b, nc, Q, N)
    Cc = F.pad(Cm, (0, 0, 0, pad)).float().reshape(b, nc, Q, N)
    dtc = F.pad(dt, (0, 0, 0, pad)).reshape(b, nc, Q, H)
    h = (torch.zeros((b, H, P, N), dtype=f32, device=x.device) if h0 is None
         else h0.float())
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    ys = []
    for ci in range(nc):
        xq, Bq, Cq, dtq = xs[:, ci], Bc[:, ci], Cc[:, ci], dtc[:, ci]
        dA = dtq * A                                   # (B,Q,H) negative
        a_cum = torch.cumsum(dA, dim=1)                # (B,Q,H)
        # intra-chunk dual (quadratic) form
        G = torch.einsum("bqn,bkn->bqk", Cq, Bq)       # (B,Q,Q)
        # mask the exponent BEFORE exp: the i>j half would overflow to
        # inf and poison the backward via inf*0=NaN cotangents
        delta = a_cum[:, :, None, :] - a_cum[:, None, :, :]
        delta = torch.where(tril[None, :, :, None], delta, -1e30)
        decay = torch.exp(delta)
        M = G[..., None] * decay * dtq[:, None, :, :]  # (B,Q,K,H)
        y_intra = torch.einsum("bqkh,bkhp->bqhp", M, xq)
        # inter-chunk from carried state
        y_inter = torch.einsum("bqn,bhpn->bqhp", Cq, h) \
            * torch.exp(a_cum)[..., None]
        # state update
        w = dtq * torch.exp(a_cum[:, -1:, :] - a_cum)  # (B,Q,H)
        h = h * torch.exp(a_cum[:, -1])[:, :, None, None] \
            + torch.einsum("bkh,bkn,bkhp->bhpn", w, Bq, xq)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, nc * Q, H, P)[:, :S]
    y = y + D[None, None, :, None] * x.float()
    return y, h


def _one_span():
    """Refuse the zigzag layout: the conv's rows and the SSD's state are
    carried in position order, from each rank's one span to the next
    rank's (``specs.sequence_split`` keeps these families
    contiguous)."""
    if c.model_split().zigzag:
        raise ValueError("a recurrence split over \"model\" needs each "
                         "rank's positions in one contiguous span")


def rows_before(t, k: int):
    """Under the sequence split, the ``k`` rows of (B, S, C) ``t`` that
    come before this "model" rank's: the previous rank's last ``k``
    (zeros on the first rank), exchanged over "model" with a backward;
    else None (the sequence starts here)."""
    if not c.model_split().sequence:
        return None
    _one_span()
    if t.shape[1] < CONV_K:
        raise ValueError(f"the sequence split gives this rank {t.shape[1]} "
                         f"positions: the conv's state needs {CONV_K}")
    tails = c.gather_model(t[:, -k:])
    r = c._context_mesh().get_local_rank("model")
    # the first rank reads a tail too (and takes zeros), so that every
    # rank's backward runs the exchange's reduce-scatter
    return torch.where(torch.tensor(r > 0, device=t.device), tails[r - 1],
                       torch.zeros_like(tails[0]))


def carry_in(y, h, Cm, a_cum, states, decays, r: int):
    """The span ``r`` of a sequence scanned span by span, each from a
    zero state, with the state the earlier spans carry into it: (y, h)
    of :func:`ssd_chunked` over the span from ``h0 = 0``, the span's
    ``Cm`` (B, S, N) and cumulative ``dt * A`` (B, S, H), and every
    span's final state from zero (n, B, H, P, N) and total decay
    ``exp(sum dt * A)`` (n, B, H) in span order. The incoming state
    folds spans 0..r-1 in order; its contribution ``C_t . h_in *
    exp(a_cum_t)`` is added to ``y`` and its decay over the span to
    ``h``. Returns (y, h) as the scan from the sequence's start gives
    them, up to f32 reassociation. Every span's state and decay is read
    (those from span ``r`` on leave ``h_in`` as it is), so that the
    backward of their exchange over "model" runs on every rank."""
    h_in = torch.zeros_like(h)
    for j in range(len(states)):
        h_in = torch.where(torch.tensor(j < r, device=h.device),
                           h_in * decays[j][..., None, None] + states[j],
                           h_in)
    y = y + torch.einsum("bsn,bhpn->bshp", Cm.float(), h_in) \
        * torch.exp(a_cum)[..., None]
    return y, h + h_in * decays[r][..., None, None]


def ssd_span(cfg, x, Bm, Cm, dt, A, D):
    """:func:`ssd_chunked` over the step's positions; under the sequence
    split over this "model" rank's span, from a zero state, then the
    state of every earlier span folded in (:func:`carry_in`): each
    rank's final state and total decay are exchanged over "model" (with
    a backward: in a train step this runs inside ``common.remat``)."""
    y, h = ssd_chunked(cfg, x, Bm, Cm, dt, A, D)
    if not c.model_split().sequence:
        return y, h
    _one_span()
    a_cum = torch.cumsum(dt * A, dim=1)
    return carry_in(y, h, Cm, a_cum, c.gather_model(h),
                    c.gather_model(torch.exp(a_cum[:, -1])),
                    c._context_mesh().get_local_rank("model"))


def layer_forward(cfg, lp, x, return_state=False):
    """One mamba2 block. x: (B,S,D). With ``return_state`` also the final
    SSM state and the conv state: the last CONV_K raw (pre-conv) xBC
    rows, zero-padded on the left when S < CONV_K."""
    din, H, P, N = _dims(cfg)
    B, S, D = x.shape
    hid = c.rmsnorm(x, lp["ln_g"], cfg.norm_eps)
    zxbcdt = c.matmul(hid, lp["in_proj"])
    z, xBC_raw, dt_raw = _split_proj(cfg, zxbcdt)
    xBC = _causal_conv(xBC_raw, lp["conv_w"], lp["conv_b"],
                       rows_before(xBC_raw, CONV_K - 1))
    xs = xBC[..., :din].reshape(B, S, H, P)
    Bm = xBC[..., din:din + N]
    Cm = xBC[..., din + N:]
    dt = softplus(dt_raw.float() + lp["dt_bias"])
    A = -torch.exp(lp["A_log"])
    y, h_fin = ssd_span(cfg, xs, Bm, Cm, dt, A, lp["D"])
    y = y.reshape(B, S, din).to(x.dtype)
    y = c.rmsnorm(y, lp["norm_g"], cfg.norm_eps) * c.silu(z)
    out = x + c.matmul(y, lp["out_proj"])
    if return_state:
        tail = x.new_zeros((B, CONV_K, din + 2 * N))
        take = min(CONV_K, S)
        tail[:, CONV_K - take:] = xBC_raw[:, S - take:]
        return out, h_fin, tail
    return out


def backbone(cfg, params, x, collect_state=False):
    """The layer loop and the final norm; with ``collect_state`` also the
    per-layer (ssm_state, conv_state), stacked on a leading L axis."""
    hs, convs = [], []
    for lp in tfm.layers(params):
        if collect_state:
            x, h, conv = layer_forward(cfg, lp, x, return_state=True)
            hs.append(h)
            convs.append(conv)
        else:
            x = c.remat(cfg, layer_forward, cfg, lp, x)
    x = c.rmsnorm(x, params["ln_f_g"], cfg.norm_eps)
    return x, ((torch.stack(hs), torch.stack(convs)) if collect_state
               else None)


def forward(cfg, params, batch):
    x = c.constrain_act(params["embed"][batch["tokens"]])
    x, _ = backbone(cfg, params, x)
    return c.logits(cfg, x, params["lm_head"])


def loss_fn(cfg, params, batch):
    return c.cross_entropy(forward(cfg, params, batch), batch["labels"],
                           cfg.vocab_size, cfg.vocab_padded)


def prefill(cfg, params, batch):
    """The final SSM and conv states and the last position's logits:
    under the sequence split, the last "model" rank's, on every rank."""
    x = params["embed"][batch["tokens"]]
    x, (h, conv) = backbone(cfg, params, x, collect_state=True)
    logits = c.logits(cfg, c.last_position(x), params["lm_head"])
    return {"ssm_state": c.from_last_rank(h),
            "conv_state": c.from_last_rank(conv)}, logits


def ssm_step(h, xs, Bm, Cm, dt, A, D, model_sum=None):
    """One recurrent SSD step in f32. h: (B,H,P,N); xs: (B,H,P); Bm, Cm:
    (B,N); dt: (B,H) post-softplus. Returns (y (B,H,P), h').

    Under the columns split ``h``, ``Bm`` and ``Cm`` are this "model"
    rank's slice of N: the update is elementwise in N, and ``C . h``
    is partial, summed by ``model_sum`` before ``D * x`` is added, once."""
    xf = xs.float()
    dA = torch.exp(dt * A)                                  # (B,H)
    h = h * dA[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt, Bm.float(), xf)
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), h)
    if model_sum is not None:
        y = model_sum(y)
    return y + D[None, :, None] * xf, h


def state_slice(t, width: int, n_local: int):
    """The slice of ``t``'s last dim (``width`` long) that this "model"
    rank holds ``n_local`` of: all of it, or, under the columns split,
    its contiguous share."""
    if n_local == width:
        return t
    lo = c._context_mesh().get_local_rank("model") * n_local
    return t[..., lo:lo + n_local]


def ssm_sum():
    """What sums ``C . h`` over the slices of N (:func:`ssm_step`): the
    sum over "model" under the columns split, else nothing."""
    return c.model_sum if c.model_split().columns else None


def decode_step(cfg, params, cache, token, length):
    """O(1) recurrent step. cache: ssm_state (L,B,H,P,N), conv_state
    (L,B,CONV_K,conv_dim) holding the last raw xBC inputs; both are
    updated in place and returned. ``length`` is not used.

    Under the columns split (``common.model_split``) each product is
    ``common.split_matmul``'s, and the state is as
    ``specs.decode_cache_spec`` places it: this rank's channels of
    ``conv_state`` (the conv runs on them, then ``xBC`` is gathered)
    and its slice of N of ``ssm_state``."""
    del length
    din, H, P, N = _dims(cfg)
    x = c.gather_columns(params["embed"][token], cfg.d_model)  # (B,1,D)
    B = x.shape[0]
    conv_dim = din + 2 * N
    for i, lp in enumerate(tfm.layers(params)):
        hid = c.rmsnorm(x, lp["ln_g"], cfg.norm_eps)
        zxbcdt = c.split_matmul(hid, lp["in_proj"], 2 * din + 2 * N + H)
        z, xBC_raw, dt_raw = _split_proj(cfg, zxbcdt)
        cs = cache["conv_state"][i]
        xBC_raw = state_slice(xBC_raw, conv_dim, cs.shape[-1])
        conv = torch.cat([cs[:, 1:], xBC_raw], dim=1)
        cache["conv_state"][i] = conv
        # exact products, an f32 sum, one rounding: the reference's einsum
        xBC = c.silu(torch.einsum("bkc,kc->bc", conv.float(),
                                  lp["conv_w"].float()).to(conv.dtype)
                     + state_slice(lp["conv_b"], conv_dim, cs.shape[-1]))
        xBC = c.gather_columns(xBC, conv_dim)
        xs = xBC[:, :din].reshape(B, H, P)
        n_loc = cache["ssm_state"].shape[-1]
        Bm = state_slice(xBC[:, din:din + N], N, n_loc)
        Cm = state_slice(xBC[:, din + N:], N, n_loc)
        dt = softplus(dt_raw[:, 0].float() + lp["dt_bias"])   # (B,H)
        A = -torch.exp(lp["A_log"])
        y, h = ssm_step(cache["ssm_state"][i], xs, Bm, Cm, dt, A, lp["D"],
                        ssm_sum())
        cache["ssm_state"][i] = h
        y = y.reshape(B, 1, din).to(x.dtype)
        y = c.rmsnorm(y, lp["norm_g"], cfg.norm_eps) * c.silu(z)
        x = x + c.split_matmul(y, lp["out_proj"], cfg.d_model)
    x = c.rmsnorm(x, params["ln_f_g"], cfg.norm_eps)
    return c.logits(cfg, x, params["lm_head"]), cache

"""Shared model building blocks (pure functions over param trees).

Conventions (the reference's, ``src/repro/models/common.py``):
  * params are nested dicts of tensors; layer-stacked leaves carry a
    leading L axis, and the models loop over it, indexing each leaf.
  * dtype policy: params/activations in cfg.dtype (bf16 default), softmax
    and reductions in f32. Where the reference asks for exact products
    with an f32 accumulator and an f32 result (``einsum(...,
    preferred_element_type=f32)`` on bf16 or f8 operands), the operands
    are upcast to f32 first: a torch bf16 matmul would round its result
    to bf16.
  * attention is an online-softmax blockwise implementation in plain
    torch ops, the same math as the reference's ``_flash_fwd_impl``,
    with its flash backward as a ``torch.autograd.Function``.
  * ``remat`` is the reference's ``jax.checkpoint`` around each layer
    when ``cfg.remat`` is set and autograd is recording; a layer of
    shards (``shards.ShardedLayer``) is gathered inside it, always.
  * the reference's sharding constraints redistribute a DTensor to their
    spec where the dims divide, and are identities on plain tensors. The
    mesh a model runs on (``use_mesh``, the reference's ``with mesh:``)
    is what the MoE's expert-sharded branch, the layers' Megatron split
    (``model_split``) and ``cross_entropy`` read: on a mesh each rank
    computes on its own batch shard (of its data shard's rows, where the
    batch is split over "model" too), and the loss is the global
    batch's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..configs import torch_dtype
from . import shards
from .shards import ShardedLayer


def dtype_of(cfg) -> torch.dtype:
    return torch_dtype(cfg.dtype)


# ---------------------------------------------------------------------------
# the mesh a model runs on, and sharding constraints
# ---------------------------------------------------------------------------

_MESH = threading.local()


@contextlib.contextmanager
def use_mesh(mesh, data_dims=None, split=None, cache_len=None):
    """Run the block on ``mesh`` (a ``DeviceMesh``, or None for none):
    the reference's ``with mesh:``. ``data_dims`` names the mesh dims
    the batch is split on, each rank holding its own shard ("pod" and
    "data", those the mesh has, by default; "model" too where the batch
    is split there). ``split`` (a ``sharding.specs.ModelSplit``) is what
    this rank computes of its model group's work: the layers read it
    (:func:`model_split`) and split their heads and FFN dim, or their
    positions, by it. ``cache_len``: a prefill whose keys and values
    every layer keeps only at this rank's positions of a decode cache
    of that many positions (:func:`keep_decode_positions`); None keeps
    every position."""
    if mesh is not None and data_dims is None:
        data_dims = tuple(a for a in ("pod", "data")
                          if a in mesh.mesh_dim_names)
    prev = getattr(_MESH, "cache_len", None)
    _MESH.cache_len = cache_len
    try:
        with _in_context((mesh, tuple(
                a for a in (data_dims or ())
                if mesh.size(mesh.mesh_dim_names.index(a)) > 1), split)):
            yield mesh
    finally:
        _MESH.cache_len = prev


def _context_mesh():
    return getattr(_MESH, "mesh", None)


def _context() -> tuple:
    return (getattr(_MESH, "mesh", None), getattr(_MESH, "data_dims", ()),
            getattr(_MESH, "split", None))


@contextlib.contextmanager
def _in_context(ctx):
    """Run the block in the context ``ctx`` (:func:`_context`'s) on this
    thread."""
    prev = _context()
    _MESH.mesh, _MESH.data_dims, _MESH.split = ctx
    try:
        yield
    finally:
        _MESH.mesh, _MESH.data_dims, _MESH.split = prev


def _data_dims() -> tuple:
    """The context mesh's dims (of size > 1) that the batch is split
    on."""
    return getattr(_MESH, "data_dims", ())


def model_split():
    """The context's ``ModelSplit`` (:func:`use_mesh`); no split off a
    mesh or where none was given."""
    from ..sharding.specs import ModelSplit
    return getattr(_MESH, "split", None) or ModelSplit()


def _all_reduce(x, mesh, dims, op: str = "sum"):
    """``op`` ("sum" or "max") of ``x`` over the mesh dims named
    ``dims`` (functional collectives, one per dim)."""
    import torch.distributed._functional_collectives as funcol
    for name in dims:
        x = funcol.all_reduce(x, op, (mesh, mesh.mesh_dim_names.index(
            name)))
        if isinstance(x, funcol.AsyncCollectiveTensor):
            x = x.wait()
    return x


class _EnterModel(torch.autograd.Function):
    """Entry of the model-parallel region: the identity forward; the
    backward sums each rank's partial gradient over "model" (Megatron's
    f), so what comes out of the region has one gradient on every
    rank."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ("model",)), None


class _ReduceOver(torch.autograd.Function):
    """Sum over the mesh dims ``dims`` scaled by ``scale`` (a psum, or a
    pmean with ``1 / n``). Backward: the gradient times ``grad_scale``,
    with no collective (Megatron's g). Every rank holds the same
    downstream gradient, so the identity is the psum's transpose over
    ranks that computed different parts (experts on "model", tokens on
    the data dims, whose weight gradients ``shards`` sums); a pmean
    passes ``1 / n`` back to each rank's part."""

    @staticmethod
    def forward(ctx, x, mesh, dims, scale, grad_scale):
        ctx.grad_scale = grad_scale
        out = _all_reduce(x, mesh, dims)
        return out * scale if scale != 1 else out

    @staticmethod
    def backward(ctx, g):
        return g * ctx.grad_scale, None, None, None, None


def enter_model(x, on: bool = True):
    """``x`` entering a region whose work the context's "model" ranks
    split (:class:`_EnterModel`) where ``on``; else ``x`` itself."""
    return _EnterModel.apply(x, _context_mesh()) if on else x


def model_sum(y, on: bool = True):
    """``y``, this rank's partial sum of a region split over "model",
    summed over "model" (:class:`_ReduceOver`) where ``on``; else ``y``
    itself."""
    return _ReduceOver.apply(y, _context_mesh(), ("model",), 1, 1) \
        if on else y


def _model_group(mesh):
    return (mesh, mesh.mesh_dim_names.index("model"))


def _wait(x):
    import torch.distributed._functional_collectives as funcol
    return x.wait() if isinstance(x, funcol.AsyncCollectiveTensor) else x


class _GatherRows(torch.autograd.Function):
    """The model group's rows: each rank's ``x`` concatenated on ``dim``
    (0 by default) in "model" rank order (an all-gather). Backward: each
    rank's rows of the gradient summed over "model" (a reduce-scatter),
    since each rank's gradient of the whole is partial."""

    @staticmethod
    def forward(ctx, x, mesh, dim=0):
        import torch.distributed._functional_collectives as funcol
        ctx.mesh, ctx.dim = mesh, dim
        return _wait(funcol.all_gather_tensor(x.contiguous(), dim,
                                              _model_group(mesh)))

    @staticmethod
    def backward(ctx, g):
        return _ScatterRows.apply(g, ctx.mesh, ctx.dim), None, None


class _ScatterRows(torch.autograd.Function):
    """This rank's rows on ``dim`` (0 by default) of ``y`` (rows of the
    model group, each rank's ``y`` a partial sum) summed over "model" (a
    reduce-scatter). Backward: the gradients of every rank's rows (an
    all-gather)."""

    @staticmethod
    def forward(ctx, y, mesh, dim=0):
        import torch.distributed._functional_collectives as funcol
        ctx.mesh, ctx.dim = mesh, dim
        return _wait(funcol.reduce_scatter_tensor(y.contiguous(), "sum", dim,
                                                  _model_group(mesh)))

    @staticmethod
    def backward(ctx, g):
        return _GatherRows.apply(g, ctx.mesh, ctx.dim), None, None


# ---------------------------------------------------------------------------
# the sequence split of a train or prefill step (``specs.ModelSplit.
# sequence``): each "model" rank its share of the positions, a zigzag of
# two spans or one contiguous span (``shards.position_spans``)
# ---------------------------------------------------------------------------

def step_spans(length: int) -> tuple:
    """(this rank's spans [(first global position, count)], all
    positions) of a step whose rows hold ``length`` positions here:
    under the sequence split, this "model" rank's share of n x
    ``length`` positions (``shards.position_spans``, as the split's
    layout says); else ([(0, ``length``)], ``length``)."""
    sp = model_split()
    if not sp.sequence:
        return [(0, length)], length
    total = sp.n * length
    return shards.position_spans(total, sp.n, _context_mesh().get_local_rank(
        "model"), sp.zigzag), total


def position_share(length: int) -> tuple:
    """(its first position, its count, every rank's positions) of this
    "model" rank's contiguous share of ``length`` positions under the
    sequence split (``shards.position_spans``: padded at the end to
    divide; whisper's encoder frames, whatever the split's layout);
    else (0, ``length``, ``length``)."""
    sp = model_split()
    if not sp.sequence:
        return 0, length, length
    (lo, per), = shards.position_spans(
        length, sp.n, _context_mesh().get_local_rank("model"))
    return lo, per, sp.n * per


@contextlib.contextmanager
def contiguous_positions():
    """Run the block with the sequence split's positions contiguous
    (one span a rank; whisper's encoder frames, whatever the decoder's
    layout): :func:`step_spans` and :func:`gather_positions` read it,
    and ``remat``'s recompute runs in it too."""
    mesh, dims, sp = _context()
    if sp is not None and sp.zigzag:
        sp = dataclasses.replace(sp, zigzag=False)
    with _in_context((mesh, dims, sp)):
        yield


def _zigzag_chunks(n: int, to_global: bool) -> list:
    """The chunk order that takes the model group's positions gathered
    in rank order (rank r's chunks r and 2n-1-r) to global order
    (``to_global``), or back."""
    held = [c for r in range(n) for c in (r, 2 * n - 1 - r)]
    return [held.index(c) for c in range(2 * n)] if to_global else held


def _reorder(t, order: list):
    """(B, S, ...) ``t`` with its S positions' len(``order``) equal
    chunks taken in ``order``."""
    return t.unflatten(1, (len(order), -1))[:, order].flatten(1, 2)


def gather_positions(t, total: Optional[int] = None):
    """``t`` (B, S, ...) at every position of the step under the
    sequence split, in global position order: every "model" rank's
    positions gathered (an all-gather; its backward reduce-scatters the
    gradient to each position's owner) and, under the zigzag layout,
    each rank's two spans put in their places; cut to the first
    ``total`` where they were padded to divide. ``t`` itself under any
    other split."""
    sp = model_split()
    if not sp.sequence:
        return t
    out = _GatherRows.apply(t, _context_mesh(), 1)
    if sp.zigzag:
        out = _reorder(out, _zigzag_chunks(sp.n, True))
    return out if total is None else out[:, :total]


def scatter_positions(y):
    """This rank's positions of ``y`` (B, S, ...), every position of the
    step in global order, each rank's ``y`` a partial sum: the
    transpose of :func:`gather_positions` (a reduce-scatter over
    "model", after putting the positions in rank order under the zigzag
    layout)."""
    sp = model_split()
    if sp.zigzag:
        y = _reorder(y, _zigzag_chunks(sp.n, False))
    return _ScatterRows.apply(y, _context_mesh(), 1)


def gather_model(t):
    """Every "model" rank's ``t`` stacked on a new leading dim in rank
    order (n, ...) (an all-gather; its backward sums each rank's part of
    the gradient to its owner)."""
    return _GatherRows.apply(t[None], _context_mesh(), 0)


def from_last_rank(t):
    """Under the sequence split, the last "model" rank's ``t`` (what is
    taken at its last position: the step's under the contiguous layout,
    the recurrences' final states) on every rank; else ``t``."""
    return gather_model(t)[-1] if model_split().sequence else t


def last_position(x):
    """(B, 1, D): the step's last position of ``x`` (B, S, D), from the
    "model" rank that holds it under the sequence split: the last rank
    (contiguous), or rank 0, whose second span ends the step (zigzag).
    Every rank takes part in the gather, so that every rank's backward
    runs its reduce-scatter."""
    sp = model_split()
    if not sp.sequence:
        return x[:, -1:]
    return gather_model(x[:, -1:])[0 if sp.zigzag else -1]


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, *spec):
    """Redistribute a DTensor ``x`` to ``spec`` (per dim: None, a mesh
    dim's name or a tuple of names) on its own mesh, keeping only the
    names the mesh has and that divide their dim (the reference's
    ``with_sharding_constraint`` rule); the identity on a plain
    tensor."""
    if not _is_dtensor(x):
        return x
    from ..sharding.specs import Layout, mesh_sizes
    mesh = x.device_mesh
    sizes = mesh_sizes(mesh)
    fixed = []
    for d, ax in enumerate(spec):
        axes = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        axes = tuple(a for a in axes if a in sizes)
        n = int(np.prod([sizes[a] for a in axes])) if axes else 1
        ok = axes and x.shape[d] % n == 0 and x.shape[d] >= n
        fixed.append((axes if len(axes) > 1 else axes[0]) if ok else None)
    return x.redistribute(mesh, Layout(mesh, tuple(fixed)).placements)


def constrain_logits(x):
    """(B, S, V) or (B, 1, V): batch over ("pod","data"), vocab on
    model."""
    return constrain(x, ("pod", "data"), None, "model")


def logits(cfg, x, lm_head):
    """``x @ lm_head`` under the reference's logits constraint. Where the
    head comes as this rank's slice of the vocabulary (``shards`` gathers
    it so on a "model" dim, as the reference places the logits), the
    result is this rank's slice of the logits, and ``x`` enters the
    model region: each rank's gradient of it is partial."""
    mesh = _context_mesh()
    if mesh is not None and lm_head.shape[-1] != cfg.vocab_padded:
        x = _EnterModel.apply(x, mesh)
    return constrain_logits(matmul(x, lm_head))


def constrain_act(x):
    """(B, S, D): batch over ("pod","data")."""
    return constrain(x, ("pod", "data"), *([None] * (x.ndim - 1)))


def remat(cfg, fn, *args):
    """``fn(*args)``; under ``torch.utils.checkpoint`` (non-reentrant)
    when ``cfg.remat`` is set and autograd is recording, as the
    reference wraps each layer in ``jax.checkpoint``: the layer's
    activations are recomputed in the backward instead of kept. A
    :class:`~.shards.ShardedLayer` argument is gathered inside the
    checkpoint whatever ``cfg.remat`` says, so that the layer's whole
    weights are gathered again for the backward, not kept (ZeRO-3).
    The recompute runs in the forward's :func:`use_mesh` context: on
    the card autograd runs the backward on a thread of its own, which
    does not see this one's."""
    sharded = any(isinstance(a, ShardedLayer) for a in args)
    if not torch.is_grad_enabled() or not (sharded or cfg.remat):
        return fn(*args)
    ctx = _context()

    def run(*a):
        with _in_context(ctx):
            return fn(*(x.gather() if isinstance(x, ShardedLayer) else x
                        for x in a))
    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# initialisers: tensors are made on the current default device (the
# ``torch.device`` context; ``models.api.Model.init`` sets it to the
# generator's device, ``param_specs`` to "meta")
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in, d_out, dtype, scale=None):
    scale = scale if scale is not None else (1.0 / np.sqrt(d_in))
    return (torch.randn((d_in, d_out), generator=gen) * scale).to(dtype)


def embed_init(gen: torch.Generator, v, d, dtype):
    return (torch.randn((v, d), generator=gen) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms: normalize in f32, cast to the activation dtype, then scale
# ---------------------------------------------------------------------------

def rmsnorm(x, gamma, eps=1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def layernorm(x, gamma, beta, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * gamma + beta


# ---------------------------------------------------------------------------
# RoPE (standard / partial a.k.a. chatglm "2d" / none)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def rope_freqs(head_dim, base=10000.0, rotary_dim=None, device=None):
    """The inverse frequencies, computed in numpy as the reference does;
    one tensor per (shape, device), shared and never written, so a
    decode step makes no host-to-device copy for them."""
    rd = rotary_dim or head_dim
    inv = 1.0 / (base ** (np.arange(0, rd, 2, dtype=np.float32) / rd))
    with torch.inference_mode(False):     # usable where autograd records
        return torch.from_numpy(np.asarray(inv, np.float32)).to(device)


def apply_rope(x, positions, inv_freq, rotary_dim=None):
    """x: (..., S, H, hd); positions: (..., S) int. Rotates the first
    rotary_dim dims in interleaved pairs (0::2, 1::2); partial rotary is
    chatglm3's 2D RoPE on half the dims."""
    hd = x.shape[-1]
    rd = rotary_dim or hd
    ang = positions[..., :, None].float() * inv_freq          # (...,S,rd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xr = x[..., :rd].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    rot = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    if rd == hd:
        return rot
    return torch.cat([rot, x[..., rd:]], dim=-1)


# ---------------------------------------------------------------------------
# blockwise causal attention (online softmax)
# ---------------------------------------------------------------------------

def _repeat_kv(k, n_rep):
    if n_rep == 1:
        return k
    b, s, kh, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, n_rep, hd) \
        .reshape(b, s, kh * n_rep, hd)


def _block_mask(qi_ids, kj_ids, causal, window, sq, skv, q_offset=0):
    """Which (query, key) pairs are seen: ``qi_ids`` count the queries
    from 0 here (those past ``sq`` are padding) and ``q_offset`` more in
    the sequence, which numbers the keys from 0."""
    mask = (kj_ids < skv) & (qi_ids < sq)
    if q_offset:
        qi_ids = qi_ids + q_offset
    if causal:
        mask &= kj_ids <= qi_ids
    if window is not None:
        mask &= kj_ids > qi_ids - window
    return mask


def _blocks(x, n, blk):
    """(B, S, H, hd) -> (n, B, H, blk, hd), zero-padded to n * blk."""
    b, s, h, hd = x.shape
    x = F.pad(x, (0, 0, 0, 0, 0, n * blk - s))
    return x.reshape(b, n, blk, h, hd).permute(1, 0, 3, 2, 4)


def blockwise_attention(q, k, v, *, causal=True, window: Optional[int] = None,
                        q_block=512, kv_block=512, q_offset: int = 0):
    """q: (B, Sq, H, hd), k, v: (B, Skv, KH, hd) with H % KH == 0; the
    queries are positions ``q_offset`` to ``q_offset + Sq`` of the
    keys' sequence (0 and Sq = Skv for self-attention over one span; a
    rank's positions against every key under the sequence split).
    Online softmax over KV blocks, in f32: the reference's
    ``_flash_fwd_impl`` (-inf masking with its ``m_safe`` / ``alpha``
    guards). A KV block is visited only by the query blocks that see at
    least one of its keys (:func:`_visible_q_blocks`, from the shapes,
    ``causal``, ``window`` and ``q_offset`` alone): a block none of a
    query block's rows sees would leave its ``m``, ``l`` and ``o`` as
    they are, so the forward equals the visit of every block bit for
    bit, and the backward within f32 reassociation (each ``dk`` / ``dv``
    block sums over fewer query blocks). Returns q's dtype.

    Differentiable through :class:`_Flash`, the reference's flash
    ``custom_vjp``: the forward saves only (q, k, v, out, lse) and the
    backward re-derives each P panel from lse. The KV heads are repeated
    outside it, so autograd sums dk / dv over each GQA group. A query
    block is at most the queries there are (the reference pads them to
    ``q_block``): a rank's share of the positions under the sequence
    split may be shorter than a block, and padded queries are work."""
    q_block = min(q_block, q.shape[1])
    h = q.shape[2]
    k = _repeat_kv(k, h // k.shape[2])
    v = _repeat_kv(v, h // v.shape[2])
    return _Flash.apply(q, k, v, causal, window, q_block, kv_block, q_offset)


def _visible_q_blocks(causal, window, q_offset, q_block, kv_block, sq,
                      skv) -> list:
    """Per KV block, the range ``(qa, qz)`` of the query blocks that see
    at least one of its keys (``qa == qz``: none does), by
    :func:`_block_mask`'s inequalities on the blocks' extreme
    positions: a query block of global positions g0..g1 sees a key block
    k0..k1 where ``g1 >= k0`` (causal) and ``g0 - k1 < window``; both
    hold on a contiguous run of query blocks. Python ints only, so that
    a meta trace and ``FlopCounterMode`` count what runs."""
    nq, nk = -(-sq // q_block), -(-skv // kv_block)
    out = []
    for kj in range(nk):
        k0, k1 = kj * kv_block, min((kj + 1) * kv_block, skv) - 1
        seen = [i for i in range(nq)
                if (not causal
                    or q_offset + min((i + 1) * q_block, sq) - 1 >= k0)
                and (window is None or q_offset + i * q_block - k1 < window)]
        out.append((seen[0], seen[-1] + 1) if seen else (0, 0))
    return out


def _flash_fwd_impl(q, k, v, causal, window, q_block, kv_block, q_offset=0):
    """Every q block runs the same recurrence over the KV blocks, so the
    q blocks go through it side by side: one (nq, B, H, q_block,
    kv_block) panel stack is live at a time, cut to the q blocks that
    see the KV block (:func:`_visible_q_blocks`). Returns (out in q's
    dtype, lse of shape (nq, B, H, q_block))."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    scale = 1.0 / np.sqrt(hd)
    nq = -(-sq // q_block)
    nk = -(-skv // kv_block)
    dev = q.device
    qb = _blocks(q, nq, q_block).float()            # (nq, B, H, qb, hd)
    kb = _blocks(k, nk, kv_block)                   # (nk, B, H, kb, hd)
    vb = _blocks(v, nk, kv_block)
    q_ids = torch.arange(nq * q_block, device=dev).reshape(nq, q_block)
    k_ids = torch.arange(nk * kv_block, device=dev).reshape(nk, kv_block)
    m = torch.full((nq, b, h, q_block), float("-inf"), device=dev)
    l = torch.zeros((nq, b, h, q_block), device=dev)
    o = torch.zeros((nq, b, h, q_block, hd), device=dev)
    for kj, (qa, qz) in enumerate(_visible_q_blocks(
            causal, window, q_offset, q_block, kv_block, sq, skv)):
        if qa == qz:
            continue
        s = torch.einsum("nbhqd,bhkd->nbhqk", qb[qa:qz],
                         kb[kj].float()) * scale
        mask = _block_mask(q_ids[qa:qz, :, None], k_ids[kj][None, None, :],
                           causal, window, sq, skv, q_offset)[:, None, None]
        s = torch.where(mask, s, float("-inf"))
        m_old = m[qa:qz]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        alpha = torch.where(torch.isfinite(m_old), torch.exp(m_old - m_safe),
                            0.0)
        l[qa:qz] = l[qa:qz] * alpha + p.sum(dim=-1)
        o[qa:qz] = o[qa:qz] * alpha[..., None] + torch.einsum(
            "nbhqk,bhkd->nbhqd", p, vb[kj].float())
        m[qa:qz] = m_new
    o = o / torch.clamp(l[..., None], min=1e-20)
    lse = torch.where(l > 0, torch.where(torch.isfinite(m), m, 0.0)
                      + torch.log(torch.clamp(l, min=1e-20)), float("-inf"))
    out = o.permute(1, 0, 3, 2, 4).reshape(b, nq * q_block, h, hd)
    return out[:, :sq].to(q.dtype), lse


def _unblock(x, length):
    """(n, B, H, blk, hd) -> (B, length, H, hd)."""
    n, b, h, blk, hd = x.shape
    return x.permute(1, 0, 3, 2, 4).reshape(b, n * blk, h, hd)[:, :length]


def _flash_bwd_impl(q, k, v, out, lse, dout, causal, window, q_block,
                    kv_block, q_offset=0):
    """The reference's ``_flash_bwd``: D_i = rowsum(dout * out), each P
    panel recomputed from lse; ``p`` is rounded to q's dtype for dv and
    ``ds`` for dq / dk, every product exact with an f32 sum. The q
    blocks go side by side, as in the forward: one (nq, B, H, q_block,
    kv_block) panel stack is live per KV block, never the S x S one, cut
    to the q blocks that see it; a KV block none sees has zero dk and
    dv."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    scale = 1.0 / np.sqrt(hd)
    nq = -(-sq // q_block)
    nk = -(-skv // kv_block)
    dev = q.device
    f32 = torch.float32
    qb, dob = _blocks(q, nq, q_block), _blocks(dout, nq, q_block)
    ob = _blocks(out, nq, q_block)
    kb, vb = _blocks(k, nk, kv_block), _blocks(v, nk, kv_block)
    q_ids = torch.arange(nq * q_block, device=dev).reshape(nq, q_block)
    k_ids = torch.arange(nk * kv_block, device=dev).reshape(nk, kv_block)
    Db = (dob.to(f32) * ob.to(f32)).sum(dim=-1)    # (nq, B, H, qb)
    qf, dof = qb.to(f32), dob.to(f32)
    dq = torch.zeros((nq, b, h, q_block, hd), dtype=f32, device=dev)
    dk = torch.zeros((nk, b, h, kv_block, hd), dtype=f32, device=dev)
    dv = torch.zeros((nk, b, h, kv_block, hd), dtype=f32, device=dev)
    for kj, (qa, qz) in enumerate(_visible_q_blocks(
            causal, window, q_offset, q_block, kv_block, sq, skv)):
        if qa == qz:
            continue
        kf, vf = kb[kj].to(f32), vb[kj].to(f32)
        s = torch.einsum("nbhqd,bhkd->nbhqk", qf[qa:qz], kf) * scale
        mask = _block_mask(q_ids[qa:qz, :, None], k_ids[kj][None, None, :],
                           causal, window, sq, skv, q_offset)[:, None, None]
        p = torch.where(mask, torch.exp(s - lse[qa:qz, ..., None]), 0.0)
        pb = p.to(q.dtype).to(f32)
        dv[kj] = torch.einsum("nbhqk,nbhqd->bhkd", pb, dof[qa:qz])
        dp = torch.einsum("nbhqd,bhkd->nbhqk", dof[qa:qz], vf)
        ds = p * (dp - Db[qa:qz, ..., None]) * scale
        dsb = ds.to(q.dtype).to(f32)
        dq[qa:qz] = dq[qa:qz] + torch.einsum("nbhqk,bhkd->nbhqd", dsb, kf)
        dk[kj] = torch.einsum("nbhqk,nbhqd->bhkd", dsb, qf[qa:qz])
    return (_unblock(dq, sq).to(q.dtype), _unblock(dk, skv).to(k.dtype),
            _unblock(dv, skv).to(v.dtype))


class _Flash(torch.autograd.Function):
    """Blockwise attention with the reference's flash VJP
    (``_flash_fwd`` / ``_flash_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, *args):
        """``args``: (causal, window, q_block, kv_block[, q_offset])."""
        out, lse = _flash_fwd_impl(q, k, v, *args)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = args
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, out, lse, dout, *ctx.args)
        return (dq, dk, dv) + (None,) * len(ctx.args)


def decode_attention(q, k_cache, v_cache, length, *, window=None,
                     split=None):
    """Single-token attention against a cache.
    q: (B, 1, H, hd); caches: (B, S_max, KH, hd); length: current length
    (int, 0-d tensor or (B,) tensor) — positions >= length are masked
    (-1e30, as the reference). GQA is grouped against the KH-headed
    cache. Products are exact with an f32 accumulator: the operands are
    upcast, and the softmax weights are first rounded to the cache's
    dtype, as the reference's ``p.astype(v_cache.dtype)``.

    ``split`` names how the context's "model" ranks split the cache
    (:func:`model_split`'s ``columns``), with ``q`` whole on each:
      * "positions": each rank holds its contiguous S_max / n positions
        (global positions mask them); the row max and the sum of
        ``exp(s - max)`` are reduced over "model", ``p`` rounded as
        above, and the partial ``p @ v`` summed over "model";
      * "head_dim": each rank holds its slice of the head dim; the
        scores' partial products are summed over "model" before the
        scale, ``p`` is whole on every rank, and each rank's slice of
        the output is all-gathered."""
    b, one, h, hd = q.shape
    s_loc, kh, hd_loc = k_cache.shape[1:]
    rep = h // kh
    mesh = _context_mesh() if split else None
    r = mesh.get_local_rank("model") if split else 0
    qg = q.reshape(b, one, kh, rep, hd)
    if split == "head_dim":
        qg = qg[..., r * hd_loc:(r + 1) * hd_loc]
    s = torch.einsum("bqkrd,bskd->bkrqs", qg.float(), k_cache.float())
    if split == "head_dim":
        s = _all_reduce(s, mesh, ("model",))
    s = s * (1.0 / np.sqrt(hd))
    lo = r * s_loc if split == "positions" else 0
    pos = torch.arange(lo, lo + s_loc, device=q.device)
    ln = length             # a Python int stays one: no copy to the device
    if isinstance(ln, torch.Tensor):
        ln = ln.to(q.device)
        ln = ln[:, None, None, None, None] if ln.ndim else ln
    mask = pos[None, None, None, None, :] < ln
    if window is not None:
        mask &= pos[None, None, None, None, :] >= (ln - window)
    s = torch.where(mask, s, -1e30)
    if split == "positions":
        top = _all_reduce(s.amax(dim=-1, keepdim=True), mesh, ("model",),
                          "max")
        e = torch.exp(s - top)
        p = e / _all_reduce(e.sum(dim=-1, keepdim=True), mesh, ("model",))
    else:
        p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkrqs,bskd->bqkrd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    if split == "positions":
        o = _all_reduce(o, mesh, ("model",))
    return gather_columns(o.reshape(b, one, h, hd_loc).to(q.dtype), hd)


# ---------------------------------------------------------------------------
# products, MLP and loss
# ---------------------------------------------------------------------------

def matmul(a, b):
    """``a @ b`` (batched where the operands are) as the reference's XLA
    dot computes it in bf16: exact products, an f32 accumulator, one
    rounding to the operands' dtype. cuBLAS does that on the card (TF32
    and reduced-precision reductions off); torch's CPU kernels round
    bf16 partial sums, so there the operands are upcast."""
    if a.device.type == "cpu" and a.dtype in (torch.bfloat16, torch.float16):
        return torch.matmul(a.float(), b.float()).to(a.dtype)
    return torch.matmul(a, b)


# ---------------------------------------------------------------------------
# the columns split of a decode step (``specs.ModelSplit.columns``): every
# weight where the rules placed it, only activations cross "model"
# ---------------------------------------------------------------------------

def gather_columns(y, width: int):
    """``y`` whole on its last dim, ``width`` long, under the context's
    columns split: ``y`` itself, or, where it is this "model" rank's
    contiguous 1/n of it, every rank's concatenated in rank order (an
    all-gather over "model"). ``y`` itself under any other split."""
    if y.shape[-1] == width or not model_split().columns:
        return y
    import torch.distributed._functional_collectives as funcol
    return _wait(funcol.all_gather_tensor(
        y.contiguous(), y.ndim - 1, _model_group(_context_mesh())))


def split_matmul(x, w, width: int):
    """``x @ w`` (``width`` columns) whole on every "model" rank under
    the context's ``columns`` split, with ``x`` whole and ``w`` as the
    rules placed it (``specs.compute_spec``):
      * this rank's columns: its products, all-gathered. Each column is
        computed on its own (:func:`matmul`), so the result is the
        unsharded product's bit for bit wherever the GEMM's reduction
        order does not depend on how many columns it is given;
      * its rows (the input dim on "model"): its slice of ``x`` times
        them in f32, summed over "model" and rounded once;
      * whole: the product.
    ``w`` may be a batch of weights (its last two dims the product's).
    Under any other split, :func:`matmul`."""
    if not model_split().columns:
        return matmul(x, w)
    if w.shape[-2] != x.shape[-1]:
        mesh = _context_mesh()
        k = w.shape[-2]
        lo = mesh.get_local_rank("model") * k
        part = torch.matmul(x[..., lo:lo + k].float(), w.float())
        return _all_reduce(part, mesh, ("model",)).to(x.dtype)
    return gather_columns(matmul(x, w), width)


def decode_positions(cache_len: int, n: int, rank: int) -> tuple:
    """(first global position, count) of the positions that "model" rank
    ``rank`` of n holds of a split decode's self-attention cache of
    ``cache_len`` positions: its contiguous ``cache_len`` / n
    (``specs.decode_cache_spec`` puts the positions on "model", which
    raises where they do not divide)."""
    per = cache_len // n
    return rank * per, per


def cache_positions(cache_len: int) -> tuple:
    """(its first global position, all positions) of a self-attention
    cache of ``cache_len`` positions: under the columns split, this
    "model" rank's share of n x ``cache_len`` positions
    (:func:`decode_positions`); else (0, ``cache_len``)."""
    sp = model_split()
    if not sp.columns:
        return 0, cache_len
    total = sp.n * cache_len
    return decode_positions(total, sp.n, _context_mesh().get_local_rank(
        "model"))[0], total


def keep_decode_positions(t):
    """``t`` (B, S, ...), a layer's keys or values at every position of
    the prefill in global order, as this "model" rank's slice of the
    decode cache that the context's prefill hands off to
    (:func:`use_mesh`'s ``cache_len``): its positions
    (:func:`decode_positions`) below S, zero-padded to its share, in a
    tensor of its own, so that the layer's whole ``t`` is freed with the
    layer and no rank holds more than one layer's. ``t`` itself where
    the context hands off nothing."""
    cache_len = getattr(_MESH, "cache_len", None)
    if cache_len is None:
        return t
    n = model_split().n
    lo, per = decode_positions(cache_len, n, _context_mesh().get_local_rank(
        "model") if n > 1 else 0)
    out = t.new_zeros((t.shape[0], per) + tuple(t.shape[2:]))
    m = max(0, min(per, t.shape[1] - lo))
    if m:
        out[:, :m] = t[:, lo:lo + m]
    return out


def silu(x):
    """``jax.nn.silu``'s formula, op by op in x's dtype: in bf16 each op
    rounds, and ``F.silu`` (one rounding) differs in 4 of 10 values."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x):
    """``jax.nn.gelu`` (tanh approximation, its default), op by op, its
    two constants rounded to x's dtype as JAX rounds them."""
    c1 = x.new_tensor(float(np.sqrt(2 / np.pi)))
    c2 = x.new_tensor(0.044715)
    cdf = 0.5 * (1.0 + torch.tanh(c1 * (x + c2 * (x * x * x))))
    return x * cdf


def gated_mlp(x, w_gate, w_up, w_down, d_ff=None):
    """The gated-SiLU MLP. Under the columns split (:func:`split_matmul`)
    the gate and up weights are split alike, so ``h`` is formed on this
    rank's columns and gathered once, to ``d_ff``."""
    h = silu(split_matmul(x, w_gate, w_gate.shape[-1])) \
        * split_matmul(x, w_up, w_up.shape[-1])
    return split_matmul(gather_columns(h, d_ff or h.shape[-1]), w_down,
                        x.shape[-1])


def gelu_mlp(x, w_up, b_up, w_down, b_down, d_ff=None):
    """The GELU MLP; ``d_ff`` as :func:`gated_mlp`'s."""
    h = gelu(split_matmul(x, w_up, d_ff or w_up.shape[-1]) + b_up)
    return split_matmul(h, w_down, x.shape[-1]) + b_down


def cross_entropy(logits, labels, vocab_real: Optional[int] = None,
                  vocab_padded: Optional[int] = None):
    """Mean CE in f32; labels < 0 masked; vocab padding masked.

    On a mesh (``use_mesh``): logits narrower than ``vocab_padded`` are
    this "model" rank's slice of the vocabulary (:func:`logits`), and the
    log-sum-exp and the label's logit are reduced over "model"
    (Megatron's vocab-parallel CE); where the batch is split, the loss is
    the global batch's mean: the NLL sum and the count of labelled
    tokens are summed over the data dims and divided once, so shards of
    unequal label counts weigh as the reference's global mean does."""
    lf = logits.float()
    V = lf.shape[-1]
    mesh = _context_mesh()
    split = vocab_padded is not None and V != vocab_padded
    lo = mesh.get_local_rank("model") * V if split else 0
    if vocab_real is not None and vocab_real < (vocab_padded if split
                                                else V):
        vid = torch.arange(lo, lo + V, device=lf.device)
        lf = torch.where(vid < vocab_real, lf, -1e30)
    idx = labels.clamp(min=0).long() - lo
    if split:
        top = _all_reduce(lf.detach().amax(-1), mesh, ("model",), "max")
        se = (lf - top[..., None]).exp().sum(-1)
        lse = top + _ReduceOver.apply(se, mesh, ("model",), 1, 1).log()
        mine = (idx >= 0) & (idx < V)
        ll = lf.gather(-1, idx.clamp(0, V - 1)[..., None])[..., 0] * mine
        ll = _ReduceOver.apply(ll, mesh, ("model",), 1, 1)
    else:
        lse = torch.logsumexp(lf, dim=-1)
        ll = lf.gather(-1, idx[..., None])[..., 0]
    mask = labels >= 0
    nll, count = ((lse - ll) * mask).sum(), mask.sum()
    dims = _data_dims()
    if dims:
        mesh = _context_mesh()
        nll = _ReduceOver.apply(nll, mesh, dims, 1, 1)
        count = _all_reduce(count, mesh, dims)
    return nll / torch.clamp(count, min=1)

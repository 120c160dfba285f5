"""A model's weights as this rank's shards, gathered for compute one layer
at a time (ZeRO-3): how the port runs a step on what ``sharding.specs``
places, where the reference lets GSPMD partition every op.

:func:`model_view` turns a params tree of local shards and their DTensor
placements into the tree a model reads:

  * a leaf outside the layer stacks (embed, lm_head, the final norms) is
    gathered once, for the whole step;
  * a layer stack ("layers", "enc_layers") becomes a
    :class:`ShardedStack`, and ``transformer.layers`` yields one
    :class:`ShardedLayer` per layer, still shards. ``common.remat``
    gathers a layer inside a checkpoint, so that its whole weights live
    only while the layer runs (forward, then the recompute in the
    backward) and are never saved for the backward; with autograd off a
    layer is gathered as it is yielded and dropped with it.

A rank so holds its shards, the gathered leaves outside the stacks and
the weights of one layer at a time (in the backward also their
gradient), not the model.

A weight is gathered to its *compute layout* (``specs.compute_spec``)
under the step's ``specs.ModelSplit``, so that a rank computes 1/n of
its model group's work rather than all of it:

  * where the batch (or the positions) is split over "model" too,
    weights are gathered whole (but the MoE's expert weights, to this
    rank's own experts, or FFN slice, on "model"), and each rank runs
    its rows (its positions of every row);
  * otherwise the attention's and the MLP's weights go to Megatron's
    column / row slices on "model" where their heads and FFN dim divide
    (the layers enter and sum the model region, ``common.enter_model``
    / ``model_sum``), the experts to this rank's share, and ``lm_head``
    to its vocabulary slice, as the reference's logits are
    (``common.logits`` / ``cross_entropy``); a part that does not divide
    is gathered whole and computed by every rank.

Gradients (:class:`_Gather`'s backward) go back to the shard layout:
summed over ``data_dims``, the mesh dims the batch is split on (each
rank computed its own tokens' share of the global loss), on those dims
where the compute layout is whole (a reduce-scatter where the weight is
sharded on such a dim, an all-reduce where it is not); on the other
dims every rank computed its own part's whole gradient, which is cut to
the shard (an all-to-all for the experts). A weight that entered a
Megatron region whole was summed over "model" there, by
``common.enter_model``, which is not a data dim under that split.
"""
from __future__ import annotations

import math
from collections.abc import Mapping

import torch

STACKS = ("layers", "enc_layers")


def _redistribute(t, mesh, src, dst):
    """This rank's local tensor of ``t`` (a local tensor of placements
    ``src``) redistributed to ``dst``."""
    from torch.distributed._functional_collectives import (
        AsyncCollectiveTensor)
    from torch.distributed.tensor import DTensor
    if tuple(src) == tuple(dst):
        return t.view_as(t)
    out = DTensor.from_local(t.detach().contiguous(), mesh, src,
                             run_check=False).redistribute(
                                 mesh, dst).to_local()
    return out.wait() if isinstance(out, AsyncCollectiveTensor) else out


def _full_shape(t, placements, mesh) -> tuple:
    """The whole shape of the local tensor ``t`` of ``placements`` (the
    rules split only the dims that divide)."""
    full = list(t.shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            full[p.dim] *= mesh.size(i)
    return tuple(full)


class _Gather(torch.autograd.Function):
    """A shard ``local`` of placements ``src`` as its compute layout's
    local tensor (placements ``dst``). Backward: the gradient, partial
    over the mesh dims ``data_dims`` (indices), back to ``src``."""

    @staticmethod
    def forward(ctx, local, mesh, src, dst, data_dims):
        ctx.plan = (mesh, src, dst, data_dims)
        return _redistribute(local, mesh, src, dst)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Partial
        mesh, src, dst, data_dims = ctx.plan
        partial = tuple(Partial() if i in data_dims and pl.is_replicate()
                        else pl for i, pl in enumerate(dst))
        return _redistribute(g, mesh, partial, src), None, None, None, None


class ShardedLayer(Mapping):
    """One layer's weights as this rank's shards (views into the
    stacks) and the plan that gathers each to its compute layout.
    ``lp[name]`` gathers one weight (autograd then keeps it where the
    layer saves it); :meth:`gather` all of them, as ``common.remat``
    does inside its checkpoint."""

    def __init__(self, local: dict, plans: dict, mesh, data_dims):
        self.local, self.plans = local, plans
        self.mesh, self.data_dims = mesh, data_dims

    def __getitem__(self, name):
        src, dst = self.plans[name]
        return _Gather.apply(self.local[name], self.mesh, src, dst,
                             self.data_dims)

    def __iter__(self):
        return iter(self.local)

    def __len__(self):
        return len(self.local)

    def gather(self) -> dict:
        return {k: self[k] for k in self.local}


class ShardedStack:
    """A layer stack ({name: (L, ...) shard}) with each leaf's
    placements; :meth:`layers` yields it layer by layer."""

    def __init__(self, local: dict, placements: dict, mesh, data_dims,
                 split):
        self.local, self.placements = local, placements
        self.mesh, self.data_dims, self.split = mesh, data_dims, split

    def layers(self):
        """One :class:`ShardedLayer` per layer while autograd records
        (``common.remat`` gathers it), else the layer gathered as it is
        yielded. A 1-D stack split over its layers (the rules never
        split dim 0 of a wider stack) is gathered whole first."""
        from torch.distributed.tensor import Replicate, Shard
        from ..sharding.specs import Layout, compute_spec
        mesh, dd = self.mesh, self.data_dims
        rep = (Replicate(),) * mesh.ndim
        cols, plans = {}, {}
        for k, t in self.local.items():
            pl = tuple(self.placements.get(k) or rep)
            if any(p.is_shard(0) for p in pl):
                t, pl = _Gather.apply(t, mesh, pl, rep, dd), rep
            src = tuple(Shard(p.dim - 1) if p.is_shard() else p for p in pl)
            dst = Layout(mesh, compute_spec(
                k, _full_shape(t, pl, mesh)[1:], mesh, self.split)).placements
            cols[k], plans[k] = t.unbind(0), (src, dst)
        for vals in zip(*cols.values()):
            layer = ShardedLayer(dict(zip(cols, vals)), plans, mesh, dd)
            yield layer if torch.is_grad_enabled() else layer.gather()


def model_view(local, placements, mesh, data_dims=(), split=None):
    """The params tree a model reads, from this rank's shards ``local``
    and their ``placements`` (a matching tree; None for a leaf every
    rank holds whole). ``data_dims`` names the mesh dims the batch is
    split on, ``split`` (a ``specs.ModelSplit``; none by default) what
    this rank computes of its model group's work. Leaves outside the
    stacks are gathered to their compute layout now."""
    from torch.distributed.tensor import Replicate
    from ..sharding.specs import Layout, compute_spec
    dims = tuple(mesh.mesh_dim_names.index(n) for n in data_dims)
    rep = (Replicate(),) * mesh.ndim

    def walk(node, pl, key):
        if isinstance(node, dict):
            if key in STACKS:
                return ShardedStack(node, pl or {}, mesh, dims, split)
            return {k: walk(v, (pl or {}).get(k), k)
                    for k, v in node.items()}
        pl = tuple(pl or rep)
        dst = Layout(mesh, compute_spec(key, _full_shape(node, pl, mesh),
                                        mesh, split)).placements
        return _Gather.apply(node, mesh, pl, dst, dims)

    return walk(local, placements, None)


def local_shards(tree):
    """(this rank's local tensors, their placements) of a tree of
    DTensors; a plain tensor stays, with placements None."""
    from torch.distributed.tensor import DTensor
    from ..tree import tree_map
    return (tree_map(lambda t: t.to_local() if isinstance(t, DTensor)
                     else t, tree),
            tree_map(lambda t: tuple(t.placements)
                     if isinstance(t, DTensor) else None, tree))


def split_rows(local_batch, mesh, data_dims, split):
    """(this rank's batch, the mesh dims the batch is split on) under
    ``split`` (a ``specs.ModelSplit``): where it splits the batch over
    "model", the rank's contiguous 1/n of its data shard's rows
    ``local_batch`` and "model" added to ``data_dims``; else both as they
    are."""
    from ..tree import leaves, tree_map
    if not split.batch:
        return local_batch, data_dims
    per = leaves(local_batch)[0].shape[0] // split.n
    lo = mesh.get_local_rank("model") * per
    return (tree_map(lambda b: b[lo:lo + per], local_batch),
            data_dims + ("model",))


POSITIONAL = ("tokens", "labels", "embeds")     # (B, S, ...) inputs


def positions(batch) -> int:
    """The positions a row of ``batch`` (a dict of inputs) holds."""
    return next(batch[k] for k in POSITIONAL if k in batch).shape[1]


def position_spans(length: int, n: int, rank: int,
                   zigzag: bool = False) -> list:
    """``rank``'s share of ``length`` positions split ``n`` ways, as the
    spans ``[(first position, count)]`` it holds, in order:

      * ``zigzag``: chunks ``rank`` and 2n-1-``rank`` of 2n equal chunks
        (``length`` must divide by 2n), one from each end, so that
        under a causal mask every rank's queries see as many keys;
      * else its contiguous ceil(``length`` / n) positions: the total
        is ``length`` padded at the end to divide by n."""
    if zigzag:
        if length % (2 * n):
            raise ValueError(f"{length} positions do not divide into "
                             f"{2 * n} chunks")
        c = length // (2 * n)
        return [(rank * c, c), ((2 * n - 1 - rank) * c, c)]
    per = -(-length // n)
    return [(rank * per, per)]


def take_spans(t, spans, dim: int = 1):
    """``t``'s entries on ``dim`` at ``spans`` (:func:`position_spans`),
    concatenated in order (one span: a view)."""
    parts = [t.narrow(dim, lo, count) for lo, count in spans]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def split_positions(local_batch, mesh, data_dims, split):
    """(this rank's batch, the mesh dims the batch is split on) under
    ``split`` (a ``specs.ModelSplit``): where it splits the positions
    over "model", the rank's share (:func:`position_spans`, zigzag or
    contiguous as ``split`` says) of each of its data shard's rows'
    positions (``POSITIONAL`` inputs, which must divide by n; whisper's
    encoder frames stay whole, ``whisper.encode`` takes its own
    contiguous share of them, padded) and "model" added to
    ``data_dims``; else both as they are."""
    if not split.sequence:
        return local_batch, data_dims
    s = positions(local_batch)
    if s % split.n:
        raise ValueError(f"{s} positions do not divide over {split.n} "
                         f"model ranks")
    spans = position_spans(s, split.n, mesh.get_local_rank("model"),
                           split.zigzag)
    return ({k: take_spans(b, spans) if k in POSITIONAL else b
             for k, b in local_batch.items()}, data_dims + ("model",))


def local_step(params, batch, cfg, micro_batches: int = 1):
    """What a rank computes a step on, from DTensor ``params`` and
    ``batch`` (DTensors placed by ``specs.batch_placements``, or plain
    tensors every rank shares): (mesh, its weight shards, their
    placements, its batch, the mesh dims that batch is split on, the
    ``specs.ModelSplit``: ``specs.model_split`` of ``cfg`` at its data
    shard's rows and positions). The batch is its data shard's, cut to
    its rows or positions where the split takes them."""
    from torch.distributed.tensor import DTensor
    from ..sharding.specs import model_split
    from ..tree import leaves
    mesh = next(t for t in leaves(params)
                if isinstance(t, DTensor)).device_mesh
    data_dims = batch_dims(batch, mesh)
    local, placements = local_shards(params)
    local_batch = local_shards(batch)[0]
    split = model_split(cfg, leaves(local_batch)[0].shape[0], mesh,
                        micro_batches, positions(local_batch))
    local_batch, data_dims = split_rows(local_batch, mesh, data_dims, split)
    local_batch, data_dims = split_positions(local_batch, mesh, data_dims,
                                             split)
    return mesh, local, placements, local_batch, data_dims, split


def sharded_prefill(prefill, params, batch, cfg, cache_len=None):
    """(cache, last logits, split) of ``prefill(params, batch)`` (a
    ``Model.prefill``) on DTensor ``params`` and ``batch``: each rank's
    share (:func:`local_step`) through ``prefill`` on its weight shards,
    gathered layer by layer (:func:`model_view`), with autograd off. The
    logits are the rank's data shard's: its rows under the batch split,
    the last position's on every "model" rank under the sequence split,
    the vocabulary slice under Megatron's split.

    Without ``cache_len`` the cache is the rank's data shard's in the
    prefill's own layout: its rows under the batch split, every
    position on every "model" rank under the sequence split, the KV
    heads its query heads read under Megatron's split.

    With ``cache_len`` it is this rank's local slice of the decode
    cache that a split decode step (``specs.model_split_decode``)
    reads: the prefill's cache with its self-attention ``k`` / ``v``
    grown to ``cache_len`` positions (zeros past the prompt; the
    hybrid's window, the recurrent states and whisper's cross cache
    keep their shapes), each leaf cut as ``specs.decode_cache_spec``
    places it (:func:`to_decode_layout`). Raises where ``cache_len`` is
    shorter than the prompt, or where the grown positions do not divide
    over "model" (``decode_cache_spec``'s error)."""
    from ..sharding.specs import decode_cache_spec
    from ..tree import leaves
    from . import common
    mesh, local, placements, local_batch, dims, split = local_step(
        params, batch, cfg)
    if cache_len is not None:
        s, rows = positions(batch), leaves(batch)[0].shape[0]
        if cache_len < s:
            raise ValueError(f"a decode cache of {cache_len} positions is "
                             f"shorter than the prompt's {s}")
        if cfg.family not in GROWS_NOTHING:
            decode_cache_spec("k", (cfg.num_layers, rows, cache_len,
                                    cfg.num_kv_heads, cfg.hd), mesh,
                              cfg.family)
    # under the batch split a rank holds its rows of the data shard, under
    # Megatron's its KV heads: the cache moves after the prefill
    # (:func:`to_decode_layout`). Under any other split every "model"
    # rank holds every position, row and head of its data shard, so each
    # layer's keys and values are cut to the rank's decode positions as
    # the layer ends (``common.keep_decode_positions``)
    keep = None if split.batch or split.heads else cache_len
    with torch.no_grad(), common.use_mesh(mesh, dims, split, keep):
        cache, logits = prefill(model_view(local, placements, mesh, dims,
                                           split), local_batch)
        if cache_len is not None:
            cache = to_decode_layout(cache, mesh, split, cfg, rows,
                                     cache_len)
    return cache, logits, split


GROWS_NOTHING = ("ssm", "hybrid")   # families whose cache has no growing k / v


def to_decode_layout(cache, mesh, split, cfg, rows: int, cache_len: int):
    """The decode layout of ``cache``, this rank's prefill cache under
    ``split`` of a batch of ``rows`` rows: each leaf as
    ``specs.decode_cache_spec`` places it on the whole decode cache
    (the self-attention ``k`` / ``v`` of the families but the recurrent
    and hybrid grown to ``cache_len`` positions). The leaves are
    popped from ``cache`` one at a time, so that each prefill-layout
    leaf is freed as soon as it has been cut or sent.

      * Where the prefill kept every position, row and head (any split
        but the batch split and Megatron's), the grown ``k`` / ``v``
        are cut already, and every other leaf is cut on its "model"
        dim here, with no communication.
      * Under the batch split the rank's rows go to every rank, each
        its share of the leaf's "model" dim (:func:`_exchange`); under
        Megatron's heads the rank's KV heads, each rank its positions.
        One ``all_to_all_single`` a leaf on the "model" group, on the
        device the cache lies on: ``torch.distributed``, unlike the
        reference, which leaves the resharding to GSPMD (its decode is
        jitted with the cache's shardings as ``in_shardings``).

    Every rank's data rows stay its data shard's: the rules split the
    batch and the cache's batch dim over the same data dims."""
    from ..sharding.specs import decode_cache_spec, mesh_sizes
    sizes = mesh_sizes(mesh)
    n = sizes.get("model", 1)
    r = mesh.get_local_rank("model") if n > 1 else 0
    out = {}
    for name in list(cache):
        grows = name in ("k", "v") and cfg.family not in GROWS_NOTHING
        full = [*cache[name].shape[:1], rows, *cache[name].shape[2:]]
        if grows:
            full[2] = cache_len
        src = m = None
        if split.batch:
            src, m = 1, n
        elif split.heads and name in ("k", "v"):
            src, m = 3, (n if split.kv == "split" else cfg.num_kv_heads)
            full[3] = cfg.num_kv_heads
        spec = decode_cache_spec(name, tuple(full), mesh, cfg.family)
        dst = spec.index("model") if n > 1 and "model" in spec else None
        if src is not None:         # popped into the call: freed once sent
            t = _exchange(cache.pop(name), src, dst, m, mesh,
                          cache_len if grows else None)
        else:
            t = cache.pop(name)
            if dst is not None and not grows:
                per = t.shape[dst] // n
                t = t.narrow(dst, r * per, per).clone(
                    memory_format=torch.contiguous_format)
        want = tuple(d // _spread(ax, sizes) for d, ax in zip(full, spec))
        if tuple(t.shape) != want:
            raise RuntimeError(f"decode cache {name}: this rank's slice "
                               f"{tuple(t.shape)}, {want} placed by "
                               f"{spec}")
        out[name] = t
    return out


def _spread(ax, sizes) -> int:
    """How many ranks a spec entry (None, a mesh dim's name or a tuple
    of names) splits its dim over."""
    names = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
    return math.prod(sizes.get(a, 1) for a in names)


def _exchange(t, src: int, dst: int, m: int, mesh, grow=None):
    """The leaf whose ``t`` this rank holds of ``m`` equal chunks of dim
    ``src`` (rank r the chunk r // (n / m): its rows, its KV heads or,
    under Megatron's "pick", the one KV head its group of ranks reads)
    as its share of dim ``dst`` with every chunk of ``src``, in one
    ``all_to_all_single`` on the "model" group: rank j receives from
    the first rank of each chunk's group (so a head that several ranks
    hold comes from one of them) that rank's chunk of ``src`` at j's
    slice of ``dst``, ``grow`` long in all (zeros past ``t``'s end; the
    leaf's own length by default) and split n ways. Every decode-state
    leaf has such a ``dst`` (``specs.cache_spec`` puts "model" on its
    last dim past the batch that divides, and every config's state has
    one). ``t`` is dropped as soon as its send buffer is made."""
    import torch.distributed._functional_collectives as funcol
    from .common import _model_group, _wait
    n = mesh.size(mesh.mesh_dim_names.index("model"))
    r = mesh.get_local_rank("model")
    g = n // m
    first = [int(i % g == 0) for i in range(n)]
    size = grow or t.shape[dst]
    per = size // n
    shape = list(t.shape)
    shape[dst] = per
    if first[r]:
        buf = t.new_zeros([n] + shape)
        for j in range(n):
            k = max(0, min(per, t.shape[dst] - j * per))
            if k:
                buf[j].narrow(dst, 0, k).copy_(t.narrow(dst, j * per, k))
    else:
        buf = t.new_empty([0] + shape)
    del t
    got = _wait(funcol.all_to_all_single(buf, first, [first[r]] * n,
                                         _model_group(mesh)))
    del buf
    return got.movedim(0, src).flatten(src, src + 1)


def batch_dims(batch, mesh) -> tuple:
    """The names of the mesh dims (of size > 1) that a batch of
    DTensors is split on, in the mesh's order."""
    from torch.distributed.tensor import DTensor
    from ..tree import leaves
    split = set()
    for b in leaves(batch):
        if isinstance(b, DTensor):
            split |= {i for i, pl in enumerate(b.placements)
                      if pl.is_shard() and mesh.size(i) > 1}
    return tuple(mesh.mesh_dim_names[i] for i in sorted(split))

"""Partitioning rules for params, optimizer state, activations and caches
(the reference's ``src/repro/sharding/specs.py``) over a
``torch.distributed`` ``DeviceMesh`` with named dims ("pod", "data",
"model").

Strategy, as the reference's rules (Megatron-style dims on "model",
ZeRO/FSDP-style weight sharding on "data" for large tensors, batch DP
over ("pod", "data")):

  * every >=2D weight shards its LAST divisible dim on "model";
  * leaves with >= FSDP_MIN elements additionally shard another divisible
    dim on "data";
  * layer-stacked leaves (under "layers" / "enc_layers") never shard
    dim 0;
  * non-divisible dims fall back to replication (e.g. qwen2's 12 heads on
    a 16-way model axis);
  * batch-like inputs shard dim 0 over ("pod", "data") when divisible,
    then ("data",), else replicate (long_500k's batch=1).

A spec is the reference's ``PartitionSpec`` as a tuple: per tensor dim,
None, a mesh dim's name, or a tuple of names. :class:`Layout` pairs a
spec with its mesh and gives the DTensor placements (``Shard(d)`` on
each mesh dim that dim ``d`` names, ``Replicate()`` elsewhere).
``distribute_tree`` places a tree's tensors by their layouts.

The rules read only the mesh's dim names and sizes, so a
:class:`MeshShape` (names and sizes, no devices) serves wherever only
specs are wanted. How the port computes on what these rules place
(each layer's weights gathered to their :func:`compute_spec` while the
layer runs, grads reduce-scattered back) is ``models/shards.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from ..tree import flatten_with_path, tree_map, unflatten

FSDP_MIN = 1 << 22          # 4M elements: shard weights on "data" too


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's dim names and sizes without devices: what the rules
    read."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def mesh_sizes(mesh) -> dict:
    """{dim name: size} of a ``DeviceMesh`` or a :class:`MeshShape`."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _axis_size(mesh, name: str) -> int:
    return mesh_sizes(mesh).get(name, 1)


def _is_stacked(path) -> bool:
    return any(k in ("layers", "enc_layers") for k in path)


def leaf_spec(path, shape, mesh) -> tuple:
    """The spec of the leaf at ``path`` (a tuple of dict keys / list
    indices, as :func:`repro_torch.tree.flatten_with_path` gives it)
    with ``shape``."""
    if len(shape) == 0:
        return ()
    names = mesh_sizes(mesh)
    model = names.get("model", 1)
    data = names.get("data", 1)
    lo = 1 if (_is_stacked(path) and len(shape) > 1) else 0
    spec = [None] * len(shape)
    # model axis: last divisible dim
    m_dim = None
    if "model" in names:
        for d in range(len(shape) - 1, lo - 1, -1):
            if shape[d] % model == 0 and shape[d] >= model:
                spec[d] = "model"
                m_dim = d
                break
    # data axis (FSDP) for big leaves: another divisible dim
    numel = int(np.prod(shape))
    if "data" in names and numel >= FSDP_MIN:
        for d in range(len(shape) - 1, lo - 1, -1):
            if d != m_dim and shape[d] % data == 0 and shape[d] >= data:
                spec[d] = "data"
                break
    return tuple(spec)


EXPERT_LEAVES = {"we_gate": 2, "we_up": 2, "we_down": 1}   # F's dim
MEGATRON_FAMILIES = ("dense", "vlm", "moe")   # heads (and FFN) split
ZIGZAG_FAMILIES = ("dense", "vlm", "moe", "audio")   # zigzag positions


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """What a rank computes of its model group's work (``n`` ranks on
    "model"), where the reference lets GSPMD split every op there:

      * ``batch``: its contiguous 1/n of its data shard's rows, with
        whole weights (FSDP over "model");
      * else Megatron's column / row pairs: ``heads``, its 1/n of the
        query heads (``wq``, ``bq`` by columns, ``wo`` by rows); ``kv``
        "split", its 1/n of the KV heads (``wk``, ``wv``, ``bk``,
        ``bv``), or "pick", the one KV head its query heads read (the
        KV weights whole); ``ffn``, its 1/n of the FFN dim (``w_gate``,
        ``w_up``, ``b_up`` by columns, ``w_down`` by rows);
      * ``sequence``: its 1/n of the step's positions of each of its
        data shard's rows, with whole weights (FSDP over "model", as
        under ``batch``); only the attention's keys and values and the
        recurrences' carried state cross "model". Its ``layout``: with
        ``zigzag``, chunks r and 2n-1-r of 2n (causal attention's work
        the same on every rank, each skipping the key blocks its
        queries cannot see); else one contiguous span;
      * ``columns`` (a decode step): every weight where the rules
        placed it on "model", each product this rank's output columns
        (all-gathered) or, where "model" is the weight's input dim, its
        partial sum (summed over "model"); the decode state split as
        :func:`decode_cache_spec` places it;
      * a part with none of these is computed whole by every rank.

    :func:`model_split` and :func:`model_split_decode` choose it;
    ``models/shards.py`` gathers each weight to its :func:`compute_spec`
    under it."""
    n: int = 1
    batch: bool = False
    heads: bool = False
    kv: str = ""
    ffn: bool = False
    columns: bool = False
    sequence: bool = False
    zigzag: bool = False

    @property
    def name(self) -> str:
        """"batch", "sequence", "columns", "heads+ffn", "heads", "ffn" or
        "none"."""
        if self.batch:
            return "batch"
        if self.sequence:
            return "sequence"
        if self.columns:
            return "columns"
        return "+".join(p for p, on in (("heads", self.heads),
                                        ("ffn", self.ffn)) if on) or "none"

    @property
    def layout(self) -> str:
        """How the sequence split lays out a rank's positions: "zigzag"
        or "contiguous"; "" under any other split."""
        if not self.sequence:
            return ""
        return "zigzag" if self.zigzag else "contiguous"


def sequence_split(cfg, n: int, seq: int) -> ModelSplit:
    """The sequence split of ``seq`` positions over n "model" ranks:
    zigzag for the families whose positions mix only through attention
    (``ZIGZAG_FAMILIES``; whisper's decoder, its encoder frames staying
    contiguous) where ``seq`` divides by 2n; else contiguous (mamba2's
    and hymba's scans carry their state in position order, and hymba's
    windowed attention is balanced over contiguous spans already)."""
    return ModelSplit(n, sequence=True, zigzag=cfg.family in ZIGZAG_FAMILIES
                      and seq % (2 * n) == 0)


def model_split(cfg, rows: int, mesh, micro_batches: int = 1,
                seq: int = None) -> ModelSplit:
    """How a step over ``rows`` rows a data shard (each of
    ``micro_batches`` microbatches a rank takes its share of) and
    ``seq`` positions a row splits over "model", in this order: the
    batch, when ``rows`` divides by n x ``micro_batches``; else, for the
    dense, vlm and MoE families, the query heads where they divide (with
    the KV heads where they divide, or divide n), and the FFN dim where
    it divides (not the MoE's: its experts split on their own); else,
    for every family, the positions, where ``seq`` divides by n (a
    zigzag of two spans a rank where the family allows it and ``seq``
    divides by 2n, else one contiguous span: :func:`sequence_split`,
    which never raises for the layout); else,
    for those three families, the FFN dim alone where it divides; else
    nothing. A part whose dims do not divide stays whole, as the rules
    replicate a dim that does not divide."""
    n = _axis_size(mesh, "model")
    if n == 1:
        return ModelSplit()
    if rows % (n * micro_batches) == 0:
        return ModelSplit(n, batch=True)
    megatron = cfg.family in MEGATRON_FAMILIES
    if megatron:
        H, KH = cfg.num_heads, cfg.num_kv_heads
        kv = "split" if KH % n == 0 else "pick" if n % KH == 0 else ""
        ffn = cfg.family != "moe" and cfg.d_ff % n == 0
        if kv and H % n == 0:
            return ModelSplit(n, heads=True, kv=kv, ffn=ffn)
    if seq is not None and seq % n == 0:
        return sequence_split(cfg, n, seq)
    return ModelSplit(n, ffn=megatron and ffn)


def model_split_decode(mesh) -> ModelSplit:
    """How a decode step splits over "model": ``columns`` wherever the
    "model" dim has more than one rank, whatever the rows or heads (the
    weights and the decode state stay where the rules placed them, and
    only activations move over "model"); else nothing."""
    n = _axis_size(mesh, "model")
    return ModelSplit(n, columns=True) if n > 1 else ModelSplit()


_COLUMNS = {"wq": ("heads", 1), "bq": ("heads", 0), "wo": ("heads", 0),
            "wk": ("kv", 1), "wv": ("kv", 1), "bk": ("kv", 0),
            "bv": ("kv", 0), "w_gate": ("ffn", 1), "w_up": ("ffn", 1),
            "b_up": ("ffn", 0), "w_down": ("ffn", 0)}


def compute_spec(name: str, shape, mesh, split: ModelSplit = None) -> tuple:
    """The spec the weight ``name`` of ``shape`` (one layer's, for a
    stacked leaf) is computed in under ``split`` (no split by default):
    whole, except on a "model" dim of more than one rank
      * ``lm_head``'s vocabulary, where the reference's logits are
        (``constrain_logits``), when it divides, unless the batch or the
        positions are split over "model" (the logits then are this
        rank's rows or positions, with the whole vocabulary);
      * under ``columns``, every other weight of two or more dims on the
        dim :func:`leaf_spec` put on "model" (one layer's dims, for a
        stacked leaf), the MoE's expert weights too, so that no weight
        crosses "model"; a 1-D weight (a norm gain, a bias) whole;
      * the MoE's expert weights, where the expert-sharded branch
        computes them (the reference's ``shard_map`` in_specs): the
        experts on "model" when they divide, else the FFN dim when it
        divides;
      * the attention's and the MLP's weights, each split on the dim
        that :class:`ModelSplit` names for the part it splits."""
    split = split or ModelSplit()
    spec = [None] * len(shape)
    n = mesh_sizes(mesh).get("model", 1)
    f_dim = EXPERT_LEAVES.get(name)
    part, dim = _COLUMNS.get(name, (None, None))
    if n == 1:
        return tuple(spec)
    if name == "lm_head" and len(shape) == 2:
        if shape[1] % n == 0 and not (split.batch or split.sequence):
            spec[1] = "model"
    elif split.columns:
        if len(shape) >= 2:
            return tuple("model" if ax == "model" else None
                         for ax in leaf_spec((name,), tuple(shape), mesh))
    elif f_dim is not None and len(shape) == 3:
        if shape[0] % n == 0:
            spec[0] = "model"
        elif shape[f_dim] % n == 0:
            spec[f_dim] = "model"
    elif part is not None and getattr(split, part) in (True, "split"):
        if shape[dim] % n:
            raise ValueError(f"{name} {tuple(shape)}: dim {dim} does not "
                             f"divide over {n} model ranks")
        spec[dim] = "model"
    return tuple(spec)


def batch_spec(shape, mesh) -> tuple:
    """Shard dim0 (batch) over ("pod","data") / ("data",) / replicate."""
    names = mesh_sizes(mesh)
    cands = []
    if "pod" in names and "data" in names:
        cands.append(("pod", "data"))
    if "data" in names:
        cands.append(("data",))
    for axes in cands:
        size = int(np.prod([names[a] for a in axes]))
        if shape[0] % size == 0 and shape[0] >= size:
            return (axes if len(axes) > 1 else axes[0],
                    *([None] * (len(shape) - 1)))
    return tuple([None] * len(shape))


def cache_spec(shape, mesh) -> tuple:
    """Decode caches: (L, B, S, KH, hd)-style — shard B (dim1) on data
    (on ("pod", "data") when there are pods and they divide), and the
    last divisible head/state dim on model."""
    model = _axis_size(mesh, "model")
    data = _axis_size(mesh, "data")
    pod = _axis_size(mesh, "pod")
    spec = [None] * len(shape)
    if len(shape) >= 2:
        if pod > 1 and shape[1] % (pod * data) == 0 \
                and shape[1] >= pod * data:
            spec[1] = ("pod", "data")
        elif shape[1] % data == 0 and shape[1] >= data:
            spec[1] = "data"
    for d in range(len(shape) - 1, 1, -1):
        if shape[d] % model == 0 and shape[d] >= model:
            spec[d] = "model"
            break
    return tuple(spec)


def decode_cache_spec(name: str, shape, mesh, family: str) -> tuple:
    """The placement of the decode-state leaf ``name`` of ``shape`` that
    a split decode step (:func:`model_split_decode`) reads, for a model
    of ``family``: :func:`cache_spec`'s, but for the self-attention
    ``k`` / ``v`` caches (L, B, S, KH, hd) of every family but the
    hybrid's (whose 1,024-entry window shifts every step), which hold
    their positions (dim 2) on "model" in place of the head dim: a
    rank's attention then reads only its own positions, and only its
    softmax statistics and its partial output are summed over "model".
    Raises where the positions do not divide over "model"."""
    spec = list(cache_spec(shape, mesh))
    n = _axis_size(mesh, "model")
    if n == 1 or name not in ("k", "v") or family == "hybrid":
        return tuple(spec)
    if shape[2] % n:
        raise ValueError(f"decode cache {name} {tuple(shape)}: its "
                         f"{shape[2]} positions do not divide over {n} "
                         f"model ranks")
    spec = [None if ax == "model" else ax for ax in spec]
    spec[2] = "model"
    return tuple(spec)


@dataclasses.dataclass(frozen=True)
class Layout:
    """A spec on a mesh: the reference's ``NamedSharding``."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [d for d, ax in enumerate(self.spec)
                    if ax == name or (isinstance(ax, tuple) and name in ax)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def tree_placements(tree, mesh):
    """:class:`Layout` of every leaf of a params / optimizer-state tree
    (the reference's ``tree_shardings``)."""
    flat, treedef = flatten_with_path(tree)
    return unflatten(treedef, [Layout(mesh, leaf_spec(p, tuple(l.shape),
                                                      mesh))
                               for p, l in flat])


def batch_placements(tree, mesh):
    return tree_map(lambda l: Layout(mesh, batch_spec(tuple(l.shape), mesh)),
                    tree)


def cache_placements(tree, mesh):
    return tree_map(lambda l: Layout(mesh, cache_spec(tuple(l.shape), mesh)),
                    tree)


def decode_cache_placements(cache: dict, mesh, family: str) -> dict:
    """:class:`Layout` of every leaf of a decode cache by
    :func:`decode_cache_spec`."""
    return {k: Layout(mesh, decode_cache_spec(k, tuple(v.shape), mesh,
                                              family))
            for k, v in cache.items()}


def replicated(mesh) -> Layout:
    return Layout(mesh, ())


def distribute(t: torch.Tensor, layout: Layout):
    """``t`` (the same full tensor on every rank, or a meta tensor) as a
    DTensor placed by ``layout``: each rank keeps its own slice, with no
    communication."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, layout.mesh, layout.placements,
                             src_data_rank=None)


def distribute_tree(tree, layouts):
    """Every tensor of ``tree`` placed by the matching :class:`Layout` of
    ``layouts`` (one Layout for the whole tree also serves)."""
    if isinstance(layouts, Layout):
        return tree_map(lambda t: distribute(t, layouts), tree)
    return tree_map(distribute, tree, layouts)

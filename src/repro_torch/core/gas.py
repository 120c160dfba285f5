"""Gather-Apply-Scatter programming interface (paper §V-B, Listing 1).

Users supply three UDFs, like ReGraph's accScatter/accGather/accApply:
gather is one of the associative modes the kernel implements; apply is a
vertex-wise function on torch tensors. The scatter UDF is the plain
callable ``scatter`` (the plain path and the CPU run it). A builtin app
also names it among the kernel's built-in ops (``scatter_op``, one of
:data:`SCATTER_OPS`). On the card an app whose ``scatter_op`` is None
launches a kernel variant generated from ``scatter`` itself: it is
traced with ``torch.fx`` into C++ (``kernels/udf_codegen.py``) and
built once per UDF. A UDF outside the generator's elementwise ops
raises ``NotImplementedError`` there; nothing falls back to the plain
path.

Built-in applications mirror the paper's benchmarks (PR, BFS, CC) plus
SSSP and WCC. CC is Closeness Centrality via 32-source bit-parallel BFS
(OR-aggregation).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

INF = np.float32(3.0e38)

# gather modes and their identity elements
GATHER_IDENTITY = {
    "sum": 0.0,
    "min": INF,
    "max": -INF,
    "or": 0,           # int32 bitwise OR
}

# the kernel's named scatter ops: name -> plain callable
SCATTER_OPS = {
    "copy": lambda src_prop, w: src_prop,
    "add_weight": lambda src_prop, w: src_prop + w,
}


@dataclasses.dataclass(frozen=True)
class GASApp:
    """A graph application in the GAS model.

    prop is a scalar per-vertex property (f32, or i32 for 'or' mode).
    scatter(src_prop, edge_weight) -> update value  [plain callable]
    scatter_op: the kernel's name for ``scatter`` (see SCATTER_OPS), or
                None: the kernel then runs a variant generated from
                ``scatter``
    gather mode in {'sum','min','max','or'}         [the router]
    apply(accum, prop, aux, iteration) -> new prop  [vertex-wise, torch]
    init(graph_aux) -> initial prop                  (numpy)
    converged(old_prop, new_prop, iteration) -> bool
    iteration_key: what one iteration depends on, or None. Apps with
                equal keys run the same iteration on the same plan, so
                a captured iteration is shared between them
                (``core/replay.py``): the name, gather mode and scatter
                op, and every parameter ``apply`` reads. It leaves out
                what only changes the initial vector or the loop (a
                root, ``max_iters``). An app whose ``apply`` reads its
                ``iteration`` argument, or parameters the executor
                cannot see, has none and runs eagerly.
    """

    name: str
    gather: str
    scatter: Callable
    apply: Callable
    init: Callable
    converged: Callable
    needs_weights: bool = False
    prop_dtype: str = "float32"
    max_iters: int = 64
    scatter_op: Optional[str] = None
    iteration_key: Optional[tuple] = None


def _equal(old, new, it) -> bool:
    return bool(torch.equal(old, new))


# ---------------------------------------------------------------------------
# PageRank (paper Listing 1): pull model. The stored property is
# rank/out_degree so scatter is the identity — exactly the paper's UDF.
# ---------------------------------------------------------------------------

def make_pagerank(damping: float = 0.85, max_iters: int = 16) -> GASApp:
    def apply(accum, prop, aux, it):
        outdeg, num_v = aux["outdeg"], aux["num_v"]
        rank = (1.0 - damping) / num_v + damping * accum
        return rank / torch.clamp_min(outdeg, 1.0)

    def init(aux):
        v = aux["outdeg"].shape[0]
        return (np.full(v, 1.0 / aux["num_v"], np.float32)
                / np.maximum(aux["outdeg"], 1.0)).astype(np.float32)

    def converged(old, new, it):
        return bool(torch.max(torch.abs(old - new)) < 1e-7)

    return GASApp("pagerank", "sum", SCATTER_OPS["copy"], apply, init,
                  converged, max_iters=max_iters, scatter_op="copy",
                  iteration_key=("pagerank", "sum", "copy", float(damping)))


def _root_init(root: int):
    def init(aux):
        p = np.full(aux["num_v_pad"], INF, np.float32)
        perm = aux.get("perm")
        p[int(perm[root]) if perm is not None else root] = 0.0
        return p
    return init


# ---------------------------------------------------------------------------
# BFS: pull-based level propagation; prop = level (INF = unvisited).
# ---------------------------------------------------------------------------

def make_bfs(root: int = 0, max_iters: int = 64) -> GASApp:
    def apply(accum, prop, aux, it):
        reachable = accum < INF
        return torch.where((prop >= INF) & reachable, accum + 1.0, prop)

    return GASApp("bfs", "min", SCATTER_OPS["copy"], apply, _root_init(root),
                  _equal, max_iters=max_iters, scatter_op="copy",
                  iteration_key=("bfs", "min", "copy"))


# ---------------------------------------------------------------------------
# SSSP: prop = distance; scatter adds edge weight; gather = min.
# ---------------------------------------------------------------------------

def make_sssp(root: int = 0, max_iters: int = 64) -> GASApp:
    def apply(accum, prop, aux, it):
        return torch.minimum(prop, accum)

    return GASApp("sssp", "min", SCATTER_OPS["add_weight"], apply,
                  _root_init(root), _equal, needs_weights=True,
                  max_iters=max_iters, scatter_op="add_weight",
                  iteration_key=("sssp", "min", "add_weight"))


# ---------------------------------------------------------------------------
# WCC: prop = component label, gather = min label.
# ---------------------------------------------------------------------------

def make_wcc(max_iters: int = 64) -> GASApp:
    def apply(accum, prop, aux, it):
        return torch.minimum(prop, accum)

    def init(aux):
        return np.arange(aux["num_v_pad"], dtype=np.float32)

    return GASApp("wcc", "min", SCATTER_OPS["copy"], apply, init, _equal,
                  max_iters=max_iters, scatter_op="copy",
                  iteration_key=("wcc", "min", "copy"))


# ---------------------------------------------------------------------------
# CC (Closeness Centrality): 32-source bit-parallel BFS with OR gather.
# prop = int32 visited bitmask.
# ---------------------------------------------------------------------------

def make_closeness(sources: Optional[np.ndarray] = None,
                   max_iters: int = 32) -> GASApp:
    def apply(accum, prop, aux, it):
        return prop | accum

    def init(aux):
        p = np.zeros(aux["num_v_pad"], np.int32)
        srcs = sources
        if srcs is None:
            srcs = np.arange(min(32, int(aux["num_v"])), dtype=np.int64)
        perm = aux.get("perm")
        for bit, s in enumerate(np.asarray(srcs)[:32]):
            s = int(perm[int(s)]) if perm is not None else int(s)
            mask = (1 << bit) & 0xFFFFFFFF
            if mask >= (1 << 31):      # wrap to signed int32
                mask -= 1 << 32
            p[s] |= np.int32(mask)
        return p

    return GASApp("closeness", "or", SCATTER_OPS["copy"], apply, init,
                  _equal, prop_dtype="int32", max_iters=max_iters,
                  scatter_op="copy",
                  iteration_key=("closeness", "or", "copy"))


BUILTIN_APPS = {
    "pagerank": make_pagerank,
    "bfs": make_bfs,
    "sssp": make_sssp,
    "wcc": make_wcc,
    "closeness": make_closeness,
}

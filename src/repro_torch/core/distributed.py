"""Chunk-granular SPMD execution over a GraphStore plan via
``torch.distributed``.

One of the port's two multi-device paths, built on the layered
GraphStore → Planner → Executor API: ``DistributedEngine(store, app)``
plans on the store (cached per :class:`~.planner.PlanConfig`), re-chunks
the plan's blocked works into tile-snapped units (chunks never share a
destination tile), LPT-balances the chunks over the process group's
ranks with a uniform per-block cost, and runs the same iteration on
every rank: its own chunks through the GAS kernel, then ONE
``all_reduce`` of the property accumulator, then Apply. The chunking,
the giant-tile overflow and the LPT assignment (tie order included) are
the reference's (``repro/core/distributed.py``), so every rank builds
the same queues as the reference and keeps its own.

Where the reference pads every chunk to one fixed ``(depth, B, E_BLK)``
stack for ``shard_map`` — a chunk that reaches a giant tile widens B to
the whole tile, so the stack of a large graph grows to many times its
edges — each rank here packs its Little chunks, and then its Big chunks,
into one packed payload each (``kernels.ops._pack_group``: per-chunk
tile ids rebased, Big window ids rebased against the chunks' own
``unique_src`` tables, each work's table packed once), so an iteration
launches the kernel about once per kind, whatever the chunk count.

Merge: chunk tiles are disjoint, so each rank's tiles land by
scatter-set in a full-length accumulator that holds the gather
identity elsewhere, and one ``all_reduce`` combines the ranks: ``SUM``
for sum and for or (a tile is written by one rank; the others hold 0,
so the sum is exact and NCCL's lack of a bitwise OR does not matter),
``MIN`` and ``MAX`` for the others. Properties stay replicated on every
rank (the small array; edges dominate and are fully sharded).

The caller starts the process group (``torch.distributed.
init_process_group``) and names each rank's device; with no group the
engine raises rather than run on one device behind the caller's back.
The other multi-device path is :mod:`repro_torch.sharding`
(lane-granular, several devices driven from one process).
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import ops
from .executor import init_props
from .gas import GATHER_IDENTITY
from .types import BlockedEdges

_REDUCE = {"sum": "SUM", "or": "SUM", "min": "MIN", "max": "MAX"}


def _chunk_work(work: BlockedEdges, blocks_per_chunk: int) -> List[tuple]:
    """Split a work into tile-snapped chunks of <= blocks_per_chunk."""
    chunks = []
    lo = 0
    while lo < work.n_blocks:
        hi = ops.snap_down(work, min(lo + blocks_per_chunk, work.n_blocks))
        if hi <= lo:  # giant tile: overflow a chunk (rare; keep correctness)
            nxt = lo + blocks_per_chunk
            while nxt < work.n_blocks and work.tile_first[nxt] != 1:
                nxt += 1
            hi = min(nxt, work.n_blocks)
        chunks.append((work, lo, hi))
        lo = hi
    return chunks


def balance(chunks: List[tuple], n_ranks: int) -> List[List[tuple]]:
    """LPT: chunks by descending block count (stable), each to the
    least-loaded rank (lowest rank on ties)."""
    queues: List[List[tuple]] = [[] for _ in range(n_ranks)]
    loads = np.zeros(n_ranks)
    for c in sorted(chunks, key=lambda c: -(c[2] - c[1])):
        k = int(np.argmin(loads))
        queues[k].append(c)
        loads[k] += c[2] - c[1]
    return queues


def chunk_queues(bundle, n_ranks: int, blocks_per_chunk: int = 32):
    """Every rank's Little and Big chunk queues for a plan:
    ``(little_queues, big_queues)``, one list of ``(work, lo, hi)`` per
    rank."""
    little = [c for w in bundle.little_works.values()
              for c in _chunk_work(w, blocks_per_chunk)]
    big = [c for w in bundle.big_works
           for c in _chunk_work(w, blocks_per_chunk)]
    return balance(little, n_ranks), balance(big, n_ranks)


def pack_chunks(chunks: List[tuple]) -> Optional[dict]:
    """One packed host payload of same-kind chunks (None when there are
    none), of the form ``ops._validate_packed`` accepts."""
    entries = [ops._entry_np(work, lo, hi) for work, lo, hi in chunks]
    return ops._pack_group(entries) if entries else None


class DistributedEngine:
    """Chunk-granular SPMD runner for one app on a GraphStore, one rank
    of a ``torch.distributed`` process group.

    Parameters
    ----------
    store:  a prepared :class:`~.store.GraphStore` (every rank holds the
            same graph).
    app:    the :class:`~.gas.GASApp` to execute.
    config: :class:`~.planner.PlanConfig` of the (cached) plan whose
            blocked works are chunked; defaults to ``PlanConfig()``.
    group:  the process group (default: the default group, which must
            be initialised).
    device: this rank's device; default ``cuda`` (the current card),
            raising when there is none and ``device="cpu"`` was not
            passed. NCCL needs a card per rank; gloo runs on the CPU.
    blocks_per_chunk: chunk size in E_BLK blocks before tile-snapping.

    ``run`` matches ``Executor.run``'s contract: props in ORIGINAL
    vertex ids plus an iteration count, equal to the single-device
    paths for min/max/or apps, and to rounding for sum apps.
    """

    def __init__(self, store, app, config=None, group=None, device=None,
                 blocks_per_chunk: int = 32):
        from .planner import PlanConfig
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "DistributedEngine needs an initialised torch.distributed "
                "process group; call torch.distributed.init_process_group "
                "first")
        store.require_padded("DistributedEngine")
        self.store = store
        self.app = app
        self.group = group
        self.device = ops.resolve_device(device)
        if (dist.get_backend(group) == dist.Backend.NCCL
                and self.device.type != "cuda"):
            raise ValueError(f"the NCCL backend needs a CUDA device per "
                             f"rank, got {self.device}")
        self.path = ops.default_path(self.device)
        self.rank = dist.get_rank(group)
        self.world_size = dist.get_world_size(group)
        self.bundle = store.plan(config or PlanConfig())
        self.geom = store.geom
        self.V_pad = store.V_pad
        self.blocks_per_chunk = int(blocks_per_chunk)
        t0 = time.perf_counter()
        self.little_queues, self.big_queues = chunk_queues(
            self.bundle, self.world_size, self.blocks_per_chunk)
        host = [pack_chunks(q[self.rank])
                for q in (self.little_queues, self.big_queues)]
        self.payloads = [ops._upload_payload(p, self.device)
                         for p in host if p is not None]
        self.t_pack = time.perf_counter() - t0
        self.aux = store.aux_on(self.device)
        self._op = getattr(dist.ReduceOp, _REDUCE[app.gather])

    def gather(self, vprops):
        """This rank's kernel launches, the scatter-set merge into an
        identity-filled accumulator, and the ``all_reduce`` over ranks:
        the padded accumulator every rank then applies."""
        app = self.app
        accum = torch.full((self.V_pad,), float(GATHER_IDENTITY[app.gather]),
                           dtype=(torch.int32 if app.gather == "or"
                                  else torch.float32),
                           device=self.device)
        outs = [ops.run_lane(p, vprops, app.scatter, app.gather, self.path,
                             scatter_op=app.scatter_op)
                for p in self.payloads]
        accum = ops.merge_all(accum, outs, self.geom.T)
        dist.all_reduce(accum, op=self._op, group=self.group)
        return accum

    def iteration(self, vprops, it: int):
        return self.app.apply(self.gather(vprops), vprops, self.aux, it)

    def init_props(self):
        return init_props(self.store, self.app, self.device)

    def run(self, max_iters: Optional[int] = None):
        """Run to convergence; returns ``(props, {"iterations": n})``
        with props in ORIGINAL vertex ids (numpy). Every rank runs the
        same iterations on the same merged accumulators."""
        vprops = self.init_props()
        iters = max_iters or self.app.max_iters
        it_done = 0
        for it in range(iters):
            new = self.iteration(vprops, it)
            done = self.app.converged(vprops, new, it)
            it_done = it + 1
            vprops = new
            if done:
                break
        return vprops.cpu().numpy()[self.store.perm], {"iterations": it_done}

    def time_iteration(self, repeats: int = 5) -> float:
        """Median wall time (s) of one iteration on this rank, the
        ``all_reduce`` included, device synchronized."""
        vprops = self.init_props()
        ts = []
        for r in range(repeats + 1):                  # 1 warm-up
            t0 = time.perf_counter()
            self.iteration(vprops, 0)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if r:
                ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    def stats(self) -> dict:
        """What this rank holds and launches per iteration."""
        def blocks(q):
            return sum(hi - lo for _, lo, hi in q)
        return {
            "rank": self.rank, "world_size": self.world_size,
            "device": str(self.device), "path": self.path,
            "blocks_per_chunk": self.blocks_per_chunk,
            "little_chunks": len(self.little_queues[self.rank]),
            "big_chunks": len(self.big_queues[self.rank]),
            "chunks_total": sum(len(q) for q in self.little_queues)
            + sum(len(q) for q in self.big_queues),
            "blocks": [blocks(lq) + blocks(bq) for lq, bq
                       in zip(self.little_queues, self.big_queues)],
            "payloads": len(self.payloads),
            "launches_per_iteration": len(self.payloads),
            "all_reduces_per_iteration": 1,
            "packed_bytes": sum(ops.payload_nbytes(p)
                                for p in self.payloads),
            "t_pack_ms": self.t_pack * 1e3,
        }

#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA GPU
and check it; the quickest proof that the port still starts on the card.

    python3 chip_smoke.py [--out results.json]

Phases (any failed check exits non-zero before the last line):

1. Device and build: the card's name and power limit, then the GAS
   kernel built from ``src/repro_torch/kernels/csrc/gas_kernel.cu`` (the
   named ops' library and phase 15's generated variants, one ``nvcc``
   each, all started together).
2. Kernel vs plain version on the card, on inputs made from a numpy seed:
   every gather mode (sum, min, max, or) and scatter op, both input forms
   (Little, Big), both launch forms (per entry, packed lane), at the
   geometries (E_BLK, W, T) of the reference's kernel sweep, and a heavy
   tile of about 10.5 chunks of ``CHUNK_EDGES`` live edges, half of its
   edges to one hub slot, with scattered pads, beside a tile with no live
   edge. min, max and or must match exactly; sum
   within the worst-case in-order fp32 summation error of the exact
   (fp64) sum, and on the graph payloads also within rtol 1e-5 / atol
   1e-5 of the plain version (whose ``scatter_reduce`` adds in another
   order). A second kernel run must be bit-equal to the first, and the
   heavy tile's tiles launched one by one bit-equal to the packed
   launch.
3. Main path: ``rmat(19, 56, seed=23)`` (graph500 shape, 524,288
   vertices) with the default Geometry and ``PlanConfig(n_lanes=8)``,
   which must plan both Little and Big lanes. PageRank and BFS run
   through ``api.compile(...).run()`` on the card and on the port's
   plain path on the same card: BFS must match exactly; PageRank within
   rtol 1e-5 / atol 1e-7, as ``tests/test_torch_cuda.py`` holds it (the
   two paths add fp32 in-edge sums in different orders). One PageRank
   gather is held against the edge-list oracle ``edge_ref`` (rtol 1e-4:
   it sums unblocked edges with atomics, in no fixed order). The
   kernel's launch count must show the main path went through it.
4. Measurements at the main path's shapes. The kernel's 8 PageRank
   launches with each chunk size of the sweep (each held within the fp32
   summation error of the exact sum), per launch its time, CTAs and real
   edges, the per-entry form (``fuse_lanes=False``: its launches, time
   and bound, and its gather bit-equal to the fused one), and one
   PageRank iteration split into Big gathers, GAS launches, merge,
   Apply and the convergence test with CUDA events, the Big gathers
   beside their bound (the ids read, each value they pick read and
   written once, at 3,350 GB/s). Then one ``kernels``
   JSON line: per kernel its launches on the main path, error against
   the plain version, its time, the plain version's time, one
   ``scatter_reduce`` over pre-gathered values (``library_ms``) and the
   least time the card could take (``bound_ms``). Then the shapes of
   urand20's Big lanes (``phase_urand_big``): a uniform graph of 2**20
   vertices and in-degree 32 (as GAP urand at scale 20 stored both
   ways), the Big blocking of a quarter of its partitions packed two
   batches a payload as the plan packs them, its live share, and the
   kernel's time (PageRank sum/copy, SSSP min/add_weight) beside the
   bound of the live-edge stream.
5. Sharded path on the main path's store: ``api.compile(..., shard=1)``
   and two owners on the one card (``shard=[cuda:0, cuda:0]``: a test of
   the two-owner path, not a multi-card number), and every card when
   there are several. PageRank (4 iterations) and BFS must be bit-equal
   (``torch.equal``) to the fused path, one gather too, with one merge
   per iteration; the kernel's launch count must show the path went
   through it. Its iteration time beside the fused one, launches per
   iteration and device bytes; for one owner every launch on the
   sharded payloads held against its plain version slot by slot (fp32
   summation error of the exact sum), and its time beside the plain
   version's, the bound and the library call.
6. Streaming: one delta, ``random_delta(graph, churn=0.001, seed=SEED +
   1, hot_frac=0.05, grow_frac=0.0005)``, applied with the fused and
   both sharded forms materialized. Packed and shard reuse must be
   above 0, and every reused lane must hold the very tensors it held
   before (same objects, same ``data_ptr()``). The kernel on the
   post-delta shapes is held against its plain version: every launch of
   one PageRank gather on random properties slot by slot (fp32
   summation error of the exact sum), and PageRank (4 iterations) and
   BFS, fused and sharded, against the plain path (rtol 1e-5 / atol
   1e-7, and exactly). They must also be bit-equal to a cold
   ``GraphStore(post_graph, perm=...)`` rebuild run the same ways, with
   the kernel's launches counted on the derived store.
   ``t_apply_ms`` beside the cold rebuild's store + plan + pack time.
7. Utilization: ``Executor.time_lanes`` on the main path's PageRank, then
   ``Executor.utilization()`` per kind (GB/s: the bytes each lane must
   move, ``obs.lane_traffic``, over its host-clock time; % of the card's
   data-sheet rate when the card is in ``perf_model.DATASHEET_HBM_GBPS``),
   and each lane's analytic ``total_bytes`` within 10 % of
   ``tensor_lane_bytes``.
8. Serving: a ``GraphService(cache=..., device=cuda, workers=2)`` whose
   store cache is seeded with phase 3's store. The five builtin apps
   once each, each bit-equal (``torch.equal``) to a direct ``Executor``
   on the same store and plan, PageRank also within rtol 1e-5 / atol
   1e-7 of the plain path; 20 warm PageRank requests one after another
   (stages, p50 and p99) beside ``Executor.run`` alone on the same
   executor, on the main thread and on a plain thread; a burst of 8
   identical submits, which must run once; then the phase 6 delta
   through ``GraphService(pool=1)`` (a spawned worker splices it), whose
   snapshot's PageRank and BFS must be bit-equal to phase 6's derived
   store, timed beside phase 6's in-process apply, with what shipping
   the base store costs (pickle bytes and ms, unpickle ms, a pool
   pipe's ms).
9. Control plane: ``ControlPlane(service).serve_http("127.0.0.1", 0)``.
   Two rounds of a PageRank and a BFS job over HTTP, equal to phase 8's;
   ``/metrics``, ``/dashboard``, ``/metrics.json`` and ``/readyz`` answer
   200; the ``/healthz`` round trip; one PageRank job on a new executor
   key under a ``Tracer(lane_detail=True)``, bit-equal to phase 8's
   untraced PageRank, whose trace must hold ``service.store``,
   ``service.plan``, ``service.execute``, one ``executor.lane`` span per
   non-empty lane per iteration and ``executor.merge_apply``.
   ``launches_by_path`` counts the kernel's launches on the serving and
   control paths (zeroed just before each run of the service, read just
   after; the comparison runs are not counted).
10. Autotune on phase 3's store: an ``AutoTuner`` whose ``SpecRegistry``
   lives in a temp dir and an ``Executor(calibrator=...)``;
   ``tuner.retune(..., force=True)`` sweeps the lanes through the kernel
   (host clock, each lane ended by a synchronize), fits, searches the
   candidate plans and adopts the winner. The fit's diagnostics, the
   scored candidates, the chosen split, ``t_retune_s`` and the time of
   ``search_plan`` alone are printed. An applied fit: PageRank under the
   adopted plan within rtol 1e-5 / atol 1e-7 of phase 3's, BFS
   bit-equal, and the spec file names the card. A fit the guard rejects
   is printed as such (the guard working, not a failure) and the
   unchanged plan's results are held to phase 3's. Then a
   ``GraphService(autotune=tuner)``: a PageRank request,
   ``ControlPlane.retune_job``, and a PageRank request equal to the
   first (rtol 1e-5). The plane, given a lane-detail tracer, makes each
   served run feed the calibrator too; the sample counts and every measured
   lane time the second fit saw are printed.
11. ``DistributedEngine`` on a one-rank NCCL group (``FileStore`` in a
   temp dir): PageRank and BFS held to phase 3's (allclose, bit-equal),
   its chunks, payloads, launches per iteration, packed bytes and
   ``iteration_ms``; each launch on its packed payloads held against
   the plain version and timed beside it, the bound and the library
   call. ``launches_by_path`` gains ``autotune`` and ``distributed``.
12. LM serving on the card (``phase_lm``), weights from a seeded
   ``torch.Generator``. 12a: qwen2-1.5B at full width (28 layers,
   d_model 1536, vocab padded to 153,600) in fp32: forward on 2 x 256
   tokens, then prefill the first half and decode the rest step by
   step, each step within the reference's tolerances of forward (2e-2,
   5e-2); the same widths at 2 layers on the card and on the CPU within
   rtol 1e-4 / atol 1e-4. 12b: the same model in bf16 behind
   ``ServeEngine(max_batch=8)``: 16 requests, prompts of 128-512 tokens
   (numpy ``default_rng(0)``), 32 new tokens each at temperature 0;
   tokens/s, mean TTFT, prefill and decode-step device ms (CUDA events)
   at the first wave's shape, parameter and cache bytes, peak device
   memory; one request through a ``max_batch=1`` engine token for token
   equal to a manual prefill + decode loop. 12c: granite-MoE (32 layers,
   40 experts padded to 48, top-8, biglittle dispatch) in bf16: one
   layer's dispatch on 256 tokens at a capacity nothing overflows
   against ``ref.moe_dispatch_ref`` (fp32 rtol 1e-4 / atol 1e-5, bf16
   rtol = atol = 2e-2), then 8 of the same requests served as in 12b,
   with ``biglittle_split``'s (n_hot, C_hot, C_cold). The LM path
   launches no hand-written kernel, so the ``kernels`` line keeps its
   one row.
13. The recurrent and encoder-decoder families on the card
   (``phase_lm_recurrent``), each at the repo's full config, weights
   from ``torch.Generator`` seed 0. 13a: mamba2-2.7B (64 layers, d_model
   2560, 80 SSM heads of 64, state 128) in fp32: forward on 2 x 512
   tokens, prefill the first 256 and decode the rest, each step within
   8e-2 of forward (2e-2 for the prefill's last logits); 2 layers at
   full widths on the card and the CPU within 1e-4; then in bf16 behind
   ``ServeEngine(max_batch=8)`` as 12b, with the decode step's bound
   (every weight and the decode state read once). 13b: hymba-1.5B the
   same, its fp32 decode crossing the 1,024-token window (prefill 1,000,
   decode 64). 13c: whisper-tiny (4 + 4 layers, 1,500 seeded encoder
   frames, batch 8): fp32 decode against forward (prefill 64, decode
   32), then bf16 prefill of 64 tokens and a manual greedy loop of 32
   steps, timed (the engine does not serve whisper, as in the
   reference).
14. Training on the card (``phase_train``). 14a: the flash backward
   (``common._Flash``) against plain autograd of dense softmax attention
   at B 2, S 2048, 12 heads over 2, head dim 128, causal: fp32 within
   1e-4, bf16 within 2e-2, with forward + backward ms and peak memory.
   14b: qwen2-1.5B at full width and depth in bf16 (remat on), AdamW
   with f32 moments, 5 steps of 4 x 512 ``TokenPipeline`` tokens through
   ``Trainer`` into a temporary directory: step ms (CUDA events, host),
   tokens/s, peak memory, the final save's seconds and bytes; every loss
   finite. 14c: the same at 2 layers, AdamW(lr 3e-3): 16 uninterrupted
   steps against 11 steps + a restart from the step-10 checkpoint to 16
   under ``torch.use_deterministic_algorithms(True)``, params and
   moments bit-equal (else within 2e-2); 25 steps without it lower the
   mean loss of the last 5 below the first 5's; the median step with
   and without deterministic algorithms.
15. Custom scatter UDFs on the card (``phase_custom_udf``), on phase 3's
   store: three apps that are not builtins, their scatter UDFs plain
   torch callables with no ``scatter_op`` (widest path: max of
   ``minimum(src, w)``; sum of ``src * w * 0.5 + 0.25``; or of
   ``src & 0xFFFF`` on int32), each through ``api.compile(...).run()``,
   which launches the kernel variant generated for its UDF (traced by
   ``kernels/udf_codegen.py``, built in phase 1 beside the sweep, one
   ``nvcc`` each). Launches counted, results against the plain path on
   the card (max and or bit-equal, sum within rtol 1e-5 / atol 1e-7);
   each launch of one gather on random properties and weights against
   its plain version (bit-equal, or within the fp32 summation error of
   the exact sum). Per variant: nvcc seconds, one iteration's launches'
   device ms beside PageRank's copy variant (phase 4), the bound, the
   plain version and the library call (the UDF in torch ops, then one
   ``scatter_reduce``; none for or); the ``kernels`` line lists each
   variant with its ``launches_by_path``. (The smoke graph has no
   weights, so its edges carry 0; the random weights exercise ``w``.)
16. The LM substrate's sharding (``phase_sharding``). 16a: qwen2-1.5B at
   full width in bf16, one AdamW step on 4 x 512 tokens with params,
   state and batch placed by ``sharding.specs`` on a one-rank NCCL mesh
   (``make_host_mesh()``), against the unsharded step from the same
   seeded init (loss and params within 2e-2 relative), both steps'
   device ms. 16b: granite-MoE's ``moe_ffn`` at full width, f32, one
   layer, 8 x 512 tokens, capacity 10 (no expert overflows, checked; the
   reference's test takes 50 on 8 x 16 tokens, which at 8 x 512 would
   not fit the card beside two ranks), in two spawned processes sharing
   the card over gloo (NCCL takes one rank per GPU) on a ("data",
   "model") = (1, 2) mesh: the expert-sharded branch (E_pad 48 / 2)
   against the single-device ``moe_ffn`` at rtol 1e-4 / atol 1e-5 (its
   times are not multi-card times). 16c: the dry run
   (``launch.dryrun``) of qwen2 ``train_4k`` and ``prefill_32k``,
   command-r ``prefill_32k`` and granite ``decode_32k`` at the
   production pod mesh on a fake group of 256 ranks: each record's
   status, split over "model", rank 0's argument bytes, traced peak,
   collective bytes and traced FLOPs beside the roofline's analytic
   share a rank. Each must fit 80 GB; qwen2 ``train_4k`` (the batch
   split) must trace at most 1.25x its analytic share, command-r
   ``prefill_32k`` (heads and FFN split) at most a tenth of the 6.51e15
   FLOP a rank it traced while every model rank computed its group's
   whole work.
17. The sharded step's compute split over "model" (``phase_split``):
   qwen2-1.5B at full width in bf16, one AdamW step from the seeded
   init, in two spawned processes sharing the card over gloo on a
   ("data", "model") = (1, 2) mesh, their all-gathers, reduce-scatters
   and all-to-alls staged through host memory (gloo takes no all-gather
   of CUDA tensors). 17a: 4 x 512 tokens, the batch split (2 rows a
   rank); 17b: 1 x 512, Megatron's split (6 of 12 heads, 1 of 2 KV
   heads, 4,480 of 8,960 FFN columns). Each against the unsharded step
   (rank 0, computed and freed before the ranks place anything): the
   split taken, loss within SHARD_TOL relative, params within SHARD_TOL
   of each leaf's largest (an element whose unsharded gradient is
   within SHARD_TOL of the leaf's largest is held to 2 lr more: AdamW's
   first step moves it by +-lr whatever the gradient's size), each
   rank's FLOPs (``FlopCounterMode``'s formulas, summed by
   ``_flop_count``) at most 0.6 of the unsharded step's; per rank the step's ms (CUDA events; two processes on one
   card, not multi-card times) and peak over the arguments.
18. A decode step split over "model" (``phase_decode_split``): qwen2-1.5B,
   granite-MoE, mamba2-2.7B, hymba-1.5B and whisper-tiny at full width
   in bf16 and f32, in two spawned processes sharing the card over gloo
   on a ("data", "model") = (1, 2) mesh, collectives staged as phase
   17's. Each rank runs an unsharded prefill of 2 x 512 tokens
   (whisper's over 1,500 seeded frames), grows the self-attention cache
   to 1,024 positions, takes its slice of that cache
   (``decode_cache_spec``) and of the params (``tree_placements``), and
   runs 8 teacher-forced
   decode steps under the columns split beside the unsharded
   ``decode_step``, in bf16 and on the same weights and cache upcast to
   f32. Per step the split taken and the rank's logits (its vocabulary
   slice), relative to their largest: in f32 within 1e-3 of the
   unsharded step's, and in bf16 at most twice as far from the f32
   logits as the unsharded bf16 step's (over the steps); per family
   each rank's bf16 FLOPs at most 0.6 of the unsharded step's and its
   decode state half the unsharded cache's bytes, and the bf16 step's
   ms beside the unsharded step's (two processes on one card: not
   multi-card times).
19. Train and prefill steps split by positions (``phase_seq_split``,
   the sequence split): two spawned processes sharing the card over
   gloo on a ("data", "model") = (1, 2) mesh, collectives staged as
   phase 17's. 19a: qwen2-1.5B, granite-MoE, mamba2-2.7B, hymba-1.5B
   and whisper-tiny at full width and depth, a prefill of one row of
   4,096 positions (1 row does not divide over 2 ranks, and the
   positions do: each rank takes 2,048; whisper over 1,500 seeded
   frames, 750 a rank) through ``shards.sharded_prefill`` beside the
   unsharded ``prefill`` (on the second process), in bf16 and on the
   same weights upcast to f32, the weights placed whole on each rank
   (under the rules' placements each layer's weights would cross the
   host, as in 19b, and set the step's time). qwen2, granite and
   whisper's decoder lay out a rank's positions as a zigzag of two
   spans (chunks r and 3 - r of 4), mamba2 and hymba as one contiguous
   span; the attention visits only the key blocks a query block can see,
   and each rank's count of visited (query block, KV block) pairs is
   printed. Per family: on each rank the split taken and its layout,
   the zigzag ranks' FLOPs within 3 % of each other, and the FLOPs at
   most 0.6 of the unsharded step's (``_flop_count`` on the f32 steps,
   the same shapes, equal to ``FlopCounterMode``'s count of the same
   run), every rank's logits and
   cache the same (a digest of each leaf); in f32 the last logits and
   every cache leaf within 1e-5 of the unsharded step's largest value
   (1e-4 for mamba2 and hymba, whose scan sums in a new order); in bf16
   each at most twice as far from the unsharded f32 step's as the
   unsharded bf16 step's, and within SEQ_SPLIT_BF16_CEIL of the
   unsharded bf16 step's itself (each cache leaf's first layer within
   SEQ_SPLIT_BF16_FIRST_LAYER: no depth yet to grow a flipped rounding);
   the bf16 step's ms (CUDA events) and peak beside the unsharded
   step's (two processes on one card: not multi-card times), and the
   unsharded step's ms beside its reading with every KV block visited
   (phase 14a prints its flash times so too). For qwen2 and granite the
   rule is made to give the sequence split (``specs.sequence_split``):
   their query heads divide over 2 ranks, so at (1, 2) it gives them
   Megatron's split (it gives them "sequence" at the pod's 16); granite
   at capacity factor 5, where no expert can drop a token at 1 or 2
   model ranks (at its 1.25 the reference's capacities, and so its
   drops, depend on the model ranks). 19b: hymba-1.5B in bf16, one
   AdamW step on 2 x 2,048 tokens in 2 microbatches (2 rows do not
   divide over 2 ranks x 2 microbatches), placed by ``specs`` against
   the unsharded step (rank 0, computed and freed before the ranks
   place anything), held as phase 17 holds its steps; its FLOPs and ms
   from one run of each step (the ms with the count's host work).

Needs one CUDA card; imports neither JAX nor the reference package.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12       # fp32 outside the tensor cores
# the main path's graph and plan: the paper's graph500 shape at its
# smallest vertex count, which plans both Little and Big lanes
SCALE, EDGE_FACTOR, SEED, N_LANES = 19, 56, 23, 8
REPS = 5                          # timed repetitions after one warm-up
GEOMETRIES = [(128, 512, 512), (256, 512, 512), (128, 1024, 512),
              (128, 512, 1024)]
# (mode, scatter op) pairs the kernel implements
MODE_OPS = [("sum", "copy"), ("sum", "add_weight"), ("min", "copy"),
            ("min", "add_weight"), ("max", "copy"), ("max", "add_weight"),
            ("or", "copy")]
CHUNK_SWEEP = (2048, 4096, 8192)  # the chunk sizes CHUNK_EDGES is chosen from


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


HOST_AHEAD_CYCLES = int(1e8)      # ~50 ms of device spin before a timing


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs (CUDA
    events, after one warm-up run). The card first spins for
    ``HOST_AHEAD_CYCLES``, so the host has queued every launch before
    the first event: the time is the device's, not the host's rate of
    issuing launches."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOST_AHEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fp32_sum_share(got, plain64) -> float:
    """How much of the worst-case error of an in-order fp32 sum ``got``
    uses, slot by slot, against the exact sum (largest share; a tree of
    the same terms errs less). Two correct fp32 sums of a slot's n terms
    in different orders differ by up to ~(n - 1) * 2**-24 of the sum,
    far above any fixed rtol at large in-degrees, hence this check:
        |got - exact| <= gamma(n - 1) * sum|terms|,
        gamma(m) = m u / (1 - m u),  u = 2**-24.
    ``plain64(f)`` is the plain version's fp64 sum of ``f`` over each
    slot's terms (the scattered values, rounded to fp32 as the kernel
    rounds them)."""
    import torch
    mu = (plain64(torch.ones_like) - 1).clamp_min(0) * 2.0 ** -24
    allowed = mu / (1 - mu) * plain64(torch.abs)
    gap = (got.double() - plain64(lambda v: v)).abs()
    check(bool((gap <= allowed).all()),
          f"off the exact sum by {float(gap.max())}, beyond fp32 summation "
          "error")
    return float((gap / allowed.clamp_min(1e-300)).max())


# ---------------------------------------------------------------------------
# Phase 2: kernel vs plain version
# ---------------------------------------------------------------------------

def _host_payloads(geom, seed: int):
    """Per-entry and packed host payloads of both kinds on a small R-MAT
    graph: Little on the first partitions, Big on batches of the rest;
    packed groups mix split entries (Big: a shared compaction table) and
    whole works (Big: a second table, rebased)."""
    import numpy as np
    from repro_torch.core import partition as part
    from repro_torch.graphs.rmat import rmat
    from repro_torch.kernels import ops

    g = rmat(13, 16, seed=seed, weighted=True)
    graph, _ = part.apply_dbg(g)
    infos, edges = part.partition_graph(graph, geom)
    infos = [i for i in infos if i.num_edges > 0]
    check(len(infos) >= 4, f"sweep graph has {len(infos)} partitions")
    little = [part.block_little(edges, i, geom) for i in infos[:2]]
    half = max(1, (len(infos) - 2) // 2)
    big = [part.block_big(edges, infos[2:2 + half], geom),
           part.block_big(edges, infos[2 + half:], geom)]
    out = []
    for kind, works in (("little", little), ("big", big)):
        w0 = works[0]
        out.append((kind, "entry", ops._entry_np(w0, 0, w0.n_blocks)))
        thirds = np.linspace(0, w0.n_blocks, 4).astype(int)
        parts = [ops._entry_np(w0, int(lo), int(hi))
                 for lo, hi in zip(thirds[:-1], thirds[1:])]
        parts = [p for p in parts if p is not None]
        parts.append(ops._entry_np(works[1], 0, works[1].n_blocks))
        out.append((kind, "packed", ops._pack_group(parts)))
    return graph.num_vertices, out


def _heavy_tile(geom, device, rng):
    """Padded blocks of four tiles, the first of about 10.5 chunks of
    live edges: half of its edges go to one hub slot, a quarter of all
    slots are pads scattered through the blocks (not a prefix), and the
    last tile has no live edge."""
    import numpy as np
    import torch
    from repro_torch.kernels import gas_kernel

    n_win = 4
    c = -(-gas_kernel.CHUNK_EDGES * 4 // (3 * geom.E_BLK))  # blocks a chunk
    sizes = [10 * c + c // 2, 3, c + 1, 2]
    tile_id = np.repeat(np.arange(4), sizes).astype(np.int32)
    shape = (tile_id.shape[0], geom.E_BLK)
    dst = rng.integers(0, geom.T, shape)
    dst[(rng.random(shape) < 0.5) & (tile_id[:, None] == 0)] = 17
    arrays = {
        "src_local": rng.integers(0, geom.W, shape),
        "dst_local": dst,
        "weights": rng.random(shape, dtype=np.float32),
        "valid": (rng.random(shape) >= 0.25) & (tile_id[:, None] != 3),
        "window_id": rng.integers(0, n_win, shape[0]),
        "tile_id": tile_id,
    }
    return {k: torch.from_numpy(v.astype(
        np.float32 if k == "weights" else np.int32)).to(device)
        for k, v in arrays.items()}, sizes, n_win


def _launch_blocks(a, vwin, geom, mode, op, lo=0, hi=None):
    """The kernel on blocks [lo, hi) of ``a`` (whole tiles), over the
    live-edge stream derived from them."""
    import torch
    from repro_torch.kernels import gas_kernel, ops
    from repro_torch.kernels.little_pipeline import _blocked

    tid = a["tile_id"][lo:hi].cpu().numpy()
    tid = tid - tid[0]
    blocks = {k: a[k][lo:hi] for k in ("src_local", "dst_local", "weights",
                                       "valid", "window_id")}
    blocks["tile_block_start"] = torch.from_numpy(ops.tile_block_start(
        tid, int(tid[-1]) + 1)).to(vwin.device)
    blocks["num_real_edges"] = int(blocks["valid"].count_nonzero())
    blocks["geom"] = geom
    return gas_kernel.gas_tiles(
        vwin, *_blocked(ops.edge_stream(blocks, vwin.device)),
        scatter_op=op, mode=mode, t=geom.T)


def phase_heavy_tile(device, seed: int) -> dict:
    """The heavy tile in every mode/op pair: kernel == plain, bit-stable,
    and packed == its tiles launched one by one; min, max and or go
    through the order-free fold (their launches count their edges as
    exact)."""
    import numpy as np
    import torch
    from repro_torch.core.gas import SCATTER_OPS
    from repro_torch.core.types import Geometry
    from repro_torch.kernels import gas_kernel, ref

    geom = Geometry()
    rng = np.random.default_rng(seed)
    a, sizes, n_win = _heavy_tile(geom, device, rng)
    n = n_win * geom.W
    props = {"sum": rng.random(n, dtype=np.float32),
             "min": rng.standard_normal(n).astype(np.float32) * 4,
             "or": rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)}
    starts = np.cumsum([0] + sizes)
    share = 0.0
    for mode, op in MODE_OPS:
        vwin = torch.from_numpy(props.get(mode, props["min"])).to(
            device).view(n_win, geom.W)
        exact0 = gas_kernel.gas_tiles.exact_edges
        k1 = _launch_blocks(a, vwin, geom, mode, op)
        k2 = _launch_blocks(a, vwin, geom, mode, op)
        live = int(a["valid"].count_nonzero())
        check(gas_kernel.gas_tiles.exact_edges - exact0 == (
            2 * live if mode in gas_kernel.EXACT_MODES else 0),
            f"exact edges miscounted: {mode}/{op}")

        def plain(v, scatter_fn=SCATTER_OPS[op]):
            return ref.gas_ref(v, a["src_local"], a["dst_local"],
                               a["weights"], a["valid"], a["window_id"],
                               a["tile_id"], scatter_fn=scatter_fn,
                               mode=mode, t=geom.T, n_out_tiles=len(sizes))
        torch.cuda.synchronize()
        case = f"heavy tile ({sizes[0]} blocks) {mode}/{op}"
        check(torch.equal(k1, k2), f"kernel not bit-stable: {case}")
        if mode == "sum":
            share = max(share, fp32_sum_share(k1, lambda f: plain(
                vwin.double(), lambda x, wt: f(
                    SCATTER_OPS[op](x.float(), wt).double()))))
        else:
            check(torch.equal(k1, plain(vwin)), f"kernel != plain: {case}")
        for k, (lo, hi) in enumerate(zip(starts[:-1], starts[1:])):
            check(torch.equal(k1[k], _launch_blocks(
                a, vwin, geom, mode, op, lo, hi)[0]),
                f"packed != per-entry tile {k}: {case}")
    return {"cases": len(MODE_OPS), "blocks": sizes,
            "sum_fp32_bound_used": share}


def _padded_plain(host, vprops, fn, mode):
    """``ref.gas_ref`` on a host payload's padded blocks, on vprops'
    device: the plain version the kernel over the uploaded stream is
    held to (a device payload holds no padded array)."""
    import torch
    from repro_torch.kernels import ref

    dev, geom = vprops.device, host["geom"]
    vwin = (vprops[torch.from_numpy(host["unique_src"]).to(dev)]
            if host["kind"] == "big" else vprops).view(-1, geom.W)
    blocks = [torch.from_numpy(host[k]).to(dev) for k in (
        "src_local", "dst_local", "weights", "valid", "window_id",
        "tile_id")]
    return ref.gas_ref(vwin, *blocks, scatter_fn=fn, mode=mode, t=geom.T,
                       n_out_tiles=host["n_out_tiles"])


def phase_kernel_vs_plain(device, seed: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import partition as part
    from repro_torch.core.gas import SCATTER_OPS
    from repro_torch.core.types import Geometry
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    n_cases, worst_sum = 0, 0.0
    for e_blk, w, t in GEOMETRIES:
        geom = Geometry(U=max(w, t), W=w, T=t, E_BLK=e_blk, big_batch=2)
        num_v, payloads = _host_payloads(geom, seed)
        V_pad = part.padded_num_vertices(num_v, geom)
        # sum: values in [0, 1) as in the reference's kernel tests (signed
        # values cancel, and rtol then says nothing); min/max: signed
        sprops = torch.from_numpy(
            rng.random(V_pad, dtype=np.float32)).to(device)
        fprops = torch.from_numpy(
            rng.standard_normal(V_pad).astype(np.float32) * 4).to(device)
        iprops = torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, V_pad, dtype=np.int64).astype(
                np.int32)).to(device)
        for kind, form, host in payloads:
            p = ops._upload_payload(host, device)
            for mode, op in MODE_OPS:
                vp = {"or": iprops, "sum": sprops}.get(mode, fprops)
                fn = SCATTER_OPS[op]
                k1, _ = ops.run_lane(p, vp, fn, mode, "cuda", op)
                k2, _ = ops.run_lane(p, vp, fn, mode, "cuda", op)
                ref = _padded_plain(host, vp, fn, mode)
                torch.cuda.synchronize()
                case = (f"E_BLK={e_blk} W={w} T={t} {kind} {form} "
                        f"{mode}/{op}")
                check(torch.equal(k1, k2), f"kernel not bit-stable: {case}")
                # the card's scatter_reduce adds in no fixed order
                stream_ref, _ = ops.run_lane(p, vp, fn, mode, "ref", op)
                check(torch.allclose(stream_ref, ref, rtol=1e-5, atol=1e-5)
                      if mode == "sum" else torch.equal(stream_ref, ref),
                      f"plain path over the stream != padded plain: {case}")
                if mode == "sum":
                    err = float((k1 - ref).abs().max())
                    worst_sum = max(worst_sum, err)
                    check(torch.allclose(k1, ref, rtol=1e-5, atol=1e-5),
                          f"kernel != plain (max abs err {err}): {case}")
                    fp32_sum_share(k1, lambda f: _padded_plain(
                        host, vp.double(), lambda x, wt: f(fn(
                            x.float(), wt).double()), mode))
                else:
                    check(torch.equal(k1, ref), f"kernel != plain: {case}")
                n_cases += 1
    return {"cases": n_cases, "sum_max_abs_err": worst_sum}


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def _max_rel(a, b) -> float:
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    den = np.maximum(np.abs(b), np.finfo(np.float32).tiny)
    return float(np.max(np.abs(a - b) / den)) if a.size else 0.0


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def phase_main_path(device, scale=SCALE, edge_factor=EDGE_FACTOR, seed=SEED,
                    n_lanes=N_LANES, reps=REPS) -> dict:
    """The main path at ``rmat(scale, edge_factor, seed)``; the script
    runs it at the module's constants (a rehearsal on the CPU may import
    it and pass a small scale)."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.graphs.rmat import rmat
    from repro_torch.kernels import gas_kernel, ops, ref

    res = {}
    t0 = time.perf_counter()
    graph = rmat(scale, edge_factor, seed=seed)
    res["t_rmat_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = api.GraphStore(graph, geom=api.Geometry())
    res["t_store_s"] = time.perf_counter() - t0
    config = api.PlanConfig(n_lanes=n_lanes)
    t0 = time.perf_counter()
    bundle = store.plan(config)
    res["t_plan_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lanes = bundle.packed_lanes(device)
    _sync(device)
    res["t_pack_s"] = time.perf_counter() - t0
    payloads = [p for lane in lanes for p in lane]
    plan = bundle.plan
    res.update(V=graph.num_vertices, E=graph.num_edges,
               little_lanes=plan.num_little_lanes,
               big_lanes=plan.num_big_lanes, payloads=len(payloads),
               dense=len(bundle.dense), sparse=len(bundle.sparse),
               n_blocks=sum(p["n_blocks"] for p in payloads),
               n_out_tiles=sum(p["n_out_tiles"] for p in payloads),
               payload_bytes=sum(ops.payload_nbytes(p) for p in payloads))
    log(f"main path graph: {json.dumps(res)}")
    check(plan.num_little_lanes > 0 and plan.num_big_lanes > 0,
          f"plan has {plan.num_little_lanes} Little and "
          f"{plan.num_big_lanes} Big lanes; both are needed")
    check({p["kind"] for p in payloads} == {"little", "big"},
          "packed payloads do not hold both input forms")

    # -- the kernel path, counted ------------------------------------
    gas_kernel.gas_tiles.launches = 0
    pr_k = api.compile(None, "pagerank", store=store, config=config,
                       device=device)
    pr_props, pr_meta = pr_k.run(collect_history=True)
    bfs_k = api.compile(None, "bfs", store=store, config=config,
                        device=device)
    bfs_props, bfs_meta = bfs_k.run()
    _sync(device)
    res["launches"] = gas_kernel.gas_tiles.launches
    res["launches_per_iteration"] = len(payloads)
    res["iterations"] = {"pagerank": pr_meta["iterations"],
                         "bfs": bfs_meta["iterations"]}
    check(res["launches"] == len(payloads) * (pr_meta["iterations"]
                                              + bfs_meta["iterations"]),
          f"kernel launched {res['launches']} times on the main path; "
          f"expected one per payload per iteration")
    check(res["launches"] > 0, "the main path never launched the kernel")

    # -- the plain path on the same card --------------------------------
    pr_r = api.compile(None, "pagerank", store=store, config=config,
                       device=device, path="ref")
    pr_props_r, pr_meta_r = pr_r.run(collect_history=True)
    bfs_r = api.compile(None, "bfs", store=store, config=config,
                        device=device, path="ref")
    bfs_props_r, bfs_meta_r = bfs_r.run()
    check(bfs_meta["iterations"] == bfs_meta_r["iterations"]
          and np.array_equal(bfs_props, bfs_props_r),
          "BFS on the kernel path != BFS on the plain path")
    check(np.isfinite(pr_props).all()
          and pr_props.shape == (graph.num_vertices,),
          "PageRank result is not finite / misshapen")
    n_common = min(pr_meta["iterations"], pr_meta_r["iterations"])
    check(abs(pr_meta["iterations"] - pr_meta_r["iterations"]) <= 1,
          f"PageRank iterations {pr_meta['iterations']} vs "
          f"{pr_meta_r['iterations']}")
    hk, hr = pr_meta["history"][n_common - 1], pr_meta_r["history"][
        n_common - 1]
    res["pagerank_max_rel_err_vs_plain"] = _max_rel(hk, hr)
    check(np.allclose(hk, hr, rtol=1e-5, atol=1e-7),
          f"PageRank kernel vs plain path: max rel err "
          f"{res['pagerank_max_rel_err_vs_plain']}")
    res["bfs_reached"] = int((bfs_props < 1e38).sum())

    # -- one gather against the edge-list oracle -------------------------
    ex = pr_k.executor
    vprops = ex.init_props()
    acc = ex.gather(vprops)
    g2 = store.graph
    oracle = ref.edge_ref(torch.from_numpy(g2.src.astype(np.int64)).to(device),
                          torch.from_numpy(g2.dst.astype(np.int64)).to(device),
                          torch.zeros(g2.num_edges, device=device), vprops,
                          pr_k.app.scatter, "sum", store.V_pad)
    res["gather_max_rel_err_vs_edge_ref"] = _max_rel(acc.cpu(), oracle.cpu())
    check(torch.allclose(acc, oracle, rtol=1e-4, atol=0),
          f"one PageRank gather vs edge_ref: max rel err "
          f"{res['gather_max_rel_err_vs_edge_ref']}")

    # -- per-iteration times ---------------------------------------------
    res["iteration_ms"] = {
        "pagerank_kernel": pr_k.time_iteration(reps) * 1e3,
        "pagerank_plain": pr_r.time_iteration(reps) * 1e3,
        "bfs_kernel": bfs_k.time_iteration(reps) * 1e3,
        "bfs_plain": bfs_r.time_iteration(reps) * 1e3,
    }
    res["_store"], res["_payloads"], res["_vprops"] = store, payloads, vprops
    res["_pr"], res["_bfs"], res["_config"] = pr_k, bfs_k, config
    res["_pr_history"] = pr_meta["history"]
    res["_bfs_result"] = (bfs_props, bfs_meta["iterations"])
    res["_graph"], res["_pr_plain"] = graph, pr_r
    return res


# ---------------------------------------------------------------------------
# Phase 4: measurements and the kernels line
# ---------------------------------------------------------------------------

def _bound_ms(calls) -> tuple:
    """(bound ms, what bounds it, bytes) of the sum/copy launches: the
    bytes and operations each launch must at least move and do on this
    run's data (``obs.launch_traffic``: src and dst of every live edge
    of the payload's stream; the tile edge and chunk indices; each
    distinct source value the edges read, once; the output tiles; one
    combine per live edge)."""
    from repro_torch.obs import launch_traffic
    nbytes = n_ops = 0
    for _, p in calls:
        b, o = launch_traffic(p, "copy")
        nbytes, n_ops = nbytes + b, n_ops + o
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = n_ops / H100_FP32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes)


def _calls(payloads, vprops, geom):
    """(vwin, payload) per launch: the Big gathers done beforehand."""
    return [((vprops[p["unique_src"]] if p["kind"] == "big" else vprops)
             .view(-1, geom.W), p) for p in payloads]


def _stream_slots(p, t: int):
    """(vertex slot, ``vwin`` index) of every live edge of device payload
    ``p``, in stream order: the destination's slot in the padded vertex
    vector, and where its source value lies in the launch's ``vwin``."""
    import torch
    counts = torch.diff(p["tile_edge_start"].to(torch.int64))
    tile = p["tile_idx"].to(torch.int64).repeat_interleave(counts)
    return (tile * t + p["edge_dst"].to(torch.int64),
            p["edge_src"].to(torch.int64))


def _library_ms(calls, geom, v_pad: int, device, reps: int) -> float:
    """The library yardstick: one ``scatter_reduce`` of the pre-gathered,
    pad-free values of every launch in ``calls`` into the padded vertex
    vector (device ms)."""
    import torch
    idx_parts, val_parts = [], []
    for vwin, p in calls:
        idx, src = _stream_slots(p, geom.T)
        val_parts.append(vwin.reshape(-1)[src])
        idx_parts.append(idx)
    idx, vals = torch.cat(idx_parts), torch.cat(val_parts)
    out = torch.zeros(v_pad, device=device)
    return cuda_ms(lambda: out.zero_().scatter_reduce_(
        0, idx, vals, reduce="sum", include_self=True), reps)


def _pagerank_launch(vwin, p, geom, tcs=None, chunk_edges=None):
    from repro_torch.kernels import gas_kernel
    from repro_torch.kernels.little_pipeline import _blocked

    arrays = _blocked(p)
    if tcs is not None:
        arrays = arrays[:-1] + (tcs,)
    return gas_kernel.gas_tiles(
        vwin, *arrays, scatter_op="copy", mode="sum", t=geom.T,
        chunk_edges=chunk_edges or gas_kernel.CHUNK_EDGES)


def _pagerank_plain(vwin, p, geom, f=lambda x: x):
    """The plain version of a PageRank launch over the payload's stream,
    summing ``f`` of each term."""
    from repro_torch.kernels import ref

    return ref.gas_stream_ref(
        vwin, p["edge_src"], p["edge_dst"], p["edge_w"],
        p["tile_edge_start"], scatter_fn=lambda x, w: f(x), mode="sum",
        t=geom.T, n_out_tiles=p["n_out_tiles"])


def _held_to_plain(calls, geom, what: str) -> dict:
    """Each launch of ``calls`` (PageRank, sum mode) against its plain
    version on the same payload: slot by slot within the fp32 in-order
    summation error of the exact sum (as :func:`fp32_sum_share`), and
    its largest gap to the plain fp32 sum."""
    share = err = 0.0
    try:
        for vwin, p in calls:
            k = _pagerank_launch(vwin, p, geom)
            share = max(share, fp32_sum_share(
                k, lambda f, v=vwin, q=p: _pagerank_plain(v.double(), q,
                                                          geom, f)))
            err = max(err, float(
                (k - _pagerank_plain(vwin, p, geom)).abs().max()))
    except CheckFailed as exc:
        raise CheckFailed(f"{what}: {exc}") from None
    return {"fp32_sum_bound_used": share, "max_abs_err": err}


def phase_kernel_line(main_res: dict, device, reps: int = REPS):
    """Times the GAS kernel on the main path's 8 payloads (PageRank, sum
    mode, one iteration's worth of launches) at each chunk size of the
    sweep, beside the plain version, one library ``scatter_reduce`` and
    the bound; then each launch alone."""
    import torch
    from repro_torch.kernels import gas_kernel

    store, payloads, vprops = (main_res["_store"], main_res["_payloads"],
                               main_res["_vprops"])
    geom = store.geom
    calls = _calls(payloads, vprops, geom)

    def plain(vwin, p, f=lambda x: x):
        return _pagerank_plain(vwin, p, geom, f)

    def run_plain():
        return [plain(vwin, p) for vwin, p in calls]

    # each chunk size of the sweep, in turns (forward, then backward),
    # every launch within fp32 summation error of the exact sum
    exact = [(lambda f, v=vwin, q=p: plain(v.double(), q, f))
             for vwin, p in calls]
    sweep, kernel_out, share = {}, None, 0.0
    for c in CHUNK_SWEEP:
        tcs = [gas_kernel.tile_chunk_start(p["tile_edge_start"], c)
               for _, p in calls]
        run = (lambda c=c, tcs=tcs: [
            _pagerank_launch(vwin, p, geom, tc, c)
            for (vwin, p), tc in zip(calls, tcs)])
        out = run()
        for k, plain64 in zip(out, exact):
            share = max(share, fp32_sum_share(k, plain64))
        if c == gas_kernel.CHUNK_EDGES:
            kernel_out = out
        sweep[c] = {"run": run, "ms": [],
                    "ctas": sum(int(tc[-1]) for tc in tcs)}
    for c in list(CHUNK_SWEEP) + list(reversed(CHUNK_SWEEP)):
        sweep[c]["ms"].append(cuda_ms(sweep[c]["run"], reps))
    chunk_sweep = {c: {"ms": sum(v["ms"]) / len(v["ms"]), "ctas": v["ctas"]}
                   for c, v in sweep.items()}
    kernel_ms = chunk_sweep[gas_kernel.CHUNK_EDGES]["ms"]
    plain_out = run_plain()
    err = max(float((k - r).abs().max())
              for k, r in zip(kernel_out, plain_out))
    rel = max(_max_rel(k.cpu(), r.cpu())
              for k, r in zip(kernel_out, plain_out))
    plain_ms = cuda_ms(run_plain, reps)

    # each launch alone: its time beside its CTAs and real edges
    per_payload = []
    for vwin, p in calls:
        edges = torch.diff(p["tile_edge_start"]).cpu()
        per_payload.append({
            "kind": p["kind"], "n_blocks": p["n_blocks"],
            "n_out_tiles": p["n_out_tiles"],
            "max_tile_edges": int(edges.max()),
            "ctas": int(p["tile_chunk_start"][-1]),
            "grid": gas_kernel.max_chunks(int(p["edge_src"].numel()),
                                          p["n_out_tiles"]),
            "real_edges": int(p["num_real_edges"]),
            "ms": cuda_ms(lambda: _pagerank_launch(vwin, p, geom), reps)})

    library_ms = _library_ms(calls, geom, store.V_pad, device, reps)

    bound_ms, bound_by, nbytes = _bound_ms(calls)
    return {
        "name": "gas_tile_kernel",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gas_kernel.cu",
        "replaces": "src/repro/kernels/gas_kernel.py:67",
        "modes": ["sum", "min", "max", "or"],
        "launches": main_res["launches"],
        "max_abs_err": err,
        "max_rel_err": rel,
        "fp32_sum_bound_used": share,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "bound_bytes": nbytes,
        "chunk_edges": gas_kernel.CHUNK_EDGES,
        "ctas": chunk_sweep[gas_kernel.CHUNK_EDGES]["ctas"],
        "chunk_sweep": chunk_sweep,
        "shapes": "PageRank sum/copy, one iteration's launches "
                  f"({len(payloads)} payloads)",
    }, per_payload


def phase_per_entry(main_res: dict, device, reps: int = REPS) -> dict:
    """The per-entry form (``fuse_lanes=False``) at the smoke graph: its
    launches per iteration, their time, the plain version's time on the
    same entries and the bound, its iteration time, and one gather
    bit-equal to the fused form's. (The library yardstick is the one of
    the packed form: the same edges into the same vector.)"""
    import torch
    from repro_torch import api

    store, vprops = main_res["_store"], main_res["_vprops"]
    geom = store.geom
    pr_e = api.compile(None, "pagerank", store=store,
                       config=main_res["_config"], device=device,
                       fuse_lanes=False)
    entries = [p for lane in pr_e.executor.lanes for p in lane]
    check(torch.equal(pr_e.executor.gather(vprops),
                      main_res["_pr"].executor.gather(vprops)),
          "per-entry gather != fused gather")
    calls = _calls(entries, vprops, geom)
    bound_ms, bound_by, nbytes = _bound_ms(calls)
    return {
        "launches_per_iteration": len(entries),
        "kernel_ms": cuda_ms(lambda: [_pagerank_launch(vwin, p, geom)
                                      for vwin, p in calls], reps),
        "plain_ms": cuda_ms(lambda: [_pagerank_plain(vwin, p, geom)
                                     for vwin, p in calls], reps),
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
        "ctas": sum(int(p["tile_chunk_start"][-1]) for p in entries),
        "iteration_ms": pr_e.time_iteration(reps) * 1e3,
    }


def phase_breakdown(main_res: dict, device, reps: int = REPS) -> dict:
    """One PageRank iteration split into its steps: the Big gathers, the
    GAS launches, the merge (identity fill + ``merge_all``), Apply and
    the convergence test (its reduction and the host's read of the
    result). Device ms from CUDA events with the host queued ahead (as
    in :func:`cuda_ms`). Host ms from the host clock: the time to issue
    the steps before the convergence test, and the whole iteration to
    the end of the convergence test, which waits for the device. Means
    of ``reps`` after a warm-up. The steps are the executor's own, run
    one by one; their result must equal ``Executor.iteration`` bit for
    bit."""
    import time as _time

    import torch
    from repro_torch.core.gas import GATHER_IDENTITY
    from repro_torch.kernels import ops

    ex = main_res["_pr"].executor
    app, geom, vprops = ex.app, ex.geom, ex.init_props()

    def steps(mark):
        calls = _calls(main_res["_payloads"], vprops, geom)
        mark()
        outs = [(_pagerank_launch(vwin, p, geom), p["tile_idx"])
                for vwin, p in calls]
        mark()
        accum = torch.full((ex.V_pad,), float(GATHER_IDENTITY[app.gather]),
                           dtype=ex.accum_dtype, device=device)
        accum = ops.merge_all(accum, outs, geom.T)
        mark()
        new = app.apply(accum, vprops, ex.aux, 0)
        mark()
        app.converged(vprops, new, 0)
        mark()
        return new

    host_ms = {"issue": 0.0, "iteration": 0.0}
    for r in range(reps + 1):
        clock = []
        torch.cuda.synchronize()
        t0 = _time.perf_counter()
        steps(lambda: clock.append(_time.perf_counter()))
        if r:
            host_ms["issue"] += (clock[3] - t0) * 1e3 / reps
            host_ms["iteration"] += (clock[4] - t0) * 1e3 / reps
    names = ("big_gathers", "gas_launches", "merge", "apply", "converged")
    dev_ms = dict.fromkeys(names, 0.0)
    for r in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        torch.cuda.synchronize()
        torch.cuda._sleep(HOST_AHEAD_CYCLES)
        ev[0].record()
        marks = iter(ev[1:])
        new = steps(lambda: next(marks).record())
        torch.cuda.synchronize()
        if r:
            for i, name in enumerate(names):
                dev_ms[name] += ev[i].elapsed_time(ev[i + 1]) / reps
    check(torch.equal(new, ex.iteration(vprops, 0)),
          "breakdown's steps != Executor.iteration")
    # the Big gathers' bound: each lane's unique_src ids read, and each
    # value they pick read once and written once, over the card's rate
    ids = [p["unique_src"] for p in main_res["_payloads"]
           if p["kind"] == "big"]
    gather_bytes = sum(i.numel() * (i.element_size()
                                    + 2 * vprops.element_size())
                       for i in ids)
    return {"device_ms": dev_ms, "host_ms": host_ms,
            "big_gather_bytes": gather_bytes,
            "big_gather_bound_ms": gather_bytes / H100_BYTES_PER_S * 1e3}


# the shapes of urand20's Big lanes: GAP urand at scale 20 (2**20
# vertices, 33.55 M edges stored both ways) as uniform sources over 2**20
# vertices, in-degree 32, and the batches of its Big blocking that phase 4
# times (4 of 16, 2 a payload as the port's plan packs them on 8 lanes);
# only those batches' destinations get edges, which is what their blocks
# hold in the whole graph, at a quarter of the host's preparation
URAND_SCALE, URAND_DEGREE, URAND_BATCHES = 20, 32, 4


def phase_urand_big(device, reps: int = REPS, scale: int = URAND_SCALE,
                    batches: int = URAND_BATCHES) -> dict:
    """The GAS kernel at the shapes of urand20's Big lanes: the live
    share of the padded blocks, and per launch form (PageRank sum/copy
    through the ordered fold, SSSP min/add_weight through the order-free
    one) the kernel's time beside the bound of the stream it reads
    (``obs.launch_traffic``), each launch held to the plain version."""
    import numpy as np
    import torch
    from repro_torch.core import partition as part
    from repro_torch.core.gas import SCATTER_OPS
    from repro_torch.core.types import Geometry
    from repro_torch.graphs.formats import from_edges
    from repro_torch.kernels import gas_kernel, ops
    from repro_torch.kernels.little_pipeline import _blocked
    from repro_torch.obs import launch_traffic

    geom = Geometry()
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    n, n_dst = 1 << scale, batches * geom.big_batch * geom.U
    m = n_dst * URAND_DEGREE
    src, dst = rng.integers(0, n, m), rng.integers(0, n_dst, m)
    keep = src != dst
    g = from_edges(src[keep], dst[keep], num_vertices=n,
                   weights=rng.integers(1, 256, int(keep.sum())))
    infos, edges = part.partition_graph(g, geom)
    size = geom.big_batch
    works = [part.block_big(edges, infos[b * size:(b + 1) * size], geom)
             for b in range(batches)]
    payloads = [ops._upload_payload(ops._pack_group(
        [ops._entry_np(w, 0, w.n_blocks) for w in works[i:i + 2]]), device)
        for i in range(0, batches, 2)]
    v_pad = part.padded_num_vertices(g.num_vertices, geom)
    res = {"V": g.num_vertices, "E": g.num_edges, "batches": batches,
           "payloads": len(payloads), "t_prep_s": time.perf_counter() - t0,
           "padded_slots": sum(p["n_blocks"] * geom.E_BLK for p in payloads),
           "live_edges": sum(int(p["edge_src"].numel()) for p in payloads),
           # the padded slabs stay on the host; the card holds the stream
           "padded_bytes": sum(ops.payload_footprint(p)["edge_bytes"]
                               for p in payloads),
           "stream_bytes": sum(ops.payload_footprint(p)["stream_bytes"]
                               for p in payloads)}
    res["live_share"] = res["live_edges"] / res["padded_slots"]
    gen = torch.Generator(device=device).manual_seed(SEED)
    vprops = torch.rand(v_pad, generator=gen, device=device)
    calls = _calls(payloads, vprops, geom)
    res["forms"] = {}
    for mode, op in (("sum", "copy"), ("min", "add_weight")):
        fn = SCATTER_OPS[op]

        def run(mode=mode, op=op):
            return [ops.run_lane(p, vprops, SCATTER_OPS[op], mode, "cuda",
                                 op)[0] for p in payloads]
        for got, p in zip(run(), payloads):
            want = ops.run_lane(p, vprops, fn, mode, "ref", op)[0]
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-5)
                  if mode == "sum" else torch.equal(got, want),
                  f"urand Big lanes {mode}/{op}: kernel != plain")
        nbytes = n_ops = 0
        for _, p in calls:
            b, o = launch_traffic(p, op)
            nbytes, n_ops = nbytes + b, n_ops + o
        bound_ms = max(nbytes / H100_BYTES_PER_S,
                       n_ops / H100_FP32_OPS_PER_S) * 1e3
        # the launches alone: the Big gathers done beforehand
        kernel_ms = cuda_ms(lambda mode=mode, op=op: [
            gas_kernel.gas_tiles(vwin, *_blocked(p), scatter_op=op,
                                 mode=mode, t=geom.T) for vwin, p in calls],
            reps)
        res["forms"][f"{mode}/{op}"] = {
            "fold": ("order-free" if mode in gas_kernel.EXACT_MODES
                     else "ordered"),
            "kernel_ms": kernel_ms, "bound_ms": bound_ms,
            "bound_bytes": nbytes, "roofline_pct": 100 * bound_ms / kernel_ms,
            "ctas": sum(int(p["tile_chunk_start"][-1]) for p in payloads)}
    return res


# ---------------------------------------------------------------------------
# Phases 5-7: the sharded path, a streaming delta, utilization
# ---------------------------------------------------------------------------

def _counted(fn):
    """``fn()`` with the kernel's launch count set to 0 just before it and
    read just after: (result, launches)."""
    import torch
    from repro_torch.kernels import gas_kernel

    gas_kernel.gas_tiles.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, gas_kernel.gas_tiles.launches


def _same(a, b) -> bool:
    """Bit-equal results (numpy arrays of ``run``), as ``torch.equal``."""
    import torch
    return torch.equal(torch.from_numpy(a), torch.from_numpy(b))


def _pr_bfs(store, config, pr_iters: int = 4, **where):
    """PageRank (``pr_iters`` iterations) and BFS (to convergence) on
    ``store``: ((pr props, pr iterations), (bfs props, bfs iterations),
    (pr app, bfs app))."""
    from repro_torch import api
    pr = api.compile(None, "pagerank", store=store, config=config, **where)
    bfs = api.compile(None, "bfs", store=store, config=config, **where)
    a, ma = pr.run(max_iters=pr_iters)
    b, mb = bfs.run()
    return (a, ma["iterations"]), (b, mb["iterations"]), (pr, bfs)


def _shard_forms(device) -> list:
    """(label, shard=) of the sharded forms the smoke drives."""
    import torch
    forms = [("1 owner", 1),
             ("2 owners on one card", [device, device])]
    if torch.cuda.device_count() > 1:
        forms.append((f"every card ({torch.cuda.device_count()})", True))
    return forms


def phase_sharded(main_res: dict, device, reps: int = REPS) -> dict:
    """The sharded path on the main path's store: each form bit-equal to
    fused, one merge per iteration, launches counted; for one owner the
    kernel on the sharded payloads held against the plain version slot
    by slot, and timed beside plain, bound and library."""
    import torch

    store, config = main_res["_store"], main_res["_config"]
    vprops, geom = main_res["_vprops"], store.geom
    fused_pr, fused_bfs, (pr_f, _) = _pr_bfs(store, config, device=device)
    fused_gather = pr_f.executor.gather(vprops)
    out = {"fused_iteration_ms": pr_f.time_iteration(reps) * 1e3,
           "forms": {}}
    for label, shard in _shard_forms(device):
        (pr, bfs, (pr_s, bfs_s)), launches = _counted(
            lambda: _pr_bfs(store, config, shard=shard))
        ex = pr_s.executor
        per_iter = ex.dispatch_stats()["kernel_dispatches"]
        check(launches > 0, f"sharded ({label}) never launched the kernel")
        check(launches == per_iter * (pr[1] + bfs[1]),
              f"sharded ({label}) launched the kernel {launches} times; "
              f"expected {per_iter} per iteration")
        check(pr[1] == fused_pr[1] and _same(pr[0], fused_pr[0]),
              f"sharded ({label}) PageRank != fused")
        check(bfs[1] == fused_bfs[1] and _same(bfs[0], fused_bfs[0]),
              f"sharded ({label}) BFS != fused")
        check(torch.equal(ex.gather(vprops), fused_gather),
              f"sharded ({label}) gather != fused gather")
        last = ex.dispatch_stats()["last_iteration"]
        check(last["merges"] == 1 and sum(last["launches_per_device"])
              == per_iter, f"sharded ({label}) iteration dispatched {last}")
        out["forms"][label] = {
            "devices": [str(d) for d in ex.devices],
            "launches": launches,
            "launches_per_iteration": last["launches_per_device"],
            "merges_per_iteration": last["merges"],
            "iteration_ms": pr_s.time_iteration(reps) * 1e3,
            "device_bytes": ex.memory_footprint(),
            "bytes_per_device": ex.sharded.bytes_per_device(),
            "t_materialize_s": ex.t_materialize,
            "iterations": {"pagerank": pr[1], "bfs": bfs[1]},
        }
        if shard == 1:
            calls = _calls([p for ps in ex._dev_payloads for p in ps],
                           vprops, geom)
            bound_ms, bound_by, _ = _bound_ms(calls)
            out["kernel"] = {
                "launches_per_iteration": len(calls),
                **_held_to_plain(calls, geom, "kernel on the sharded "
                                 "payloads vs plain"),
                "kernel_ms": cuda_ms(lambda: [
                    _pagerank_launch(vwin, p, geom) for vwin, p in calls],
                    reps),
                "plain_ms": cuda_ms(lambda: [
                    _pagerank_plain(vwin, p, geom) for vwin, p in calls],
                    reps),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": _library_ms(calls, geom, store.V_pad, device,
                                          reps)}
    out["launches"] = sum(f["launches"] for f in out["forms"].values())
    out["placement"] = store.placement_stats()
    return out


def _tensor_ptrs(lanes) -> list:
    """Every tensor's ``data_ptr()`` of each lane's payloads."""
    import torch
    return [[v.data_ptr() for p in lane for v in p.values()
             if isinstance(v, torch.Tensor)] for lane in lanes]


def _reuse_checked(old_lanes, new_lanes, n_reused: int, what: str) -> int:
    """The lanes of ``new_lanes`` carried over from ``old_lanes`` are the
    same objects holding the same tensors; their count is ``n_reused``."""
    old_ptrs = {id(lane): ptrs for lane, ptrs in
                zip(old_lanes, _tensor_ptrs(old_lanes))}
    carried = [lane for lane in new_lanes if id(lane) in old_ptrs]
    check(len(carried) == n_reused,
          f"{what}: {len(carried)} lanes carried over, stats say {n_reused}")
    for lane, ptrs in zip(carried, _tensor_ptrs(carried)):
        check(ptrs == old_ptrs[id(lane)],
              f"{what}: a carried-over lane's tensors moved")
    return len(carried)


def phase_streaming(main_res: dict, device) -> dict:
    """One delta on the main path's store with the fused and sharded
    forms materialized: reuse, tensors kept in place, the kernel on the
    derived store's payloads held against the plain version (launch by
    launch, and PageRank and BFS against the plain path), and the
    derived store bit-equal to a cold rebuild, fused and sharded."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.streaming import (apply_delta, apply_delta_to_graph,
                                       random_delta)

    store, config, graph = (main_res["_store"], main_res["_config"],
                            main_res["_graph"])
    base = store.plan(config)
    old_packed = base.packed_lanes(device)
    forms = _shard_forms(device)
    old_sharded = {label: store.shard(config, shard)
                   for label, shard in forms}
    t0 = time.perf_counter()
    delta = random_delta(graph, churn=0.001, seed=SEED + 1, hot_frac=0.05,
                         grow_frac=0.0005)
    t_delta = time.perf_counter() - t0
    res = apply_delta(store, delta)
    torch.cuda.synchronize()
    st = res.stats
    check(st["packed_lanes_reused"] > 0,
          f"no packed lane was reused across the delta: {st}")
    check(st["shards_reused"] > 0,
          f"no sharded lane was reused across the delta: {st}")
    check(store.fingerprint() == graph.fingerprint(),
          "the base store's identity changed")
    derived = res.store.plan(config)
    _reuse_checked(old_packed, derived.packed_lanes(device),
                   derived.packed_lanes_reused, "packed form")
    for label, shard in forms:
        new_sh = res.store.shard(config, shard)
        _reuse_checked(old_sharded[label].lanes, new_sh.lanes,
                       new_sh.reused, f"sharded form ({label})")

    def run_all(s):
        return {"fused": _pr_bfs(s, config, device=device)[:2],
                **{label: _pr_bfs(s, config, shard=shard)[:2]
                   for label, shard in forms}}
    got, launches = _counted(lambda: run_all(res.store))
    check(launches > 0, "the derived store never launched the kernel")

    # the kernel on the post-delta shapes against the plain version:
    # every launch of one gather slot by slot (random properties, so a
    # wrong source shows), and the apps against the plain path
    gen = torch.Generator(device=device).manual_seed(SEED)
    vprops = torch.rand(res.store.V_pad, generator=gen, device=device)
    held = _held_to_plain(
        _calls([p for lane in derived.packed_lanes(device) for p in lane],
               vprops, res.store.geom),
        res.store.geom, "kernel on the derived store's payloads vs plain")
    (pr_r, n_pr_r), (bfs_r, n_bfs_r), _ = _pr_bfs(res.store, config,
                                                  device=device, path="ref")
    pr_err = 0.0
    for form, ((pr, n_pr), (bfs, n_bfs)) in got.items():
        pr_err = max(pr_err, _max_rel(pr, pr_r))
        check(n_pr == n_pr_r and np.allclose(pr, pr_r, rtol=1e-5,
                                             atol=1e-7),
              f"derived store PageRank ({form}) vs the plain path: max "
              f"rel err {_max_rel(pr, pr_r)}")
        check(n_bfs == n_bfs_r and np.array_equal(bfs, bfs_r),
              f"derived store BFS ({form}) != the plain path")

    t0 = time.perf_counter()
    post = apply_delta_to_graph(graph, delta)
    t_post = time.perf_counter() - t0
    t0 = time.perf_counter()
    cold = api.GraphStore(post, geom=store.geom, perm=res.store.perm)
    t_store = time.perf_counter() - t0
    t0 = time.perf_counter()
    cold_bundle = cold.plan(config)
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    cold_bundle.packed_lanes(device)
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    want = run_all(cold)
    for form, ((pr, n_pr), (bfs, n_bfs)) in got.items():
        (pr_c, n_pr_c), (bfs_c, n_bfs_c) = want[form]
        check(n_pr == n_pr_c and _same(pr, pr_c),
              f"derived store PageRank ({form}) != cold rebuild")
        check(n_bfs == n_bfs_c and _same(bfs, bfs_c),
              f"derived store BFS ({form}) != cold rebuild")
    return {
        "delta": {"adds": delta.num_adds, "removes": delta.num_removes,
                  "grown_vertices": st["grown_vertices"],
                  "t_random_delta_s": t_delta},
        "stats": st,
        "dirty_pids": list(res.dirty_pids),
        "launches": launches,
        "kernel_vs_plain": {**held,
                            "pagerank_max_rel_err_vs_plain": pr_err},
        "t_apply_ms": st["t_apply_ms"],
        "cold_ms": {"apply_delta_to_graph": t_post * 1e3,
                    "store": t_store * 1e3, "plan": t_plan * 1e3,
                    "pack": t_pack * 1e3,
                    "store_plan_pack": (t_store + t_plan + t_pack) * 1e3},
        "packed_bytes": derived.device_bytes()["packed_bytes"],
        "_delta": delta, "_fingerprint": res.fingerprint,
        "_fused": got["fused"],
    }


def phase_utilization(main_res: dict, reps: int = REPS) -> dict:
    """``time_lanes`` on the main path's PageRank, then the executor's
    utilization report per kind, and each lane's analytic byte count
    within 10 % of the count over its tensors."""
    import torch
    from repro_torch import obs
    from repro_torch.core import perf_model

    ex = main_res["_pr"].executor
    lane_s = ex.time_lanes(reps)
    rep = ex.utilization()
    name = torch.cuda.get_device_name(ex.device)
    peak = perf_model.DATASHEET_HBM_GBPS.get(name)
    check(rep["peak_bandwidth_gbps"] == peak,
          f"peak {rep['peak_bandwidth_gbps']} GB/s for {name!r}; the "
          f"data sheet's is {peak}")
    check(rep["kinds"] and all(k["gbps"] > 0 for k in rep["kinds"].values()),
          f"time_lanes recorded no utilization: {rep['kinds']}")
    for i, fp in enumerate(ex.footprints()):
        if fp is not None:
            counted = obs.tensor_lane_bytes(ex, i)
            check(abs(fp.total_bytes - counted) <= 0.1 * counted,
                  f"lane {i}: footprint {fp.total_bytes} B vs tensors "
                  f"{counted} B")
    return {
        "lane_ms": [t * 1e3 for t in lane_s],
        "lane_bytes": [t and t[0] for t in ex.lane_traffic()],
        "lane_model_hbm_bytes": [fp and fp.hbm_bytes
                                 for fp in ex.footprints()],
        "peak_bandwidth_gbps": rep["peak_bandwidth_gbps"],
        "kinds": {kind: {"gbps": k["gbps"], "bytes": k["bytes"],
                         "n": k["n"],
                         "percent_of_peak": (None if k["utilization"] is None
                                             else 100 * k["utilization"])}
                  for kind, k in rep["kinds"].items()},
    }


# ---------------------------------------------------------------------------
# Phases 8-9: the serving layer and the control plane
# ---------------------------------------------------------------------------

SERVE_APPS = [("pagerank", {}), ("bfs", {}), ("sssp", {}), ("wcc", {}),
              ("closeness", {})]
N_WARM, BURST = 20, 8


def _stages(h) -> dict:
    m = h.metrics
    return {k: getattr(m, k) for k in ("t_queue_ms", "t_store_ms",
                                       "t_plan_ms", "t_execute_ms",
                                       "t_total_ms")}


def _pct(xs, p: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(xs, dtype=np.float64), p))


def _seeded_cache(store):
    """A GraphStoreCache holding ``store`` under its service key (spares
    the service a second store build)."""
    from repro_torch.serve_graph import GraphStoreCache, store_key
    cache = GraphStoreCache()
    cache.put(store_key(store.fingerprint(), store.geom, store.use_dbg),
              store)
    return cache


def _ship_cost(store) -> dict:
    """What shipping ``store`` to a spawned worker costs, piece by piece:
    its pickle (bytes, ms), unpickling it, and sending the bytes through
    a process pool's pipe to a bare spawned process (which imports
    nothing of the port)."""
    import multiprocessing
    import pickle
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    blob = pickle.dumps(store)
    t1 = time.perf_counter()
    pickle.loads(blob)
    t2 = time.perf_counter()
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
            "spawn")) as ex:
        ex.submit(len, b"").result()               # the process is up
        t3 = time.perf_counter()
        check(ex.submit(len, blob).result() == len(blob), "pipe lost bytes")
        t4 = time.perf_counter()
    return {"base_pickle_bytes": len(blob), "t_pickle_ms": (t1 - t0) * 1e3,
            "t_unpickle_ms": (t2 - t1) * 1e3, "t_ship_ms": (t4 - t3) * 1e3}


def phase_serving(main_res: dict, stream_res: dict, device) -> tuple:
    """GraphService on the card over phase 3's store: the five builtin
    apps once each, 20 warm PageRank requests, a burst of 8 identical
    submits (one execution), then the phase 6 delta through a service
    with a spawned pool worker. Returns (report, the running service,
    each app's served props)."""
    import numpy as np
    from repro_torch import api
    from repro_torch.core.executor import Executor
    from repro_torch.core.gas import BUILTIN_APPS

    store, config, graph = (main_res["_store"], main_res["_config"],
                            main_res["_graph"])
    fp = store.fingerprint()
    out = {"launches": 0}
    svc = api.GraphService(cache=_seeded_cache(store), device=device,
                           workers=2)
    check(svc.device == device, f"service device {svc.device}")

    def serve(app, kw, **extra):
        return svc.submit(fingerprint=fp, app=app, app_kwargs=kw,
                          config=config, **extra)

    # -- the five apps, once each (counted) -----------------------------
    def five():
        hs = [serve(app, kw) for app, kw in SERVE_APPS]
        return [h.result(timeout=600) for h in hs], hs
    (results, hs), n = _counted(five)
    out["launches"] += n
    out["requests"] = {app: _stages(h) for (app, _), h in
                       zip(SERVE_APPS, hs)}
    served = {}
    for (app, kw), (props, meta) in zip(SERVE_APPS, results):
        ex = Executor(store, store.plan(config), BUILTIN_APPS[app](**kw),
                      device=device)
        want, wmeta = ex.run()
        check(meta["iterations"] == wmeta["iterations"]
              and _same(props, want),
              f"served {app} != a direct Executor on the same store and "
              "plan")
        check(props.shape == (graph.num_vertices,)
              and (app != "pagerank" or np.isfinite(props).all()),
              f"served {app}: non-finite or misshapen result")
        served[app] = (props, meta)
    pr, pr_meta = served["pagerank"]
    k = pr_meta["iterations"]
    plain, plain_meta = main_res["_pr_plain"].run(max_iters=k)
    out["pagerank_max_rel_err_vs_plain"] = _max_rel(pr, plain)
    check(abs(plain_meta["iterations"] - k) <= 1
          and np.allclose(pr, plain, rtol=1e-5, atol=1e-7),
          f"served PageRank vs the plain path: max rel err "
          f"{out['pagerank_max_rel_err_vs_plain']}")

    # -- 20 warm PageRank requests one after another (counted) ----------
    def warm():
        stages = []
        for _ in range(N_WARM):
            h = serve("pagerank", {})
            props, _ = h.result(timeout=600)
            check(_same(props, pr), "a warm PageRank request changed")
            check(h.metrics.store_hit and h.metrics.plan_hit,
                  "a warm request missed the store or plan cache")
            stages.append(_stages(h))
        return stages
    stages, n = _counted(warm)
    out["launches"] += n
    totals = [st["t_total_ms"] for st in stages]
    (ex, _), = [v for key, v in svc._executors.items()
                if key[1][1] == "pagerank"]
    def run_alone(ms):
        for _ in range(N_WARM):
            t0 = time.perf_counter()
            ex.run()
            ms.append((time.perf_counter() - t0) * 1e3)
    alone, in_thread = [], []
    run_alone(alone)
    # the same runs on a plain thread of their own (no service around
    # them): does the thread alone account for the service's overhead?
    t = threading.Thread(target=run_alone, args=(in_thread,))
    t.start()
    t.join(timeout=600)
    check(not t.is_alive() and len(in_thread) == N_WARM,
          "the runs on a plain thread did not finish")
    out["warm_pagerank_ms"] = {
        "service_p50": _pct(totals, 50), "service_p99": _pct(totals, 99),
        **{k[2:-3] + "_p50": _pct([st[k] for st in stages], 50)
           for k in ("t_queue_ms", "t_store_ms", "t_plan_ms",
                     "t_execute_ms")},
        "executor_run_p50": _pct(alone, 50),
        "executor_run_p99": _pct(alone, 99),
        "executor_run_thread_p50": _pct(in_thread, 50)}
    out["warm_pagerank_ms"]["overhead_p50"] = (
        out["warm_pagerank_ms"]["service_p50"]
        - out["warm_pagerank_ms"]["executor_run_p50"])
    # each request's lease re-measures the store on release
    # (GraphStoreCache.lease): its share of the overhead
    foot = []
    for _ in range(N_WARM):
        t0 = time.perf_counter()
        store.memory_footprint()
        foot.append((time.perf_counter() - t0) * 1e3)
    out["warm_pagerank_ms"]["memory_footprint_p50"] = _pct(foot, 50)

    # -- a burst of identical submits coalesces (counted) ---------------
    before = svc.metrics.snapshot()["executions"]

    def burst():
        hs = [serve("pagerank", {}) for _ in range(BURST)]
        return [h.result(timeout=600) for h in hs], hs
    (res_b, hs_b), n = _counted(burst)
    out["launches"] += n
    executions = svc.metrics.snapshot()["executions"] - before
    out["burst"] = {"submits": BURST, "executions": executions,
                    "coalesced": sum(h.metrics.coalesced for h in hs_b)}
    check(executions == 1,
          f"{BURST} identical submits ran {executions} executions")
    check(all(r[0] is res_b[0][0] for r in res_b) and _same(res_b[0][0], pr),
          "the coalesced burst did not fan one result out")

    # -- an update through a spawned pool worker (counted) --------------
    delta = stream_res["_delta"]
    with api.GraphService(cache=_seeded_cache(store), device=device,
                          pool=1) as psvc:
        t0 = time.perf_counter()
        up = psvc.update(fp, delta)
        t_update = (time.perf_counter() - t0) * 1e3
        check(up.mode == "incremental" and up.fingerprint
              == stream_res["_fingerprint"],
              f"pool update: mode {up.mode}, fingerprint {up.fingerprint}")

        def after():
            a = psvc.submit(fingerprint=up.fingerprint, app="pagerank",
                            config=config, max_iters=4).result(timeout=600)
            b = psvc.submit(fingerprint=up.fingerprint, app="bfs",
                            config=config).result(timeout=600)
            return a, b
        ((pr4, m4), (bfs, mb)), n = _counted(after)
        out["launches"] += n
        (want_pr, n_pr), (want_bfs, n_bfs) = stream_res["_fused"]
        check(m4["iterations"] == n_pr and _same(pr4, want_pr),
              "PageRank on the pool-updated snapshot != phase 6's "
              "derived store")
        check(mb["iterations"] == n_bfs and _same(bfs, want_bfs),
              "BFS on the pool-updated snapshot != phase 6's derived store")
        out["pool_update"] = {
            "scale": SCALE, "t_update_ms": t_update,
            "t_pool_apply_ms": up.stats["t_apply_ms"],
            "t_splice_ms": up.stats["t_splice_ms"],
            "t_replan_ms": up.stats["t_replan_ms"],
            "in_process_apply_ms": stream_res["t_apply_ms"],
            "packed_lanes_reused": up.stats["packed_lanes_reused"],
            "pool": psvc.stats()["pool"], **_ship_cost(store)}
    check(out["launches"] > 0, "the serving path never launched the kernel")
    out["service"] = {k: v for k, v in svc.metrics.snapshot().items()
                      if k in ("submitted", "completed", "executions",
                               "coalesced", "store_hits", "plan_hits")}
    return out, svc, served


def _http(method: str, url: str, body=None):
    import urllib.request
    req = urllib.request.Request(
        url, method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        data = r.read()
        is_json = "json" in r.headers.get("Content-Type", "")
        return r.status, (json.loads(data) if is_json else data.decode())


def _job_metrics(plane, jid: str) -> dict:
    """A finished job's request metrics: the record turns terminal just
    after the handle resolves (the observer fires last)."""
    from repro_torch.control.jobs import JobState
    deadline = time.perf_counter() + 30
    while time.perf_counter() < deadline:
        rec = plane.jobs.get(jid)
        if rec.state in JobState.TERMINAL:
            check(rec.state == JobState.DONE and rec.metrics,
                  f"job {jid} ended {rec.state}: {rec.error}")
            return rec.metrics
        time.sleep(0.01)
    raise CheckFailed(f"job {jid} never reached a terminal state")


def phase_control(main_res: dict, svc, served: dict, device) -> dict:
    """The control plane over phase 8's service on 127.0.0.1 (port 0):
    a PageRank and a BFS job over HTTP equal to phase 8's, /metrics and
    /dashboard, then one job with lane detail whose trace covers the
    store, the plan, the execution and every non-empty lane, bit-equal
    to the untraced run."""
    from repro_torch import api

    store, config = main_res["_store"], main_res["_config"]
    fp = store.fingerprint()
    out = {"launches": 0}
    tracer = api.Tracer(lane_detail=True)
    plane = api.ControlPlane(svc, tracer=tracer)
    check(plane.tracer is tracer, "the plane did not take the tracer")
    try:
        _, base = plane.serve_http(host="127.0.0.1", port=0)

        def jobs():
            got = []                # two rounds: the first pays each
            for _ in range(2):      # executor's first traced run
                for app in ("pagerank", "bfs"):
                    t0 = time.perf_counter()
                    st, rec = _http("POST", base + "/jobs", {
                        "fingerprint": fp, "app": app,
                        "n_lanes": config.n_lanes})
                    check(st == 201, f"POST /jobs ({app}): {st} {rec}")
                    st, res = _http("GET", base + f"/jobs/{rec['id']}"
                                    "/result?timeout=600")
                    got.append((app, (time.perf_counter() - t0) * 1e3,
                                rec["id"], st, res))
            return got
        got, n = _counted(jobs)
        out["launches"] += n
        out["http_round_trip_ms"] = {"pagerank": [], "bfs": []}
        for app, ms, jid, st, res in got:
            check(st == 200 and res["num_properties"]
                  == served[app][0].shape[0],
                  f"GET /jobs/{jid}/result ({app}): {st} {res}")
            props, meta = plane.result(jid)
            check(meta["iterations"] == served[app][1]["iterations"]
                  and _same(props, served[app][0]),
                  f"{app} over HTTP != phase 8's")
            out["http_round_trip_ms"][app].append(ms)
            out.setdefault("http_execute_ms", {}).setdefault(app, []).append(
                _job_metrics(plane, jid)["t_execute_ms"])
        for route in ("/metrics", "/dashboard", "/metrics.json",
                      "/readyz"):
            st, body = _http("GET", base + route)
            check(st == 200 and body, f"GET {route}: {st}")
        st, prom = _http("GET", base + "/metrics")
        check("regraph_requests_total" in prom
              and 'regraph_jobs{state="done"}' in prom,
              "/metrics lacks the request and job families")

        rtt = []
        for _ in range(5):
            t0 = time.perf_counter()
            _http("GET", base + "/healthz")
            rtt.append((time.perf_counter() - t0) * 1e3)
        out["healthz_round_trip_ms_p50"] = _pct(rtt, 50)

        # one job under lane detail on a new executor key (PageRank
        # with its damping spelled out: the same app, another coalescing
        # token), so the service builds its executor inside the trace
        def traced():
            rec = plane.submit_job(fingerprint=fp, app="pagerank",
                                   app_kwargs={"damping": 0.85},
                                   config=config)
            return plane.result(rec.id, timeout=600), rec
        ((props, meta), rec), n = _counted(traced)
        out["launches"] += n
        want, wmeta = served["pagerank"]
        check(meta["iterations"] == wmeta["iterations"]
              and _same(props, want),
              "the traced PageRank job != phase 8's untraced PageRank")
        doc = plane.trace(rec.id)
        check(doc is not None, "the traced job has no trace")
        names = [e["name"] for e in doc["traceEvents"]]
        for needle in ("service.store", "service.plan", "service.execute",
                       "executor.iteration", "executor.merge_apply"):
            check(needle in names, f"trace lacks {needle}: "
                  f"{sorted(set(names))}")
        lanes = [e["args"] for e in doc["traceEvents"]
                 if e["name"] == "executor.lane"]
        bundle = store.plan(config)
        nonempty = {i for i, lane in enumerate(bundle.packed_lanes(device))
                    if lane}
        check(len(lanes) == len(nonempty) * meta["iterations"]
              and {a["lane"] for a in lanes} == nonempty
              and all("est_time" in a for a in lanes),
              f"{len(lanes)} executor.lane spans for {len(nonempty)} "
              f"non-empty lanes x {meta['iterations']} iterations")
        check(names.count("executor.merge_apply") == meta["iterations"],
              "one executor.merge_apply span per iteration expected")
        out["traced_job"] = {
            "iterations": meta["iterations"], "lane_spans": len(lanes),
            "lane_ms_by_kind": {}}
        for a, e in zip(lanes, [e for e in doc["traceEvents"]
                                if e["name"] == "executor.lane"]):
            out["traced_job"]["lane_ms_by_kind"].setdefault(
                a["kind"], []).append(e["dur"] / 1e3)
        out["traced_job"]["lane_ms_by_kind"] = {
            k: {"p50": _pct(v, 50), "n": len(v)}
            for k, v in out["traced_job"]["lane_ms_by_kind"].items()}
    finally:
        plane.close()
    check(out["launches"] > 0, "the control plane never launched the kernel")
    out["jobs"] = plane.jobs.stats()
    return out


# ---------------------------------------------------------------------------
# Phases 10-11: autotune, the SPMD path
# ---------------------------------------------------------------------------

def _held_to_main(main_res: dict, pr_history: list, bfs: tuple,
                  what: str) -> dict:
    """PageRank within rtol 1e-5 / atol 1e-7 of phase 3's (at the last
    iteration both ran; iteration counts within one) and BFS bit-equal
    to phase 3's, with iteration counts equal."""
    import numpy as np
    want_hist = main_res["_pr_history"]
    want_bfs, want_bfs_iters = main_res["_bfs_result"]
    n = min(len(pr_history), len(want_hist))
    check(n > 0 and abs(len(pr_history) - len(want_hist)) <= 1,
          f"{what}: PageRank ran {len(pr_history)} iterations, phase 3 "
          f"{len(want_hist)}")
    got, want = pr_history[n - 1], want_hist[n - 1]
    err = _max_rel(got, want)
    check(np.isfinite(got).all() and np.allclose(got, want, rtol=1e-5,
                                                 atol=1e-7),
          f"{what}: PageRank vs phase 3: max rel err {err}")
    check(bfs[1] == want_bfs_iters and _same(bfs[0], want_bfs),
          f"{what}: BFS != phase 3's")
    return {"pagerank_max_rel_err_vs_main": err,
            "pagerank_bit_equal_to_main": bool(
                len(pr_history) == len(want_hist) and _same(got, want)),
            "iterations": {"pagerank": len(pr_history), "bfs": bfs[1]}}


def _pr_bfs_full(store, config, device) -> tuple:
    """PageRank (to convergence, with its history) and BFS on ``store``
    under ``config``: (pr history, (bfs props, bfs iterations))."""
    from repro_torch import api
    _, pm = api.compile(None, "pagerank", store=store, config=config,
                        device=device).run(collect_history=True)
    b, bm = api.compile(None, "bfs", store=store, config=config,
                        device=device).run()
    return pm["history"], (b, bm["iterations"])


def phase_autotune(main_res: dict, device) -> dict:
    """A forced calibrate-and-replan on phase 3's store: the calibration
    sweep through the kernel, the guarded fit, the candidate search, the
    adopted plan's PageRank and BFS against phase 3's, the spec naming
    the card; then a GraphService(autotune=...) whose
    ``ControlPlane.retune_job`` runs between two PageRank requests."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.autotune import AutoTuner, SpecRegistry, retuner
    from repro_torch.serve_graph import store_key

    store, config = main_res["_store"], main_res["_config"]
    fp = store.fingerprint()
    # the service's key of the store: the tuner remembers each graph's
    # winning config under it (a fixed split may win the search)
    skey = store_key(fp, store.geom, store.use_dbg)
    card = torch.cuda.get_device_name(device)
    out = {"launches": 0}
    with tempfile.TemporaryDirectory() as spec_dir:
        tuner = AutoTuner(registry=SpecRegistry(spec_dir), device=device)
        check(tuner.device_kind.startswith(card + "@"),
              f"device kind {tuner.device_kind!r} does not name the card")
        ex = api.Executor(store, store.plan(config), api.make_pagerank(),
                          device=device, calibrator=tuner.calibrator)
        # time the candidate search inside the retune (the module's own
        # search_plan, wrapped for this call only)
        search_s, search_plan = [], retuner.search_plan

        def timed_search(*a, **kw):
            t0 = time.perf_counter()
            r = search_plan(*a, **kw)
            search_s.append(time.perf_counter() - t0)
            return r
        retuner.search_plan = timed_search
        # and each calibration sweep (Executor.time_lanes)
        sweep_s, time_lanes = [], ex.time_lanes

        def timed_lanes(*a, **kw):
            t0 = time.perf_counter()
            r = time_lanes(*a, **kw)
            sweep_s.append(time.perf_counter() - t0)
            return r
        ex.time_lanes = timed_lanes
        try:
            t0 = time.perf_counter()
            event, n = _counted(lambda: tuner.retune(store, ex, config,
                                                     skey=skey, force=True))
            t_wall = time.perf_counter() - t0
        finally:
            retuner.search_plan = search_plan

        def samples_ms(start=0):
            """The calibrator's samples from ``start`` on: (kind,
            measured lane ms)."""
            return [(k, y * 1e3) for _, k, y in
                    list(tuner.calibrator._samples)[start:]]
        n_first = tuner.calibrator.counts()["n"]
        lanes = sum(1 for lane in ex.lanes if lane)
        check(n > 0, "the retune's calibration sweep never launched the "
              "kernel")
        out["launches"] += n
        fit = event.get("fit") or {}
        out.update(
            device_kind=tuner.device_kind, applied=event["applied"],
            sweep_launches=n, lanes_timed=lanes,
            samples=tuner.calibrator.counts(),
            fit={k: fit.get(k) for k in ("n", "n_little", "n_big", "cond",
                                         "residual_rel", "fallback",
                                         "kept_prior")},
            t_retune_s=event.get("t_retune_s", t_wall),
            t_search_plan_s=search_s[0] if search_s else None,
            t_sweeps_s=sweep_s, sweep_lane_ms=samples_ms())
        if event["applied"]:
            out.update(candidates=event["candidates"],
                       chosen=event["chosen"],
                       hw=tuner.stats()["hw"])
            cfg_b = tuner.resolve_config(api.PlanConfig(n_lanes=N_LANES),
                                         skey)
            check(cfg_b.hw is tuner.hw and store.has_plan(cfg_b)
                  and (cfg_b.mode, cfg_b.forced_little, cfg_b.forced_big)
                  == (event["chosen"]["mode"],
                      *(map(int, event["chosen"]["split"].split(":"))
                        if event["chosen"]["split"] else (0, 0))),
                  f"the retune's winning plan {event['chosen']} was not "
                  "adopted")
            (pr_hist, bfs), n = _counted(
                lambda: _pr_bfs_full(store, cfg_b, device))
            out["launches"] += n
            out["adopted_plan"] = {
                "little_lanes": store.plan(cfg_b).plan.num_little_lanes,
                "big_lanes": store.plan(cfg_b).plan.num_big_lanes,
                "launches": n,
                **_held_to_main(main_res, pr_hist, bfs,
                                "under the adopted plan")}
            with open(event["spec_path"]) as f:
                spec = json.load(f)
            check(card in spec["device_kind"] and spec["version"] == 1
                  and spec["source"] == "calibrated",
                  f"spec file: {spec['device_kind']!r}, version "
                  f"{spec['version']}, source {spec['source']!r}")
            out["spec"] = {k: spec[k] for k in ("device_kind", "geom_key",
                                                "version", "source")}
        else:
            # the guard rejected the fit: nothing was adopted, and the
            # plan runs as before
            out["rejected"] = event["rejected"]
            check(tuner.hw is None and tuner.version == 0,
                  "a rejected fit changed the tuner's HW")
            (pr_hist, bfs), n = _counted(
                lambda: _pr_bfs_full(store, config, device))
            out["launches"] += n
            out["unchanged_plan"] = _held_to_main(
                main_res, pr_hist, bfs, "after a rejected fit")

        # -- the service and the control plane ----------------------------
        svc = api.GraphService(cache=_seeded_cache(store), device=device,
                               autotune=tuner)
        plane = api.ControlPlane(svc, tracer=api.Tracer(lane_detail=True))
        try:
            def request():
                return svc.submit(fingerprint=fp, app="pagerank",
                                  config=api.PlanConfig(n_lanes=N_LANES)
                                  ).result(timeout=600)
            # the plane's lane-detail tracer makes each served run feed
            # the calibrator one sample per lane per iteration, beside
            # the retune's sweeps: count them
            n_samples = {}
            (pr0, m0), n = _counted(request)
            out["launches"] += n
            n_samples["after_request_1"] = tuner.calibrator.counts()["n"]
            t0 = time.perf_counter()
            rec, n = _counted(lambda: plane.retune_job(
                fingerprint=fp, app="pagerank", n_lanes=N_LANES))
            t_job = time.perf_counter() - t0
            out["launches"] += n
            n_samples["after_retune_job"] = tuner.calibrator.counts()["n"]
            check(rec.state == "done",
                  f"retune job ended {rec.state}: {rec.error}")
            (pr1, m1), n = _counted(request)
            out["launches"] += n
            n_samples["after_request_2"] = tuner.calibrator.counts()["n"]
            check(np.isfinite(pr1).all() and np.allclose(
                pr1, pr0, rtol=1e-5, atol=1e-7),
                "PageRank after the retune job != before: max rel err "
                f"{_max_rel(pr1, pr0)}")
            st = svc.stats()["autotune"]
            job_fit = rec.metrics.get("fit") or {}
            out["service"] = {
                "retune_job_applied": rec.metrics.get("applied"),
                "retune_job_rejected": rec.metrics.get("rejected"),
                "retune_job_fit": {k: job_fit.get(k) for k in (
                    "n", "residual_rel", "cond", "fallback")},
                "samples_before": n_first, "samples": n_samples,
                "retune_job_chosen": rec.metrics.get("chosen"),
                "retune_job_sweep_lane_ms": samples_ms(n_first),
                "t_retune_job_s": t_job,
                "iterations": [m0["iterations"], m1["iterations"]],
                "pagerank_bit_equal": _same(pr0, pr1),
                "pagerank_max_rel_err": _max_rel(pr1, pr0),
                "version": st["version"], "retunes": st["retunes"],
                "fit_rejects": st["fit_rejects"],
                "retunes_metric": svc.metrics.retunes}
        finally:
            plane.close()
            svc.close()
    check(out["launches"] > 0, "the autotune path never launched the kernel")
    return out


def phase_distributed(main_res: dict, device, reps: int = REPS) -> dict:
    """DistributedEngine on a one-rank NCCL group (a FileStore in a temp
    dir): PageRank and BFS against phase 3's, the launches counted, one
    iteration timed; then each launch on its packed payloads held
    against the plain version and timed beside it, the bound and the
    library call."""
    import datetime
    import tempfile
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.core.distributed import DistributedEngine

    store, config, vprops = (main_res["_store"], main_res["_config"],
                             main_res["_vprops"])
    geom = store.geom
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "rendezvous"), 1),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=600))
        try:
            t0 = time.perf_counter()
            pr_eng = DistributedEngine(store, api.make_pagerank(),
                                       config=config, device=device)
            out["t_engine_s"] = time.perf_counter() - t0
            bfs_eng = DistributedEngine(store, api.make_bfs(),
                                        config=config, device=device)
            k = len(main_res["_pr_history"])

            def run():
                # PageRank one iteration at a time, to keep its history
                vp, hist = pr_eng.init_props(), []
                for it in range(k + 1):
                    new = pr_eng.iteration(vp, it)
                    done = pr_eng.app.converged(vp, new, it)
                    vp = new
                    hist.append(vp.cpu().numpy())     # as run() keeps it
                    if done:
                        break
                return hist, bfs_eng.run()
            (pr_hist, (bfs, bm)), n = _counted(run)
            st = pr_eng.stats()
            per_iter = st["launches_per_iteration"]
            check(n == per_iter * (len(pr_hist) + bm["iterations"]) > 0,
                  f"DistributedEngine launched the kernel {n} times; "
                  f"expected {per_iter} per iteration")
            out.update(launches=n, **st)
            out.update(_held_to_main(main_res, pr_hist,
                                     (bfs, bm["iterations"]),
                                     "DistributedEngine"))
            out["iteration_ms"] = pr_eng.time_iteration(reps) * 1e3
            calls = _calls(pr_eng.payloads, vprops, geom)
            bound_ms, bound_by, _ = _bound_ms(calls)
            out["kernel"] = {
                "per_payload": [{"kind": p["kind"],
                                 "n_blocks": p["n_blocks"],
                                 "n_out_tiles": p["n_out_tiles"],
                                 "n_entries": p["n_entries"]}
                                for p in pr_eng.payloads],
                **_held_to_plain(calls, geom, "kernel on the distributed "
                                 "payloads vs plain"),
                "kernel_ms": cuda_ms(lambda: [
                    _pagerank_launch(vwin, p, geom) for vwin, p in calls],
                    reps),
                "plain_ms": cuda_ms(lambda: [
                    _pagerank_plain(vwin, p, geom) for vwin, p in calls],
                    reps),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": _library_ms(calls, geom, store.V_pad, device,
                                          reps)}
        finally:
            dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# Phase 12: LM serving on the card
# ---------------------------------------------------------------------------

LM_DENSE, LM_MOE = "qwen2_1p5b", "granite_moe_3b_a800m"
LM_SEED = 0                       # the weights' torch.Generator seed
LM_REQUESTS, LM_MOE_REQUESTS, LM_NEW = 16, 8, 32
LM_PROMPT = (128, 512)            # prompt lengths, numpy default_rng(0)
LM_TF_B, LM_TF_S = 2, 256         # teacher-forced decode: prefill S/2
LM_CPU_LAYERS = 2                 # card vs CPU: full widths, 2 layers
LM_DISPATCH_T = 256               # tokens of the one-layer dispatch check
LM_BF16_TOL = 2e-2                # rtol = atol, bf16 (model parity tests)


def _lm_requests(cfg, n: int):
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(0)
    lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)
    return [Request(tokens=rng.integers(0, cfg.vocab_size, int(n_tok))
                    .astype(np.int32), max_new_tokens=LM_NEW)
            for n_tok in lens][:n]


def _grown(cfg, cache, extra: int):
    """The self-attention cache ("k", "v") grown by ``extra`` positions
    on axis 2; recurrent state (ssm, hybrid) and whisper's
    cross-attention cache stay as they are."""
    import torch
    if cfg.family in ("ssm", "hybrid"):
        return cache
    return {k: (torch.cat([v, v.new_zeros(v.shape[:2] + (extra,)
                                          + v.shape[3:])], dim=2)
                if k in ("k", "v") else v)
            for k, v in cache.items()}


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _within(got, want, tol: float) -> bool:
    """|got - want| <= tol + tol * |want| everywhere."""
    import torch
    g, w = got.double().cpu(), want.double().cpu()
    return bool(torch.isfinite(g).all()) and bool(
        ((g - w).abs() <= tol + tol * w.abs()).all())


def _param_bytes(params) -> int:
    if isinstance(params, dict):
        return sum(_param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()


def _lm_teacher_forced(model, params, device, b: int = LM_TF_B,
                       s: int = LM_TF_S, half=None, step_tol: float = 5e-2,
                       extra=None) -> dict:
    """Full width, fp32: forward on b x s tokens (``extra`` adds inputs,
    whisper's frames); prefill the first ``half`` (s/2 by default), then
    decode the rest step by step, each step's logits against forward's
    at the reference's tolerances (2e-2 for the prefill's last logits,
    ``step_tol`` per step: 5e-2, 8e-2 for ssm / hybrid;
    tests/test_models.py:67-98)."""
    import numpy as np
    import torch
    cfg = model.cfg
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).to(device)
    half = s // 2 if half is None else half
    batch = {"tokens": tok, **(extra or {})}
    with torch.inference_mode():
        full = model.forward(params, batch)
        check(tuple(full.shape) == (b, s, cfg.vocab_padded)
              and bool(torch.isfinite(full).all()),
              f"forward logits {tuple(full.shape)} not finite / wrong shape")
        cache, last = model.prefill(params, {**batch, "tokens": tok[:, :half]})
        cache = _grown(cfg, cache, s - half)
        check(_within(last[:, 0], full[:, half - 1], 2e-2),
              "prefill's last logits != forward's (2e-2)")
        errs = [_max_err(last[:, 0], full[:, half - 1])]
        for t in range(half, s):
            logits, cache = model.decode_step(params, cache, tok[:, t:t + 1],
                                              t)
            check(_within(logits[:, 0], full[:, t], step_tol),
                  f"decode step at {t} != forward ({step_tol})")
            errs.append(_max_err(logits[:, 0], full[:, t]))
    return {"tokens": [b, s], "prefill": half, "decode_steps": s - half,
            "max_abs_err_prefill": errs[0],
            "max_abs_err_decode": max(errs[1:])}


def _lm_card_vs_cpu(cfg, device) -> dict:
    """The same model at full widths and LM_CPU_LAYERS layers, fp32,
    the same weights and tokens on the card and on the CPU: forward
    logits within rtol 1e-4 / atol 1e-4 (TF32 off)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models.api import build_model
    model = build_model(dataclasses.replace(cfg, num_layers=LM_CPU_LAYERS))
    params = model.init(torch.Generator(device).manual_seed(LM_SEED))
    tok = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (LM_TF_B, LM_TF_S)).astype(np.int32)
    with torch.inference_mode():
        card = model.forward(params, {
            "tokens": torch.from_numpy(tok).to(device)}).cpu()
        cpu_params = {k: ({n: t.cpu() for n, t in v.items()}
                          if isinstance(v, dict) else v.cpu())
                      for k, v in params.items()}
        del params
        t0 = time.perf_counter()
        host = model.forward(cpu_params, {"tokens": torch.from_numpy(tok)})
        t_cpu = time.perf_counter() - t0
    err = _max_err(card, host)
    check(bool(torch.allclose(card, host, rtol=1e-4, atol=1e-4)),
          f"card != CPU at {LM_CPU_LAYERS} layers: max abs err {err}")
    return {"layers": LM_CPU_LAYERS, "max_abs_err": err,
            "t_cpu_forward_s": t_cpu}


def _device_profile(fn, reps: int) -> dict:
    """Device busy time of ``fn()`` per run from ``torch.profiler``
    (the sum of its kernels' device time; CUDA activity only, after one
    warm-up) and its five costliest kernels; None where the profiler
    sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3 / reps)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        return {"busy_ms": None, "top": []}
    kernels.sort(key=lambda kv: -kv[1])
    return {"busy_ms": sum(ms for _, ms in kernels),
            "kernels": len(kernels),
            "top": [[name[:60], ms] for name, ms in kernels[:5]]}


def _lm_serving(model, params, n_requests: int, device) -> dict:
    """ServeEngine(max_batch=8) on the card at temperature 0: a warm-up
    request, then ``n_requests`` requests; prefill and decode-step
    device ms (CUDA events) at the first wave's shape and the decode
    step's host-clock ms; one request through a max_batch=1 engine
    token for token against a manual prefill + decode loop."""
    import torch
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.kvcache import cache_bytes
    cfg = model.cfg
    reqs = _lm_requests(cfg, n_requests)
    max_seq = LM_PROMPT[1] + LM_NEW
    eng = ServeEngine(model, params, max_batch=8, max_seq=max_seq,
                      device=device)
    eng.run_wave([Request(tokens=reqs[0].tokens[:32], max_new_tokens=2)])
    torch.cuda.synchronize(device)
    stats = eng.serve(reqs)
    check(all(r.done and len(r.out) == LM_NEW for r in reqs),
          "a served request did not get its 32 tokens")
    check(all(((r.out >= 0) & (r.out < cfg.vocab_size)).all() for r in reqs),
          "a served token is outside the vocabulary")

    wave = reqs[:8]
    plen = max(len(r.tokens) for r in wave)
    toks = torch.zeros((len(wave), plen), dtype=torch.int32)
    for i, r in enumerate(wave):
        toks[i, plen - len(r.tokens):] = torch.from_numpy(r.tokens)
    toks = toks.to(device)
    with torch.inference_mode():
        prefill_ms = cuda_ms(lambda: model.prefill(params, {"tokens": toks}),
                             3)
        cache, logits = model.prefill(params, {"tokens": toks})
        cache = _grown(cfg, cache, LM_NEW + 1)
        state_bytes = _param_bytes(cache)
        cur = torch.argmax(logits[:, -1, :cfg.vocab_size], -1) \
            .to(torch.int32)[:, None]
        decode_ms = cuda_ms(
            lambda: model.decode_step(params, cache, cur, plen), REPS)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(REPS):
            model.decode_step(params, cache, cur, plen)
        torch.cuda.synchronize(device)
        decode_host_ms = (time.perf_counter() - t0) * 1e3 / REPS
        decode_prof = _device_profile(
            lambda: model.decode_step(params, cache, cur, plen), REPS)
        prefill_prof = _device_profile(
            lambda: model.prefill(params, {"tokens": toks}), 1)
    del cache, logits

    one = ServeEngine(model, params, max_batch=1, max_seq=max_seq,
                      device=device)
    prompt = reqs[0].tokens
    [req] = one.run_wave([Request(tokens=prompt, max_new_tokens=LM_NEW)])

    def greedy(logits):        # the engine's rule: argmax of f32 logits
        lf = logits[0, -1, :cfg.vocab_size].float()
        top = torch.topk(lf, 2).values
        return int(torch.argmax(lf)), float(top[0] - top[1])

    with torch.inference_mode():
        cache, logits = model.prefill(
            params, {"tokens": torch.from_numpy(prompt)[None].to(device)})
        cache = _grown(cfg, cache, LM_NEW + 1)
        manual, gaps = zip(greedy(logits))
        manual, gaps = list(manual), list(gaps)
        for t in range(LM_NEW - 1):
            logits, cache = model.decode_step(
                params, cache,
                torch.tensor([[manual[-1]]], dtype=torch.int32,
                             device=device), len(prompt) + t)
            tok, gap = greedy(logits)
            manual.append(tok)
            gaps.append(gap)
    diff = [i for i, (a, b) in enumerate(zip(req.out.tolist(), manual))
            if a != b]
    check(not diff,
          "max_batch=1 engine tokens != the manual prefill + decode loop "
          f"from token {diff[0] if diff else None}: engine "
          f"{req.out.tolist()}, manual {manual}, top-2 logit gaps {gaps}")
    return {"requests": stats["requests"],
            "generated_tokens": stats["generated_tokens"],
            "wall_s": stats["wall_s"], "tokens_per_s": stats["tokens_per_s"],
            "mean_ttft_s": stats["mean_ttft_s"],
            "prompt_lens": [len(r.tokens) for r in reqs],
            "param_bytes": _param_bytes(params),
            "cache_bytes": cache_bytes(cfg, 8, max_seq),
            "decode_state_bytes": state_bytes,
            # a decode step reads every weight and its decode state once
            "decode_bound_ms": (_param_bytes(params) + state_bytes)
            / H100_BYTES_PER_S * 1e3,
            "prefill_shape": [len(wave), plen], "prefill_ms": prefill_ms,
            "decode_step_ms": decode_ms,
            "decode_step_host_ms": decode_host_ms,
            "decode_step_device_profile": decode_prof,
            "prefill_device_profile": prefill_prof,
            "request0_tokens": req.out.tolist(),
            "served_request0_tokens": reqs[0].out.tolist(),
            "greedy_equals_manual_loop": True}


def _lm_dispatch(model, params, device) -> dict:
    """One MoE layer's dispatch (``moe._moe_ffn_tokens``, biglittle) on
    LM_DISPATCH_T tokens at a capacity every expert's share fits (each
    expert takes at most T tokens, so nothing drops), with the model's
    router and distinct random expert weights, against the exact
    mixture ``ref.moe_dispatch_ref``: fp32 within rtol 1e-4 / atol 1e-5
    (the reference's own test), bf16 within rtol = atol = 2e-2 (the
    dispatch adds each token's 8 expert rows in bf16)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.moe_schedule import biglittle_split
    cfg = model.cfg
    E, D = cfg.num_experts_padded, cfg.d_model
    F = cfg.moe_d_ff or cfg.d_ff
    cf = 50.0
    n_hot, c_hot, c_cold = biglittle_split(E, cfg.top_k, LM_DISPATCH_T, cf)
    check(min(c_hot, c_cold) >= LM_DISPATCH_T,
          f"capacities {c_hot}/{c_cold} could drop tokens")
    gen = torch.Generator(device).manual_seed(LM_SEED + 1)
    x = torch.randn((LM_DISPATCH_T, D), generator=gen, device=device)
    w = {"we_gate": torch.randn((E, D, F), generator=gen, device=device)
         / D ** 0.5,
         "we_up": torch.randn((E, D, F), generator=gen, device=device)
         / D ** 0.5,
         "we_down": torch.randn((E, F, D), generator=gen, device=device)
         / F ** 0.5}
    router = params["layers"]["router"][0]
    out = {"tokens": LM_DISPATCH_T, "capacity_factor": cf,
           "split": [n_hot, c_hot, c_cold]}
    with torch.inference_mode():
        for name, dt, tol in (("fp32", torch.float32, (1e-4, 1e-5)),
                              ("bf16", torch.bfloat16,
                               (LM_BF16_TOL, LM_BF16_TOL))):
            xd = x.to(dt)
            wd = {k: v.to(dt) for k, v in w.items()}
            logits = xd.float() @ router          # as moe._route's
            logits[:, cfg.num_experts:] = -1e30
            got, _ = moe_mod._moe_ffn_tokens(
                cfg, router, wd["we_gate"], wd["we_up"], wd["we_down"], xd,
                0, E, 1, cf)
            want = ref.moe_dispatch_ref(xd, logits, wd["we_gate"],
                                        wd["we_up"], wd["we_down"],
                                        cfg.top_k)
            err = _max_err(got, want)
            check(bool(torch.allclose(got.float(), want.float(),
                                      rtol=tol[0], atol=tol[1])),
                  f"MoE dispatch ({name}) != moe_dispatch_ref: max abs "
                  f"err {err}")
            out[f"max_abs_err_{name}"] = err
            out[f"ref_max_abs_{name}"] = float(want.float().abs().max())
    return out


def phase_lm(device) -> dict:
    """Phase 12: 12a qwen2-1.5B at full width in fp32 (teacher-forced
    decode against forward; 2 layers at full widths, card against CPU),
    12b the same model in bf16 served by ServeEngine, 12c granite-MoE at
    full width in bf16 (one layer's dispatch against its oracle, then
    served)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.models.moe_schedule import biglittle_split

    out = {}
    torch.cuda.init()                 # the memory stats need a context
    # 12a: full width, fp32
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(get_config(LM_DENSE), dtype="float32")
    model = build_model(cfg32)
    params = model.init(torch.Generator(device).manual_seed(LM_SEED))
    a = _lm_teacher_forced(model, params, device)
    a["param_bytes"] = _param_bytes(params)
    del params
    torch.cuda.empty_cache()
    a["card_vs_cpu"] = _lm_card_vs_cpu(cfg32, device)
    a["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    a["t_s"] = time.perf_counter() - t0
    out["fp32_" + LM_DENSE] = a
    torch.cuda.empty_cache()

    # 12b: full width, bf16 serving
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = build_model(get_config(LM_DENSE))
    params = model.init(torch.Generator(device).manual_seed(LM_SEED))
    b = _lm_serving(model, params, LM_REQUESTS, device)
    b["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    b["t_s"] = time.perf_counter() - t0
    out["bf16_" + LM_DENSE] = b
    del params
    torch.cuda.empty_cache()

    # 12c: MoE, full width, bf16
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    cfg = get_config(LM_MOE)
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(LM_SEED))
    c = {"dispatch": _lm_dispatch(model, params, device)}
    c.update(_lm_serving(model, params, LM_MOE_REQUESTS, device))
    E = cfg.num_experts_padded
    c["biglittle_split"] = {
        "prefill": [c["prefill_shape"][0] * c["prefill_shape"][1],
                    *biglittle_split(E, cfg.top_k, c["prefill_shape"][0]
                                     * c["prefill_shape"][1],
                                     cfg.capacity_factor)],
        "decode": [c["prefill_shape"][0],
                   *biglittle_split(E, cfg.top_k, c["prefill_shape"][0],
                                    cfg.capacity_factor)]}
    c["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    c["t_s"] = time.perf_counter() - t0
    out["bf16_" + LM_MOE] = c
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 13: the recurrent and encoder-decoder families on the card
# ---------------------------------------------------------------------------

LM_SSM, LM_HYBRID, LM_AUDIO = "mamba2_2p7b", "hymba_1p5b", "whisper_tiny"
LM_SSM_TF = (2, 512)              # teacher-forced: prefill S/2, decode S/2
LM_HYBRID_TF = (2, 1000, 64)      # prefill 1,000, decode 64: past the window
LM_AUDIO_B, LM_AUDIO_PROMPT = 8, 64   # whisper: batch, prompt tokens
LM_RECURRENT_STEP_TOL = 8e-2      # ssm / hybrid decode vs forward
                                  # (tests/test_models.py:89)


def _free() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _lm_recurrent_served(arch: str, device) -> dict:
    """One recurrent family at full width: fp32 teacher-forced decode
    against forward (and, for mamba2, 2 layers card against CPU), then
    bf16 serving as phase 12b."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg32)
    params = model.init(torch.Generator(device).manual_seed(LM_SEED))
    if arch == LM_HYBRID:
        b, half, n = LM_HYBRID_TF
        out = _lm_teacher_forced(model, params, device, b, half + n, half,
                                 LM_RECURRENT_STEP_TOL)
        check(half < cfg.sliding_window < half + n,
              "the teacher-forced decode does not cross the window edge")
    else:
        out = _lm_teacher_forced(model, params, device, *LM_SSM_TF,
                                 step_tol=LM_RECURRENT_STEP_TOL)
    out["fp32_param_bytes"] = _param_bytes(params)
    del params
    _free()
    if arch == LM_SSM:
        out["card_vs_cpu"] = _lm_card_vs_cpu(cfg32, device)
    out["fp32_max_memory_allocated"] = torch.cuda.max_memory_allocated(
        device)
    torch.cuda.reset_peak_memory_stats(device)
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(LM_SEED))
    out.update(_lm_serving(model, params, LM_REQUESTS, device))
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    out["t_s"] = time.perf_counter() - t0
    del params
    _free()
    return out


def _lm_whisper(device) -> dict:
    """whisper-tiny at full width (1,500 encoder frames, seeded): fp32
    teacher-forced decode against forward (prefill 64, decode 32), then
    bf16 prefill of 64 tokens for a batch of 8 and a manual greedy loop
    of 32 steps, timed (the reference's engine cannot serve whisper)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    cfg = get_config(LM_AUDIO)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    gen = torch.Generator(device).manual_seed(LM_SEED + 2)
    frames = torch.randn((LM_AUDIO_B, cfg.encoder_seq, cfg.d_model),
                         generator=gen, device=device)
    model = build_model(dataclasses.replace(cfg, dtype="float32"))
    params = model.init(torch.Generator(device).manual_seed(LM_SEED))
    out = _lm_teacher_forced(model, params, device, LM_AUDIO_B,
                             LM_AUDIO_PROMPT + LM_NEW, LM_AUDIO_PROMPT,
                             extra={"enc_embeds": frames})
    del params
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(LM_SEED))
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (LM_AUDIO_B, LM_AUDIO_PROMPT)).astype(np.int32)) \
        .to(device)
    batch = {"tokens": tok, "enc_embeds": frames.to(torch.bfloat16)}

    def greedy(logits):
        return torch.argmax(logits[:, -1, :cfg.vocab_size].float(), -1) \
            .to(torch.int32)[:, None]

    with torch.inference_mode():
        prefill_ms = cuda_ms(lambda: model.prefill(params, batch), 3)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        cache, logits = model.prefill(params, batch)
        cache = _grown(cfg, cache, LM_NEW)
        toks = [greedy(logits)]
        torch.cuda.synchronize(device)
        t_prefill = time.perf_counter() - t1
        t1 = time.perf_counter()
        for t in range(LM_NEW - 1):
            logits, cache = model.decode_step(params, cache, toks[-1],
                                              LM_AUDIO_PROMPT + t)
            toks.append(greedy(logits))
        out_tok = torch.cat(toks, 1)
        torch.cuda.synchronize(device)
        t_loop = time.perf_counter() - t1
        cur = toks[-1]
        step_ms = cuda_ms(lambda: model.decode_step(
            params, cache, cur, LM_AUDIO_PROMPT + LM_NEW - 1), REPS)
        step_prof = _device_profile(lambda: model.decode_step(
            params, cache, cur, LM_AUDIO_PROMPT + LM_NEW - 1), REPS)
    check(tuple(out_tok.shape) == (LM_AUDIO_B, LM_NEW) and bool(
        ((out_tok >= 0) & (out_tok < cfg.vocab_size)).all()),
        "whisper's greedy tokens are outside the vocabulary")
    state_bytes = _param_bytes(cache)
    out.update({
        "batch": LM_AUDIO_B, "frames": cfg.encoder_seq,
        "param_bytes": _param_bytes(params), "decode_state_bytes": state_bytes,
        "decode_bound_ms": (_param_bytes(params) + state_bytes)
        / H100_BYTES_PER_S * 1e3,
        "prefill_ms": prefill_ms, "prefill_host_ms": t_prefill * 1e3,
        "decode_loop_step_host_ms": t_loop * 1e3 / (LM_NEW - 1),
        "decode_step_ms": step_ms,
        "decode_step_device_profile": step_prof,
        "tokens_per_s": LM_AUDIO_B * LM_NEW / (t_prefill + t_loop),
        "request0_tokens": out_tok[0].tolist(),
        "max_memory_allocated": torch.cuda.max_memory_allocated(device),
        "t_s": time.perf_counter() - t0})
    del params, cache, frames
    _free()
    return out


def phase_lm_recurrent(device) -> dict:
    """Phase 13: 13a mamba2-2.7B, 13b hymba-1.5B, 13c whisper-tiny, each
    at the repo's full config with weights from a seeded generator."""
    import torch
    torch.cuda.init()
    return {LM_SSM: _lm_recurrent_served(LM_SSM, device),
            LM_HYBRID: _lm_recurrent_served(LM_HYBRID, device),
            LM_AUDIO: _lm_whisper(device)}


# ---------------------------------------------------------------------------
# Phase 14: training on the card
# ---------------------------------------------------------------------------

ATTN_BWD = (2, 2048, 12, 2, 128)  # B, S, heads, KV heads, head dim; causal
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 512, 5
RESTART_LAYERS, RESTART_STEPS, RESTART_AT, FALL_STEPS = 2, 16, 11, 25


def _dense_attention(q, k, v):
    """Plain softmax attention, causal, GQA by repeating the KV heads."""
    import numpy as np
    import torch
    rep = q.shape[2] // k.shape[2]
    kk, vv = (x.repeat_interleave(rep, dim=2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / np.sqrt(q.shape[-1])
    n = q.shape[1]
    mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv)


def _attention_backward(device) -> dict:
    """The flash backward (``common._Flash``) against plain autograd of
    dense softmax attention in f32 on the same (rounded) inputs: fp32
    within rtol = atol = 1e-4, bf16 within 2e-2 (the bf16 backward
    rounds p and ds to bf16, as the reference's). Times of forward +
    backward and the peak memory each takes."""
    import torch
    from repro_torch.models import common as mc
    B, S, H, KH, hd = ATTN_BWD
    gen = torch.Generator(device).manual_seed(LM_SEED + 3)
    q, k, v, do = (torch.randn(shape, generator=gen, device=device)
                   for shape in ((B, S, H, hd), (B, S, KH, hd),
                                 (B, S, KH, hd), (B, S, H, hd)))
    out = {"shape": list(ATTN_BWD)}
    for name, dt, tol in (("fp32", torch.float32, 1e-4),
                          ("bf16", torch.bfloat16, 2e-2)):
        x = [t.to(dt).requires_grad_() for t in (q, k, v)]
        xd = [t.to(dt).float().requires_grad_() for t in (q, k, v)]
        g_out = do.to(dt)

        def flash():
            o = mc.blockwise_attention(*x, causal=True)
            return torch.autograd.grad(o, x, g_out)

        def dense():
            return torch.autograd.grad(_dense_attention(*xd), xd,
                                       g_out.float())

        res = {}
        for which, fn in (("flash", flash), ("dense", dense)):
            torch.cuda.synchronize(device)
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            grads = fn()
            torch.cuda.synchronize(device)
            res[which] = grads
            out[f"{name}_{which}_peak_bytes"] = \
                torch.cuda.max_memory_allocated(device) - base
            out[f"{name}_{which}_fwd_bwd_ms"] = cuda_ms(fn, 3)
        errs = []
        for a, b, g in zip(res["flash"], res["dense"], "qkv"):
            check(a.dtype == dt and _within(a, b, tol),
                  f"{name} d{g} of the flash backward != dense autograd "
                  f"({tol}): max abs err {_max_err(a, b)}")
            errs.append(_max_err(a, b))
        out[f"{name}_max_abs_err_dq_dk_dv"] = errs
        out[f"{name}_max_abs_dq_dk_dv"] = [
            float(b.abs().max()) for b in res["dense"]]
        del res, x, xd
        _free()
    return out


class _StepClock:
    """``on_step`` hook for Trainer.run: each step's host-clock time and
    its CUDA-event time (an event recorded once the step's loss is on
    the host), and each step's loss."""

    def __init__(self):
        import torch
        self.events = [torch.cuda.Event(enable_timing=True)]
        self.host = []
        self.losses = []

    def start(self):
        self.events[0].record()
        self.host.append(time.perf_counter())

    def __call__(self, step, metrics):
        import torch
        self.losses.append(float(metrics["loss"]))
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)
        self.host.append(time.perf_counter())

    def summary(self) -> dict:
        import torch
        torch.cuda.synchronize()
        ev = [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]
        host = [(b - a) * 1e3 for a, b in zip(self.host, self.host[1:])]
        return {"step_ms_events": ev, "step_ms_host": host,
                "losses": self.losses}


def _timed_saves(trainer) -> list:
    """Wrap ``trainer.ckpt.save`` to record each save's seconds."""
    saves = []
    save = trainer.ckpt.save

    def timed(step, tree, blocking=False):
        t0 = time.perf_counter()
        save(step, tree, blocking=blocking)
        saves.append({"step": step, "blocking": blocking,
                      "s": time.perf_counter() - t0})
    trainer.ckpt.save = timed
    return saves


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def _train_full(device) -> dict:
    """qwen2-1.5B at full width and depth in bf16 (remat on), AdamW with
    f32 moments, TokenPipeline batches of 4 x 512, 5 steps through
    Trainer into a temporary run directory, ending in the Trainer's
    blocking save; the loss must be finite every step."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import adamw
    from repro_torch.train.loop import Trainer
    cfg = get_config(LM_DENSE)
    check(cfg.remat and cfg.dtype == "bfloat16", "qwen2's config changed")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                      global_batch=TRAIN_B)
    with tempfile.TemporaryDirectory(prefix="train_full_") as d:
        tr = Trainer(build_model(cfg), adamw(), data, d, checkpoint_every=0,
                     device=device)
        saves = _timed_saves(tr)
        clock = _StepClock()
        torch.cuda.reset_peak_memory_stats(device)
        clock.start()
        # the Trainer makes the state (seed 0 = LM_SEED) and holds no
        # second copy of it: the first step's times include that
        params, opt_state, losses = tr.run(TRAIN_STEPS, log_every=0,
                                           on_step=clock)
        out = {"param_bytes": _param_bytes(params),
               "opt_state_bytes": _param_bytes(opt_state)}
        out.update(clock.summary())
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
        # device busy in one more step (after a warm-up one), outside the
        # Trainer's steps above
        batch = tr._to_device(tr.pipeline.batch(TRAIN_STEPS))
        out["step_device_profile"] = _device_profile(
            lambda: tr.step_fn(params, opt_state, batch), 1)
        del params, opt_state, batch
        check(len(losses) == TRAIN_STEPS and bool(np.isfinite(losses).all()),
              f"a training loss is not finite: {losses.tolist()}")
        out["saves"] = saves
        out["checkpoint_bytes"] = _dir_bytes(Path(d) / "ckpt")
        out["disk_free_bytes"] = shutil.disk_usage(d).free
    steady = sorted(out["step_ms_events"][1:])
    out["median_step_ms_events"] = steady[len(steady) // 2]
    out["tokens_per_s"] = TRAIN_B * TRAIN_S / out["median_step_ms_events"] \
        * 1e3
    _free()
    return out


class _Deterministic:
    """``torch.use_deterministic_algorithms(True)`` inside the block (the
    card's cuBLAS also needs CUBLAS_WORKSPACE_CONFIG, which ``main``
    sets before CUDA starts)."""

    def __enter__(self):
        import torch
        self.prev = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)

    def __exit__(self, *exc):
        import torch
        torch.use_deterministic_algorithms(self.prev)


def _train_restart(device) -> dict:
    """qwen2-1.5B at full width and 2 layers, bf16, AdamW(lr 3e-3), the
    reference's integration tests on the card: 16 uninterrupted steps
    against 11 steps + a restart from the step-10 checkpoint to 16,
    under deterministic algorithms, params and moments bit-equal; then
    25 steps without them, the mean loss of the last 5 below that of the
    first 5 (tests/test_train_serve.py:28-67)."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import adamw
    from repro_torch.tree import leaves
    from repro_torch.train.loop import Trainer
    cfg = dataclasses.replace(get_config(LM_DENSE), num_layers=RESTART_LAYERS)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                      global_batch=TRAIN_B)

    def trainer(d, every):
        return Trainer(build_model(cfg), adamw(lr=3e-3, weight_decay=0.0),
                       data, d, checkpoint_every=every, device=device)

    out = {"layers": RESTART_LAYERS}
    with _Deterministic(), tempfile.TemporaryDirectory(prefix="rs_") as d:
        clock = _StepClock()
        clock.start()
        p_full, o_full, _ = trainer(Path(d) / "a", 10).run(
            RESTART_STEPS, log_every=0, on_step=clock)
        out["deterministic"] = clock.summary()
        trainer(Path(d) / "b", 10).run(RESTART_AT, log_every=0)
        tr3 = trainer(Path(d) / "b", 10)
        p_res, o_res, resumed = tr3.run(RESTART_STEPS, log_every=0)
        check(len(resumed) == RESTART_STEPS - RESTART_AT,
              f"the restart resumed {len(resumed)} steps")
        full = leaves({"p": p_full, "o": o_full})
        res = leaves({"p": p_res, "o": o_res})
        equal = all(a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in zip(full, res))
        out["restart_bit_equal"] = equal
        out["restart_max_abs_diff"] = max(_max_err(a, b)
                                          for a, b in zip(full, res))
        check(equal or all(_within(a, b, 2e-2) for a, b in zip(full, res)),
              f"restart != uninterrupted run (2e-2): max abs diff "
              f"{out['restart_max_abs_diff']}")
        del p_full, o_full, p_res, o_res, full, res
    _free()
    with tempfile.TemporaryDirectory(prefix="fall_") as d:
        clock = _StepClock()
        clock.start()
        _, _, losses = trainer(d, 0).run(FALL_STEPS, log_every=0,
                                         on_step=clock)
        out["nondeterministic"] = clock.summary()
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    out["loss_first5"], out["loss_last5"] = first, last
    check(last < first, f"25 steps did not lower the loss: {first} -> "
          f"{last}")
    for k in ("deterministic", "nondeterministic"):
        steady = sorted(out[k]["step_ms_events"][1:])
        out[f"median_step_ms_{k}"] = steady[len(steady) // 2]
    _free()
    return out


def phase_train(device) -> dict:
    """Phase 14: 14a the attention backward, 14b qwen2-1.5B trained at
    full width and depth, 14c restart exactness and a falling loss at
    full width, 2 layers."""
    import torch
    torch.cuda.init()
    return {"attention_backward": _attention_backward(device),
            "full": _train_full(device),
            "restart": _train_restart(device)}


# ---------------------------------------------------------------------------
# Phase 15: custom scatter UDFs on the card
# ---------------------------------------------------------------------------

def custom_apps() -> dict:
    """The apps of phase 15, none a builtin: their scatter UDFs are
    plain torch callables with no ``scatter_op``, so the card runs the
    kernel variant generated for each."""
    import numpy as np
    import torch
    from repro_torch.core import gas

    def hub_init(aux):
        p = np.full(aux["num_v_pad"], -gas.INF, np.float32)
        p[int(np.argmax(aux["outdeg"]))] = gas.INF
        return p

    def equal(a, b, it):
        return bool(torch.equal(a, b))

    return {
        # widths from the vertex of most out-edges: max of min(src, w)
        "widest": gas.GASApp(
            "widest", "max", lambda s, w: torch.minimum(s, w),
            lambda acc, p, aux, it: torch.maximum(p, acc), hub_init, equal,
            needs_weights=True, max_iters=64),
        # a sum-mode UDF with a product and two constants
        "scaled_sum": gas.GASApp(
            "scaled_sum", "sum", lambda s, w: s * w * 0.5 + 0.25,
            lambda acc, p, aux, it: acc / (1.0 + acc),
            lambda aux: np.full(aux["num_v_pad"], 0.5, np.float32),
            lambda a, b, it: False, needs_weights=True, max_iters=8),
        # the low 16 source bits of closeness's bitmask, or-mode on int32
        "low_bits": gas.GASApp(
            "low_bits", "or", lambda s, w: s & 0xFFFF,
            lambda acc, p, aux, it: p | acc, gas.make_closeness().init,
            equal, prop_dtype="int32", max_iters=32),
    }


def _with_weights(p: dict, weights) -> dict:
    """Device payload ``p`` with other weights on its live edges (the
    stream's ``edge_w``; the device holds no padded weight)."""
    return dict(p, edge_w=weights)


def _udf_launch(vwin, p, geom, app):
    from repro_torch.kernels import gas_kernel
    from repro_torch.kernels.little_pipeline import _blocked
    return gas_kernel.gas_tiles(vwin, *_blocked(p), scatter_op=None,
                                mode=app.gather, t=geom.T,
                                scatter_fn=app.scatter)


def _udf_plain(vwin, p, geom, app, fn=None):
    from repro_torch.kernels import ref
    return ref.gas_stream_ref(
        vwin, p["edge_src"], p["edge_dst"], p["edge_w"],
        p["tile_edge_start"], scatter_fn=fn or app.scatter,
        mode=app.gather, t=geom.T, n_out_tiles=p["n_out_tiles"])


def _udf_held_to_plain(calls, geom, app) -> dict:
    """Each launch of ``calls`` with ``app``'s generated variant against
    its plain version on the same payload: bit-equal for min, max and
    or; for sum, slot by slot within the fp32 in-order summation error
    of the exact sum (``fp32_sum_share``), and its largest gap to the
    plain fp32 sum."""
    import torch
    share = err = 0.0
    try:
        for vwin, p in calls:
            k = _udf_launch(vwin, p, geom, app)
            plain = _udf_plain(vwin, p, geom, app)
            if app.gather == "sum":
                share = max(share, fp32_sum_share(k, lambda f, v=vwin, q=p: (
                    _udf_plain(v.double(), q, geom, app,
                               lambda x, w: f(app.scatter(
                                   x.float(), w).double())))))
                err = max(err, float((k - plain).abs().max()))
            else:
                check(torch.equal(k, plain), "kernel != plain")
    except CheckFailed as exc:
        raise CheckFailed(f"custom UDF {app.name}: {exc}") from None
    return {"fp32_sum_bound_used": share, "max_abs_err": err}


def _udf_library_ms(calls, geom, app, v_pad: int, device,
                    reps: int):
    """The library yardstick: the UDF over the pre-gathered sources and
    weights in torch ops, then one ``scatter_reduce`` into the padded
    vertex vector (device ms). None for ``or``: torch has no bitwise-or
    reduction."""
    import torch
    if app.gather == "or":
        return None
    src_parts, w_parts, idx_parts = [], [], []
    for vwin, p in calls:
        idx, src = _stream_slots(p, geom.T)
        src_parts.append(vwin.reshape(-1)[src])
        w_parts.append(p["edge_w"])
        idx_parts.append(idx)
    src, w, idx = torch.cat(src_parts), torch.cat(w_parts), \
        torch.cat(idx_parts)
    reduce = {"sum": "sum", "min": "amin", "max": "amax"}[app.gather]
    out = torch.zeros(v_pad, device=device)
    return cuda_ms(lambda: out.zero_().scatter_reduce_(
        0, idx, app.scatter(src, w), reduce=reduce, include_self=True),
        reps)


def _udf_bound_ms(calls, udf) -> tuple:
    """(bound ms, what bounds it) of one iteration's launches: the bytes
    and operations ``obs.launch_traffic`` counts (the weight of every
    real edge too when the UDF reads it)."""
    from repro_torch.obs import launch_traffic
    op = "add_weight" if udf.uses_weight else "copy"
    nbytes = n_ops = 0
    for _, p in calls:
        b, o = launch_traffic(p, op)
        nbytes, n_ops = nbytes + b, n_ops + o
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = n_ops / H100_FP32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes)


def phase_custom_udf(main_res: dict, kernel: dict, build_s: dict, device,
                     reps: int = REPS) -> list:
    """Phase 15: each app of :func:`custom_apps` through
    ``api.compile(...).run()`` on phase 3's store, its launches counted
    (``gas_tiles.launches`` zeroed just before, read just after), held
    to the plain path on the card (min/max/or bit-equal, sum at rtol
    1e-5 / atol 1e-7); each launch of one gather on random properties
    and weights held to the plain version (``_udf_held_to_plain``); the
    time of one iteration's launches beside PageRank's copy variant
    (phase 4), the bound, the plain version and the library call.
    Returns one ``kernels`` entry per generated variant."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.kernels import gas_kernel

    store, config = main_res["_store"], main_res["_config"]
    geom = store.geom
    gen = torch.Generator(device).manual_seed(SEED)
    entries = []
    for name, app in custom_apps().items():
        udf = gas_kernel.scatter_udf(app.scatter, app.gather)
        gas_kernel.gas_tiles.launches = 0
        kern = api.compile(None, app, store=store, config=config,
                           device=device)
        got, meta = kern.run()
        _sync(device)
        launches = gas_kernel.gas_tiles.launches
        payloads = [p for lane in kern.executor.lanes for p in lane]
        check(launches == len(payloads) * meta["iterations"] > 0,
              f"{name}: the generated variant launched {launches} times; "
              f"expected one per payload per iteration")
        plain = api.compile(None, app, store=store, config=config,
                            device=device, path="ref")
        want, meta_r = plain.run()
        check(meta["iterations"] == meta_r["iterations"],
              f"{name}: {meta['iterations']} iterations on the kernel path, "
              f"{meta_r['iterations']} on the plain path")
        if app.gather == "sum":
            check(np.allclose(got, want, rtol=1e-5, atol=1e-7),
                  f"{name}: kernel path vs plain path: max rel err "
                  f"{_max_rel(got, want)}")
        else:
            check(np.array_equal(got, want),
                  f"{name}: kernel path != plain path")
        # one gather's launches on random properties and weights
        vp = kern.executor.init_props()
        rnd = (torch.randint(-2 ** 31, 2 ** 31 - 1, vp.shape, device=device,
                             dtype=torch.int32, generator=gen)
               if app.gather == "or" else
               torch.rand(vp.shape, device=device, generator=gen) * 4 - 1)
        rcalls = [(v, _with_weights(p, torch.rand(
            p["edge_w"].shape, device=device, generator=gen)))
            for v, p in _calls(payloads, rnd, geom)]
        held = _udf_held_to_plain(rcalls, geom, app)
        calls = _calls(payloads, vp, geom)
        bound_ms, bound_by, nbytes = _udf_bound_ms(calls, udf)
        entries.append({
            "name": f"gas_tile_kernel[udf:{name}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gas_kernel.cu",
            "replaces": "src/repro/kernels/gas_kernel.py:67",
            "launches": launches,
            "max_abs_err": held["max_abs_err"],
            "fp32_sum_bound_used": held["fp32_sum_bound_used"],
            "ms": cuda_ms(lambda: [_udf_launch(v, p, geom, app)
                                   for v, p in calls], reps),
            "plain_ms": cuda_ms(lambda: [_udf_plain(v, p, geom, app)
                                         for v, p in calls], reps),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": _udf_library_ms(calls, geom, app, store.V_pad,
                                          device, reps),
            "bound_bytes": nbytes,
            "pagerank_copy_ms": kernel["kernel_ms"],
            "build_s": build_s[name],
            "mode": app.gather,
            "expr": udf.expr,
            "iterations": meta["iterations"],
            "launches_by_path": {"custom_udf": launches},
            "shapes": f"{name} ({app.gather}), one iteration's launches "
                      f"({len(payloads)} payloads)",
        })
    return entries


# ---------------------------------------------------------------------------
# Phase 16: the LM substrate's sharding on the card
# ---------------------------------------------------------------------------

SHARD_TRAIN = (4, 512)            # 16a: qwen2-1.5B bf16, one step, B x S
# 16b: granite-MoE f32, B x S, capacity factor. The reference's test
# uses capacity 50 on 8 x 16 tokens so that nothing overflows; at 8 x 512
# full-width tokens that is a 23 GB dispatch buffer and ~70 GB for the
# single-device run, more than one card holds beside two ranks, so 10,
# with every expert's load checked to stay within its capacity
SHARD_MOE = (8, 512, 10.0)
SHARD_TOL = 2e-2                  # 16a: loss and params, relative
# 16c: the dry run's cells, each with the most FLOP a rank may trace
# (None: recorded, no bound). qwen2 train_4k splits its batch over
# "model": within 1.25x the roofline's analytic share a rank; command-r
# prefill_32k (2 rows a data shard) splits heads and FFN: at least 10x
# under the 6.51e15 a rank traced while every model rank computed its
# group's whole work; qwen2 prefill_32k splits only its FFN dim, and a
# decode step nothing
DRYRUN_CELLS = {(LM_DENSE, "train_4k"): lambda r: 1.25 * r[
                    "analytic_flops_per_rank"],
                (LM_MOE, "decode_32k"): None,
                ("command_r_35b", "prefill_32k"): lambda r: 6.51e15 / 10,
                (LM_DENSE, "prefill_32k"): None}


def _rel_err(a, b) -> float:
    import torch
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _flop_count():
    """A dispatch mode that sums ``torch.utils.flop_counter``'s formulas
    (its ``flop_registry``, which ``FlopCounterMode`` applies) over the
    ops run under it, into ``total``: ``FlopCounterMode``'s count without
    its module tracking or its per-op guard, so with less host work in
    the steps it counts and times (phase 19 checks the two counts
    equal)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Count(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.total += formula(*args, **kwargs, out_val=out)
            return out
    return Count()


def _shard_train(device) -> dict:
    """16a: one AdamW step of qwen2-1.5B at full width in bf16 on 4 x 512
    tokens, unsharded and with params, state and batch placed by
    ``specs`` on a one-rank NCCL mesh (``make_host_mesh()``), from the
    same seeded init: loss and every param within SHARD_TOL relative;
    both steps' device ms (CUDA events, a warm-up and two steps each)
    and the peak memory each first step allocates over its
    arguments."""
    import datetime
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import adamw
    from repro_torch.sharding import specs
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves, tree_map

    b, s = SHARD_TRAIN
    cfg = get_config(LM_DENSE)
    model = build_model(cfg)
    opt = adamw()
    step = make_train_step(model, opt)
    params = model.init(torch.Generator(device).manual_seed(LM_SEED))
    state = opt.init(params)
    tok = torch.from_numpy(np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab_size, (b, s), dtype=np.int64).astype(np.int32)).to(
            device)
    batch = {"tokens": tok, "labels": tok}
    out = {"shape": [b, s]}
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    p1, _, m1 = step(params, state, batch)
    out["unsharded_peak_over_args_bytes"] = \
        torch.cuda.max_memory_allocated(device) - base
    want = tree_map(lambda t: t.cpu(), p1)
    loss1 = float(m1["loss"])
    del p1, m1
    out["unsharded_step_ms"] = cuda_ms(lambda: step(params, state, batch), 2)
    _free()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "rendezvous"), 1),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=600))
        try:
            mesh = make_host_mesh()
            pd = specs.distribute_tree(params, specs.tree_placements(
                params, mesh))
            sd = specs.distribute_tree(state, specs.tree_placements(
                state, mesh))
            bd = specs.distribute_tree(batch, specs.batch_placements(
                batch, mesh))
            del params, state             # the DTensors hold them now
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            p2, _, m2 = step(pd, sd, bd)
            out["sharded_peak_over_args_bytes"] = \
                torch.cuda.max_memory_allocated(device) - base
            out["loss"] = [loss1, float(m2["loss"])]
            check(abs(out["loss"][1] - loss1) <= SHARD_TOL * abs(loss1),
                  f"16a: sharded loss {out['loss'][1]} vs {loss1}")
            errs = [_rel_err(g.full_tensor().cpu(), w)
                    for g, w in zip(leaves(p2), leaves(want))]
            out["params_max_rel_err"] = max(errs)
            check(max(errs) <= SHARD_TOL,
                  f"16a: sharded params off by {max(errs)} relative")
            out["placements"] = str(pd["layers"]["wq"].placements)
            del p2, m2
            out["sharded_step_ms"] = cuda_ms(lambda: step(pd, sd, bd), 2)
            del pd, sd
        finally:
            dist.destroy_process_group()
    _free()
    return out


def _moe_rank(rank: int, world: int, tmp: str) -> None:
    """16b, one of two processes on the one card: granite-MoE's
    ``moe_ffn`` (one layer, f32) over a ("data", "model") = (1, 2) gloo
    mesh (the expert-sharded branch, E_pad 48 / 2); rank 0 also runs the
    single-device ``moe_ffn`` first. Writes rank 0's findings to
    ``tmp/moe.json``. Rank 0 also checks that no expert overflows its
    capacity under either split (``round_to`` 1 and 2), so that the two
    dispatches keep every assignment and must agree."""
    import dataclasses
    import datetime
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.models import common, moe
    from repro_torch.models.moe_schedule import biglittle_split
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    b, s, cf = SHARD_MOE
    cfg = dataclasses.replace(get_config(LM_MOE), dtype="float32")
    with torch.device(device):
        lp = moe.init_layer_params(cfg, torch.Generator(device).manual_seed(
            LM_SEED))
    lp = {k: lp[k].float() for k in ("router", "we_gate", "we_up",
                                     "we_down")}
    x = torch.randn((b, s, cfg.d_model), device=device,
                    generator=torch.Generator(device).manual_seed(1)) * 0.5
    res = {"E_pad": cfg.num_experts_padded, "d_model": cfg.d_model,
           "moe_d_ff": cfg.moe_d_ff, "shape": [b, s], "capacity": cf}
    if rank == 0:
        E, K, T = cfg.num_experts_padded, cfg.top_k, b * s
        _, gi, _ = moe._route(x.reshape(T, -1), lp["router"], K,
                              cfg.num_experts)
        load = torch.bincount(gi.reshape(-1), minlength=E).cpu()
        res["max_expert_load"] = int(load.max())
        res["capacities"] = {}
        for r in (1, world):
            n_hot, c_hot, c_cold = biglittle_split(E, K, T, cf, round_to=r)
            res["capacities"][r] = [n_hot, c_hot, c_cold]
            res.setdefault("drop_free", True)
            res["drop_free"] &= bool((load[:n_hot] <= c_hot).all()
                                     and (load[n_hot:] <= c_cold).all())
        local, _ = moe.moe_ffn(cfg, lp, x, capacity_factor=cf)
        res["single_ms"] = cuda_ms(
            lambda: moe.moe_ffn(cfg, lp, x, capacity_factor=cf), 2)
        local = local.cpu()
        torch.cuda.empty_cache()
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "rendezvous"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=600))
    try:
        mesh = init_device_mesh("cpu", (1, world),
                                mesh_dim_names=("data", "model"))
        with common.use_mesh(mesh):
            out, _ = moe.moe_ffn(cfg, lp, x, capacity_factor=cf)
            torch.cuda.synchronize()
            dist.barrier()
            start = time.perf_counter()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            moe.moe_ffn(cfg, lp, x, capacity_factor=cf)
            ev[1].record()
            torch.cuda.synchronize()
            res["sharded_ms_events"] = ev[0].elapsed_time(ev[1])
            res["sharded_ms_host"] = (time.perf_counter() - start) * 1e3
        res["e_per_rank"] = cfg.num_experts_padded // mesh.size(1)
        if rank == 0:
            got = out.cpu()
            res["max_abs_err"] = float((got - local).abs().max())
            res["allclose"] = bool(torch.allclose(got, local, rtol=1e-4,
                                                  atol=1e-5))
            res["finite"] = bool(torch.isfinite(got).all())
            with open(os.path.join(tmp, "moe.json"), "w") as f:
                json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _shard_moe() -> dict:
    """16b: :func:`_moe_rank` in two spawned processes sharing the card
    (NCCL takes one rank per GPU, so the group is gloo): the
    expert-sharded output against the single-device one at rtol 1e-4 /
    atol 1e-5, the reference's tolerance. Two ranks on one card: its
    times are not multi-card times."""
    import tempfile
    import torch
    import torch.multiprocessing as mp
    _free()
    reserved = torch.cuda.memory_reserved()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_moe_rank, args=(2, tmp), nprocs=2)
        with open(os.path.join(tmp, "moe.json")) as f:
            res = json.load(f)
    check(res["drop_free"], f"16b: an expert overflows its capacity "
          f"({res['max_expert_load']} assignments; {res['capacities']})")
    check(res["finite"] and res["allclose"],
          f"16b: expert-sharded moe_ffn vs single device: max abs err "
          f"{res['max_abs_err']}")
    res["parent_reserved_bytes"] = reserved
    return res


def _shard_dryrun() -> dict:
    """16c: the dry run of ``DRYRUN_CELLS`` at the pod mesh (256 fake
    ranks): each record's status, the split over "model", rank 0's
    argument bytes, traced peak, collective bytes and traced FLOPs
    beside the analytic share a rank; each must fit 80 GB and trace at
    most its cell's bound."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    out = {}
    try:
        for (arch, shape), bound in DRYRUN_CELLS.items():
            rec = dryrun.run_cell(arch, shape, False, force=True)
            check(rec["status"] == "ok",
                  f"16c: dry run {arch} {shape}: {rec.get('error')}")
            check(rec["memory"]["fits_80g_hbm"],
                  f"16c: {arch} {shape} traces a peak of "
                  f"{rec['memory']['peak_traced_bytes']} B a rank")
            if bound is not None:
                check(rec["traced_flops_per_rank"] <= bound(rec),
                      f"16c: {arch} {shape} traces "
                      f"{rec['traced_flops_per_rank']:.4g} FLOP a rank, "
                      f"more than {bound(rec):.4g}")
            out[f"{arch}.{shape}"] = {
                "status": rec["status"], "mesh": rec["mesh"],
                "trace_s": rec["trace_s"], "memory": {
                    k: rec["memory"][k] for k in (
                        "argument_bytes", "output_bytes", "alias_bytes",
                        "peak_traced_bytes", "fits_80g_hbm")},
                "collectives": rec["collectives"],
                "traced_flops_per_rank": rec["traced_flops_per_rank"],
                "analytic_flops_per_rank": rec["analytic_flops_per_rank"],
                "model_split": rec["model_split"],
                "roofline_dominant": rec["roofline"]["dominant"],
                "roofline_bound_s": rec["roofline"]["roofline_bound_s"]}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return out


def phase_sharding(device) -> dict:
    """Phase 16: 16a the sharded train step on a one-rank NCCL mesh, 16b
    the expert-sharded MoE over two processes on the card, 16c the dry
    run at the production pod mesh."""
    import torch
    torch.cuda.init()
    t0 = time.perf_counter()
    out = {"train": _shard_train(device)}
    out["t_train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["moe"] = _shard_moe()
    out["t_moe_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["dryrun"] = _shard_dryrun()
    out["t_dryrun_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 17: the sharded step's compute split over "model"
# ---------------------------------------------------------------------------

# qwen2-1.5B bf16, one AdamW step, B x S, on ("data", "model") = (1, 2):
# 17a's 4 rows split over "model" (2 a rank), 17b's 1 row does not, so
# the heads (6 of 12, 1 of 2 KV heads) and the FFN dim (4,480 of 8,960)
SPLIT_CASES = {"17a": ((4, 512), "batch"), "17b": ((1, 512), "heads+ffn")}
SPLIT_FLOP_SHARE = 0.6            # a rank's FLOPs over the unsharded step's
SPLIT_LR = 3e-4                   # AdamW's (its default, as 16a's)
# gloo takes an all-reduce of CUDA tensors (phase 16b) but a gloo
# all-gather of CUDA tensors kills the process, so phase 17's two
# processes send these through host memory
STAGED_COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor",
                      "all_to_all_single")


def _stage_through_host(counts: dict):
    """This process's transport for phase 17: the CUDA kernel of each of
    ``STAGED_COLLECTIVES`` (the functional collectives DTensor and the
    model call) becomes one that copies its input to the host, runs the
    gloo collective there and copies the result back, counting calls in
    ``counts``. The model path calls the same collectives; only where
    their bytes travel changes. Returns the registration, which lasts as
    long as it is referenced."""
    import torch
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name in STAGED_COLLECTIVES:
        def staged(x, *args, op=getattr(torch.ops._c10d_functional,
                                        name).default, name=name):
            counts[name] = counts.get(name, 0) + 1
            out = torch.ops._c10d_functional.wait_tensor(op(x.cpu(), *args))
            return out.to(x.device)
        lib.impl(name, staged, "CUDA")
    return lib


def _held_to_unsharded(got: list, ref: dict) -> dict:
    """Phase 17's params (``got``, leaf by leaf) against the unsharded
    step's: the largest difference over the leaf's largest |param|, as
    16a holds it, over every element and over the elements whose
    unsharded gradient is beyond SHARD_TOL of the leaf's largest. AdamW's
    first step moves an element by +-lr whatever its gradient's size, so
    where the gradient is within that tolerance of zero a summation in
    another order can turn its sign and the move: those elements are
    held to 2 lr beyond SHARD_TOL (``near_zero_beyond_tol_max``, the
    largest excess; ``near_zero_flipped``, how many exceed SHARD_TOL),
    as ``tests/test_torch_sharding_lm.py`` holds such elements to lr.
    ``leaves``: per leaf, its error over every element, the count beyond
    SHARD_TOL and the largest of their unsharded gradients over the
    leaf's largest."""
    every = settled = excess = 0.0
    flipped = 0
    rows = {}
    for name, g, w, d in zip(ref["paths"], got, ref["params"], ref["grads"]):
        g, w, d = (t.to(got[0].device).float() for t in (g, w, d))
        scale = w.abs().max().clamp_min(1e-30)
        diff = (g - w).abs() / scale
        near0 = d.abs() <= SHARD_TOL * d.abs().max()
        beyond = diff > SHARD_TOL
        rows[name] = [float(diff.max()), int(beyond.sum()), float(
            (d.abs() * beyond).max() / d.abs().max().clamp_min(1e-30))]
        every = max(every, rows[name][0])
        if (~near0).any():
            settled = max(settled, float(diff[~near0].max()))
        if near0.any():
            loose = (diff[near0] - SHARD_TOL) * scale
            flipped += int((loose > 0).sum())
            excess = max(excess, float(loose.max()))
    return {"params_max_rel_err": every,
            "params_max_rel_err_settled": settled,
            "near_zero_flipped": flipped,
            "near_zero_beyond_tol_max": excess, "leaves": rows}


def _event_ms(fn) -> float:
    """Device ms of one ``fn()`` between two CUDA events."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1])


def _split_rank(rank: int, world: int, tmp: str, device: str) -> None:
    """Phase 17, one of two processes on the one card: qwen2-1.5B's
    AdamW step on each of ``SPLIT_CASES``' batches, unsharded (rank 0,
    before either rank places anything, then freed) and placed by
    ``specs`` on a ("data", "model") = (1, 2) gloo mesh, from the same
    seeded init. Per case and rank: the split the step took, loss,
    params, step ms (CUDA events), peak over the arguments and FLOPs
    (:func:`_flop_count`). Rank 0 writes every rank's numbers to
    ``tmp/split.json``. ``device`` is "cuda" (the card's first) but for
    a rehearsal on the CPU."""
    import datetime
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import adamw
    from repro_torch.sharding import specs
    from repro_torch.train.step import make_train_step, value_and_grad
    from repro_torch.tree import flatten_with_path, leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device = torch.device(device, 0)
    staged: dict = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        transport = _stage_through_host(staged)   # kept while it runs
    cfg = get_config(LM_DENSE)
    model = build_model(cfg)
    opt = adamw(lr=SPLIT_LR)
    step = make_train_step(model, opt)

    def batch_of(b, s):
        tok = torch.from_numpy(np.random.default_rng(LM_SEED).integers(
            0, cfg.vocab_size, (b, s), dtype=np.int64).astype(np.int32))
        return {"tokens": tok.to(device), "labels": tok.to(device)}

    def counted(fn):
        with _flop_count() as fc:
            out = fn()
        return out, fc.total

    res = {"rank": rank, "cases": {}}
    ref = {}
    if rank == 0:
        params = model.init(torch.Generator(device).manual_seed(LM_SEED))
        state = opt.init(params)
        for case, ((b, s), _) in SPLIT_CASES.items():
            batch = batch_of(b, s)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            # (params, metrics): the new state is dropped at once
            (p1, m1), flops = counted(lambda: step(params, state, batch)[::2])
            ref[case] = {
                "loss": float(m1["loss"]), "flops": flops,
                "params": [t.cpu() for t in leaves(p1)],
                "paths": [".".join(k) for k, _ in flatten_with_path(p1)[0]],
                "grads": [t.cpu() for t in leaves(value_and_grad(
                    model.loss, params, batch)[1])],
                "peak_over_args_bytes":
                    torch.cuda.max_memory_allocated(device) - base}
            del p1, m1
            ref[case]["step_ms"] = _event_ms(
                lambda: step(params, state, batch))
        del params, state
        _free()
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "rendezvous"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=600))
    try:
        mesh = init_device_mesh(device.type, (1, world),
                                mesh_dim_names=("data", "model"))
        params = model.init(torch.Generator(device).manual_seed(LM_SEED))
        pd = specs.distribute_tree(params, specs.tree_placements(params,
                                                                 mesh))
        del params
        sd = opt.init(pd)                 # the moments placed as the params
        sd["step"] = specs.distribute(sd["step"], specs.replicated(mesh))
        for case, ((b, s), _) in SPLIT_CASES.items():
            batch = batch_of(b, s)
            bd = specs.distribute_tree(batch, specs.batch_placements(batch,
                                                                     mesh))
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            (p2, m2), flops = counted(lambda: step(pd, sd, bd)[::2])
            out = {"split": m2["model_split"], "loss": float(m2["loss"]),
                   "flops": flops, "shape": [b, s],
                   "peak_over_args_bytes":
                       torch.cuda.max_memory_allocated(device) - base}
            got = [t.full_tensor() for t in leaves(p2)]
            del p2, m2
            dist.barrier()                # the ranks' steps start together
            out["step_ms"] = _event_ms(lambda: step(pd, sd, bd))
            if rank == 0:
                out.update(_held_to_unsharded(got, ref[case]))
            del got
            res["cases"][case] = out
        res["staged_collectives"] = dict(staged)
        every = [None] * world
        dist.all_gather_object(every, res)
        if rank == 0:
            for case, r in ref.items():
                del r["params"], r["grads"], r["paths"]
            with open(os.path.join(tmp, "split.json"), "w") as f:
                json.dump({"unsharded": ref, "ranks": every}, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
        if device.type == "cuda":
            del transport


def phase_split() -> dict:
    """Phase 17: :func:`_split_rank` in two spawned processes sharing
    the card over gloo (NCCL takes one rank per GPU): per case the split
    the step took, loss and params within SHARD_TOL of the unsharded
    step, each rank's FLOPs at most SPLIT_FLOP_SHARE of its. Two ranks
    on one card: their times are not multi-card times."""
    import tempfile
    import torch
    import torch.multiprocessing as mp
    _free()
    reserved = torch.cuda.memory_reserved()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_split_rank, args=(2, tmp, "cuda"), nprocs=2)
        with open(os.path.join(tmp, "split.json")) as f:
            res = json.load(f)
    res["parent_reserved_bytes"] = reserved
    log("phase 17: " + json.dumps(res))
    for case, (_, split) in SPLIT_CASES.items():
        ref = res["unsharded"][case]
        for r in res["ranks"]:
            got = r["cases"][case]
            check(got["split"] == split,
                  f"{case}: rank {r['rank']} took split {got['split']}, "
                  f"not {split}")
            check(abs(got["loss"] - ref["loss"]) <= SHARD_TOL
                  * abs(ref["loss"]), f"{case}: rank {r['rank']} loss "
                  f"{got['loss']} vs unsharded {ref['loss']}")
            check(got["flops"] <= SPLIT_FLOP_SHARE * ref["flops"],
                  f"{case}: rank {r['rank']} runs {got['flops']:.4g} FLOP, "
                  f"the unsharded step {ref['flops']:.4g}")
        got = res["ranks"][0]["cases"][case]
        check(got["params_max_rel_err_settled"] <= SHARD_TOL
              and got["near_zero_beyond_tol_max"] <= 2 * SPLIT_LR,
              f"{case}: params off by {got['params_max_rel_err_settled']} "
              f"relative, {got['near_zero_beyond_tol_max']} beyond it where "
              f"the gradient is near zero")
    return res


# phase 18: decode under the columns split on ("data", "model") = (1, 2)
DECODE_SPLIT_ARCHS = (LM_DENSE, LM_MOE, LM_SSM, LM_HYBRID, LM_AUDIO)
DECODE_SPLIT_PROMPT = (2, 512)    # unsharded prefill, B x S
DECODE_SPLIT_CACHE = 1024         # self-attention positions after growth
DECODE_SPLIT_STEPS = 8            # teacher-forced decode steps
DECODE_SPLIT_TOL = 1e-3           # f32 logits, relative to their largest
# bf16: the split's logits at most this many times as far from the f32
# logits (the same weights and cache, upcast) as the unsharded step's
DECODE_SPLIT_BF16_FACTOR = 2.0


def _rel_errs(got: list, want: list, cols: slice) -> list:
    """Per step, the largest |got - want| over want's largest, on the
    vocabulary columns ``cols`` (of ``want``, and of ``got`` where it
    holds every column)."""
    out = []
    for g, w in zip(got, want):
        w = w[..., cols]
        g = g[..., cols] if g.shape[-1] != w.shape[-1] else g
        out.append(float((g - w).abs().max() / w.abs().max()))
    return out


def _decode_split_arch(arch: str, mesh, device) -> dict:
    """Phase 18 for one family on this rank: the bf16 unsharded prefill
    and DECODE_SPLIT_STEPS decode steps, the same steps on the same
    weights and cache upcast to f32, then both under the columns split
    on this rank's slices of the cache and the params."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config, torch_dtype
    from repro_torch.models import common, shards
    from repro_torch.models.api import build_model
    from repro_torch.sharding import specs
    from repro_torch.tree import tree_map
    cfg = get_config(arch)
    models = {"bf16": build_model(cfg), "f32": build_model(
        dataclasses.replace(cfg, dtype="float32"))}
    b, s = DECODE_SPLIT_PROMPT
    rng = np.random.default_rng(LM_SEED)
    tok = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, s + DECODE_SPLIT_STEPS)).astype(
            np.int32)).to(device)
    batch = {"tokens": tok[:, :s]}
    if cfg.frontend == "audio":
        batch["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model), dtype=np.float32)).to(
                device, torch_dtype(cfg.dtype))
    params = models["bf16"].init(torch.Generator(device).manual_seed(LM_SEED))
    with torch.no_grad():
        cache, _ = models["bf16"].prefill(params, batch)
    cache = {"bf16": _grown(cfg, cache, DECODE_SPLIT_CACHE - s)}
    cache["f32"] = tree_map(lambda t: t.to(torch.float32, copy=True),
                            cache["bf16"])       # its own, written in place
    split = specs.model_split_decode(mesh)
    local = {k: {n: t.to_local().clone() for n, t in specs.distribute_tree(
        c, specs.decode_cache_placements(c, mesh, cfg.family)).items()}
        for k, c in cache.items()}
    shards_bf16 = shards.local_shards(specs.distribute_tree(
        params, specs.tree_placements(params, mesh)))

    def steps(model, p, c):
        """(logits of each step, FLOPs of the first, ms of the rest)."""
        out, flops, ms = [], 0, []
        for t in range(DECODE_SPLIT_STEPS):
            tk = tok[:, s + t:s + t + 1]
            if t == 0:
                with _flop_count() as fc:
                    lg, _ = model.decode_step(p, c, tk, s + t)
                flops = fc.total
            else:
                got = {}
                ms.append(_event_ms(lambda: got.update(
                    lg=model.decode_step(p, c, tk, s + t)[0])))
                lg = got["lg"]
            out.append(lg.float())
        return out, flops, ms

    def upcast(tree):
        return tree_map(lambda t: t.float(), tree)

    # one model's whole weights at a time (the card also holds what
    # phases 1-17 keep, and the other rank's)
    full, split_run = {}, {}
    with torch.no_grad():
        full["bf16"] = steps(models["bf16"], params, cache["bf16"])
        params = upcast(params)
        full["f32"] = steps(models["f32"], params, cache["f32"])
        state_full = sum(t.numel() * t.element_size()
                         for t in cache["bf16"].values())
        del params, cache
        sh, pl = shards_bf16
        del shards_bf16
        for k in ("bf16", "f32"):
            if k == "f32":
                sh = upcast(sh)
            view = shards.model_view(sh, pl, mesh, (), split)
            with common.use_mesh(mesh, (), split):
                split_run[k] = steps(models[k], view, local[k])
            del view
    v = split_run["bf16"][0][0].shape[-1]      # this rank's vocabulary
    cols = slice(mesh.get_local_rank("model") * v,
                 (mesh.get_local_rank("model") + 1) * v)
    want = full["f32"][0]
    return {"split": split.name, "vocab_slice": [cols.start, cols.stop],
            "f32_rel_err_per_step": _rel_errs(split_run["f32"][0], want,
                                              cols),
            "bf16_rel_err_per_step": _rel_errs(split_run["bf16"][0], want,
                                               cols),
            "unsharded_bf16_rel_err_per_step": _rel_errs(full["bf16"][0],
                                                         want, cols),
            "bf16_vs_unsharded_bf16_rel_err_per_step": _rel_errs(
                split_run["bf16"][0], full["bf16"][0], cols),
            "flops": split_run["bf16"][1], "unsharded_flops": full["bf16"][1],
            "state_bytes": sum(t.numel() * t.element_size()
                               for t in local["bf16"].values()),
            "unsharded_state_bytes": state_full,
            "step_ms": float(np.median(split_run["bf16"][2])),
            "unsharded_step_ms": float(np.median(full["bf16"][2])),
            "f32_step_ms": float(np.median(split_run["f32"][2])),
            "unsharded_f32_step_ms": float(np.median(full["f32"][2]))}


# 18b: each family's f32 prefill of DECODE_SPLIT_PROMPT (2 rows, which
# divide over 2 model ranks: the rule's "batch") handed off to the split
# decode (``shards.sharded_prefill(..., cache_len=DECODE_SPLIT_CACHE)``)
# on the weights placed replicated, as 19a places them; granite at
# SEQ_SPLIT_MOE_CAPACITY, where neither one device nor two model ranks
# drop a token (F11); then HANDOFF_STEPS split decode steps from the
# handed-off slice
HANDOFF_STEPS = 2


def _handoff_arch(arch: str, mesh, device) -> dict:
    """Phase 18b for one family on this rank: the unsharded f32 prefill
    of phase 18's prompt on phase 18's weights upcast, grown to
    DECODE_SPLIT_CACHE positions (:func:`_grown`) and placed by
    ``specs.decode_cache_placements`` (this rank's slice of it), and
    HANDOFF_STEPS unsharded f32 decode steps on it; then the same
    prefill through ``sharded_prefill`` with the cache's length, and the
    split decode steps ("columns") from the slice it hands off, with
    nothing in between. Returns the splits, each leaf's distance from
    the placed slice relative to its largest value, both slices' bytes,
    each step's logits' distance from the unsharded step's (this rank's
    vocabulary slice) and the split prefill's seconds."""
    import contextlib
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import common, shards
    from repro_torch.models.api import build_model
    from repro_torch.sharding import specs
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=SEQ_SPLIT_MOE_CAPACITY)
    model = build_model(cfg)
    b, s = DECODE_SPLIT_PROMPT
    rng = np.random.default_rng(LM_SEED)
    tok = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, s + HANDOFF_STEPS)).astype(np.int32)).to(
            device)
    batch = {"tokens": tok[:, :s]}
    if cfg.frontend == "audio":
        batch["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model), dtype=np.float32)).to(device)
    params = _upcast(build_model(get_config(arch)).init(
        torch.Generator(device).manual_seed(LM_SEED)))
    dsplit = specs.model_split_decode(mesh)

    def steps(p, c, ctx):
        out = []
        with ctx:
            for t in range(HANDOFF_STEPS):
                out.append(model.decode_step(p, c, tok[:, s + t:s + t + 1],
                                             s + t)[0].float())
        return out

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree.values())

    with torch.no_grad():
        cache, _ = model.prefill(params, batch)
        cache = _grown(cfg, cache, DECODE_SPLIT_CACHE - s)
        want = {k: t.to_local().clone() for k, t in specs.distribute_tree(
            cache, specs.decode_cache_placements(cache, mesh,
                                                 cfg.family)).items()}
        full = steps(params, cache, contextlib.nullcontext())
        del cache
        pd = specs.distribute_tree(params, specs.replicated(mesh))
        del params
        bd = specs.distribute_tree(batch, specs.batch_placements(batch, mesh))
        t0 = time.perf_counter()
        got, _, split = shards.sharded_prefill(model.prefill, pd, bd, cfg,
                                               cache_len=DECODE_SPLIT_CACHE)
        prefill_s = time.perf_counter() - t0
        leaf_err = {k: _rel_err(got[k], w) for k, w in want.items()}
        out = {"split": split.name, "decode_split": dsplit.name,
               "tol": SEQ_SPLIT_SCAN_TOL if cfg.family in ("ssm", "hybrid")
               else SEQ_SPLIT_TOL, "rel_err": leaf_err,
               "slice_bytes": nbytes(got), "placed_bytes": nbytes(want),
               "prefill_s": prefill_s}
        del want
        view = shards.model_view(*shards.local_shards(pd), mesh, (), dsplit)
        split_steps = steps(view, got, common.use_mesh(mesh, (), dsplit))
    v = split_steps[0].shape[-1]
    r = mesh.get_local_rank("model")
    out["step_rel_err"] = _rel_errs(split_steps, full,
                                    slice(r * v, (r + 1) * v))
    return out


def _decode_split_rank(rank: int, world: int, tmp: str, device: str) -> None:
    """Phase 18, one of two processes on the one card: each of
    DECODE_SPLIT_ARCHS through :func:`_decode_split_arch` on a ("data",
    "model") = (1, 2) gloo mesh, collectives staged through the host as
    phase 17's. Rank 0 writes every rank's numbers to
    ``tmp/decode_split.json``. ``device`` is "cuda" (the card's first)
    but for a rehearsal on the CPU."""
    import datetime
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device = torch.device(device, 0)
    staged: dict = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        transport = _stage_through_host(staged)   # kept while it runs
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "rendezvous"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=600))
    try:
        mesh = init_device_mesh(device.type, (1, world),
                                mesh_dim_names=("data", "model"))
        res = {"rank": rank, "archs": {}}
        for arch in DECODE_SPLIT_ARCHS:
            dist.barrier()                # the ranks' steps start together
            t0 = time.perf_counter()
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            a = res["archs"][arch] = _decode_split_arch(arch, mesh, device)
            a["s"] = time.perf_counter() - t0
            if device.type == "cuda":
                a["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                    device)
                _free()
            dist.barrier()
            t0 = time.perf_counter()
            h = a["handoff"] = _handoff_arch(arch, mesh, device)
            h["s"] = time.perf_counter() - t0
            if device.type == "cuda":
                _free()
        res["staged_collectives"] = dict(staged)
        every = [None] * world
        dist.all_gather_object(every, res)
        if rank == 0:
            with open(os.path.join(tmp, "decode_split.json"), "w") as f:
                json.dump({"ranks": every}, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
        if device.type == "cuda":
            del transport


def phase_decode_split() -> dict:
    """Phase 18: :func:`_decode_split_rank` in two spawned processes
    sharing the card over gloo. Per family and rank, at every step: the
    columns split; in f32 the logits within DECODE_SPLIT_TOL of the
    unsharded step's, relative to their largest (the same function); in
    bf16, on the same weights and cache, the logits at most
    DECODE_SPLIT_BF16_FACTOR times as far from the f32 logits as the
    unsharded bf16 step's, over the steps (the split adds no more
    rounding than it has); the bf16 FLOPs at most SPLIT_FLOP_SHARE of
    the unsharded step's and the decode state half the unsharded
    cache's. 18b (:func:`_handoff_arch`): the prefill takes "batch" and
    the decode "columns"; each leaf of the handed-off slice within
    SEQ_SPLIT_TOL (mamba2 and hymba SEQ_SPLIT_SCAN_TOL) of the placed
    unsharded f32 cache, relative to its largest value, and as many
    bytes; the split decode steps from it within DECODE_SPLIT_TOL of the
    unsharded f32 steps."""
    import tempfile
    import torch.multiprocessing as mp
    _free()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_decode_split_rank, args=(2, tmp, "cuda"), nprocs=2)
        with open(os.path.join(tmp, "decode_split.json")) as f:
            res = json.load(f)
    log("phase 18: " + json.dumps(res))
    for r in res["ranks"]:
        for arch, a in r["archs"].items():
            where = f"{arch}: rank {r['rank']}"
            check(a["split"] == "columns",
                  f"{where} took split {a['split']}, not columns")
            check(max(a["f32_rel_err_per_step"]) <= DECODE_SPLIT_TOL,
                  f"{where} f32 logits off by {a['f32_rel_err_per_step']} "
                  f"relative to the unsharded step's")
            bound = DECODE_SPLIT_BF16_FACTOR * max(
                a["unsharded_bf16_rel_err_per_step"])
            check(max(a["bf16_rel_err_per_step"]) <= bound,
                  f"{where} bf16 logits off the f32 ones by "
                  f"{a['bf16_rel_err_per_step']}, the unsharded bf16 "
                  f"step's by {a['unsharded_bf16_rel_err_per_step']}")
            check(a["flops"] <= SPLIT_FLOP_SHARE * a["unsharded_flops"],
                  f"{where} runs {a['flops']:.4g} FLOP, the unsharded "
                  f"step {a['unsharded_flops']:.4g}")
            check(2 * a["state_bytes"] == a["unsharded_state_bytes"],
                  f"{where} holds {a['state_bytes']} B of decode state, "
                  f"the unsharded cache {a['unsharded_state_bytes']} B")
            h, where = a["handoff"], f"18b {where}"
            check(h["split"] == "batch" and h["decode_split"] == "columns",
                  f"{where}: prefill split {h['split']}, decode split "
                  f"{h['decode_split']}, not batch and columns")
            for name, e in h["rel_err"].items():
                check(e <= h["tol"], f"{where}: the handed-off {name} off "
                      f"the placed unsharded f32 cache by {e} of its "
                      f"largest, beyond {h['tol']}")
            check(h["slice_bytes"] == h["placed_bytes"],
                  f"{where}: the handed-off slice holds {h['slice_bytes']} "
                  f"B, the placed cache {h['placed_bytes']} B")
            check(max(h["step_rel_err"]) <= DECODE_SPLIT_TOL,
                  f"{where}: the split decode steps from the handed-off "
                  f"slice off the unsharded f32 steps by "
                  f"{h['step_rel_err']}")
    return res


# ---------------------------------------------------------------------------
# Phase 19: train and prefill steps split by positions over "model"
# ---------------------------------------------------------------------------

SEQ_SPLIT_ARCHS = (LM_DENSE, LM_MOE, LM_SSM, LM_HYBRID, LM_AUDIO)
SEQ_SPLIT_PREFILL = (1, 4096)     # rows x positions: 2,048 a rank
SEQ_SPLIT_TRAIN = (2, 2048, 2)    # 19b: rows x positions, microbatches
SEQ_SPLIT_TOL = 1e-5              # f32 against the unsharded step, of its
SEQ_SPLIT_SCAN_TOL = 1e-4         # largest value; mamba2 and hymba
SEQ_SPLIT_BF16_FACTOR = 2.0       # bf16: at most this x the unsharded's
# bf16 against the unsharded bf16 step itself, relative to the largest
# value: every leaf, and the first layer's slice of each cache leaf
# (on the card: 0 for qwen2, mamba2 and whisper, at most 0.0246 for
# granite and 0.0358 for hymba, and 0 at every first layer; the unsharded
# bf16 step is 0.13-0.22 from f32 for hymba, 0.025 for granite). The
# ceiling is 2.2x the largest reading, under half hymba's distance from
# f32; the first layer's bound is one or two bf16 roundings of the
# largest value, far under what a position misplaced or dropped gives
SEQ_SPLIT_BF16_CEIL = 0.08
SEQ_SPLIT_BF16_FIRST_LAYER = 1e-2
SEQ_SPLIT_HEAVY = (LM_MOE, LM_SSM)  # f32 weights too big beside 19b's step
# granite's capacity factor in 19a: every expert's smallest capacity, at
# 1 and at 2 model ranks, holds all 4,096 tokens (top-k experts are
# distinct, so no expert gets more), so neither dispatch drops. At its
# own 1.25 the capacities differ with the model ranks (the biglittle
# split rounds its hot experts to them, as the reference's does), and
# so do the drops: a different function, whatever the split
SEQ_SPLIT_MOE_CAPACITY = 5.0
# the families the rule lays out in a zigzag of two spans a rank (their
# positions mix only through attention; 4,096 divide by 2 x 2 ranks),
# whose ranks then visit as many attention blocks: their FLOPs a rank
# within SEQ_SPLIT_FLOP_LEVEL of each other
SEQ_SPLIT_ZIGZAG = (LM_DENSE, LM_MOE, LM_AUDIO)
SEQ_SPLIT_FLOP_LEVEL = 0.03
# 19a's f32 prefill also hands its cache off to the split decode: a
# cache of 4,096 + 8 positions, 2,052 a rank (the zigzag's positions, or
# the contiguous span's, are not the decode slice), then one split
# decode step from the slice
SEQ_HANDOFF_CACHE = SEQ_SPLIT_PREFILL[1] + 8
# observations printed beside this run's, not checked: the unsharded
# bf16 prefill's ms (phase 19a) and phase 14a's flash forward + backward
# ms with every KV block visited, on an H100 80GB HBM3 at 700 W
# (``chip_smoke.py`` before attention skipped the blocks its queries
# cannot see)
EVERY_BLOCK_PREFILL_MS = {LM_DENSE: 264.2, LM_MOE: 618.0, LM_SSM: 2053.4,
                          LM_HYBRID: 1625.1, LM_AUDIO: 73.0}
EVERY_BLOCK_ATTN_MS = {"fp32": 10.71, "bf16": 12.00}


def _attention_pairs():
    """A context that counts the (query block, KV block) pairs
    ``common.blockwise_attention`` visits, and the pairs there are, while
    it is open: it yields ``[visited, there]``."""
    import contextlib
    from repro_torch.models import common

    @contextlib.contextmanager
    def counting():
        visible, pairs = common._visible_q_blocks, [0, 0]

        def counted(causal, window, q_offset, q_block, kv_block, sq, skv):
            got = visible(causal, window, q_offset, q_block, kv_block, sq,
                          skv)
            pairs[0] += sum(z - a for a, z in got)
            pairs[1] += -(-sq // q_block) * len(got)
            return got
        common._visible_q_blocks = counted
        try:
            yield pairs
        finally:
            common._visible_q_blocks = visible
    return counting()


def _seq_inputs(arch: str, device) -> tuple:
    """(config by dtype, model by dtype, bf16 batch) of phase 19a's
    ``arch``: full width and depth, granite at SEQ_SPLIT_MOE_CAPACITY,
    one row of SEQ_SPLIT_PREFILL[1] seeded tokens (and whisper's seeded
    frames)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config, torch_dtype
    from repro_torch.models.api import build_model
    cfg = get_config(arch)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=SEQ_SPLIT_MOE_CAPACITY)
    cfgs = {"bf16": cfg, "f32": dataclasses.replace(cfg, dtype="float32")}
    b, s = SEQ_SPLIT_PREFILL
    rng = np.random.default_rng(LM_SEED)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).to(device)}
    if cfg.frontend == "audio":
        batch["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model), dtype=np.float32)).to(
                device, torch_dtype(cfg.dtype))
    return cfgs, {k: build_model(c) for k, c in cfgs.items()}, batch


def _upcast(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.float() if t.is_floating_point() else t,
                    tree)


def _seq_run(fn, counted: bool, device) -> dict:
    """``fn()``'s (cache, logits[, split]) as f32 copies, with its peak
    over what was allocated before it and its FLOPs
    (:func:`_flop_count`, and ``FlopCounterMode``'s count of the same
    run beside it, and the attention's block pairs visited and there
    are, :func:`_attention_pairs`) where ``counted``, else its ms (CUDA
    events). Each step of phase 19a runs once: the f32 step is counted,
    the bf16 one timed (the counts depend on the shapes alone)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    got, res = [], {}
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    if counted:
        with _flop_count() as fc, FlopCounterMode(display=False) as ref, \
                _attention_pairs() as pairs:
            got.append(fn())
        res.update(flops=fc.total, flops_counter_mode=ref.get_total_flops(),
                   attention_pairs=pairs)
    else:
        res["ms"] = _event_ms(lambda: got.append(fn()))
    res["peak_over_args_bytes"] = \
        torch.cuda.max_memory_allocated(device) - base
    out = got.pop()
    res.update(cache=_upcast(out[0]), logits=out[1].float())
    if len(out) > 2:
        res["split"], res["layout"] = out[2].name, out[2].layout
    return res


def _seq_unsharded(arch: str, device) -> dict:
    """Phase 19a's unsharded prefills of ``arch`` on this rank: bf16
    (timed after one untimed run), then on the same weights upcast to
    f32 (counted), and one f32 decode step at position
    SEQ_SPLIT_PREFILL[1] (the prompt's last token again) on a copy of
    the f32 cache grown to SEQ_HANDOFF_CACHE positions (its logits
    ``full["f32"]["decode_logits"]``)."""
    import torch
    from repro_torch.tree import tree_map
    cfgs, models, batch = _seq_inputs(arch, device)
    params = models["bf16"].init(torch.Generator(device).manual_seed(LM_SEED))
    full = {}
    s = SEQ_SPLIT_PREFILL[1]
    with torch.no_grad():
        models["bf16"].prefill(params, batch)      # warm-up, not timed
        full["bf16"] = _seq_run(lambda: models["bf16"].prefill(params, batch),
                                False, device)
        params = _upcast(params)
        full["f32"] = _seq_run(lambda: models["f32"].prefill(
            params, _upcast(batch)), True, device)
        grown = _grown(cfgs["f32"], tree_map(
            lambda t: t.clone(), full["f32"]["cache"]), SEQ_HANDOFF_CACHE - s)
        full["f32"]["decode_logits"] = models["f32"].decode_step(
            params, grown, batch["tokens"][:, -1:], s)[0].float()
    return full


def _seq_split_prefill(arch: str, mesh, device, full=None) -> dict:
    """Phase 19a for one family on this rank: its bf16 and f32 prefills
    through ``shards.sharded_prefill`` under the sequence split, on the
    params placed replicated (the bf16 ones, then upcast): the split
    taken, FLOPs, ms, peak and a digest of every leaf (its f64 sum and
    largest |value|: every rank returns the same cache and logits, so
    the ranks' digests are equal), and, on the rank given the unsharded
    prefills ``full`` (:func:`_seq_unsharded`), each leaf's distance
    from the unsharded f32 step's, relative to its largest value."""
    import torch
    from repro_torch.models import shards
    from repro_torch.models.moe_schedule import biglittle_split
    from repro_torch.sharding import specs
    cfgs, models, batch = _seq_inputs(arch, device)
    cfg = cfgs["bf16"]
    b, s = SEQ_SPLIT_PREFILL
    n = mesh.size(mesh.mesh_dim_names.index("model"))
    least_capacity = None
    if cfg.family == "moe":
        least_capacity = min(min(biglittle_split(
            cfg.num_experts_padded, cfg.top_k, b * s, cfg.capacity_factor,
            round_to=r)[1:]) for r in (1, n))
    # the whole weights on every rank (placed replicated): under the
    # rules' placements every layer's weights would cross "model" through
    # the host on this one card (19b's step and phases 16-18 do that),
    # and that, not the split, would be the step's time
    pd = specs.distribute_tree(
        models["bf16"].init(torch.Generator(device).manual_seed(LM_SEED)),
        specs.replicated(mesh))
    # the rule's split at this mesh; where it is Megatron's (the query
    # heads of qwen2 and granite divide over 2 ranks, not over the pod's
    # 16), the rule is made to give the sequence split for these steps,
    # in the layout it gives them there
    rule_fn = specs.model_split
    rule = rule_fn(cfg, b, mesh, seq=s)
    split = {}
    try:
        if not rule.sequence:
            specs.model_split = lambda *a, **k: specs.sequence_split(
                cfg, rule.n, s)
        for k in ("bf16", "f32"):
            if k == "f32":
                pd = _upcast(pd)
            bk = batch if k == "bf16" else _upcast(batch)
            bd = specs.distribute_tree(bk, specs.batch_placements(bk, mesh))
            split[k] = _seq_run(lambda: shards.sharded_prefill(
                models[k].prefill, pd, bd, cfgs[k]), k == "f32", device)
        # the f32 prefill once more, handing its cache off to the split
        # decode (timed, for its seconds and peak)
        t0 = time.perf_counter()
        handoff = _seq_run(lambda: shards.sharded_prefill(
            models["f32"].prefill, pd, bd, cfgs["f32"],
            cache_len=SEQ_HANDOFF_CACHE), False, device)
    finally:
        specs.model_split = rule_fn
    handoff.update(_seq_handoff_decode(
        models["f32"], pd, handoff, batch["tokens"][:, -1:], mesh, cfg,
        None if full is None else full["f32"]))
    handoff["s"] = time.perf_counter() - t0
    del pd
    names = ["logits"] + sorted(split["f32"]["cache"])

    def leaf(r, name):
        return r["logits"] if name == "logits" else r["cache"][name]

    out = {"split": split["bf16"]["split"], "f32_split": split["f32"]["split"],
           "layout": split["bf16"]["layout"],
           "f32_layout": split["f32"]["layout"],
           "rule_split": rule.name, "moe_least_capacity": least_capacity,
           "flops": split["f32"]["flops"],
           "attention_pairs": split["f32"]["attention_pairs"],
           "flops_counter_mode": split["f32"]["flops_counter_mode"],
           "step_ms": split["bf16"]["ms"],
           "peak_over_args_bytes": split["bf16"]["peak_over_args_bytes"],
           "f32_peak_over_args_bytes": split["f32"]["peak_over_args_bytes"],
           "handoff": {k: v for k, v in handoff.items()
                       if k not in ("cache", "logits")},
           "digest": {k: {n: [float(leaf(r, n).double().sum()),
                              float(leaf(r, n).abs().max())] for n in names}
                      for k, r in split.items()}}
    if full is not None:
        pairs = {"f32": (split["f32"], full["f32"]),
                 "bf16": (split["bf16"], full["f32"]),
                 "unsharded_bf16": (full["bf16"], full["f32"]),
                 "bf16_to_unsharded_bf16": (split["bf16"], full["bf16"])}
        out.update(
            tol=SEQ_SPLIT_SCAN_TOL if cfg.family in ("ssm", "hybrid")
            else SEQ_SPLIT_TOL,
            rel_err={k: {n: _rel_err(leaf(a, n), leaf(w, n)) for n in names}
                     for k, (a, w) in pairs.items()},
            # the cache's leaves layer by layer (each relative to that
            # layer's largest value): where the bf16 distances come from
            rel_err_by_layer={k: {n: [_rel_err(x, y) for x, y in zip(
                leaf(pairs[k][0], n), leaf(pairs[k][1], n))]
                for n in names if n != "logits"}
                for k in ("unsharded_bf16", "bf16_to_unsharded_bf16")},
            unsharded_flops=full["f32"]["flops"],
            unsharded_attention_pairs=full["f32"]["attention_pairs"],
            unsharded_step_ms=full["bf16"]["ms"],
            unsharded_peak_over_args_bytes=full["bf16"][
                "peak_over_args_bytes"])
    return out


def _seq_handoff_decode(model, pd, handoff: dict, token, mesh, cfg,
                        full=None) -> dict:
    """19a's hand-off on this rank: the slice's bytes and, on the rank
    given the unsharded f32 prefill ``full`` (:func:`_seq_unsharded`),
    each leaf's distance from that cache grown to SEQ_HANDOFF_CACHE
    positions and placed by ``specs.decode_cache_placements`` (relative
    to its largest value) and the placed slice's bytes; then one split
    decode step ("columns", on the replicated f32 weights ``pd``) from
    the handed-off slice at position SEQ_SPLIT_PREFILL[1] with
    ``token``, and its logits' distance from the unsharded step's
    (this rank's vocabulary slice)."""
    import torch
    from repro_torch.models import common, shards
    from repro_torch.sharding import specs
    s = SEQ_SPLIT_PREFILL[1]
    got = handoff["cache"]
    out = {"slice_bytes": sum(t.numel() * t.element_size()
                              for t in got.values())}
    if full is not None:
        grown = _grown(cfg, full["cache"], SEQ_HANDOFF_CACHE - s)
        want = {k: t.to_local() for k, t in specs.distribute_tree(
            grown, specs.decode_cache_placements(grown, mesh,
                                                 cfg.family)).items()}
        out["rel_err"] = {k: _rel_err(got[k], w) for k, w in want.items()}
        out["placed_bytes"] = sum(t.numel() * t.element_size()
                                  for t in want.values())
        del grown, want
    dsplit = specs.model_split_decode(mesh)
    view = shards.model_view(*shards.local_shards(pd), mesh, (), dsplit)
    with torch.no_grad(), common.use_mesh(mesh, (), dsplit):
        lg = model.decode_step(view, got, token, s)[0].float()
    out["decode_split"] = dsplit.name
    if full is not None:
        v = lg.shape[-1]
        r = mesh.get_local_rank("model")
        out["decode_rel_err"] = _rel_errs(
            [lg], [full["decode_logits"]], slice(r * v, (r + 1) * v))[0]
    return out


def _seq_split_rank(rank: int, world: int, tmp: str, device: str) -> None:
    """Phase 19, one of two processes on the one card: each of
    SEQ_SPLIT_ARCHS' unsharded prefills (:func:`_seq_unsharded`, the
    last rank) and 19b's unsharded hymba step (rank 0), before either
    rank places anything, then on a ("data", "model") = (1, 2) gloo mesh
    each family's split prefills (:func:`_seq_split_prefill`) and 19b's
    step placed by ``specs``. Rank 0 writes every rank's numbers to
    ``tmp/seq_split.json``. ``device`` is "cuda" (the card's first) but
    for a rehearsal on the CPU."""
    import datetime
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import adamw
    from repro_torch.sharding import specs
    from repro_torch.train.step import make_train_step, value_and_grad
    from repro_torch.tree import flatten_with_path, leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device = torch.device(device, 0)
    staged: dict = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        transport = _stage_through_host(staged)   # kept while it runs
    cfg = get_config(LM_HYBRID)
    model = build_model(cfg)
    opt = adamw(lr=SPLIT_LR)
    b, s, micro = SEQ_SPLIT_TRAIN
    step = make_train_step(model, opt, micro_batches=micro)
    tok = torch.from_numpy(np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).to(device)
    batch = {"tokens": tok, "labels": tok}

    def counted(fn):
        """((new params, metrics), FLOPs, ms, peak over what was
        allocated before) of one step: counted and timed in one run (the
        ms include the count's host work, in both steps)."""
        got = []
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        with _flop_count() as fc:
            ms = _event_ms(lambda: got.append(fn()[::2]))
        return got.pop(), fc.total, ms, \
            torch.cuda.max_memory_allocated(device) - base

    def unsharded(archs):
        for arch in archs:
            t0 = time.perf_counter()
            full[arch] = _seq_unsharded(arch, device)
            full[arch]["s"] = time.perf_counter() - t0
            _free()

    # before either rank places anything: 19b's unsharded step on rank 0
    # beside the unsharded prefills of the lighter families on the last
    # rank, then those of the heavier ones (the card holds 19b's step
    # beside one light prefill and what phases 1-18 keep, not beside
    # granite's or mamba2's f32 weights)
    full, ref = {}, {}
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "rendezvous"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=600))
    try:
        if rank == world - 1:
            unsharded(a for a in SEQ_SPLIT_ARCHS if a not in SEQ_SPLIT_HEAVY)
        if rank == 0:
            params = model.init(torch.Generator(device).manual_seed(LM_SEED))
            state = opt.init(params)
            (p1, m1), flops, ms, peak = counted(
                lambda: step(params, state, batch))
            ref = {"loss": float(m1["loss"]), "flops": flops, "step_ms": ms,
                   "peak_over_args_bytes": peak,
                   "params": [t.cpu() for t in leaves(p1)],
                   "paths": [".".join(k)
                             for k, _ in flatten_with_path(p1)[0]]}
            del p1, m1
            ref["grads"] = [t.cpu() for t in leaves(value_and_grad(
                model.loss, params, batch)[1])]
            del params, state
            _free()
        dist.barrier()
        if rank == world - 1:
            unsharded(SEQ_SPLIT_HEAVY)
        dist.barrier()
        mesh = init_device_mesh(device.type, (1, world),
                                mesh_dim_names=("data", "model"))
        res = {"rank": rank, "archs": {}}
        for arch in SEQ_SPLIT_ARCHS:
            dist.barrier()                # the ranks' steps start together
            t0 = time.perf_counter()
            unsharded = full.pop(arch, None)
            a = res["archs"][arch] = _seq_split_prefill(arch, mesh, device,
                                                        unsharded)
            a["s"] = time.perf_counter() - t0
            if unsharded is not None:
                a["unsharded_s"] = unsharded["s"]
            del unsharded
            _free()
        params = model.init(torch.Generator(device).manual_seed(LM_SEED))
        pd = specs.distribute_tree(params, specs.tree_placements(params,
                                                                 mesh))
        del params
        sd = opt.init(pd)                 # the moments placed as the params
        sd["step"] = specs.distribute(sd["step"], specs.replicated(mesh))
        bd = specs.distribute_tree(batch, specs.batch_placements(batch, mesh))
        dist.barrier()                    # the ranks' steps start together
        (p2, m2), flops, ms, peak = counted(lambda: step(pd, sd, bd))
        train = {"split": m2["model_split"], "loss": float(m2["loss"]),
                 "flops": flops, "step_ms": ms, "peak_over_args_bytes": peak,
                 "shape": [b, s, micro]}
        got = [t.full_tensor() for t in leaves(p2)]
        del p2, m2
        if rank == 0:
            train.update(_held_to_unsharded(got, ref))
            for k in ("params", "grads", "paths"):
                del ref[k]
        del got
        res["train"] = train
        del pd, sd
        _free()
        res["staged_collectives"] = dict(staged)
        every = [None] * world
        dist.all_gather_object(every, res)
        if rank == 0:
            with open(os.path.join(tmp, "seq_split.json"), "w") as f:
                json.dump({"unsharded_train": ref, "ranks": every}, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
        if device.type == "cuda":
            del transport


def phase_seq_split() -> dict:
    """Phase 19: :func:`_seq_split_rank` in two spawned processes sharing
    the card over gloo. 19a per family: on every rank the sequence
    split in the rule's layout (zigzag for SEQ_SPLIT_ZIGZAG, whose ranks'
    FLOPs are within SEQ_SPLIT_FLOP_LEVEL of each other, else
    contiguous), the FLOPs at most SPLIT_FLOP_SHARE of the unsharded
    step's and the logits and cache of the last rank (their digests
    equal); on
    the last rank, in f32 the logits and every cache leaf within
    SEQ_SPLIT_TOL (mamba2 and hymba SEQ_SPLIT_SCAN_TOL) of the unsharded
    step's, relative to its largest value, and in bf16 each at most
    SEQ_SPLIT_BF16_FACTOR times as far from the unsharded f32 step's as
    the unsharded bf16 step's, and each within SEQ_SPLIT_BF16_CEIL of
    the unsharded bf16 step's (every cache leaf's first layer within
    SEQ_SPLIT_BF16_FIRST_LAYER). The f32 prefill's hand-off to the
    split decode (cache of SEQ_HANDOFF_CACHE positions): "sequence" in
    the same layout, then "columns"; on the last rank each leaf within
    the f32 bound of the placed unsharded f32 cache and the decode step
    from it within DECODE_SPLIT_TOL of the unsharded f32 step; every
    rank's slice as many bytes as the placed one. 19b: hymba's step
    takes the sequence split, loss and params held as
    phase 17's, FLOPs a rank at most SPLIT_FLOP_SHARE of the unsharded
    step's."""
    import tempfile
    import torch.multiprocessing as mp
    _free()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_seq_split_rank, args=(2, tmp, "cuda"), nprocs=2)
        with open(os.path.join(tmp, "seq_split.json")) as f:
            res = json.load(f)
    log("phase 19: " + json.dumps(res))
    held = res["ranks"][-1]["archs"]       # the rank with the unsharded
    for r in res["ranks"]:
        for arch, a in r["archs"].items():
            where = f"19a {arch}: rank {r['rank']}"
            h = held[arch]
            check(a["split"] == a["f32_split"] == "sequence",
                  f"{where} took split {a['split']}, not sequence")
            layout = "zigzag" if arch in SEQ_SPLIT_ZIGZAG else "contiguous"
            check(a["layout"] == a["f32_layout"] == layout,
                  f"{where} laid out its positions {a['layout']}, not "
                  f"{layout}")
            check(a["digest"] == h["digest"],
                  f"{where}'s logits and cache differ from rank "
                  f"{res['ranks'][-1]['rank']}'s: {a['digest']} vs "
                  f"{h['digest']}")
            check(a["flops"] == a["flops_counter_mode"],
                  f"{where}: the lean count {a['flops']} is not "
                  f"FlopCounterMode's {a['flops_counter_mode']}")
            check(a["flops"] <= SPLIT_FLOP_SHARE * h["unsharded_flops"],
                  f"{where} runs {a['flops']:.4g} FLOP, the unsharded "
                  f"step {h['unsharded_flops']:.4g}")
            check(a["moe_least_capacity"] is None or a["moe_least_capacity"]
                  >= SEQ_SPLIT_PREFILL[0] * SEQ_SPLIT_PREFILL[1],
                  f"{where}: an expert's capacity "
                  f"{a['moe_least_capacity']} could drop tokens")
            ho = a["handoff"]
            check(ho["split"] == "sequence" and ho["layout"] == layout
                  and ho["decode_split"] == "columns",
                  f"{where}: the hand-off's prefill took {ho['split']} "
                  f"({ho['layout']}), its decode {ho['decode_split']}")
            check(ho["slice_bytes"] == h["handoff"]["placed_bytes"],
                  f"{where}: the handed-off slice holds "
                  f"{ho['slice_bytes']} B, the placed cache "
                  f"{h['handoff']['placed_bytes']} B")
        t, ref = r["train"], res["unsharded_train"]
        where = f"19b {LM_HYBRID}: rank {r['rank']}"
        check(t["split"] == "sequence",
              f"{where} took split {t['split']}, not sequence")
        check(abs(t["loss"] - ref["loss"]) <= SHARD_TOL * abs(ref["loss"]),
              f"{where} loss {t['loss']} vs unsharded {ref['loss']}")
        check(t["flops"] <= SPLIT_FLOP_SHARE * ref["flops"],
              f"{where} runs {t['flops']:.4g} FLOP, the unsharded step "
              f"{ref['flops']:.4g}")
    for arch in SEQ_SPLIT_ZIGZAG:
        flops = [r["archs"][arch]["flops"] for r in res["ranks"]]
        check(max(flops) <= (1 + SEQ_SPLIT_FLOP_LEVEL) * min(flops),
              f"19a {arch}: the zigzag ranks' FLOPs {flops} differ by more "
              f"than {SEQ_SPLIT_FLOP_LEVEL:.0%}")
    for arch, a in held.items():
        ho = a["handoff"]
        for name, e in ho["rel_err"].items():
            check(e <= a["tol"], f"19a {arch}: the handed-off {name} off the "
                  f"placed unsharded f32 cache by {e} of its largest, beyond "
                  f"{a['tol']}")
        check(ho["decode_rel_err"] <= DECODE_SPLIT_TOL,
              f"19a {arch}: the split decode step from the handed-off slice "
              f"off the unsharded f32 step by {ho['decode_rel_err']}")
        for name, e in a["rel_err"]["f32"].items():
            check(e <= a["tol"], f"19a {arch}: f32 {name} off by {e} of its "
                  f"largest, beyond {a['tol']}")
            un = a["rel_err"]["unsharded_bf16"][name]
            got = a["rel_err"]["bf16"][name]
            check(got <= SEQ_SPLIT_BF16_FACTOR * un,
                  f"19a {arch}: bf16 {name} {got} from the f32 step, the "
                  f"unsharded bf16 step {un}")
            e = a["rel_err"]["bf16_to_unsharded_bf16"][name]
            check(e <= SEQ_SPLIT_BF16_CEIL, f"19a {arch}: bf16 {name} off by "
                  f"{e} of the unsharded bf16 step's largest")
        for name, by in a["rel_err_by_layer"][
                "bf16_to_unsharded_bf16"].items():
            check(by[0] <= SEQ_SPLIT_BF16_FIRST_LAYER,
                  f"19a {arch}: bf16 {name}'s first layer off by {by[0]} of "
                  f"the unsharded bf16 step's largest there")
    t = res["ranks"][0]["train"]
    check(t["params_max_rel_err_settled"] <= SHARD_TOL
          and t["near_zero_beyond_tol_max"] <= 2 * SPLIT_LR,
          f"19b: params off by {t['params_max_rel_err_settled']} relative, "
          f"{t['near_zero_beyond_tol_max']} beyond it where the gradient "
          f"is near zero")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every number to this JSON file")
    args = ap.parse_args(argv)

    # deterministic cuBLAS for phase 14c's restart check: read when CUDA
    # starts, so set before anything touches the card
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this check needs "
            "one CUDA card")
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.kernels import _build, gas_kernel
    except ImportError as exc:
        log(f"FAIL: cannot import the port from {ROOT}/src: {exc}")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products as the reference's dot: one rounding of an f32 sum
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device = torch.device("cuda", torch.cuda.current_device())
    t_start = time.perf_counter()
    card = card_line()
    result = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    try:
        log(f"phase 1: {card}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}")
        t0 = time.perf_counter()
        udf_apps = custom_apps()

        def timed_build(prelude=""):
            t = time.perf_counter()
            lib = _build.build("gas_kernel", prelude)
            return lib, time.perf_counter() - t
        # every library at once: the named ops' and phase 15's generated
        # variants, one nvcc each
        with ThreadPoolExecutor(1 + len(udf_apps)) as pool:
            named = pool.submit(timed_build)
            udf_builds = {n: pool.submit(timed_build, gas_kernel.udf_prelude(
                a.scatter, a.gather)) for n, a in udf_apps.items()}
            main_lib = named.result()[0].name
            result["udf_build_s"] = {n: f.result()[1]
                                     for n, f in udf_builds.items()}
        gas_kernel.build()
        for a in udf_apps.values():
            gas_kernel.build(scatter_fn=a.scatter, mode=a.gather)
        result["build_s"] = time.perf_counter() - t0
        log(f"phase 1: built gas_kernel and the variants generated for "
            f"{len(udf_apps)} custom scatter UDFs in "
            f"{result['build_s']:.1f} s, all at once (nvcc s per variant: "
            f"{json.dumps(result['udf_build_s'])})")
        ptxas = sorted({line.split(":", 1)[-1].strip() for line in
                        _build.build_log.get(main_lib, "").splitlines()
                        if "registers" in line or "spill" in line})
        log("phase 1: ptxas, the chunk kernel x 7 instantiations, the "
            "combine (sum) and identity (min, max, or) kernels: "
            + "; ".join(ptxas))

        t0 = time.perf_counter()
        result["kernel_vs_plain"] = phase_kernel_vs_plain(device, SEED)
        result["heavy_tile"] = phase_heavy_tile(device, SEED)
        log(f"phase 2: kernel == plain version in "
            f"{result['kernel_vs_plain']['cases']} graph-payload cases and "
            f"{result['heavy_tile']['cases']} heavy-tile cases "
            f"({time.perf_counter() - t0:.1f} s): "
            + json.dumps(result["heavy_tile"]))

        t0 = time.perf_counter()
        main_res = phase_main_path(device)
        log(f"phase 3: main path ok ({time.perf_counter() - t0:.1f} s): "
            + json.dumps({k: v for k, v in main_res.items()
                          if not k.startswith("_")}))
        kernel, per_payload = phase_kernel_line(main_res, device)
        result["per_payload"] = per_payload
        log("phase 4: chunk sweep (chunk edges: ms of the 8 launches, "
            "CTAs): " + "; ".join(
                f"{c}: {v['ms']:.4f} ms, {v['ctas']}"
                for c, v in kernel["chunk_sweep"].items()))
        log("phase 4: per launch (kind, blocks, tiles, heaviest tile's "
            "edges, CTAs, real edges, ms): " + "; ".join(
                f"{q['kind']} {q['n_blocks']} {q['n_out_tiles']} "
                f"{q['max_tile_edges']} {q['ctas']} {q['real_edges']} "
                f"{q['ms']:.4f}" for q in per_payload))
        result["per_entry"] = phase_per_entry(main_res, device)
        log("phase 4: per-entry form: " + json.dumps(result["per_entry"]))
        result["breakdown"] = phase_breakdown(main_res, device)
        result["main_path"] = {k: v for k, v in main_res.items()
                               if not k.startswith("_")}
        t0 = time.perf_counter()
        result["urand_big"] = phase_urand_big(device)
        log(f"phase 4: urand20's Big lanes ({time.perf_counter() - t0:.1f} "
            "s): " + json.dumps(result["urand_big"]))

        t0 = time.perf_counter()
        result["sharded"] = phase_sharded(main_res, device)
        log(f"phase 5: sharded == fused ({time.perf_counter() - t0:.1f} s; "
            "'2 owners on one card' tests the two-owner path on one card, "
            "not a multi-card number): " + json.dumps(result["sharded"]))
        t0 = time.perf_counter()
        stream_res = phase_streaming(main_res, device)
        result["streaming"] = {k: v for k, v in stream_res.items()
                               if not k.startswith("_")}
        log(f"phase 6: derived store == cold rebuild "
            f"({time.perf_counter() - t0:.1f} s): "
            + json.dumps(result["streaming"]))
        result["utilization"] = phase_utilization(main_res)
        log("phase 7: utilization (time_lanes): "
            + json.dumps(result["utilization"]))

        t0 = time.perf_counter()
        result["serving"], svc, served = phase_serving(main_res, stream_res,
                                                       device)
        sv = result["serving"]
        log(f"phase 8: serving ok ({time.perf_counter() - t0:.1f} s; "
            f"{card}): per request (queue, store, plan, execute ms): "
            + "; ".join(f"{app} {m['t_queue_ms']:.3f} {m['t_store_ms']:.3f} "
                        f"{m['t_plan_ms']:.3f} {m['t_execute_ms']:.3f}"
                        for app, m in sv["requests"].items()))
        w = sv["warm_pagerank_ms"]
        log(f"phase 8: {N_WARM} warm PageRank requests: p50 "
            f"{w['service_p50']:.3f} ms, p99 {w['service_p99']:.3f} ms; "
            f"Executor.run alone p50 {w['executor_run_p50']:.3f} ms, p99 "
            f"{w['executor_run_p99']:.3f} ms, on a plain thread p50 "
            f"{w['executor_run_thread_p50']:.3f} ms; stages p50 queue "
            f"{w['queue_p50']:.3f}, store {w['store_p50']:.3f}, plan "
            f"{w['plan_p50']:.3f}, execute {w['execute_p50']:.3f} ms; "
            f"store.memory_footprint() "
            f"(each lease's release) p50 {w['memory_footprint_p50']:.3f} "
            f"ms ({card})")
        log(f"phase 8: burst of {sv['burst']['submits']} identical submits "
            f"-> {sv['burst']['executions']} execution(s)")
        pu = sv["pool_update"]
        log(f"phase 8: pool update at rmat({pu['scale']}, {EDGE_FACTOR}) in "
            f"a spawned worker: {pu['t_update_ms']:.1f} ms (apply "
            f"{pu['t_pool_apply_ms']:.1f}, splice {pu['t_splice_ms']:.1f}, "
            f"re-plan {pu['t_replan_ms']:.1f}) beside an in-process "
            f"apply_delta of the same delta {pu['in_process_apply_ms']:.1f} "
            f"ms; the base store pickles to {pu['base_pickle_bytes']} B in "
            f"{pu['t_pickle_ms']:.1f} ms, unpickles in "
            f"{pu['t_unpickle_ms']:.1f} ms, and crosses a pool's pipe in "
            f"{pu['t_ship_ms']:.1f} ms ({card}): " + json.dumps(sv))
        t0 = time.perf_counter()
        try:
            result["control"] = phase_control(main_res, svc, served, device)
        finally:
            svc.close()
        log(f"phase 9: control plane ok ({time.perf_counter() - t0:.1f} s; "
            f"{card}): HTTP round trip (POST + GET result) ms: "
            + json.dumps(result["control"]))

        t0 = time.perf_counter()
        at = result["autotune"] = phase_autotune(main_res, device)
        verdict = ("applied: chosen " + json.dumps(at.get("chosen"))
                   if at["applied"] else
                   f"REJECTED by the guard ({at['rejected']}); nothing "
                   "adopted, results unchanged")
        log(f"phase 10: autotune ok ({time.perf_counter() - t0:.1f} s; "
            f"{card}): fit {json.dumps(at['fit'])}; {verdict}; "
            f"t_retune_s {at['t_retune_s']:.3f}, search_plan "
            f"{at['t_search_plan_s']} s; candidates "
            f"{json.dumps(at.get('candidates'))}; " + json.dumps(at))
        t0 = time.perf_counter()
        ds = result["distributed"] = phase_distributed(main_res, device)
        log(f"phase 11: DistributedEngine (1 rank, NCCL) ok "
            f"({time.perf_counter() - t0:.1f} s; {card}): "
            f"{ds['chunks_total']} chunks, {ds['payloads']} payloads, "
            f"{ds['launches_per_iteration']} launches per iteration, "
            f"{ds['packed_bytes']} packed B, iteration "
            f"{ds['iteration_ms']:.3f} ms: " + json.dumps(ds))
        t0 = time.perf_counter()
        lm = result["lm"] = phase_lm(device)
        a, b, c = (lm["fp32_" + LM_DENSE], lm["bf16_" + LM_DENSE],
                   lm["bf16_" + LM_MOE])
        log(f"phase 12a: {LM_DENSE} full width fp32 ({a['param_bytes']} "
            f"param B): teacher-forced decode == forward (max abs err "
            f"prefill {a['max_abs_err_prefill']:.3g}, decode "
            f"{a['max_abs_err_decode']:.3g}); card == CPU at "
            f"{a['card_vs_cpu']['layers']} layers (max abs err "
            f"{a['card_vs_cpu']['max_abs_err']:.3g}) ({card})")
        for name, r in ((LM_DENSE, b), (LM_MOE, c)):
            log(f"phase 12{'b' if r is b else 'c'}: {name} bf16 served "
                f"{r['requests']} requests x {LM_NEW} tokens: "
                f"{r['tokens_per_s']:.1f} tokens/s, mean TTFT "
                f"{r['mean_ttft_s'] * 1e3:.1f} ms, prefill "
                f"{r['prefill_shape']} {r['prefill_ms']:.2f} ms, decode step "
                f"{r['decode_step_ms']:.3f} ms (host clock "
                f"{r['decode_step_host_ms']:.3f} ms; device busy "
                f"{r['decode_step_device_profile']['busy_ms']} ms by "
                f"torch.profiler, prefill's "
                f"{r['prefill_device_profile']['busy_ms']} ms), params "
                f"{r['param_bytes']} B, cache_bytes {r['cache_bytes']} B, "
                f"max_memory_allocated {r['max_memory_allocated']} B; greedy "
                f"== manual loop ({card})")
        log(f"phase 12c: dispatch == moe_dispatch_ref (fp32 max abs err "
            f"{c['dispatch']['max_abs_err_fp32']:.3g}, bf16 "
            f"{c['dispatch']['max_abs_err_bf16']:.3g}); biglittle_split "
            f"(tokens, n_hot, C_hot, C_cold) {json.dumps(c['biglittle_split'])}")
        log(f"phase 12: LM serving ok ({time.perf_counter() - t0:.1f} s): "
            + json.dumps(lm))

        t0 = time.perf_counter()
        rec = result["lm_recurrent"] = phase_lm_recurrent(device)
        for tag, name in (("13a", LM_SSM), ("13b", LM_HYBRID)):
            r = rec[name]
            log(f"phase {tag}: {name} full width fp32: teacher-forced "
                f"decode == forward (prefill {r['prefill']} of "
                f"{r['tokens']}, max abs err prefill "
                f"{r['max_abs_err_prefill']:.3g}, decode "
                f"{r['max_abs_err_decode']:.3g})"
                + (f"; card == CPU at {r['card_vs_cpu']['layers']} layers "
                   f"(max abs err {r['card_vs_cpu']['max_abs_err']:.3g})"
                   if "card_vs_cpu" in r else "")
                + f"; bf16 served {r['requests']} requests x {LM_NEW} "
                f"tokens: {r['tokens_per_s']:.1f} tokens/s, mean TTFT "
                f"{r['mean_ttft_s'] * 1e3:.1f} ms, prefill "
                f"{r['prefill_shape']} {r['prefill_ms']:.2f} ms, decode step "
                f"{r['decode_step_ms']:.3f} ms (host clock "
                f"{r['decode_step_host_ms']:.3f} ms; device busy "
                f"{r['decode_step_device_profile']['busy_ms']} ms; bound "
                f"{r['decode_bound_ms']:.3f} ms), params "
                f"{r['param_bytes']} B, decode state "
                f"{r['decode_state_bytes']} B, max_memory_allocated "
                f"{r['max_memory_allocated']} B; greedy == manual loop "
                f"({card})")
        w = rec[LM_AUDIO]
        log(f"phase 13c: {LM_AUDIO} full width ({w['frames']} frames): fp32 "
            f"teacher-forced decode == forward (max abs err prefill "
            f"{w['max_abs_err_prefill']:.3g}, decode "
            f"{w['max_abs_err_decode']:.3g}); bf16 batch {w['batch']}: "
            f"prefill {LM_AUDIO_PROMPT} tokens {w['prefill_ms']:.2f} ms, "
            f"greedy loop {w['decode_loop_step_host_ms']:.3f} ms a step on "
            f"the host clock, decode step {w['decode_step_ms']:.3f} ms "
            f"(device busy {w['decode_step_device_profile']['busy_ms']} ms; "
            f"bound {w['decode_bound_ms']:.4f} ms), "
            f"{w['tokens_per_s']:.1f} tokens/s ({card})")
        log(f"phase 13: recurrent and encoder-decoder families ok "
            f"({time.perf_counter() - t0:.1f} s): " + json.dumps(rec))

        t0 = time.perf_counter()
        tr = result["train"] = phase_train(device)
        ab, fu, rs = tr["attention_backward"], tr["full"], tr["restart"]
        log(f"phase 14a: flash backward == dense autograd at "
            f"{ab['shape']}: fp32 max abs err "
            f"{max(ab['fp32_max_abs_err_dq_dk_dv']):.3g}, bf16 "
            f"{max(ab['bf16_max_abs_err_dq_dk_dv']):.3g}; forward + backward "
            f"fp32 {ab['fp32_flash_fwd_bwd_ms']:.2f} ms (dense "
            f"{ab['fp32_dense_fwd_bwd_ms']:.2f}), bf16 "
            f"{ab['bf16_flash_fwd_bwd_ms']:.2f} ms (with every KV block "
            f"visited: fp32 {EVERY_BLOCK_ATTN_MS['fp32']}, bf16 "
            f"{EVERY_BLOCK_ATTN_MS['bf16']}); peak "
            f"{ab['fp32_flash_peak_bytes']} B (dense "
            f"{ab['fp32_dense_peak_bytes']} B) ({card})")
        log(f"phase 14b: {LM_DENSE} full width bf16 trained "
            f"{TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_S}: losses "
            f"{[round(x, 4) for x in fu['losses']]}, step ms (events) "
            f"{[round(x, 1) for x in fu['step_ms_events']]}, host "
            f"{[round(x, 1) for x in fu['step_ms_host']]}, "
            f"{fu['tokens_per_s']:.1f} tokens/s, device busy "
            f"{fu['step_device_profile']['busy_ms']} ms a step "
            f"(torch.profiler), max_memory_allocated "
            f"{fu['max_memory_allocated']} B; final save "
            f"{fu['saves'][-1]['s']:.1f} s, {fu['checkpoint_bytes']} B "
            f"({card})")
        log(f"phase 14c: {LM_DENSE} full width, {rs['layers']} layers: "
            f"restart bit-equal {rs['restart_bit_equal']} (max abs diff "
            f"{rs['restart_max_abs_diff']:.3g}); loss {rs['loss_first5']:.4f}"
            f" -> {rs['loss_last5']:.4f} over {FALL_STEPS} steps; median "
            f"step {rs['median_step_ms_deterministic']:.2f} ms "
            f"deterministic, {rs['median_step_ms_nondeterministic']:.2f} ms "
            f"not ({card})")
        log(f"phase 14: training ok ({time.perf_counter() - t0:.1f} s): "
            + json.dumps(tr))
        t0 = time.perf_counter()
        udf_kernels = phase_custom_udf(main_res, kernel,
                                       result["udf_build_s"], device)
        result["custom_udf"] = udf_kernels
        for k in udf_kernels:
            log(f"phase 15: {k['shapes']}: generated variant "
                f"`{k['expr']}` built in {k['build_s']:.1f} s, "
                f"{k['launches']} launches over {k['iterations']} "
                f"iterations, == plain path; one iteration's launches "
                f"{k['ms']:.4f} ms (PageRank's copy variant "
                f"{k['pagerank_copy_ms']:.4f} ms), bound {k['bound_ms']:.4f} "
                f"ms ({k['bound_by']}), plain {k['plain_ms']:.4f} ms, "
                f"library {k['library_ms']} ms; random props and weights: "
                f"max abs err {k['max_abs_err']:.3g}, fp32 sum bound used "
                f"{k['fp32_sum_bound_used']:.3g} ({card})")
        log(f"phase 15: custom scatter UDFs ok "
            f"({time.perf_counter() - t0:.1f} s)")

        t0 = time.perf_counter()
        sh = result["sharding"] = phase_sharding(device)
        a, m = sh["train"], sh["moe"]
        log(f"phase 16a: {LM_DENSE} full width bf16, one AdamW step on "
            f"{a['shape'][0]} x {a['shape'][1]}: placed by specs on a "
            f"one-rank NCCL mesh ({a['placements']}) == unsharded (loss "
            f"{a['loss'][1]:.6f} vs {a['loss'][0]:.6f}, params max rel err "
            f"{a['params_max_rel_err']:.3g}); step {a['sharded_step_ms']:.1f}"
            f" ms sharded, {a['unsharded_step_ms']:.1f} ms unsharded "
            f"(CUDA events); peak over the arguments "
            f"{a['sharded_peak_over_args_bytes']} B sharded, "
            f"{a['unsharded_peak_over_args_bytes']} B unsharded ({card})")
        log(f"phase 16b: {LM_MOE} moe_ffn f32, {m['shape'][0]} x "
            f"{m['shape'][1]} tokens, capacity {m['capacity']}: "
            f"expert-sharded over 2 gloo ranks on one card ({m['E_pad']} "
            f"experts, {m['e_per_rank']} a rank) == single device (max abs "
            f"err {m['max_abs_err']:.3g}); rank 0 "
            f"{m['sharded_ms_events']:.1f} ms (two processes sharing one "
            f"card: not a multi-card time), single device "
            f"{m['single_ms']:.1f} ms ({card})")
        for cell, r in sh["dryrun"].items():
            log(f"phase 16c: dry run {cell} at {r['mesh']} (256 fake ranks, "
                f"meta): {r['status']}, split {r['model_split']}, rank 0 "
                f"argument "
                f"{r['memory']['argument_bytes']} B, traced peak "
                f"{r['memory']['peak_traced_bytes']} B (fits 80 GB: "
                f"{r['memory']['fits_80g_hbm']}), collectives "
                f"{r['collectives']['total']:.6g} B "
                f"({json.dumps(r['collectives'])}), traced "
                f"{r['traced_flops_per_rank']:.6g} FLOP a rank (analytic "
                f"share {r['analytic_flops_per_rank']:.6g}), traced in "
                f"{r['trace_s']} s")
        log(f"phase 16: sharding ok ({time.perf_counter() - t0:.1f} s): "
            + json.dumps(sh))
        t0 = time.perf_counter()
        sp = result["split"] = phase_split()
        staged = [r["staged_collectives"] for r in sp["ranks"]]
        log(f"phase 17: two gloo processes on one card stage their "
            f"all-gathers, reduce-scatters and all-to-alls through host "
            f"memory (calls a rank: {json.dumps(staged)})")
        for case, ((b, s), split) in SPLIT_CASES.items():
            ref = sp["unsharded"][case]
            ranks = [r["cases"][case] for r in sp["ranks"]]
            log(f"phase {case}: {LM_DENSE} full width bf16, one AdamW step "
                f"on {b} x {s} over (data, model) = (1, 2), split "
                f"{split}: loss {ranks[0]['loss']:.6f} vs {ref['loss']:.6f} "
                f"unsharded, params max rel err "
                f"{ranks[0]['params_max_rel_err_settled']:.3g} "
                f"({ranks[0]['params_max_rel_err']:.3g} with the "
                f"{ranks[0]['near_zero_flipped']} elements of near-zero "
                f"gradient that moved the other way); FLOP a rank "
                f"{[r['flops'] for r in ranks]} vs {ref['flops']} "
                f"unsharded; step ms a rank (CUDA events, two processes "
                f"sharing one card: not multi-card times) "
                f"{[round(r['step_ms'], 1) for r in ranks]} vs "
                f"{ref['step_ms']:.1f} unsharded; peak over the arguments "
                f"a rank {[r['peak_over_args_bytes'] for r in ranks]} B vs "
                f"{ref['peak_over_args_bytes']} B unsharded ({card})")
        log(f"phase 17: split over model ok ({time.perf_counter() - t0:.1f} "
            f"s)")
        t0 = time.perf_counter()
        ds = result["decode_split"] = phase_decode_split()
        for arch in DECODE_SPLIT_ARCHS:
            ranks = [r["archs"][arch] for r in ds["ranks"]]
            worst = {k: [max(a[k + "_rel_err_per_step"]) for a in ranks]
                     for k in ("f32", "bf16", "unsharded_bf16",
                               "bf16_vs_unsharded_bf16")}
            log(f"phase 18: {arch} full width, {DECODE_SPLIT_STEPS} decode "
                f"steps on {DECODE_SPLIT_PROMPT[0]} rows after a "
                f"{DECODE_SPLIT_PROMPT[1]}-token prefill, cache "
                f"{DECODE_SPLIT_CACHE} positions, split "
                f"{ranks[0]['split']} over (data, model) = (1, 2): logits "
                f"max rel err a rank against the unsharded f32 step: split "
                f"f32 {worst['f32']}, split bf16 {worst['bf16']}, unsharded "
                f"bf16 {worst['unsharded_bf16']} (split bf16 against "
                f"unsharded bf16 {worst['bf16_vs_unsharded_bf16']}); bf16 "
                f"FLOP a rank {[a['flops'] for a in ranks]} vs "
                f"{ranks[0]['unsharded_flops']} unsharded; decode state a "
                f"rank {[a['state_bytes'] for a in ranks]} B vs "
                f"{ranks[0]['unsharded_state_bytes']} B; bf16 step ms a "
                f"rank (CUDA events, median of {DECODE_SPLIT_STEPS - 1}, two "
                f"processes sharing one card: not multi-card times) "
                f"{[round(a['step_ms'], 2) for a in ranks]} vs "
                f"{[round(a['unsharded_step_ms'], 2) for a in ranks]} "
                f"unsharded; peak allocated a rank "
                f"{[a['max_memory_allocated'] for a in ranks]} B ({card})")
        for arch in DECODE_SPLIT_ARCHS:
            hs = [r["archs"][arch]["handoff"] for r in ds["ranks"]]
            log(f"phase 18b: {arch} full width f32, the prefill of "
                f"{DECODE_SPLIT_PROMPT[0]} x {DECODE_SPLIT_PROMPT[1]} split "
                f"{hs[0]['split']} handed off to the split decode "
                f"(cache_len {DECODE_SPLIT_CACHE}): each leaf's largest "
                f"error relative to its largest value, against the placed "
                f"unsharded f32 cache, a rank "
                f"{[max(h['rel_err'].values()) for h in hs]} (bound "
                f"{hs[0]['tol']}); slice bytes a rank "
                f"{[h['slice_bytes'] for h in hs]}; {HANDOFF_STEPS} split "
                f"decode steps from it against the unsharded f32 steps "
                f"{[h['step_rel_err'] for h in hs]}; split prefill s a rank "
                f"{[round(h['prefill_s'], 2) for h in hs]}; 18b s a rank "
                f"{[round(h['s'], 1) for h in hs]} ({card})")
        log(f"phase 18: decode split over model ok "
            f"({time.perf_counter() - t0:.1f} s; staged calls a rank: "
            f"{json.dumps([r['staged_collectives'] for r in ds['ranks']])})")
        t0 = time.perf_counter()
        qs = result["seq_split"] = phase_seq_split()
        b, s = SEQ_SPLIT_PREFILL
        for arch in SEQ_SPLIT_ARCHS:
            ranks = [r["archs"][arch] for r in qs["ranks"]]
            held = ranks[-1]
            worst = {k: max(held["rel_err"][k].values())
                     for k in ("f32", "bf16", "unsharded_bf16")}
            log(f"phase 19a: {arch} full width, prefill of {b} x {s} split "
                f"{ranks[0]['split']} ({ranks[0]['layout']}) over (data, "
                f"model) = (1, 2) (the rule's there: "
                f"{ranks[0]['rule_split']}); attention block pairs visited "
                f"/ there are, a rank {[a['attention_pairs'] for a in ranks]}"
                f", unsharded {held['unsharded_attention_pairs']}; every "
                f"rank's "
                f"logits and cache the same: largest error of a leaf "
                f"relative to its largest value, against the unsharded f32 "
                f"step: split f32 {worst['f32']} (bound {held['tol']}), "
                f"split bf16 {worst['bf16']}, unsharded bf16 "
                f"{worst['unsharded_bf16']}; FLOP a rank "
                f"{[a['flops'] for a in ranks]} vs {held['unsharded_flops']} "
                f"unsharded; bf16 step ms a rank (CUDA events, two processes "
                f"sharing one card: not multi-card times) "
                f"{[round(a['step_ms'], 1) for a in ranks]} vs "
                f"{held['unsharded_step_ms']:.1f} unsharded (with every KV "
                f"block visited: {EVERY_BLOCK_PREFILL_MS[arch]}); peak over "
                f"the arguments a rank "
                f"{[a['peak_over_args_bytes'] for a in ranks]} B vs "
                f"{held['unsharded_peak_over_args_bytes']} B ({card})")
        for arch in SEQ_SPLIT_ARCHS:
            ranks = [r["archs"][arch] for r in qs["ranks"]]
            ho = ranks[-1]["handoff"]
            log(f"phase 19a: {arch} full width f32, the same prefill handed "
                f"off to the split decode (cache_len {SEQ_HANDOFF_CACHE}, "
                f"{ho['layout']} prefill): each leaf's largest error "
                f"relative to its largest value against the placed "
                f"unsharded f32 cache {max(ho['rel_err'].values())} (bound "
                f"{ranks[-1]['tol']}); slice bytes a rank "
                f"{[a['handoff']['slice_bytes'] for a in ranks]}; one split "
                f"decode step from it against the unsharded f32 step "
                f"{ho['decode_rel_err']}; f32 peak over the arguments a rank "
                f"with the hand-off "
                f"{[a['handoff']['peak_over_args_bytes'] for a in ranks]} B, "
                f"without {[a['f32_peak_over_args_bytes'] for a in ranks]} "
                f"B; its prefill ms a rank "
                f"{[round(a['handoff']['ms'], 1) for a in ranks]}; the "
                f"sub-phase s a rank "
                f"{[round(a['handoff']['s'], 1) for a in ranks]} ({card})")
        ref = qs["unsharded_train"]
        ranks = [r["train"] for r in qs["ranks"]]
        rb, rs, rm = SEQ_SPLIT_TRAIN
        log(f"phase 19b: {LM_HYBRID} full width bf16, one AdamW step on {rb} "
            f"x {rs} in {rm} microbatches over (data, model) = (1, 2), split "
            f"{ranks[0]['split']}: loss {ranks[0]['loss']:.6f} vs "
            f"{ref['loss']:.6f} unsharded, params max rel err "
            f"{ranks[0]['params_max_rel_err_settled']:.3g} "
            f"({ranks[0]['params_max_rel_err']:.3g} with the "
            f"{ranks[0]['near_zero_flipped']} elements of near-zero gradient "
            f"that moved the other way); FLOP a rank "
            f"{[r['flops'] for r in ranks]} vs {ref['flops']} unsharded; step "
            f"ms a rank (CUDA events around the FLOP-counted step, two "
            f"processes sharing one card: not multi-card times) "
            f"{[round(r['step_ms'], 1) for r in ranks]} vs "
            f"{ref['step_ms']:.1f} unsharded; peak over the arguments a rank "
            f"{[r['peak_over_args_bytes'] for r in ranks]} B vs "
            f"{ref['peak_over_args_bytes']} B unsharded ({card})")
        log(f"phase 19: sequence split ok ({time.perf_counter() - t0:.1f} s;"
            f" staged calls a rank: "
            f"{json.dumps([r['staged_collectives'] for r in qs['ranks']])})")
    except CheckFailed as exc:
        log(f"FAIL: {exc}")
        return 1
    kernel["launches_by_path"] = {
        "main": kernel["launches"],
        "sharded": result["sharded"]["launches"],
        "streaming": result["streaming"]["launches"],
        "serving": result["serving"]["launches"],
        "control": result["control"]["launches"],
        "autotune": result["autotune"]["launches"],
        "distributed": result["distributed"]["launches"]}
    result["kernels"] = [kernel] + udf_kernels
    result["t_total_s"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    log("PageRank iteration breakdown: " + json.dumps(result["breakdown"]))
    log(f"total: {result['t_total_s']:.1f} s")
    log(f"card: {card_line()}")
    log(json.dumps({"kernels": result["kernels"]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

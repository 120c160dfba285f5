#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA GPU
and check it; the quickest proof that the port still starts on the card.

    python3 chip_smoke.py [--out results.json]

Phases (any failed check exits non-zero before the last line):

1. Device and build: the card's name and power limit, then the GAS
   kernel built from ``src/repro_torch/kernels/csrc/gas_kernel.cu``, once
   for each chunk size of the sweep that chose ``CHUNK_BLOCKS`` (one
   ``nvcc`` each, all started together).
2. Kernel vs plain version on the card, on inputs made from a numpy seed:
   every gather mode (sum, min, max, or) and scatter op, both input forms
   (Little, Big), both launch forms (per entry, packed lane), at the
   geometries (E_BLK, W, T) of the reference's kernel sweep, and a heavy
   tile of 10 * CHUNK_BLOCKS + 7 blocks, half of its edges to one hub
   slot, with scattered pads. min, max and or must match exactly; sum
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
   Apply and the convergence test with CUDA events. Then one ``kernels``
   JSON line: per kernel its launches on the main path, error against
   the plain version, its time, the plain version's time, one
   ``scatter_reduce`` over pre-gathered values (``library_ms``) and the
   least time the card could take (``bound_ms``).

Needs one CUDA card; imports neither JAX nor the reference package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
CHUNK_SWEEP = (16, 32, 64)        # the chunk sizes CHUNK_BLOCKS is chosen from


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
    """Kernel arguments of three tiles, the first of 10 * CHUNK_BLOCKS + 7
    blocks: half of its edges go to one hub slot, and a quarter of all
    slots are pads scattered through the blocks (not a prefix)."""
    import numpy as np
    import torch
    from repro_torch.kernels import gas_kernel

    c, n_win = gas_kernel.CHUNK_BLOCKS, 4
    sizes = [10 * c + 7, 3, c + 1]
    tile_id = np.repeat(np.arange(3), sizes).astype(np.int32)
    shape = (tile_id.shape[0], geom.E_BLK)
    dst = rng.integers(0, geom.T, shape)
    dst[(rng.random(shape) < 0.5) & (tile_id[:, None] == 0)] = 17
    arrays = {
        "src_local": rng.integers(0, geom.W, shape),
        "dst_local": dst,
        "weights": rng.random(shape, dtype=np.float32),
        "valid": rng.random(shape) >= 0.25,
        "window_id": rng.integers(0, n_win, shape[0]),
        "tile_id": tile_id,
    }
    return {k: torch.from_numpy(v.astype(
        np.float32 if k == "weights" else np.int32)).to(device)
        for k, v in arrays.items()}, sizes, n_win


def _launch_blocks(a, vwin, geom, mode, op, lo=0, hi=None):
    """The kernel on blocks [lo, hi) of ``a`` (whole tiles)."""
    import torch
    from repro_torch.kernels import gas_kernel, ops

    tid = a["tile_id"][lo:hi].cpu().numpy()
    tid = tid - tid[0]
    tbs = ops.tile_block_start(tid, int(tid[-1]) + 1)
    index = [torch.from_numpy(x).to(vwin.device)
             for x in (tbs, ops.tile_chunk_start(tbs))]
    return gas_kernel.gas_tiles(
        vwin, *(a[k][lo:hi] for k in ("src_local", "dst_local", "weights",
                                      "valid", "window_id")),
        *index, scatter_op=op, mode=mode, t=geom.T)


def phase_heavy_tile(device, seed: int) -> dict:
    """The heavy tile in every mode/op pair: kernel == plain, bit-stable,
    and packed == its tiles launched one by one."""
    import numpy as np
    import torch
    from repro_torch.core.gas import SCATTER_OPS
    from repro_torch.core.types import Geometry
    from repro_torch.kernels import ref

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
        k1 = _launch_blocks(a, vwin, geom, mode, op)
        k2 = _launch_blocks(a, vwin, geom, mode, op)

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
                ref, _ = ops.run_lane(p, vp, fn, mode, "ref", op)
                torch.cuda.synchronize()
                case = (f"E_BLK={e_blk} W={w} T={t} {kind} {form} "
                        f"{mode}/{op}")
                check(torch.equal(k1, k2), f"kernel not bit-stable: {case}")
                if mode == "sum":
                    err = float((k1 - ref).abs().max())
                    worst_sum = max(worst_sum, err)
                    check(torch.allclose(k1, ref, rtol=1e-5, atol=1e-5),
                          f"kernel != plain (max abs err {err}): {case}")
                    fp32_sum_share(k1, lambda f: ops.run_lane(
                        p, vp.double(), lambda x, wt: f(fn(
                            x.float(), wt).double()), mode, "ref", op)[0])
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
    res["_pr"], res["_config"] = pr_k, config
    return res


# ---------------------------------------------------------------------------
# Phase 4: measurements and the kernels line
# ---------------------------------------------------------------------------

def _kernel_traffic(vwin, p, geom, scatter_op: str):
    """(bytes, operations) one launch must at least move and do on this
    payload's data: ``valid`` for every padded slot; src and dst (and
    the weight, for ``add_weight``) of every real edge; the per-block
    window ids and the tile index; each distinct source value the real
    edges read, once; the output tiles. One combine per real edge, plus
    one add for ``add_weight``."""
    import torch
    keep = p["valid"] != 0
    real = int(p["num_real_edges"])
    flat_src = (p["window_id"].to(torch.int64)[:, None] * geom.W
                + p["src_local"])[keep]
    per_edge = 12 if scatter_op == "add_weight" else 8
    nbytes = (p["valid"].numel() * 4 + real * per_edge
              + p["window_id"].numel() * 4
              + p["tile_block_start"].numel() * 4
              + int(torch.unique(flat_src).numel()) * vwin.element_size()
              + p["n_out_tiles"] * geom.T * vwin.element_size())
    n_ops = real * (2 if scatter_op == "add_weight" else 1)
    return nbytes, n_ops


def _bound_ms(calls, geom) -> tuple:
    """(bound ms, what bounds it, bytes) of the sum/copy launches."""
    nbytes = n_ops = 0
    for vwin, p in calls:
        b, o = _kernel_traffic(vwin, p, geom, "copy")
        nbytes, n_ops = nbytes + b, n_ops + o
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = n_ops / H100_FP32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes)


def _calls(payloads, vprops, geom):
    """(vwin, payload) per launch: the Big gathers done beforehand."""
    return [((vprops[p["unique_src"]] if p["kind"] == "big" else vprops)
             .view(-1, geom.W), p) for p in payloads]


def _pagerank_launch(vwin, p, geom, tcs=None, chunk_blocks=None):
    from repro_torch.kernels import gas_kernel
    from repro_torch.kernels.little_pipeline import _blocked

    arrays = _blocked(p)
    if tcs is not None:
        arrays = arrays[:-1] + (tcs,)
    return gas_kernel.gas_tiles(
        vwin, *arrays, scatter_op="copy", mode="sum", t=geom.T,
        chunk_blocks=chunk_blocks or gas_kernel.CHUNK_BLOCKS)


def _pagerank_plain(vwin, p, geom, f=lambda x: x):
    """The plain version of a PageRank launch, summing ``f`` of each
    term."""
    from repro_torch.kernels import ref

    return ref.gas_ref(vwin, p["src_local"], p["dst_local"], p["weights"],
                       p["valid"], p["window_id"], p["tile_id"],
                       scatter_fn=lambda x, w: f(x), mode="sum", t=geom.T,
                       n_out_tiles=p["n_out_tiles"])


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
    tbs_host = [p["tile_block_start"].cpu().numpy() for _, p in calls]
    exact = [(lambda f, v=vwin, q=p: plain(v.double(), q, f))
             for vwin, p in calls]
    sweep, kernel_out, share = {}, None, 0.0
    for c in CHUNK_SWEEP:
        tcs = [torch.from_numpy(gas_kernel.tile_chunk_start(t, c)).to(device)
               for t in tbs_host]
        run = (lambda c=c, tcs=tcs: [
            _pagerank_launch(vwin, p, geom, tc, c)
            for (vwin, p), tc in zip(calls, tcs)])
        out = run()
        for k, plain64 in zip(out, exact):
            share = max(share, fp32_sum_share(k, plain64))
        if c == gas_kernel.CHUNK_BLOCKS:
            kernel_out = out
        sweep[c] = {"run": run, "ms": [],
                    "ctas": sum(int(tc[-1]) for tc in tcs)}
    for c in list(CHUNK_SWEEP) + list(reversed(CHUNK_SWEEP)):
        sweep[c]["ms"].append(cuda_ms(sweep[c]["run"], reps))
    chunk_sweep = {c: {"ms": sum(v["ms"]) / len(v["ms"]), "ctas": v["ctas"]}
                   for c, v in sweep.items()}
    kernel_ms = chunk_sweep[gas_kernel.CHUNK_BLOCKS]["ms"]
    plain_out = run_plain()
    err = max(float((k - r).abs().max())
              for k, r in zip(kernel_out, plain_out))
    rel = max(_max_rel(k.cpu(), r.cpu())
              for k, r in zip(kernel_out, plain_out))
    plain_ms = cuda_ms(run_plain, reps)

    # each launch alone: its time beside its CTAs and real edges
    per_payload = []
    for vwin, p in calls:
        blocks = torch.diff(p["tile_block_start"]).cpu()
        per_payload.append({
            "kind": p["kind"], "n_blocks": p["n_blocks"],
            "n_out_tiles": p["n_out_tiles"],
            "max_tile_blocks": int(blocks.max()),
            "ctas": int(p["tile_chunk_start"][-1]),
            "grid": gas_kernel.max_chunks(p["n_blocks"], p["n_out_tiles"]),
            "real_edges": int(p["num_real_edges"]),
            "ms": cuda_ms(lambda: _pagerank_launch(vwin, p, geom), reps)})

    # the library yardstick: one scatter_reduce of the pre-gathered,
    # pad-free values into the padded vertex vector
    idx_parts, val_parts = [], []
    for vwin, p in calls:
        keep = p["valid"] != 0
        flat_src = p["window_id"].to(torch.int64)[:, None] * geom.W \
            + p["src_local"]
        val_parts.append(vwin.reshape(-1)[flat_src[keep]])
        tile_global = p["tile_idx"].to(torch.int64)[
            p["tile_id"].to(torch.int64)]
        idx_parts.append((tile_global[:, None] * geom.T
                          + p["dst_local"])[keep])
    idx, vals = torch.cat(idx_parts), torch.cat(val_parts)
    out = torch.zeros(store.V_pad, device=device)
    library_ms = cuda_ms(lambda: out.zero_().scatter_reduce_(
        0, idx, vals, reduce="sum", include_self=True), reps)

    bound_ms, bound_by, nbytes = _bound_ms(calls, geom)
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
        "chunk_blocks": gas_kernel.CHUNK_BLOCKS,
        "ctas": chunk_sweep[gas_kernel.CHUNK_BLOCKS]["ctas"],
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
    bound_ms, bound_by, nbytes = _bound_ms(calls, geom)
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
    return {"device_ms": dev_ms, "host_ms": host_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every number to this JSON file")
    args = ap.parse_args(argv)

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
    device = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    result = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    try:
        log(f"phase 1: {card}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}")
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(CHUNK_SWEEP)) as pool:
            libs = list(pool.map(lambda c: _build.build(
                "gas_kernel", GAS_CHUNK_BLOCKS=c), CHUNK_SWEEP))
        for c in CHUNK_SWEEP:
            gas_kernel.build(c)
        result["build_s"] = time.perf_counter() - t0
        log(f"phase 1: built gas_kernel for chunks of {CHUNK_SWEEP} blocks "
            f"in {result['build_s']:.1f} s")
        main_lib = libs[CHUNK_SWEEP.index(gas_kernel.CHUNK_BLOCKS)].name
        ptxas = sorted({line.split(":", 1)[-1].strip() for line in
                        _build.build_log.get(main_lib, "").splitlines()
                        if "registers" in line or "spill" in line})
        log("phase 1: ptxas, both kernels x 7 instantiations: "
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
        log("phase 4: chunk sweep (chunk blocks: ms of the 8 launches, "
            "CTAs): " + "; ".join(
                f"{c}: {v['ms']:.4f} ms, {v['ctas']}"
                for c, v in kernel["chunk_sweep"].items()))
        log("phase 4: per launch (kind, blocks, tiles, heaviest tile's "
            "blocks, CTAs, real edges, ms): " + "; ".join(
                f"{q['kind']} {q['n_blocks']} {q['n_out_tiles']} "
                f"{q['max_tile_blocks']} {q['ctas']} {q['real_edges']} "
                f"{q['ms']:.4f}" for q in per_payload))
        result["per_entry"] = phase_per_entry(main_res, device)
        log("phase 4: per-entry form: " + json.dumps(result["per_entry"]))
        result["breakdown"] = phase_breakdown(main_res, device)
        result["main_path"] = {k: v for k, v in main_res.items()
                               if not k.startswith("_")}
    except CheckFailed as exc:
        log(f"FAIL: {exc}")
        return 1
    result["kernels"] = [kernel]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    log("PageRank iteration breakdown: " + json.dumps(result["breakdown"]))
    log(f"card: {card_line()}")
    log(json.dumps({"kernels": result["kernels"]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

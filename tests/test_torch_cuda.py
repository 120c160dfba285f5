"""Card-only tests of the port: the CUDA GAS kernel against its plain
version (on graph payloads, on a heavy tile that spans many chunks, and
tile by tile on a Big payload with at most 5 % live slots and on a full
Little payload), fused == per-entry == sharded bit for bit in sum mode,
the exact modes' order-free fold bit-equal to the plain path and to an
ordered fold (hub steps, multi-chunk and unaligned chunks, empty tiles,
infinities; signed zeros and NaNs pinned) and in every launch form,
its launch and edge counts, its refusals, the variants generated for custom
scatter UDFs, the main path on the card, and the
changing-graph paths through the kernel: sharded == fused, a derived
store == a cold rebuild after a delta, and reused payloads kept in
place; and the serving layer: a served request == a direct executor,
a spawn pool with CUDA up in the parent, the traced per-lane run ==
the fused run; the replayed iteration (``core/replay.py``) == an eager
run bit for bit, one capture shared by two roots, its pool and buffers
in the bundle's device bytes, a busy capture run eagerly beside a
replay, captures beside eager work on another thread,
and new captures after an update and an adopted plan; a forced autotune
retune on the card,
``DistributedEngine`` on a one-rank NCCL group; and the LM serving
path: reduced dense and MoE models on the card against the CPU, the
engine's greedy tokens against a manual decode loop, and no serving
without a card unless the caller asks for the CPU; the recurrent and
encoder-decoder families (mamba2, hymba, whisper) on the card against
the CPU, the flash-attention backward on the card against the CPU, one
Trainer step on the card, and the MoE's expert-sharded branch over two
gloo ranks sharing the card.
They import neither JAX nor the reference package, so they also run on
a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each skips, with its reason, where torch finds no CUDA device."""
import dataclasses
import gc
import threading

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import partition as part
from repro_torch.core import replay
from repro_torch.core.gas import GATHER_IDENTITY, SCATTER_OPS
from repro_torch.core.types import Geometry
from repro_torch.graphs.rmat import rmat, uniform_random
from repro_torch.kernels import gas_kernel, ops, ref
from repro_torch.streaming import (apply_delta, apply_delta_to_graph,
                                   random_delta)

GEOM = Geometry(U=512, W=512, T=512, E_BLK=128, big_batch=2)
MODE_OPS = [("sum", "copy"), ("sum", "add_weight"), ("min", "copy"),
            ("min", "add_weight"), ("max", "copy"), ("max", "add_weight"),
            ("or", "copy")]

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the GAS kernel has no CPU build")
    return torch.device("cuda", torch.cuda.current_device())


def _host_payload(kind, seed=3):
    """A packed host payload of two entries of ``kind``, and V_pad."""
    g = rmat(10, 8, seed=seed, weighted=True)
    infos, edges = part.partition_graph(g, GEOM)
    infos = [i for i in infos if i.num_edges > 0]
    work = (part.block_little(edges, infos[0], GEOM) if kind == "little"
            else part.block_big(edges, infos[:2], GEOM))
    mid = work.n_blocks // 2
    entries = [e for e in (ops._entry_np(work, 0, mid),
                           ops._entry_np(work, mid, work.n_blocks)) if e]
    return ops._pack_group(entries), \
        part.padded_num_vertices(g.num_vertices, GEOM)


def _payload(kind, device, seed=3):
    host, V_pad = _host_payload(kind, seed)
    return ops._upload_payload(host, device), V_pad


def _padded_plain(host, vprops, fn, mode):
    """``ref.gas_ref`` on a host payload's padded blocks, on vprops'
    device."""
    dev, geom = vprops.device, host["geom"]
    vwin = (vprops[torch.from_numpy(host["unique_src"]).to(dev)]
            if host["kind"] == "big" else vprops).view(-1, geom.W)
    blocks = [torch.from_numpy(host[k]).to(dev) for k in (
        "src_local", "dst_local", "weights", "valid", "window_id",
        "tile_id")]
    return ref.gas_ref(vwin, *blocks, scatter_fn=fn, mode=mode, t=geom.T,
                       n_out_tiles=host["n_out_tiles"])


def _props(mode, n, device):
    rs = np.random.RandomState(7)
    if mode == "or":
        x = rs.randint(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    elif mode == "sum":
        x = rs.rand(n).astype(np.float32)
    else:
        x = (rs.randn(n) * 4).astype(np.float32)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("kind", ["little", "big"])
@pytest.mark.parametrize("mode,op", MODE_OPS)
def test_kernel_matches_plain_and_is_bit_stable(mode, op, kind, device):
    """The kernel over the uploaded stream, and the plain path over it,
    against the plain version on the host payload's padded blocks (the
    card's ``scatter_reduce`` adds in no fixed order: sum at rtol
    1e-5)."""
    host, V_pad = _host_payload(kind)
    p = ops._upload_payload(host, device)
    vp = _props(mode, V_pad, device)
    fn = SCATTER_OPS[op]
    before = gas_kernel.gas_tiles.launches
    k1, _ = ops.run_lane(p, vp, fn, mode, "cuda", op)
    k2, _ = ops.run_lane(p, vp, fn, mode, "cuda", op)
    plain = _padded_plain(host, vp, fn, mode)
    stream_plain, _ = ops.run_lane(p, vp, fn, mode, "ref", op)
    torch.cuda.synchronize()
    assert gas_kernel.gas_tiles.launches == before + 2
    assert torch.equal(k1, k2)
    if mode == "sum":
        torch.testing.assert_close(stream_plain, plain, rtol=1e-5,
                                   atol=1e-5)
    else:
        assert torch.equal(stream_plain, plain)
    if mode == "sum":
        torch.testing.assert_close(k1, plain, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(k1, plain)


def _heavy_tile(device, seed=5):
    """Padded blocks of four tiles, the first of about 10.5 chunks of
    live edges: half of its edges go to one hub slot, a quarter of all
    slots are pads scattered through the blocks (not a prefix), and the
    last tile has no live edge."""
    rng = np.random.default_rng(seed)
    e, n_win = GEOM.E_BLK, 4
    c = -(-gas_kernel.CHUNK_EDGES * 4 // (3 * e))   # blocks a chunk
    sizes = [10 * c + c // 2, 3, c + 1, 2]
    tile_id = np.repeat(np.arange(4), sizes).astype(np.int32)
    shape = (tile_id.shape[0], e)
    dst = rng.integers(0, GEOM.T, shape)
    dst[(rng.random(shape) < 0.5) & (tile_id[:, None] == 0)] = 17
    valid = (rng.random(shape) >= 0.25) & (tile_id[:, None] != 3)
    arrays = {
        "src_local": rng.integers(0, GEOM.W, shape),
        "dst_local": dst,
        "weights": rng.random(shape, dtype=np.float32),
        "valid": valid,
        "window_id": rng.integers(0, n_win, shape[0]),
        "tile_id": tile_id,
    }
    host = {k: v.astype(np.float32 if k == "weights" else np.int32)
            for k, v in arrays.items()}
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}, \
        sizes, n_win


def _launch(a, vwin, mode, op, lo=0, hi=None):
    """The kernel on blocks [lo, hi) of ``a`` (whole tiles), over the
    live-edge stream derived from them."""
    tid = a["tile_id"][lo:hi].cpu().numpy()
    tid = tid - tid[0]
    blocks = {k: a[k][lo:hi] for k in ("src_local", "dst_local", "weights",
                                       "valid", "window_id")}
    blocks["tile_block_start"] = torch.from_numpy(ops.tile_block_start(
        tid, int(tid[-1]) + 1)).to(vwin.device)
    blocks["num_real_edges"] = int(blocks["valid"].count_nonzero())
    blocks["geom"] = GEOM
    p = ops.edge_stream(blocks, vwin.device)
    return gas_kernel.gas_tiles(
        vwin, p["edge_src"], p["edge_dst"], p["edge_w"],
        p["tile_edge_start"], p["tile_chunk_start"], scatter_op=op,
        mode=mode, t=GEOM.T)


def _assert_within_fp32_sum(got, plain64):
    """Slot by slot, ``|got - exact| <= gamma(n - 1) * sum|terms|``, the
    worst-case error of an in-order fp32 sum of n terms (rtol 1e-5
    cannot hold sums of thousands of terms); gamma(m) = m u / (1 - m u),
    u = 2**-24. ``plain64(f)`` is the plain fp64 sum of ``f`` over each
    slot's terms (the scattered values, rounded to fp32 as the kernel
    rounds them)."""
    mu = (plain64(torch.ones_like) - 1).clamp_min(0) * 2.0 ** -24
    allowed = mu / (1 - mu) * plain64(torch.abs)
    gap = (got.double() - plain64(lambda v: v)).abs()
    assert bool((gap <= allowed).all()), float((gap - allowed).max())


@pytest.mark.parametrize("mode,op", MODE_OPS)
def test_kernel_heavy_tile(mode, op, device):
    """A tile of many chunks with a hub slot: kernel == plain (exact for
    min, max and or; sum within fp32 summation error of the fp64 sum),
    bit-stable, and bit-equal to its tiles launched one by one."""
    a, sizes, n_win = _heavy_tile(device)
    vwin = _props(mode, n_win * GEOM.W, device).view(n_win, GEOM.W)
    k1 = _launch(a, vwin, mode, op)
    k2 = _launch(a, vwin, mode, op)

    def plain(v, scatter_fn=SCATTER_OPS[op]):
        return ref.gas_ref(v, a["src_local"], a["dst_local"], a["weights"],
                           a["valid"], a["window_id"], a["tile_id"],
                           scatter_fn=scatter_fn, mode=mode, t=GEOM.T,
                           n_out_tiles=len(sizes))
    torch.cuda.synchronize()
    assert torch.equal(k1, k2)
    if mode == "sum":
        _assert_within_fp32_sum(k1, lambda f: plain(
            vwin.double(),
            lambda x, w: f(SCATTER_OPS[op](x.float(), w).double())))
    else:
        assert torch.equal(k1, plain(vwin))
    starts = np.cumsum([0] + sizes)
    for k, (lo, hi) in enumerate(zip(starts[:-1], starts[1:])):
        assert torch.equal(k1[k], _launch(a, vwin, mode, op, lo, hi)[0])


# custom scatter UDFs (no scatter_op): the kernel variant generated for
# each, in the gather mode it is written for
CUSTOM_UDFS = [
    ("max", lambda s, w: torch.minimum(s, w)),
    ("sum", lambda s, w: s * w * 0.5 + 0.25),
    ("min", lambda s, w: torch.clamp(s - w, min=-1.5) * 0.1),
    ("or", lambda s, w: s & 0xFFFF),
]


@pytest.mark.parametrize("kind", ["little", "big"])
@pytest.mark.parametrize("mode,fn", CUSTOM_UDFS)
def test_custom_udf_kernel_matches_plain(mode, fn, kind, device):
    """A scatter UDF the kernel has no name for launches its generated
    variant, bit-stable, equal to the plain version (rtol 1e-5 for
    sum)."""
    host, V_pad = _host_payload(kind)
    host["weights"] = np.random.default_rng(3).random(
        host["weights"].shape, dtype=np.float32)
    p = ops._upload_payload(host, device)      # the stream of new weights
    vp = _props(mode, V_pad, device)
    before = gas_kernel.gas_tiles.launches
    k1, _ = ops.run_lane(p, vp, fn, mode, "cuda", None)
    k2, _ = ops.run_lane(p, vp, fn, mode, "cuda", None)
    plain, _ = ops.run_lane(p, vp, fn, mode, "ref", None)
    torch.cuda.synchronize()
    assert gas_kernel.gas_tiles.launches == before + 2
    assert torch.equal(k1, k2)
    if mode == "sum":
        torch.testing.assert_close(k1, plain, rtol=1e-5, atol=1e-7)
    else:
        assert torch.equal(k1, plain)


# a Big payload of a uniform graph (at most 5 % of its slots live, as on
# urand's Big lanes) and a Little payload with every slot live
SPARSE_GEOM = Geometry(U=512, W=128, T=128, E_BLK=128, big_batch=8)


def _stream_case(case, device):
    """(host payload, device payload, V_pad) of ``case``: "sparse big"
    or "full little"."""
    if case == "sparse big":
        g, geom = uniform_random(16, 16, seed=7), SPARSE_GEOM
    else:
        g, geom = rmat(10, 8, seed=3, weighted=True), GEOM
    infos, edges = part.partition_graph(g, geom)
    infos = [i for i in infos if i.num_edges > 0]
    if case == "sparse big":
        work = part.block_big(edges, infos[:geom.big_batch], geom)
        host = ops._entry_np(work, 0, work.n_blocks)
        assert host["num_real_edges"] <= 0.05 * work.n_blocks * geom.E_BLK
    else:
        work = part.block_little(edges, infos[0], geom)
        host = ops._entry_np(work, 0, work.n_blocks)
        host["valid"] = np.ones_like(host["valid"])
        host["num_real_edges"] = host["valid"].size
    host["weights"] = np.random.default_rng(5).random(
        host["weights"].shape, dtype=np.float32)
    return host, ops._upload_payload(host, device), \
        part.padded_num_vertices(g.num_vertices, geom)


@pytest.mark.parametrize("case", ["sparse big", "full little"])
@pytest.mark.parametrize("mode,op", MODE_OPS + [("sum", None)])
def test_stream_kernel_matches_plain_tile_by_tile(case, mode, op, device):
    """The kernel over the live-edge stream against ``ref.gas_ref`` on
    the padded blocks, tile by tile: exact for min, max and or; sum
    within fp32 summation error of the fp64 sum and rtol 1e-5. ``op``
    None launches the variant generated for a custom UDF. The launch
    counts the stream's edges, which are the payload's live slots."""
    host, p, V_pad = _stream_case(case, device)
    vp = _props(mode, V_pad, device)
    fn = SCATTER_OPS[op] if op else (lambda s, w: s * w * 0.5 + 0.25)
    edges = gas_kernel.gas_tiles.edges
    got, _ = ops.run_lane(p, vp, fn, mode, "cuda", op)
    torch.cuda.synchronize()
    assert gas_kernel.gas_tiles.edges - edges == p["num_real_edges"] == \
        p["edge_src"].numel()
    plain = _padded_plain(host, vp, fn, mode)
    plain64 = (lambda f: _padded_plain(
        host, vp.double(), lambda x, w: f(fn(x.float(), w).double()),
        mode))
    for k in range(p["n_out_tiles"]):
        if mode == "sum":
            _assert_within_fp32_sum(got[k], lambda f: plain64(f)[k])
            torch.testing.assert_close(got[k], plain[k], rtol=1e-5,
                                       atol=1e-5)
        else:
            assert torch.equal(got[k], plain[k]), k


@pytest.mark.parametrize("op", ["copy", "add_weight"])
def test_fused_per_entry_sharded_kernel_bit_equal(op, device):
    """Sum mode through the kernel: a plan's packed lanes, its entries
    launched one by one and its sharded lanes (two owners on the card)
    give the same tiles bit for bit."""
    g = rmat(11, 8, seed=5, weighted=True)
    store = api.GraphStore(g, geom=SHARD_GEOM)
    bundle = store.plan(api.PlanConfig(
        n_lanes=2, hw=api.DEFAULT_HW.clone(gather_b=0.0)))
    plan = bundle.plan
    forms = {
        "fused": bundle.packed_lanes(device),
        "entry": bundle.lane_entries(device),
        "sharded": ops.pack_lanes_sharded(
            plan, bundle.little_works, bundle.big_works,
            [i % 2 for i in range(len(plan.lanes))], [device, device])[0],
    }
    vp = _props("sum", store.V_pad, device)
    tiles = {}
    for name, lanes in forms.items():
        rows = {}
        for p in (q for lane in lanes for q in lane):
            out, idx = ops.run_lane(p, vp, SCATTER_OPS[op], "sum", "cuda",
                                    op)
            rows.update(zip(idx.tolist(), out))
        tiles[name] = rows
    assert {p["kind"] for lane in forms["fused"] for p in lane} == \
        {"little", "big"}
    for name in ("entry", "sharded"):
        assert tiles[name].keys() == tiles["fused"].keys()
        for i, row in tiles["fused"].items():
            assert torch.equal(tiles[name][i], row), (name, i)


# the exact modes' order-free fold: every named op of min, max and or, and
# the generated UDF variant of each (CUSTOM_UDFS)
EXACT_CASES = [(m, op, None) for m, op in MODE_OPS
               if m in gas_kernel.EXACT_MODES] + [
    (m, None, fn) for m, fn in CUSTOM_UDFS if m in gas_kernel.EXACT_MODES]
_NP_FOLD = {"min": np.fmin, "max": np.fmax, "or": np.bitwise_or}


def _exact_stream(device, seed=11):
    """A live-edge stream of five tiles: a hub tile of 3.5 chunks whose
    edges all go to slot 17 (every step's live lanes on one slot), a tile
    of 2.5 chunks of random slots whose first edge is not 16-byte aligned
    (the hub tile's length is odd), a tile with no edge, a tile of one
    whole chunk and a tile of 7 edges. Returns the stream's arrays as
    ``gas_tiles`` takes them, ``n_win``, and the tile count."""
    rng = np.random.default_rng(seed)
    c, n_win = gas_kernel.CHUNK_EDGES, 4
    counts = [3 * c + c // 2 + 3, 2 * c + c // 2 + 1, 0, c, 7]
    dst = np.concatenate([np.full(counts[0], 17)] + [
        rng.integers(0, GEOM.T, k) for k in counts[1:]])
    tes = np.concatenate([[0], np.cumsum(counts)])
    arrays = [torch.from_numpy(x).to(device) for x in (
        rng.integers(0, n_win * GEOM.W, dst.size).astype(np.int32),
        dst.astype(np.int32), rng.random(dst.size, dtype=np.float32),
        tes.astype(np.int32))]
    return (*arrays, gas_kernel.tile_chunk_start(arrays[3])), n_win, \
        len(counts)


def _exact_props(mode, n, device):
    """Signed values with +-inf and +-3e38 (the identities) among them;
    int32 over the whole range for or."""
    x = _props(mode, n, device)
    if mode != "or":
        x[:4] = torch.tensor([float("inf"), -float("inf"), 3e38, -3e38])
    return x


def _ordered_fold(vals, flat, size, mode):
    """The fold of ``vals`` into ``size`` slots one value after another in
    stream order (numpy's fmin / fmax / bitwise-or, left to right over
    each slot's values), the identity where no value lands."""
    out = np.full(size, GATHER_IDENTITY[mode], dtype=vals.dtype)
    order = np.argsort(flat, kind="stable")
    slots, starts = np.unique(flat[order], return_index=True)
    if slots.size:
        out[slots] = _NP_FOLD[mode].reduceat(vals[order], starts)
    return out


@pytest.mark.parametrize("mode,op,fn", EXACT_CASES)
def test_exact_fold_equals_plain_and_ordered_fold(mode, op, fn, device):
    """min, max and or through the order-free fold (one shared-memory
    atomic an edge; a hub step reduced in the warp first; tiles of
    several chunks folded into the output with atomics) are bit-equal to
    the plain path (``ref.gas_stream_ref``) and to an ordered fold in
    stream order, on a hub tile, random tiles of one and several chunks
    whose chunks start on and off 16-byte boundaries, an empty tile, and
    signed values with +-inf and the identities; bit-stable; the launch
    counts its edges as exact."""
    stream, n_win, n_tiles = _exact_stream(device)
    src, dst, w, tes, tcs = stream
    vwin = _exact_props(mode, n_win * GEOM.W, device).view(n_win, GEOM.W)
    scatter = fn or SCATTER_OPS[op]
    before = gas_kernel.gas_tiles.exact_edges
    k1 = gas_kernel.gas_tiles(vwin, *stream, scatter_op=op, mode=mode,
                              t=GEOM.T, scatter_fn=fn)
    k2 = gas_kernel.gas_tiles(vwin, *stream, scatter_op=op, mode=mode,
                              t=GEOM.T, scatter_fn=fn)
    plain = ref.gas_stream_ref(vwin, src, dst, w, tes, scatter_fn=scatter,
                               mode=mode, t=GEOM.T, n_out_tiles=n_tiles)
    torch.cuda.synchronize()
    assert gas_kernel.gas_tiles.exact_edges - before == 2 * src.numel()
    assert int(tcs[1] - tcs[0]) == 4 and int(tcs[2] - tcs[1]) == 3
    assert int(tes[1]) % 4 != 0
    assert torch.equal(k1, k2)
    assert torch.equal(k1, plain)
    vals = scatter(vwin.reshape(-1)[src.long()], w).to(vwin.dtype)
    tile = torch.repeat_interleave(torch.arange(n_tiles, device=device),
                                   torch.diff(tes.long()))
    flat = (tile * GEOM.T + dst.long()).cpu().numpy()
    ordered = _ordered_fold(vals.cpu().numpy(), flat, n_tiles * GEOM.T, mode)
    assert torch.equal(k1.cpu(), torch.from_numpy(ordered).view(k1.shape))
    assert torch.equal(k1[2], torch.full_like(k1[2], GATHER_IDENTITY[mode]))


def _image(bits):
    """The kernel's order-preserving int image of float32 bits (int32)."""
    return bits ^ ((bits >> 31) & 0x7fffffff)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_exact_fold_pins_signed_zero_and_nan(mode, device):
    """The two inputs where the int image's order is not ``fminf``'s: -0
    sorts below +0, and a NaN beyond the infinity of its sign. No app
    gives them; the kernel's bits for them, in a tile of one chunk and in
    one of two (folded into the output with atomics), are the image's
    min or max over each slot (compared bit for bit)."""
    rng = np.random.default_rng(13)
    special = np.array([0.0, -0.0, np.nan, -np.nan, 1.0, -1.0],
                       dtype=np.float32)
    c = gas_kernel.CHUNK_EDGES
    tes = np.array([0, c // 2, 2 * c], dtype=np.int32)
    pick = rng.integers(0, special.size, tes[-1])
    dst = rng.integers(0, 8, tes[-1]).astype(np.int32)   # 8 slots a tile
    stream = [torch.from_numpy(x).to(device) for x in (
        pick.astype(np.int32), dst, np.zeros(tes[-1], np.float32), tes)]
    vwin = torch.from_numpy(np.resize(special, GEOM.W)).to(device).view(
        1, GEOM.W)
    got = gas_kernel.gas_tiles(
        vwin, *stream, gas_kernel.tile_chunk_start(stream[3]),
        scatter_op="copy", mode=mode, t=GEOM.T)
    torch.cuda.synchronize()
    ident = np.float32(GATHER_IDENTITY[mode]).view(np.int32)
    want = np.full(2 * GEOM.T, _image(ident), dtype=np.int32)
    flat = np.repeat([0, GEOM.T], np.diff(tes)) + dst
    fold = np.minimum if mode == "min" else np.maximum
    fold.at(want, flat, _image(special.view(np.int32)[pick]))
    assert torch.equal(got.view(torch.int32).cpu().reshape(-1),
                       torch.from_numpy(_image(want)))


@pytest.mark.parametrize("app", ["bfs", "wcc"])
def test_exact_fold_equal_in_every_launch_form(app, device, shard_graph):
    """BFS and WCC, through the order-free fold, give one answer in every
    launch form: fused lanes run eagerly, fused and replayed from a
    captured iteration, one launch per plan entry, and lanes sharded over
    two owners on the card; all bit-equal to the plain path."""
    store = api.GraphStore(shard_graph, geom=SHARD_GEOM)
    bundle = store.plan(REPLAY_CFG)
    a = _replay_app(app, _roots(shard_graph)[0])
    want = api.Executor(store, bundle, a, path="ref").run()
    ex = api.Executor(store, bundle, a)
    ex.run()                                            # the capture
    runs = {
        "fused": api.Executor(store, bundle, _eager(a)).run(),
        "replayed": ex.run(),
        "per entry": api.Executor(store, bundle, _eager(a),
                                  fuse_lanes=False).run(),
        "sharded": api.compile(None, a, store=store, config=REPLAY_CFG,
                               shard=[device, device]).run(),
    }
    torch.cuda.synchronize()
    assert ex.dispatch_stats()["replayed_iterations"] >= \
        runs["replayed"][1]["iterations"] > 1
    for name, got in runs.items():
        assert got[1]["iterations"] == want[1]["iterations"], name
        assert np.array_equal(got[0], want[0]), name


def test_kernel_refuses_unnamed_scatter_op(device):
    """A UDF outside the code generator's ops raises, naming the op, and
    launches nothing (no fallback); a named op outside its modes too."""
    p, V_pad = _payload("little", device)
    vp = _props("sum", V_pad, device)
    before = gas_kernel.gas_tiles.launches
    with pytest.raises(NotImplementedError, match="torch.sin"):
        ops.run_lane(p, vp, lambda x, w: torch.sin(x) + w, "sum", "cuda",
                     None)
    with pytest.raises(NotImplementedError, match="control flow"):
        ops.run_lane(p, vp, lambda x, w: x if x > 0 else w, "sum", "cuda",
                     None)
    with pytest.raises(NotImplementedError, match="scatter op"):
        ops.run_lane(p, _props("or", V_pad, device), SCATTER_OPS["add_weight"],
                     "or", "cuda", "add_weight")
    assert gas_kernel.gas_tiles.launches == before


def test_kernel_refuses_wrong_dtype(device):
    p, V_pad = _payload("little", device)
    with pytest.raises(ValueError, match="vwin"):
        ops.run_lane(p, _props("sum", V_pad, device).double(),
                     SCATTER_OPS["copy"], "sum", "cuda", "copy")


@pytest.mark.parametrize("app", ["pagerank", "bfs", "sssp", "wcc",
                                 "closeness"])
def test_main_path_on_card_matches_plain_path(app, device):
    g = rmat(11, 8, seed=5, weighted=True)
    store = api.GraphStore(g, geom=GEOM)
    kernel = api.compile(None, app, store=store, n_lanes=4)
    assert kernel.executor.device == device and kernel.executor.path == "cuda"
    plain = api.compile(None, app, store=store, n_lanes=4, path="ref")
    entry = api.compile(None, app, store=store, n_lanes=4, fuse_lanes=False)
    gas_kernel.gas_tiles.launches = 0
    a, ma = kernel.run()
    assert gas_kernel.gas_tiles.launches == \
        ma["iterations"] * kernel.stats()["kernel_dispatches"]
    b, mb = plain.run()
    c, mc = entry.run()
    assert ma["iterations"] == mc["iterations"] and np.array_equal(a, c)
    if app == "pagerank":
        assert abs(ma["iterations"] - mb["iterations"]) <= 1
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    else:
        assert ma["iterations"] == mb["iterations"]
        assert np.array_equal(a, b)


# -- the changing-graph paths through the kernel ------------------------

SHARD_GEOM = Geometry(U=128, W=128, T=128, E_BLK=128, big_batch=2)
APPS = ["pagerank", "bfs", "sssp", "wcc", "closeness"]


@pytest.fixture(scope="module")
def shard_graph():
    return rmat(11, 8, seed=5, weighted=True)


def _run(store, app, max_iters=4, **where):
    return api.compile(None, app, store=store, n_lanes=8,
                       **where).run(max_iters=max_iters)


@pytest.mark.parametrize("app", APPS)
def test_sharded_equals_fused_on_card(app, device, shard_graph):
    store = api.GraphStore(shard_graph, geom=SHARD_GEOM)
    want, mw = _run(store, app)
    for shard in (1, [device, device]):
        gas_kernel.gas_tiles.launches = 0
        c = api.compile(None, app, store=store, n_lanes=8, shard=shard)
        got, mg = c.run(max_iters=4)
        torch.cuda.synchronize()
        assert c.executor.path == "cuda"
        assert gas_kernel.gas_tiles.launches == \
            mg["iterations"] * c.stats()["kernel_dispatches"] > 0
        assert c.stats()["last_iteration"]["merges"] == 1
        assert mg["iterations"] == mw["iterations"]
        assert np.array_equal(got, want)


def test_sharded_over_every_card(device, shard_graph):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    store = api.GraphStore(shard_graph, geom=SHARD_GEOM)
    n = torch.cuda.device_count()
    c = api.compile(None, "pagerank", store=store, n_lanes=8, shard=True)
    sh = c.executor.sharded
    assert len(sh.devices) == n
    for i, lane in enumerate(sh.lanes):
        for p in lane:
            assert p["edge_src"].device == \
                sh.devices[sh.placement.device_of_lane[i]]
    for app in APPS:
        want, mw = _run(store, app)
        got, mg = _run(store, app, shard=True)
        assert mg["iterations"] == mw["iterations"]
        assert np.array_equal(got, want)


def test_delta_on_card_derived_equals_cold_and_keeps_tensors(
        device, shard_graph):
    """After a delta with the fused and a sharded form on the card: the
    reused lanes hold the same tensors (same data_ptr()), and every app
    on the derived store, fused and sharded, is bit-equal to a cold
    rebuild run the same ways and agrees with the plain path on the
    derived store (PageRank within rtol 1e-5 / atol 1e-7, the others
    exactly)."""
    store = api.GraphStore(shard_graph, geom=SHARD_GEOM)
    cfg = api.PlanConfig(n_lanes=8)
    owners = [device, device]
    packed0 = store.plan(cfg).packed_lanes(device)
    sharded0 = store.shard(cfg, owners)
    ptrs0 = {id(lane): [v.data_ptr() for p in lane for v in p.values()
                        if isinstance(v, torch.Tensor)]
             for lane in packed0 + sharded0.lanes}
    delta = random_delta(shard_graph, churn=0.005, seed=11, hot_frac=0.05,
                         grow_frac=0.01)
    res = apply_delta(store, delta)
    s = res.stats
    assert s["packed_lanes_reused"] > 0 and s["shards_reused"] > 0
    for new, n_reused in (
            (res.store.plan(cfg).packed_lanes(device),
             s["packed_lanes_reused"]),
            (res.store.shard(cfg, owners).lanes, s["shards_reused"])):
        kept = [lane for lane in new if id(lane) in ptrs0]
        assert len(kept) == n_reused
        for lane in kept:
            assert [v.data_ptr() for p in lane for v in p.values()
                    if isinstance(v, torch.Tensor)] == ptrs0[id(lane)]
    cold = api.GraphStore(apply_delta_to_graph(shard_graph, delta),
                          geom=SHARD_GEOM, perm=res.store.perm)
    for app in APPS:
        plain, mp = _run(res.store, app, path="ref")
        for where in ({}, {"shard": owners}):
            gas_kernel.gas_tiles.launches = 0
            got, mg = _run(res.store, app, **where)
            torch.cuda.synchronize()
            assert gas_kernel.gas_tiles.launches > 0
            want, mw = _run(cold, app, **where)
            assert mg["iterations"] == mw["iterations"]
            assert np.array_equal(got, want), (app, where)
            assert mg["iterations"] == mp["iterations"]
            if app == "pagerank":
                np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-7)
            else:
                assert np.array_equal(got, plain), (app, where)


# -- the serving layer on the card ---------------------------------------

@pytest.mark.parametrize("app,kw", [("pagerank", {}), ("bfs", {"root": 0})],
                         ids=["pagerank", "bfs"])
def test_service_on_card_equals_direct_executor(app, kw, device,
                                                shard_graph):
    """A request served on the card (default device) launches the GAS
    kernel and is bit-equal to a direct Executor on the same store and
    plan."""
    with api.GraphService(default_geom=GEOM, workers=2) as svc:
        assert svc.device == device
        fp = svc.register(shard_graph)
        gas_kernel.gas_tiles.launches = 0
        props, meta = svc.run(fingerprint=fp, app=app, app_kwargs=kw,
                              n_lanes=4, timeout=300)
        torch.cuda.synchronize()
        assert gas_kernel.gas_tiles.launches > 0
        store = svc.cache.peek((fp, GEOM, True))
        ex = api.Executor(store, store.plan(api.PlanConfig(n_lanes=4)),
                          api.BUILTIN_APPS[app](**kw))
        assert ex.device == device and ex.path == "cuda"
        want, mw = ex.run()
    assert meta["iterations"] == mw["iterations"]
    assert torch.equal(torch.from_numpy(props), torch.from_numpy(want))


def test_spawn_pool_with_cuda_initialised(device, shard_graph):
    """With CUDA up in the parent and the base planned on the card, the
    spawned workers build and splice (host numpy only, CUDA never
    initialised there), and the pool's snapshot equals an in-process
    apply_delta's bit for bit."""
    from repro_torch.control import WorkerPool
    from repro_torch.streaming import rebuild_plans

    cfg = api.PlanConfig(n_lanes=4)
    assert torch.cuda.is_initialized()
    with WorkerPool(workers=2, warm=True) as pool:
        store = pool.build_store(shard_graph, geom=GEOM, use_dbg=True,
                                 fp=shard_graph.fingerprint())
        api.compile(None, "pagerank", store=store, config=cfg).run(
            max_iters=2)                       # payloads on the card
        delta = random_delta(shard_graph, churn=0.01, seed=3, hot_frac=0.05)
        res = pool.apply(store, delta)
        res.stats.update(rebuild_plans(store, res.store, res.dirty_pids))
        for idx in range(pool.workers):
            assert pool._run(idx, torch.cuda.is_initialized) is False
    local = apply_delta(store, delta)
    assert res.stats["packed_lanes_reused"] == \
        local.stats["packed_lanes_reused"] > 0
    for app in ("pagerank", "bfs"):
        got, mg = api.compile(None, app, store=res.store, config=cfg).run()
        want, mw = api.compile(None, app, store=local.store,
                               config=cfg).run()
        assert mg["iterations"] == mw["iterations"]
        assert torch.equal(torch.from_numpy(got), torch.from_numpy(want))


def test_traced_run_on_card_equals_fused(device, shard_graph):
    """The traced per-lane run (a span and a synchronization per lane)
    launches the same payloads into the same merge: bit-equal."""
    store = api.GraphStore(shard_graph, geom=GEOM)
    c = api.compile(None, "pagerank", store=store, n_lanes=4)
    want, mw = c.run()
    tracer = api.Tracer(lane_detail=True)
    root = tracer.start_trace("job")
    gas_kernel.gas_tiles.launches = 0
    with tracer.activate(root.context):
        got, mg = c.run()
    root.end()
    torch.cuda.synchronize()
    assert gas_kernel.gas_tiles.launches == \
        mg["iterations"] * c.stats()["kernel_dispatches"]
    assert mg["iterations"] == mw["iterations"]
    assert torch.equal(torch.from_numpy(got), torch.from_numpy(want))
    lanes = [s for s in tracer.export(root.trace_id)
             if s["name"] == "executor.lane"]
    assert lanes and all("est_time" in s["attrs"] and s["attrs"]["gbps"] > 0
                         for s in lanes)


# -- autotune and the SPMD path on the card -----------------------------

def test_forced_retune_on_card(device, shard_graph, tmp_path):
    """A forced retune sweeps the lanes through the kernel, fits, adopts
    the winning plan and persists a spec that names the card; the
    adopted plan's results agree with the old plan's (PageRank within
    rtol 1e-5, BFS exactly)."""
    from repro_torch.autotune import (AutoTuner, Calibrator, RetunePolicy,
                                      SpecRegistry)
    store = api.GraphStore(shard_graph, geom=SHARD_GEOM)
    cfg = api.PlanConfig(n_lanes=4)
    tuner = AutoTuner(policy=RetunePolicy(cooldown_s=0.0),
                      calibrator=Calibrator(max_residual=float("inf")),
                      registry=SpecRegistry(str(tmp_path)))
    assert tuner.device == device
    assert tuner.device_kind.startswith(torch.cuda.get_device_name(device))
    pr = api.compile(None, "pagerank", store=store, config=cfg)
    bfs = api.compile(None, "bfs", store=store, config=cfg)
    pr_a, _ = pr.run()
    bfs_a, _ = bfs.run()
    ex = api.Executor(store, store.plan(cfg), pr.app,
                      calibrator=tuner.calibrator)
    gas_kernel.gas_tiles.launches = 0
    event = tuner.retune(store, ex, cfg, skey="g", force=True)
    torch.cuda.synchronize()
    assert gas_kernel.gas_tiles.launches > 0       # the sweep's launches
    assert event["applied"], event
    with open(event["spec_path"]) as f:
        assert torch.cuda.get_device_name(device) in f.read()
    cfg_b = tuner.resolve_config(api.PlanConfig(n_lanes=4), "g")
    assert cfg_b.hw is tuner.hw and store.has_plan(cfg_b)
    pr_b, _ = api.compile(None, "pagerank", store=store, config=cfg_b).run()
    bfs_b, _ = api.compile(None, "bfs", store=store, config=cfg_b).run()
    np.testing.assert_allclose(pr_b, pr_a, rtol=1e-5, atol=1e-7)
    assert np.array_equal(bfs_b, bfs_a)


def test_distributed_engine_on_one_rank_nccl(device, shard_graph,
                                             tmp_path):
    """DistributedEngine on a one-rank NCCL group: its two packed
    payloads through the kernel, one all_reduce, equal to the fused
    executor (PageRank within rtol 1e-5, the min apps exactly)."""
    import datetime
    import torch.distributed as dist
    from repro_torch.core.distributed import DistributedEngine
    store = api.GraphStore(shard_graph, geom=SHARD_GEOM)
    cfg = api.PlanConfig(n_lanes=4, hw=api.DEFAULT_HW.clone(gather_b=0.0))
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "rendezvous"), 1),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        for app in ("pagerank", "bfs", "sssp", "closeness"):
            want, mw = api.compile(None, app, store=store,
                                   config=cfg).run()
            eng = DistributedEngine(store, api.BUILTIN_APPS[app](),
                                    config=cfg, blocks_per_chunk=8)
            assert eng.path == "cuda" and eng.stats()["payloads"] == 2
            gas_kernel.gas_tiles.launches = 0
            got, mg = eng.run()
            torch.cuda.synchronize()
            assert gas_kernel.gas_tiles.launches == 2 * mg["iterations"]
            if app == "pagerank":
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
            else:
                assert mg["iterations"] == mw["iterations"]
                assert np.array_equal(got, want)
    finally:
        dist.destroy_process_group()


# -- the replayed iteration on the card (core/replay.py) -------------------

# Little and Big lanes on both layouts (the Big gather's cost set to 0)
REPLAY_CFG = api.PlanConfig(n_lanes=4, hw=api.DEFAULT_HW.clone(gather_b=0.0))


def _roots(g, n=2):
    """The ``n`` vertices of highest out-degree."""
    deg = np.bincount(g.src, minlength=g.num_vertices)
    return [int(v) for v in np.argsort(-deg, kind="stable")[:n]]


def _replay_app(name, root):
    kw = {"root": root} if name in ("bfs", "sssp") else {}
    return api.BUILTIN_APPS[name](**kw)


def _eager(app):
    """The same app without an iteration key: its runs never replay."""
    return dataclasses.replace(app, iteration_key=None)


def _totals():
    t = replay.totals()
    return np.array([t[key] for key in replay.COUNTS])


def _assert_same_run(got, want):
    (a, ma), (b, mb) = got, want
    assert ma["iterations"] == mb["iterations"]
    assert torch.equal(torch.from_numpy(a), torch.from_numpy(b))
    assert len(ma["history"]) == len(mb["history"])
    for x, y in zip(ma["history"], mb["history"]):
        assert torch.equal(torch.from_numpy(x), torch.from_numpy(y))


@pytest.mark.parametrize("layout", ["padded", "stream"])
@pytest.mark.parametrize("app", APPS)
def test_replayed_run_equals_eager_run(app, layout, device, shard_graph):
    """The capturing run (its first iteration eager) and a later run
    (every iteration replayed) equal a run of the same app without a key
    bit for bit: properties, iterations and history; the kernel's launch
    and edge counts stay one payload's a payload an iteration, each graph
    having recorded one iteration's (its exact edges too: all of them in
    min, max and or, none in sum), and the executor's own counts add up
    to the process's."""
    store = api.GraphStore(shard_graph, geom=SHARD_GEOM, layout=layout)
    bundle = store.plan(REPLAY_CFG)
    a = _replay_app(app, _roots(shard_graph)[0])
    want = api.Executor(store, bundle, _eager(a)).run(collect_history=True)
    n = want[1]["iterations"]
    assert n > 1
    ex = api.Executor(store, bundle, a)
    assert {p["kind"] for p in ex._payloads} == {"little", "big"}
    for run in range(2):
        before = _totals()
        gas_kernel.gas_tiles.launches = gas_kernel.gas_tiles.edges = 0
        got = ex.run(collect_history=True)
        torch.cuda.synchronize()
        _assert_same_run(got, want)
        d = ex.dispatch_stats()
        assert (gas_kernel.gas_tiles.launches, gas_kernel.gas_tiles.edges) \
            == (n * d["kernel_dispatches"], n * d["kernel_edges"])
        want_counts = [1, n - 1, 1, n] if run == 0 else [0, n, 0, n]
        assert list(_totals() - before) == want_counts
        assert [d[key] for key in replay.COUNTS] == (
            want_counts if run == 0 else [1, 2 * n - 1, 1, 2 * n])
    assert ex.dispatch_stats()["capture_pool_bytes"] > 0
    cap = bundle.iteration_capture(device, a.iteration_key)
    exact = d["kernel_edges"] if a.gather in gas_kernel.EXACT_MODES else 0
    assert [g[1] for g in cap.graphs] == [{
        "launches": d["kernel_dispatches"], "edges": d["kernel_edges"],
        "exact_edges": exact}] * 2


def test_device_bytes_count_the_captured_pools(device, shard_graph):
    """After a capture the bundle's ``device_bytes()`` (and so the
    store's ``memory_footprint()``, the store cache's budget) counts its
    graph pool and its two static buffers."""
    store = api.GraphStore(shard_graph, geom=SHARD_GEOM)
    bundle = store.plan(REPLAY_CFG)
    app = _replay_app("pagerank", 0)
    api.Executor(store, bundle, app).run()
    torch.cuda.synchronize()
    cap = bundle.iteration_capture(device, app.iteration_key)
    assert cap.captured and cap.pool_bytes > 0
    db = bundle.device_bytes()
    assert db["capture_bytes"] == cap.pool_bytes + 2 * 4 * store.V_pad \
        == bundle.capture_pool_bytes(device) + 2 * 4 * store.V_pad
    assert db["total_bytes"] == sum(v for k, v in db.items()
                                    if k != "total_bytes")
    assert store.memory_footprint()["plan_bytes"] == db["total_bytes"]


def test_replay_with_tiles_over_48k_of_shared_memory(device):
    """Tiles of 2,048 slots take 80 KB of shared memory a CTA, so each
    launch sets the kernel's shared-memory attribute, inside the capture
    too: the capture holds, and its replays equal the eager run."""
    geom = Geometry(U=4096, W=512, T=2048, E_BLK=128, big_batch=2)
    store = api.GraphStore(rmat(12, 8, seed=5, weighted=True), geom=geom)
    bundle = store.plan(api.PlanConfig(n_lanes=2))
    app = _replay_app("pagerank", 0)
    want = api.Executor(store, bundle, _eager(app)).run(collect_history=True)
    ex = api.Executor(store, bundle, app)
    for _ in range(2):
        _assert_same_run(ex.run(collect_history=True), want)
    cap = bundle.iteration_capture(device, app.iteration_key)
    assert cap.captured and cap.broken is None, cap.broken


def test_two_roots_share_one_capture(device, shard_graph):
    store = api.GraphStore(shard_graph, geom=SHARD_GEOM)
    bundle = store.plan(REPLAY_CFG)
    before = _totals()
    n_all, answers = 0, []
    for root in _roots(shard_graph):
        app = _replay_app("bfs", root)
        got = api.Executor(store, bundle, app).run()
        _assert_same_run(got, api.Executor(store, bundle,
                                           _eager(app)).run())
        n_all += got[1]["iterations"]
        answers.append(got[0])
    assert not np.array_equal(*answers)
    # the eager runs beside them count in run_iterations alone
    assert list(_totals() - before) == [1, n_all - 1, 1, 2 * n_all]
    assert len(bundle._captures) == 1


def test_busy_capture_runs_eagerly_beside_the_replay(device, shard_graph):
    """Two threads run one key at once: the one holding the capture
    replays, the other runs eagerly; both equal the eager answer."""
    store = api.GraphStore(shard_graph, geom=SHARD_GEOM)
    bundle = store.plan(REPLAY_CFG)
    app = _replay_app("pagerank", 0)
    want = api.Executor(store, bundle, _eager(app)).run()
    api.Executor(store, bundle, app).run()              # the capture
    n = want[1]["iterations"]
    inside, go, out = threading.Event(), threading.Event(), {}

    def held(old, new, it):
        if it == 1:
            inside.set()
            assert go.wait(120)
        return app.converged(old, new, it)

    def first():
        out["first"] = api.Executor(
            store, bundle, dataclasses.replace(app, converged=held)).run()

    before = _totals()
    t = threading.Thread(target=first)
    t.start()
    assert inside.wait(120)
    out["second"] = api.Executor(store, bundle, app).run()
    go.set()
    t.join(120)
    _assert_same_run(out["first"], want)
    _assert_same_run(out["second"], want)
    assert list(_totals() - before) == [0, n, n, 2 * n]


def test_capture_beside_eager_work_on_another_thread(device, shard_graph):
    """Captures on one thread while another issues eager runs back to
    back, each waiting on its stream (a wait on the whole device is not
    allowed while a stream captures): every capture holds, every answer
    equals the eager one, and the launches count one a payload an
    iteration on both threads (the other thread's launches during a
    recording count as launched)."""
    store = api.GraphStore(shard_graph, geom=SHARD_GEOM)
    wcc = _eager(_replay_app("wcc", 0))
    bundle0 = store.plan(REPLAY_CFG)
    want_wcc = api.Executor(store, bundle0, wcc).run()
    stop, errors, runs = threading.Event(), [], [0]
    busy_ex = api.Executor(store, bundle0, wcc)

    def busy():
        try:
            while not stop.is_set():
                _assert_same_run(busy_ex.run(), want_wcc)
                torch.cuda.current_stream().synchronize()
                runs[0] += 1
        except BaseException as exc:          # noqa: BLE001 — reported
            errors.append(exc)

    t = threading.Thread(target=busy)
    gas_kernel.gas_tiles.launches, expect = 0, 0
    t.start()
    try:
        before = _totals()
        for n_lanes in (2, 3, 4, 5, 6, 7):
            cfg = api.PlanConfig(n_lanes=n_lanes,
                                 hw=api.DEFAULT_HW.clone(gather_b=0.0))
            bundle = store.plan(cfg)
            app = _replay_app("pagerank", 0)
            want = api.Executor(store, bundle, _eager(app)).run()
            ex = api.Executor(store, bundle, app)
            got = ex.run()
            _assert_same_run(got, want)
            expect += 2 * got[1]["iterations"] \
                * ex.dispatch_stats()["kernel_dispatches"]
            cap = bundle.iteration_capture(device, app.iteration_key)
            assert cap.captured and cap.broken is None, cap.broken
    finally:
        stop.set()
        t.join(120)
    assert not errors, errors
    assert runs[0] > 0
    assert (_totals() - before)[0] == 6
    busy_launches = want_wcc[1]["iterations"] \
        * busy_ex.dispatch_stats()["kernel_dispatches"]
    assert gas_kernel.gas_tiles.launches == expect + runs[0] * busy_launches


def test_new_snapshot_and_adopted_plan_capture_anew(device, shard_graph):
    """After ``GraphService.update`` and after ``adopt_plan`` the run
    captures on its own bundle, and equals an eager run there."""
    from repro_torch.core.planner import Planner
    root = _roots(shard_graph)[0]
    app = _replay_app("bfs", root)
    with api.GraphService(default_geom=SHARD_GEOM, workers=2) as svc:
        fp = svc.register(shard_graph)

        def served(f):
            return svc.run(fingerprint=f, app="bfs",
                           app_kwargs={"root": root}, config=REPLAY_CFG,
                           timeout=300)

        served(fp)
        old = svc.cache.peek((fp, SHARD_GEOM, True)).plan(REPLAY_CFG)
        old_cap = old.iteration_capture(device, app.iteration_key)
        assert old_cap.captured
        before = _totals()
        delta = random_delta(shard_graph, churn=0.005, seed=11,
                             hot_frac=0.05)
        new_fp = svc.update(fp, delta).fingerprint
        props, meta = served(new_fp)
        store = svc.cache.peek((new_fp, SHARD_GEOM, True))
        bundle = store.plan(REPLAY_CFG)
        cap = bundle.iteration_capture(device, app.iteration_key)
        assert bundle is not old and cap is not old_cap and cap.captured
        assert (_totals() - before)[0] == 1
        want = api.Executor(store, bundle, _eager(app)).run()
        _assert_same_run((props, {**meta, "history": []}), want)

        adopted = Planner(store, REPLAY_CFG).build()
        store.adopt_plan(adopted)
        del old, old_cap
        gc.collect()
        torch.cuda.empty_cache()
        junk = torch.full((1 << 24,), float("nan"), device=device)
        assert store.plan(REPLAY_CFG) is adopted
        before = _totals()
        got = api.Executor(store, adopted, app).run()
        del junk
        assert (_totals() - before)[0] == 1
        assert adopted.iteration_capture(device, app.iteration_key) \
            is not cap
        _assert_same_run(got, want)


# ---------------------------------------------------------------------------
# LM serving path
# ---------------------------------------------------------------------------

@pytest.fixture
def lm_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs the LM serving path there")
    return torch.device("cuda", torch.cuda.current_device())


def _lm(arch, dtype=None):
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.api import build_model
    cfg = reduced(get_config(arch))
    return build_model(dataclasses.replace(cfg, dtype=dtype) if dtype
                       else cfg)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.parametrize("arch", ["qwen2_1p5b", "granite_moe_3b_a800m"])
def test_lm_on_card_matches_cpu(arch, lm_device):
    """Reduced models in fp32, the same weights and tokens: forward,
    prefill and four teacher-forced decode steps on the card within
    rtol 1e-4 / atol 1e-4 of the CPU, and a second forward on the card
    bit-equal to the first (the MoE combine uses no float atomics)."""
    model = _lm(arch, "float32")
    params = model.init(torch.Generator(lm_device).manual_seed(0))
    tok = torch.from_numpy(np.random.RandomState(0).randint(
        0, model.cfg.vocab_size, (2, 24)).astype(np.int32))
    outs = {}
    for dev in (lm_device, torch.device("cpu")):
        p = _to(params, dev)
        t = tok.to(dev)
        with torch.inference_mode():
            got = [model.forward(p, {"tokens": t})]
            cache, last = model.prefill(p, {"tokens": t[:, :16]})
            cache = {k: torch.cat([v, v.new_zeros(v.shape[:2] + (8,)
                                                  + v.shape[3:])], dim=2)
                     for k, v in cache.items()}
            got.append(last)
            for i in range(16, 20):
                logits, cache = model.decode_step(p, cache, t[:, i:i + 1], i)
                got.append(logits)
            if dev.type == "cuda":
                assert torch.equal(model.forward(p, {"tokens": t}), got[0])
        outs[dev.type] = [g.cpu() for g in got]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_lm_engine_greedy_equals_decode_loop_on_card(lm_device):
    """The engine's greedy tokens (bf16, max_batch=1) equal a manual
    prefill + decode loop on the card, token for token."""
    from repro_torch.serve.engine import Request, ServeEngine
    model = _lm("qwen2_1p5b")
    params = model.init(torch.Generator(lm_device).manual_seed(0))
    prompt = np.random.RandomState(1).randint(
        0, model.cfg.vocab_size, 10).astype(np.int32)
    eng = ServeEngine(model, params, max_batch=1, max_seq=32,
                      device=lm_device)
    [req] = eng.run_wave([Request(tokens=prompt, max_new_tokens=8)])
    with torch.inference_mode():
        cache, logits = model.prefill(
            params, {"tokens": torch.from_numpy(prompt)[None].to(lm_device)})
        cache = {k: torch.cat([v, v.new_zeros(v.shape[:2] + (9,)
                                              + v.shape[3:])], dim=2)
                 for k, v in cache.items()}
        out = [int(torch.argmax(logits[0, -1, :model.cfg.vocab_size]))]
        for t in range(7):
            logits, cache = model.decode_step(
                params, cache, torch.tensor([[out[-1]]], dtype=torch.int32,
                                            device=lm_device), 10 + t)
            out.append(int(torch.argmax(logits[0, 0, :model.cfg.vocab_size])))
    assert req.out.tolist() == out


def test_lm_entry_points_raise_without_a_card(lm_device, monkeypatch):
    """With CUDA hidden, serving raises unless device="cpu"."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import kvcache
    from repro_torch.serve.engine import ServeEngine
    model = _lm("qwen2_1p5b")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kvcache.init_cache(model.cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--requests", "1"])
    assert ServeEngine(model, params, device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# recurrent and encoder-decoder families, the attention backward, training
# ---------------------------------------------------------------------------

def _lm_batch(cfg, b, s, seed=0):
    rs = np.random.RandomState(seed)
    tok = torch.from_numpy(rs.randint(0, cfg.vocab_size, (b, s))
                           .astype(np.int32))
    batch = {"tokens": tok, "labels": tok}
    if cfg.frontend == "audio":
        batch["enc_embeds"] = torch.from_numpy(
            rs.randn(b, cfg.encoder_seq, cfg.d_model).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", ["mamba2_2p7b", "hymba_1p5b",
                                  "whisper_tiny"])
def test_recurrent_on_card_matches_cpu(arch, lm_device):
    """Reduced models in fp32, the same weights and inputs: forward,
    prefill and four teacher-forced decode steps on the card within rtol
    1e-4 / atol 1e-4 of the CPU (hymba's 40-token prompt passes its
    window of 32)."""
    model = _lm(arch, "float32")
    params = model.init(torch.Generator(lm_device).manual_seed(0))
    batch = _lm_batch(model.cfg, 2, 44)
    outs = []
    for dev in (lm_device, torch.device("cpu")):
        p, b = _to(params, dev), _to(batch, dev)
        with torch.inference_mode():
            got = [model.forward(p, b)]
            cache, last = model.prefill(p, {**b, "tokens": b["tokens"][:,
                                                                      :40]})
            if model.cfg.family == "audio":
                cache = {k: (torch.cat([v, v.new_zeros(
                    v.shape[:2] + (4,) + v.shape[3:])], dim=2)
                    if k in ("k", "v") else v) for k, v in cache.items()}
            got.append(last)
            for i in range(40, 44):
                logits, cache = model.decode_step(
                    p, cache, b["tokens"][:, i:i + 1], i)
                got.append(logits)
        outs.append([g.cpu() for g in got])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_backward_on_card_matches_cpu(dtype, tol, lm_device):
    """Blockwise attention's gradients (the flash backward, GQA 4 over 2,
    causal with a window, S = 300 over 128-wide blocks) on the card
    against the CPU's (rtol = atol = 1e-4 in fp32, 2e-2 in bf16)."""
    from repro_torch.models import common as mc
    g = torch.Generator().manual_seed(0)
    shapes = [(2, 300, 4, 32), (2, 300, 2, 32), (2, 300, 2, 32),
              (2, 300, 4, 32)]
    q, k, v, do = (torch.randn(s, generator=g).to(dtype) for s in shapes)
    grads = []
    for dev in (lm_device, torch.device("cpu")):
        x = [t.to(dev).requires_grad_() for t in (q, k, v)]
        out = mc.blockwise_attention(*x, causal=True, window=100,
                                     q_block=128, kv_block=128)
        grads.append([t.cpu() for t in torch.autograd.grad(
            out, x, do.to(dev))])
    for a, b in zip(*grads):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


def test_trainer_step_on_card(lm_device, tmp_path):
    """One Trainer step on the card (reduced qwen2 in fp32, AdamW, remat
    on): its loss and grad norm within rtol 1e-4 of the same step on the
    CPU, params on the card and finite, the checkpoint restored onto the
    card."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import adamw
    from repro_torch.train.loop import Trainer
    model = build_model(dataclasses.replace(
        reduced(get_config("qwen2_1p5b")), dtype="float32", remat=True))
    data = DataConfig(vocab_size=model.cfg.vocab_size, seq_len=32,
                      global_batch=4)
    seen = []
    for i, dev in enumerate((lm_device, torch.device("cpu"))):
        tr = Trainer(model, adamw(lr=1e-3), data, tmp_path / str(i),
                     checkpoint_every=0, device=dev)
        params = _to(model.init(torch.Generator(lm_device).manual_seed(0)),
                     dev)
        norms = []
        p, o, losses = tr.run(1, params=params,
                              opt_state=tr.optimizer.init(params),
                              log_every=0, on_step=lambda s, m: norms.append(
                                  float(m["grad_norm"])))
        assert p["embed"].device.type == dev.type
        assert all(bool(torch.isfinite(t).all()) for t in p["layers"]
                   .values())
        seen.append((float(losses[0]), norms[0]))
        step, back = tr.ckpt.restore(like={"params": p, "opt": o})
        assert step == 0 and back["params"]["embed"].device == \
            p["embed"].device
    (l1, n1), (l2, n2) = seen
    assert l1 == pytest.approx(l2, rel=1e-4)
    assert n1 == pytest.approx(n2, rel=1e-4)


# -- the LM substrate's sharding on the card --------------------------------

MOE_WORKER = r'''
import dataclasses, json, os, sys
import torch
import torch.distributed as dist


def run(rank, world, d):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import common, moe
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(reduced(get_config("granite_moe_3b_a800m")),
                              moe_dispatch="biglittle", dtype="float32")
    with torch.device(dev):
        lp = moe.init_layer_params(cfg, torch.Generator(dev).manual_seed(1))
    lp = {k: lp[k] for k in ("router", "we_gate", "we_up", "we_down")}
    x = torch.randn((8, 16, cfg.d_model), device=dev,
                    generator=torch.Generator(dev).manual_seed(2)) * 0.5
    local, _ = moe.moe_ffn(cfg, lp, x, capacity_factor=50.0)
    dist.init_process_group("gloo", init_method=f"file://{d}/pg",
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", (1, world),
                            mesh_dim_names=("data", "model"))
    with common.use_mesh(mesh):
        out, _ = moe.moe_ffn(cfg, lp, x, capacity_factor=50.0)
    if rank == 0:
        json.dump({"allclose": bool(torch.allclose(out, local, rtol=1e-4,
                                                   atol=1e-5)),
                   "max_abs_err": float((out - local).abs().max()),
                   "device": str(out.device)}, open(f"{d}/out.json", "w"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    torch.multiprocessing.spawn(run, args=(2, sys.argv[1]), nprocs=2)
'''


def test_expert_sharded_moe_two_ranks_on_card(lm_device, tmp_path):
    """granite-MoE reduced, f32: the expert-sharded branch of ``moe_ffn``
    (E_pad 16 / 2) in two processes sharing the card over gloo (NCCL
    takes one rank per GPU), against the single-device ``moe_ffn`` at
    the reference's rtol 1e-4 / atol 1e-5."""
    import json
    import os
    import subprocess
    import sys
    (tmp_path / "worker.py").write_text(MOE_WORKER)
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    r = subprocess.run([sys.executable, str(tmp_path / "worker.py"),
                        str(tmp_path)], env={**os.environ, "PYTHONPATH": src},
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    res = json.loads((tmp_path / "out.json").read_text())
    assert res["device"].startswith("cuda") and res["allclose"], res

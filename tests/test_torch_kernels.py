"""The port's plain GAS versions on the CPU against the reference's Pallas
kernel (interpret mode) and its jnp oracle, on the same numpy inputs:
every gather mode, both input forms (Little, Big), per-entry and
segmented (packed) launches, and the reference's geometry sweep.
Tolerances: exact for min, max and or; rtol/atol 1e-5 for sum (the
summation order differs), as in the reference's own kernel tests.

The CUDA kernel cannot run here, so its order of combines is emulated
on the payload's live-edge stream: each tile's live edges cut into
chunks counted from the tile's first live edge, a partial tile per
chunk, the partials combined in chunk order. The
emulation must equal the plain version exactly for min, max and or, lie
within the worst-case in-order fp32 summation error of the exact sum
for sum, and be bit-equal on fused and per-entry payloads."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partition as jpart
from repro.core.types import Geometry as JGeometry
from repro.graphs.rmat import rmat as jrmat
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.gas_kernel import gas_pallas_call

from repro_torch import convert
from repro_torch.core.gas import SCATTER_OPS
from repro_torch.kernels import gas_kernel, ops as tops, ref as tref
from repro_torch.kernels.little_pipeline import little_pipeline

GEOM = JGeometry(U=512, W=512, T=512, E_BLK=128, big_batch=2)
# (mode, scatter op): the kernel's named pairs
MODE_OPS = [("sum", "copy"), ("min", "add_weight"), ("max", "copy"),
            ("or", "copy")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run shares the CPU among parallel workers; torch's own
    thread pool would oversubscribe it (and disturb timing-sensitive
    tests in other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_match(mode, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if mode == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _host_payloads(graph, kind, form):
    """Reference host payloads of one kind: a whole work as one entry, or
    a packed group of split entries plus a second work."""
    infos, edges = jpart.partition_graph(graph, GEOM)
    infos = [i for i in infos if i.num_edges > 0]
    if kind == "little":
        works = [jpart.block_little(edges, i, GEOM) for i in infos[:2]]
    else:
        works = [jpart.block_big(edges, infos[:1], GEOM),
                 jpart.block_big(edges, infos[1:3], GEOM)]
    w0 = works[0]
    if form == "entry":
        return jops._entry_np(w0, 0, w0.n_blocks)
    cut = np.linspace(0, w0.n_blocks, 3).astype(int)
    parts = [jops._entry_np(w0, int(lo), int(hi))
             for lo, hi in zip(cut[:-1], cut[1:])]
    parts = [p for p in parts if p is not None]
    parts.append(jops._entry_np(works[1], 0, works[1].n_blocks))
    return jops._pack_group(parts)


_COMBINE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum,
            "or": torch.bitwise_or}


def _chunked_gas(vwin, stream, *, scatter_fn, mode, t, chunk_edges=64):
    """The kernel's order on the CPU, over a live-edge stream
    (``ops.edge_stream``): tile k's edges ``tile_edge_start[k]:
    tile_edge_start[k + 1]`` cut into chunks of ``chunk_edges`` from its
    first live edge (``tile_chunk_start``), a partial tile per chunk
    (plain version), then the partials combined in chunk order."""
    tes = stream["tile_edge_start"]
    tcs = gas_kernel.tile_chunk_start(tes, chunk_edges).numpy()
    tes = tes.numpy()
    flat = vwin.reshape(-1)
    tiles = []
    for k in range(tes.shape[0] - 1):
        acc = None
        for j in range(tcs[k + 1] - tcs[k]):
            e0 = int(tes[k]) + j * chunk_edges
            sl = slice(e0, min(e0 + chunk_edges, int(tes[k + 1])))
            vals = scatter_fn(flat[stream["edge_src"][sl].long()],
                              stream["edge_w"][sl]).to(vwin.dtype)
            part = tref._scatter_combine(stream["edge_dst"][sl].long(), vals,
                                         t, mode)
            acc = part if acc is None else _COMBINE[mode](acc, part)
        tiles.append(acc)
    return torch.stack(tiles)


def _chunked_payload(p, vprops, op, mode, chunk_edges=64):
    """:func:`_chunked_gas` on one port payload."""
    geom = p["geom"]
    vwin = (vprops[p["unique_src"]] if p["kind"] == "big"
            else vprops).view(-1, geom.W)
    return _chunked_gas(vwin, p, scatter_fn=SCATTER_OPS[op], mode=mode,
                        t=geom.T, chunk_edges=chunk_edges)


def _assert_within_fp32_sum(got, exact64, terms_abs64, n_terms):
    """Slot by slot, ``|got - exact| <= gamma(n - 1) * sum|terms|``, the
    worst-case error of an in-order fp32 sum of the slot's n terms (a
    tree of them errs less); gamma(m) = m u / (1 - m u), u = 2**-24."""
    mu = (n_terms - 1).clamp_min(0) * 2.0 ** -24
    allowed = mu / (1 - mu) * terms_abs64
    gap = (got.double() - exact64).abs()
    assert bool((gap <= allowed).all()), float((gap - allowed).max())


def _assert_chunked(mode, emulated, plain, plain64):
    """The emulated kernel order against the plain version: exact for
    min, max and or; for sum within the fp32 summation bound of the
    fp64 sum. ``plain64(f)`` is the plain version's fp64 sum of ``f``
    over each slot's terms (the scattered values, rounded to fp32)."""
    if mode != "sum":
        assert emulated.dtype == plain.dtype and torch.equal(emulated, plain)
        return
    _assert_within_fp32_sum(emulated, plain64(lambda v: v),
                            plain64(torch.abs), plain64(torch.ones_like))


def _props(mode, n, seed):
    rs = np.random.RandomState(seed)
    if mode == "or":    # full int32 range: bit 31 must survive
        return rs.randint(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(
            np.int32)
    if mode == "sum":
        return rs.rand(n).astype(np.float32)
    return (rs.randn(n) * 4).astype(np.float32)   # signed for min/max


@pytest.mark.parametrize("form", ["entry", "packed"])
@pytest.mark.parametrize("kind", ["little", "big"])
@pytest.mark.parametrize("mode,op", MODE_OPS)
def test_plain_gas_matches_pallas_and_oracle(mode, op, kind, form):
    graph = jrmat(10, 6, seed=11, weighted=True)
    host = _host_payloads(graph, kind, form)
    V_pad = jpart.padded_num_vertices(graph.num_vertices, GEOM)
    vp_np = _props(mode, V_pad, seed=len(kind) + len(form))
    fn = SCATTER_OPS[op]
    # reference: Pallas body in interpret mode, and its jnp oracle
    jpayload = jops._upload_payload(host)
    vp_j = jnp.asarray(vp_np)
    run_j = jops.run_lane if form == "packed" else jops.run_entry
    pallas, _ = run_j(jpayload, vp_j, fn, mode, "pallas")
    oracle, _ = run_j(jpayload, vp_j, fn, mode, "ref")
    # the port: plain path; the kernel path refuses CPU tensors
    tpayload = convert.payload_from_numpy(host, "cpu")
    vp_t = torch.from_numpy(vp_np)
    plain, idx = tops.run_lane(tpayload, vp_t, fn, mode, "ref", op)
    with pytest.raises(ValueError, match="CUDA device"):
        tops.run_lane(tpayload, vp_t, fn, mode, "cuda", op)
    assert plain.shape == (host["n_out_tiles"], GEOM.T)
    assert np.array_equal(idx.numpy(), host["tile_idx"])
    _assert_match(mode, plain.numpy(), pallas)
    _assert_match(mode, plain.numpy(), oracle)
    # the kernel's chunked order, against the plain version and Pallas
    emulated = _chunked_payload(tpayload, vp_t, op, mode)
    _assert_match(mode, emulated.numpy(), pallas)

    def plain64(f):
        return tops.run_lane(tpayload, vp_t.double(),
                             lambda x, w: f(fn(x.float(), w).double()), mode,
                             "ref", op)[0]
    _assert_chunked(mode, emulated, plain, plain64)


@pytest.mark.parametrize("e_blk,w,t", [(128, 512, 512), (256, 512, 512),
                                       (128, 1024, 512), (128, 512, 1024)])
def test_plain_gas_geometry_sweep(e_blk, w, t):
    """The reference's direct-call geometry sweep (scatter ``p * 2 + w``)."""
    rng = np.random.RandomState(0)
    n_blocks, n_win, n_tiles = 5, 3, 2
    vwin = rng.rand(n_win, w).astype(np.float32)
    src = rng.randint(0, w, (n_blocks, e_blk)).astype(np.int32)
    dst = rng.randint(0, t, (n_blocks, e_blk)).astype(np.int32)
    wts = rng.rand(n_blocks, e_blk).astype(np.float32)
    valid = (rng.rand(n_blocks, e_blk) < 0.9).astype(np.int32)
    wid = rng.randint(0, n_win, n_blocks).astype(np.int32)
    tid = np.sort(np.concatenate(
        [np.arange(n_tiles), rng.randint(0, n_tiles, n_blocks - n_tiles)])
    ).astype(np.int32)
    tf = np.ones(n_blocks, np.int32)
    tf[1:] = tid[1:] != tid[:-1]
    sc = lambda p, wt: p * 2 + wt    # noqa: E731
    args = (vwin, src, dst, wts, valid, wid, tid, tf)
    pallas = gas_pallas_call(*map(jnp.asarray, args), scatter_fn=sc,
                             mode="sum", e_blk=e_blk, w=w, t=t,
                             n_out_tiles=n_tiles, interpret=True)
    oracle = jref.gas_ref(*map(jnp.asarray, args), scatter_fn=sc,
                          mode="sum", t=t, n_out_tiles=n_tiles)
    targs = [torch.from_numpy(a) for a in args[:-1]]     # no tile_first
    plain = tref.gas_ref(*targs, scatter_fn=sc, mode="sum", t=t,
                         n_out_tiles=n_tiles)
    _assert_match("sum", plain.numpy(), pallas)
    _assert_match("sum", plain.numpy(), oracle)
    # the kernel's chunked order over the stream derived from these
    # blocks, with tiles of several chunks
    stream = tops.edge_stream({
        "valid": targs[4], "window_id": targs[5], "src_local": targs[1],
        "dst_local": targs[2], "weights": targs[3],
        "tile_block_start": torch.from_numpy(
            tops.tile_block_start(tid, n_tiles)),
        "num_real_edges": int(valid.sum()),
        "geom": types.SimpleNamespace(W=w)}, "cpu")
    emulated = _chunked_gas(targs[0], stream, scatter_fn=sc, mode="sum",
                            t=t, chunk_edges=128)
    _assert_match("sum", emulated.numpy(), pallas)

    def plain64(f):
        return tref.gas_ref(targs[0].double(), *targs[1:],
                            scatter_fn=lambda p, wt: f(
                                sc(p.float(), wt).double()),
                            mode="sum", t=t, n_out_tiles=n_tiles)
    _assert_chunked("sum", emulated, plain, plain64)


@pytest.mark.parametrize("mode", ["sum", "min", "max", "or"])
def test_edge_ref_matches_reference(mode):
    rs = np.random.RandomState(5)
    n, e = 300, 2000
    src = rs.randint(0, n, e).astype(np.int32)
    dst = rs.randint(0, n - 20, e).astype(np.int32)   # some untouched
    wts = rs.rand(e).astype(np.float32)
    vp = _props(mode, n, seed=6)
    fn = SCATTER_OPS["copy" if mode == "or" else "add_weight"]
    want = jref.edge_ref(jnp.asarray(src), jnp.asarray(dst),
                         jnp.asarray(wts), jnp.asarray(vp), fn, mode, n)
    got = tref.edge_ref(torch.from_numpy(src).long(),
                        torch.from_numpy(dst).long(), torch.from_numpy(wts),
                        torch.from_numpy(vp), fn, mode, n)
    _assert_match(mode, got.numpy(), want)


def test_kernel_wrapper_on_cpu_does_not_count_launches():
    """On CPU tensors the wrapper raises, on the kernel path and called
    directly, and counts no launch."""
    graph = jrmat(9, 6, seed=2)
    host = _host_payloads(graph, "little", "entry")
    p = convert.payload_from_numpy(host, "cpu")
    vp = torch.from_numpy(_props("sum", jpart.padded_num_vertices(
        graph.num_vertices, GEOM), seed=1))
    before = gas_kernel.gas_tiles.launches
    with pytest.raises(ValueError, match="CUDA device"):
        tops.run_lane(p, vp, SCATTER_OPS["copy"], "sum", "cuda", "copy")
    with pytest.raises(ValueError, match="CUDA device"):
        little_pipeline(vp, p, scatter_op="copy", mode="sum")
    assert gas_kernel.gas_tiles.launches == before


@pytest.mark.parametrize("kind", ["little", "big"])
def test_chunked_order_fused_equals_per_entry(kind):
    """Chunks are counted from each tile's first live edge, and entries
    are tile-snapped, so the kernel's order gives a packed payload and
    its entries, launched one by one, the same tiles bit for bit."""
    graph = jrmat(10, 6, seed=11, weighted=True)
    infos, edges = jpart.partition_graph(graph, GEOM)
    infos = [i for i in infos if i.num_edges > 0]
    if kind == "little":
        works = [jpart.block_little(edges, i, GEOM) for i in infos[:2]]
    else:
        works = [jpart.block_big(edges, infos[:1], GEOM),
                 jpart.block_big(edges, infos[1:3], GEOM)]
    cut = np.linspace(0, works[0].n_blocks, 4).astype(int)
    parts = [jops._entry_np(works[0], int(lo), int(hi))
             for lo, hi in zip(cut[:-1], cut[1:])]
    parts = [e for e in parts if e is not None]
    parts.append(jops._entry_np(works[1], 0, works[1].n_blocks))
    packed = convert.payload_from_numpy(jops._pack_group(parts), "cpu")
    entries = [convert.payload_from_numpy(e, "cpu") for e in parts]
    V_pad = jpart.padded_num_vertices(graph.num_vertices, GEOM)
    for mode, op in MODE_OPS + [("sum", "add_weight")]:
        vp = torch.from_numpy(_props(mode, V_pad, seed=3))
        fused = _chunked_payload(packed, vp, op, mode)
        for e in entries:
            rows = np.searchsorted(packed["tile_idx"].numpy(),
                                   e["tile_idx"].numpy())
            assert np.array_equal(packed["tile_idx"].numpy()[rows],
                                  e["tile_idx"].numpy())
            assert torch.equal(fused[torch.from_numpy(rows)],
                               _chunked_payload(e, vp, op, mode)), (mode, op)

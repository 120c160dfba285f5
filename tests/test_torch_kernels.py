"""The port's plain GAS versions on the CPU against the reference's Pallas
kernel (interpret mode) and its jnp oracle, on the same numpy inputs:
every gather mode, both input forms (Little, Big), per-entry and
segmented (packed) launches, and the reference's geometry sweep.
Tolerances: exact for min, max and or; rtol/atol 1e-5 for sum (the
summation order differs), as in the reference's own kernel tests."""
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
    # the port: plain path, and the kernel wrapper on CPU tensors
    tpayload = convert.payload_from_numpy(host, "cpu")
    vp_t = torch.from_numpy(vp_np)
    plain, idx = tops.run_lane(tpayload, vp_t, fn, mode, "ref", op)
    wrapped, _ = tops.run_lane(tpayload, vp_t, fn, mode, "cuda", op)
    assert plain.shape == (host["n_out_tiles"], GEOM.T)
    assert np.array_equal(idx.numpy(), host["tile_idx"])
    _assert_match(mode, plain.numpy(), pallas)
    _assert_match(mode, plain.numpy(), oracle)
    assert torch.equal(plain, wrapped)


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
    # the kernel wrapper takes a named op and finds its tiles from
    # tile_block_start alone; on CPU tensors it is the plain version
    wrapped = gas_kernel.gas_tiles(
        *targs[:-1], torch.from_numpy(tops.tile_block_start(tid, n_tiles)),
        scatter_op="add_weight", mode="sum", t=t)
    assert torch.equal(wrapped, tref.gas_ref(
        *targs, scatter_fn=SCATTER_OPS["add_weight"], mode="sum", t=t,
        n_out_tiles=n_tiles))


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
    """On CPU tensors the wrapper runs the plain version: no launch."""
    graph = jrmat(9, 6, seed=2)
    host = _host_payloads(graph, "little", "entry")
    p = convert.payload_from_numpy(host, "cpu")
    vp = torch.from_numpy(_props("sum", jpart.padded_num_vertices(
        graph.num_vertices, GEOM), seed=1))
    before = gas_kernel.gas_tiles.launches
    tops.run_lane(p, vp, SCATTER_OPS["copy"], "sum", "cuda", "copy")
    assert gas_kernel.gas_tiles.launches == before

"""The live-edge stream the CUDA GAS kernel reads, on the CPU.

Every device payload passes through ``ops._upload_payload``, which
derives the stream of a padded host payload on the payload's device
(``ops.edge_stream``): the live slots of the padded blocks alone, in
slot order, taken from ``valid`` slot by slot; the device payload keeps
none of the padded arrays. Checked on every way a payload is made (one
plan entry, a packed lane, a sharded lane, a ``DistributedEngine``
rank's chunks, and a payload whose ``valid`` has holes in mid-block and
a tile with no live edge), for both input forms, against the host
payload's padded blocks:

* the stream holds exactly the live slots, in slot order, and
  ``edge_src == window_id * W + src_local``;
* ``tile_edge_start`` and ``tile_chunk_start`` count each tile from its
  own first live edge;
* the kernel's order over the stream (each tile's chunks, a partial tile
  per chunk, the partials combined in chunk order), evaluated in plain
  PyTorch, equals ``ref.gas_ref`` on the padded blocks: bit for bit for
  min, max and or, rtol 1e-5 for sum; the plain path over the stream
  (``ops.run_lane(..., "ref")``) equals it bit for bit;
* and bit for bit on fused, per-entry and sharded payloads in sum mode.
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.distributed import chunk_queues, pack_chunks
from repro_torch.core.gas import SCATTER_OPS
from repro_torch.core.types import Geometry
from repro_torch.graphs.rmat import rmat
from repro_torch.kernels import gas_kernel, ops, ref

GEOM = Geometry(U=128, W=128, T=128, E_BLK=128, big_batch=2)
MODE_OPS = [("sum", "copy"), ("sum", "add_weight"), ("min", "copy"),
            ("min", "add_weight"), ("max", "copy"), ("or", "copy")]
FORMS = ["entry", "packed", "sharded", "distributed", "holes"]
CHUNK = 64                 # edges a chunk in the emulated kernel order

_COMBINE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum,
            "or": torch.bitwise_or}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run shares the CPU among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# a plan with Little and Big lanes (the Big pipeline's gather cost set
# to 0 so the sparse partitions go Big), split over few lanes so packed
# payloads hold several entries
CONFIG = api.PlanConfig(n_lanes=2, hw=api.DEFAULT_HW.clone(gather_b=0.0))


@pytest.fixture(scope="module")
def store():
    return api.GraphStore(rmat(11, 8, seed=5, weighted=True), geom=GEOM)


@pytest.fixture(scope="module")
def bundle(store):
    return store.plan(CONFIG)


def _with_holes(host: dict, seed: int = 3) -> dict:
    """A host payload whose ``valid`` is punched in mid-block (slots
    after a pad stay live: no block is a prefix of live slots), with the
    last tile's slots all pads."""
    rs = np.random.RandomState(seed)
    valid = host["valid"].copy()
    n_blocks, e_blk = valid.shape
    holes = rs.rand(n_blocks, e_blk) < 0.3
    holes[:, :2] = False                      # a live slot before a hole
    holes[:, -1] = False                      # and after it
    valid[holes] = 0
    valid[host["tile_block_start"][-2]:] = 0  # the last tile: no live edge
    return dict(host, valid=valid,
                num_real_edges=int((valid != 0).sum()))


def _payloads(bundle, kind: str, form: str) -> list:
    """(host payload, device payload) pairs of ``kind`` on the CPU, made
    as ``form`` makes them."""
    works = {"little": bundle.little_works, "big": bundle.big_works}[kind]
    plan = bundle.plan
    if form == "entry":
        w = works[max(range(len(works)), key=lambda i: works[i].n_blocks)]
        out = [(ops._entry_np(w, 0, w.n_blocks),
                ops.materialize_entry(w, 0, w.n_blocks, "cpu"))]
    elif form in ("packed", "holes"):
        host = [p for lane in plan.lanes
                for p in ops._pack_lane_np(lane, bundle.little_works,
                                           bundle.big_works)]
        if form == "holes":
            host = [_with_holes(p) for p in host]
        out = [(p, ops._upload_payload(p, "cpu")) for p in host]
    elif form == "sharded":
        host = ops.pack_lanes_host(plan, bundle.little_works,
                                   bundle.big_works, {}, 0.0)
        lanes, _, _ = ops.pack_lanes_sharded(
            plan, bundle.little_works, bundle.big_works,
            [i % 2 for i in range(len(plan.lanes))], ["cpu", "cpu"])
        out = list(zip([p for lane in host for p in lane],
                       [p for lane in lanes for p in lane]))
    else:                                   # a DistributedEngine rank's
        little, big = chunk_queues(bundle, 2, blocks_per_chunk=4)
        queues = little if kind == "little" else big
        out = [(h, ops._upload_payload(h, "cpu"))
               for h in (pack_chunks(q) for q in queues if q)]
    out = [(h, p) for h, p in out if p is not None and p["kind"] == kind]
    assert out, (kind, form)
    for h, p in out:
        assert h["kind"] == p["kind"] and h["n_blocks"] == p["n_blocks"]
    return out


def _live_slots(h):
    """The padded blocks' live slots of host payload ``h``, flat and in
    slot order."""
    keep = h["valid"].reshape(-1) != 0
    src = (h["window_id"].astype(np.int64)[:, None] * GEOM.W
           + h["src_local"]).reshape(-1)
    return (keep, src[keep], h["dst_local"].reshape(-1)[keep],
            h["weights"].reshape(-1)[keep])


def _padded_plain(h, vprops, fn, mode):
    """``ref.gas_ref`` on host payload ``h``'s padded blocks."""
    vwin = vprops[torch.from_numpy(h["unique_src"])] \
        if h["kind"] == "big" else vprops
    blocks = [torch.from_numpy(h[k]) for k in (
        "src_local", "dst_local", "weights", "valid", "window_id",
        "tile_id")]
    return ref.gas_ref(vwin.view(-1, GEOM.W), *blocks, scatter_fn=fn,
                       mode=mode, t=GEOM.T, n_out_tiles=h["n_out_tiles"])


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kind", ["little", "big"])
def test_stream_holds_the_live_slots_in_slot_order(bundle, kind, form):
    for h, p in _payloads(bundle, kind, form):
        keep, src, dst, w = _live_slots(h)
        assert keep.sum() == p["num_real_edges"] > 0
        assert p["edge_src"].dtype == p["edge_dst"].dtype == torch.int32
        assert p["edge_w"].dtype == torch.float32
        assert np.array_equal(p["edge_src"].numpy(), src)
        assert np.array_equal(p["edge_dst"].numpy(), dst)
        assert np.array_equal(p["edge_w"].numpy(), w)
        # every source indexes the kernel's vwin: raw vprops windows for
        # Little, the payload's compacted table for Big
        n_vwin = (p["unique_src"].numel() if kind == "big"
                  else int(h["window_id"].max()) * GEOM.W + GEOM.W)
        assert int(p["edge_src"].max()) < n_vwin
        for k in ops._STREAM_KEYS:
            assert p[k].is_contiguous() and k in ops._DEVICE_KEYS
        if form == "holes":
            assert any(np.any(np.diff((row != 0).astype(int)) > 0)
                       for row in h["valid"]), "no hole before a live slot"


def _check_chunks(tes: np.ndarray, tcs: np.ndarray, chunk: int) -> None:
    """The chunks cover each tile's live edges once, in order, counted
    from the tile's first live edge; an empty tile has one empty chunk;
    the kernel's grid, from sizes alone, is never short of chunks."""
    assert tcs.dtype == np.int32 and tcs.shape == tes.shape and tcs[0] == 0
    covered = []
    for k in range(tes.shape[0] - 1):
        n = int(tes[k + 1] - tes[k])
        assert tcs[k + 1] - tcs[k] == max(1, -(-n // chunk))
        for j in range(tcs[k + 1] - tcs[k]):
            e0 = int(tes[k]) + j * chunk
            covered.extend(range(e0, min(e0 + chunk, int(tes[k + 1]))))
    assert covered == list(range(int(tes[-1])))
    assert tcs[-1] <= gas_kernel.max_chunks(int(tes[-1]), tes.shape[0] - 1,
                                            chunk)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kind", ["little", "big"])
def test_tile_edge_and_chunk_indices(bundle, kind, form):
    for h, p in _payloads(bundle, kind, form):
        keep = h["valid"] != 0
        tbs = h["tile_block_start"]
        tes = p["tile_edge_start"].numpy()
        assert tes.dtype == np.int32 and tes.shape == tbs.shape
        assert np.array_equal(
            tes, np.concatenate([[0], np.cumsum(keep.sum(1))])[tbs])
        if form == "holes":
            assert tes[-1] == tes[-2]          # the tile with no live edge
        _check_chunks(tes, p["tile_chunk_start"].numpy(),
                      gas_kernel.CHUNK_EDGES)
        for c in (4, 8, CHUNK):
            _check_chunks(tes, gas_kernel.tile_chunk_start(
                p["tile_edge_start"], c).numpy(), c)


def _props(mode, n, seed=5):
    rs = np.random.RandomState(seed)
    if mode == "or":
        return torch.from_numpy(rs.randint(-2 ** 31, 2 ** 31, n,
                                           dtype=np.int64).astype(np.int32))
    if mode == "sum":
        return torch.from_numpy(rs.rand(n).astype(np.float32))
    return torch.from_numpy((rs.randn(n) * 4).astype(np.float32))


def _stream_eval(p, vprops, fn, mode, chunk=CHUNK):
    """The kernel's order over ``p``'s stream in plain PyTorch: tile k's
    edges ``tile_edge_start[k]:tile_edge_start[k + 1]`` in chunks of
    ``chunk`` from its first live edge, a partial tile per chunk, the
    partials combined in chunk order."""
    t = p["geom"].T
    vwin = vprops[p["unique_src"]] if p["kind"] == "big" else vprops
    tes = p["tile_edge_start"].numpy()
    tcs = gas_kernel.tile_chunk_start(p["tile_edge_start"], chunk).numpy()
    tiles = []
    for k in range(tes.shape[0] - 1):
        acc = None
        for j in range(tcs[k + 1] - tcs[k]):
            e0 = int(tes[k]) + j * chunk
            sl = slice(e0, min(e0 + chunk, int(tes[k + 1])))
            vals = fn(vwin[p["edge_src"][sl].long()],
                      p["edge_w"][sl]).to(vwin.dtype)
            part = ref._scatter_combine(p["edge_dst"][sl].long(), vals, t,
                                        mode)
            acc = part if acc is None else _COMBINE[mode](acc, part)
        tiles.append(acc)
    return torch.stack(tiles)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kind", ["little", "big"])
def test_stream_evaluation_equals_plain_version(store, bundle, kind, form):
    for h, p in _payloads(bundle, kind, form):
        for mode, op in MODE_OPS:
            vp = _props(mode, store.V_pad)
            fn = SCATTER_OPS[op]
            got = _stream_eval(p, vp, fn, mode)
            want = _padded_plain(h, vp, fn, mode)
            assert got.dtype == want.dtype and got.shape == want.shape
            if mode == "sum":
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            else:
                assert torch.equal(got, want), (mode, op)
            # the plain path folds the same values in the same order
            plain, _ = ops.run_lane(p, vp, fn, mode, "ref", op)
            assert torch.equal(plain, want), (mode, op)


def _tiles_by_index(payloads, vprops, fn, mode):
    """{global tile index: the kernel order's tile} over ``payloads``."""
    out = {}
    for p in payloads:
        tiles = _stream_eval(p, vprops, fn, mode)
        for i, row in zip(p["tile_idx"].tolist(), tiles):
            out[i] = row
    return out


@pytest.mark.parametrize("kind", ["little", "big"])
def test_fused_per_entry_and_sharded_streams_bit_equal(store, bundle,
                                                        kind):
    """Chunks are counted from each tile's first live edge and entries
    are tile-snapped, so the kernel's order over a packed lane, its
    entries one by one and the sharded lanes gives the same tiles bit
    for bit in sum mode."""
    plan = bundle.plan
    entries = [p for lane in ops.materialize_lanes(
        plan, bundle.little_works, bundle.big_works, "cpu") for p in lane
        if p["kind"] == kind]
    fused = [p for _, p in _payloads(bundle, kind, "packed")]
    sharded = [p for _, p in _payloads(bundle, kind, "sharded")]
    assert len(entries) >= len(fused)
    vp = _props("sum", store.V_pad)
    for op in ("copy", "add_weight"):
        fn = SCATTER_OPS[op]
        want = _tiles_by_index(fused, vp, fn, "sum")
        for form in (entries, sharded):
            got = _tiles_by_index(form, vp, fn, "sum")
            assert got.keys() == want.keys()
            assert all(torch.equal(got[i], want[i]) for i in want), op


def test_dispatch_stats_count_the_streamed_edges(store, bundle):
    """``kernel_edges`` counts the live edges one iteration streams,
    beside the padded slots, fused and per entry alike; the wrapper
    counts no edge where it refuses to launch."""
    for fuse in (True, False):
        ex = api.Executor(store, bundle, api.make_pagerank(),
                          device="cpu", fuse_lanes=fuse)
        st = ex.stats()
        assert st["kernel_edges"] == st["num_real_edges"] > 0
        assert st["kernel_edges"] < st["num_padded_edges"]
        assert st["kernel_edges"] == ex.dispatch_stats()["kernel_edges"]
    p = ex._payloads[0]
    before = (gas_kernel.gas_tiles.launches, gas_kernel.gas_tiles.edges)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.run_lane(p, ex.init_props(), ex.app.scatter, "sum", "cuda",
                     "copy")
    assert (gas_kernel.gas_tiles.launches,
            gas_kernel.gas_tiles.edges) == before


@pytest.mark.parametrize("kind", ["little", "big"])
def test_stream_derived_in_slices_is_the_same(bundle, kind, monkeypatch):
    """The derivation walks ``STREAM_SLICE_BLOCKS`` blocks at a time, into
    tensors sized once: any slice size gives the same stream, on payloads
    with holes and an empty tile too."""
    for form in ("packed", "holes"):
        for h, p in _payloads(bundle, kind, form):
            whole = ops.edge_stream(h, "cpu")
            assert all(torch.equal(whole[k], p[k]) for k in whole)
            for step in (1, 3, 7):
                monkeypatch.setattr(ops, "STREAM_SLICE_BLOCKS", step)
                sliced = ops.edge_stream(h, "cpu")
                assert all(torch.equal(sliced[k], whole[k]) for k in whole)
            monkeypatch.undo()

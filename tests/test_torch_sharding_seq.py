"""The sequence split over "model" (``specs.ModelSplit.sequence``): the
port's train and prefill steps with each "model" rank on its share of
the positions (a zigzag of two chunks for qwen2, granite and whisper's
decoder, one contiguous span for mamba2, hymba and whisper's encoder),
against the unsharded port step and the JAX package's single-device
functions on the same weights.

* Distributed: one spawn of 4 CPU ranks over gloo on a ("data",
  "model") = (2, 2) mesh, run in a subprocess, for reduced qwen2,
  granite, mamba2, hymba and whisper in f32 (qwen2 and granite with 3
  query heads over 1 KV head, which do not divide over 2 model ranks, as
  qwen2's 12 heads do not divide over 16; whisper with 23 encoder
  frames, which are padded to 24 to divide). 2 rows of 32 positions, one
  row a data shard, which does not divide over "model": every family
  takes "sequence", 16 positions a rank (shorter than an SSD chunk, so
  the spans' chunks end where the whole scan's do not: the harder case
  for the scan's rounding; under zigzag chunks 0 + 3 and 1 + 2 of 8,
  the step's last position on rank 0). The attention runs in blocks of
  4 positions in the spawn (``common.blockwise_attention`` wrapped), so
  that ranks skip whole key blocks. Per family the prefill's
  logits and cache (``shards.sharded_prefill``) and the gradients of
  the loss (``sharded_grads``), on each rank, against the unsharded
  port step and the JAX package at rtol 1e-4 / atol 1e-5 (prefill) and
  ``tests/test_torch_sharding_lm.py``'s gradient bounds. granite runs on
  one row, shared by both data ranks: the reference's MoE computes its
  aux loss per data shard, which one device on two rows does not.
  qwen2's gradients once more with the backward on another thread, as
  autograd runs it on the card. granite's MoE layer on 2 rows at a
  capacity that drops, against the dispatch of the whole data shard.
  hymba's AdamW step with 2 microbatches on 4 rows (2 a data shard,
  which do not divide over 2 x 2) against the JAX package's step.
  The hand-off to the split decode: per family the prefill with
  ``cache_len=40`` (``shards.sharded_prefill``), each rank's slice
  against the JAX package's prefill cache zero-padded to 40 positions
  and cut by ``specs.decode_cache_spec``, then 3 split decode steps
  ("columns") from that slice against the JAX package's
  ``decode_step`` on the padded cache.
* One process: the SSD scanned span by span, each span from a zero
  state with the earlier spans' states folded in (``mamba2.carry_in``),
  equals ``ssd_chunked`` over the whole sequence in f32; blockwise
  attention of a span of queries at its offset over every key equals the
  matching rows of the whole attention bit for bit in f32, its output
  and its dq, and the spans' dk and dv sum to the whole's.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models.api import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import configs as tcfg
from repro_torch.models import common, mamba2, shards
from repro_torch.sharding import specs
from repro_torch.tree import flatten_with_path

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
ARCHS = ["qwen2_1p5b", "granite_moe_3b_a800m", "mamba2_2p7b", "hymba_1p5b",
         "whisper_tiny"]
B, S, FRAMES = 2, 32, 23
CACHE_LEN, STEPS = 40, 3        # the hand-off's decode cache, decode steps
LR = 1e-2                      # the AdamW step's, as the reference test's
ADAM_EPS = 1e-8                # its eps
TRAIN_ROWS, MICRO = 4, 2


def config(configs, arch):
    """The reduced f32 config of ``arch`` in ``configs`` (either
    package's module): 3 query heads over 1 KV head for the dense and
    MoE families, 23 encoder frames for whisper."""
    cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                              dtype="float32")
    if cfg.family in ("dense", "moe"):
        cfg = dataclasses.replace(cfg, num_heads=3, num_kv_heads=1)
    if cfg.frontend == "audio":
        cfg = dataclasses.replace(cfg, encoder_seq=FRAMES)
    return cfg


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def reference():
    """Per family: the JAX package's weights, batch, prefill (cache,
    logits) and ``value_and_grad`` of the loss; hymba's AdamW step with
    2 microbatches (loss, params) on 4 rows."""
    out = {}
    for arch in ARCHS:
        cfg = config(jcfg, arch)
        model = jbuild(cfg)
        params = model.init(jax.random.key(0))
        rs = np.random.RandomState(3)
        rows = 1 if cfg.family == "moe" else B
        tok = rs.randint(0, cfg.vocab_size, (rows, S)).astype(np.int32)
        batch = {"tokens": tok}
        if cfg.frontend == "audio":
            batch["enc_embeds"] = rs.randn(rows, FRAMES,
                                           cfg.d_model).astype(np.float32)
        jb = jax.tree.map(jnp.asarray, batch)
        cache, logits = jax.jit(model.prefill)(params, jb)
        loss, grads = jax.jit(jax.value_and_grad(model.loss))(
            params, dict(jb, labels=jb["tokens"]))
        out[arch] = {"params": _np(params), "batch": batch,
                     "cache": _np(cache), "logits": np.asarray(logits),
                     "loss": float(loss), "grads": _np(grads)}
        out[arch].update(_decode_reference(model, params, cache, rows, rs))
    cfg = config(jcfg, "hymba_1p5b")
    model = jbuild(cfg)
    params = model.init(jax.random.key(0))
    tok = np.random.RandomState(4).randint(
        0, cfg.vocab_size, (TRAIN_ROWS, S)).astype(np.int32)
    opt = jadamw.adamw(lr=LR, weight_decay=0.0)
    tb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok)}
    p1, _, m1 = jax.jit(jmake_train_step(model, opt, micro_batches=MICRO))(
        params, opt.init(params), tb)
    out["train"] = {"tokens": tok, "loss": float(m1["loss"]),
                    "params": _np(p1),
                    "grads": _np(jax.jit(jax.grad(model.loss))(params, tb))}
    return out


def _decode_reference(model, params, cache, rows, rs):
    """The JAX package's prefill ``cache`` with its self-attention k / v
    zero-padded to CACHE_LEN positions (the recurrent states, hymba's
    window and whisper's cross cache as they are), and STEPS decode
    steps on it from position S: {"padded": that cache, "decode_tokens",
    "decode_logits"}."""
    if model.cfg.family != "hybrid":
        cache = {k: (jnp.pad(v, [(0, 0), (0, 0), (0, CACHE_LEN - S)]
                             + [(0, 0)] * (v.ndim - 3))
                     if k in ("k", "v") else v) for k, v in cache.items()}
    padded = _np(cache)
    tok = rs.randint(0, model.cfg.vocab_size, (rows, STEPS)).astype(np.int32)
    step = jax.jit(model.decode_step)
    logits = []
    for t in range(STEPS):
        lg, cache = step(params, cache, jnp.asarray(tok[:, t:t + 1]),
                         jnp.int32(S + t))
        logits.append(np.asarray(lg))
    return {"padded": padded, "decode_tokens": tok, "decode_logits": logits}


WORKER = r'''
import dataclasses, pickle, sys, threading
import numpy as np
import torch
import torch.distributed as dist


def run(rank, world, d):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/pg",
                            rank=rank, world_size=world)
    from repro_torch import convert
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import shards
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import adamw
    from repro_torch.sharding import specs
    from repro_torch.train.step import (make_train_step, sharded_grads,
                                        value_and_grad)
    from repro_torch.tree import flatten, tree_map, unflatten
    import functools
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import common
    inp = pickle.load(open(f"{d}/in.pkl", "rb"))
    mesh = make_host_mesh(model=2)                    # (2, 2)
    # blocks of 4 positions, so that a rank's spans of 8 positions skip
    # whole key blocks (the package's 512 would be one block of 32)
    common.blockwise_attention = functools.partial(
        common.blockwise_attention, q_block=4, kv_block=4)
    visible = common._visible_q_blocks
    pairs = []

    def counted(causal, window, q_offset, q_block, kv_block, sq, skv):
        """The (q block, KV block) pairs visited and there are."""
        got = visible(causal, window, q_offset, q_block, kv_block, sq, skv)
        pairs.append((sum(z - a for a, z in got),
                      -(-sq // q_block) * len(got)))
        return got
    out = {"coords": (mesh.get_local_rank("data"),
                      mesh.get_local_rank("model"))}

    def off_thread(loss_fn, params, batch, view):
        """``value_and_grad`` with the backward on another thread."""
        flat, treedef = flatten(params)
        live = [p.detach().requires_grad_() for p in flat]
        with torch.enable_grad():
            loss = loss_fn(view(unflatten(treedef, live)), batch)
        got = []
        t = threading.Thread(target=lambda: got.extend(torch.autograd.grad(
            loss, live, allow_unused=True)))
        t.start()
        t.join()
        return loss.detach(), unflatten(treedef, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(live, got)])

    def placed(tree, layouts):
        return specs.distribute_tree(tree, layouts(tree, mesh))

    def whole(tree):
        return tree_map(lambda t: t.full_tensor().numpy(), tree)

    LR, MICRO = inp["lr"], inp["micro"]
    for arch, cfg in inp["configs"].items():
        ref = inp[arch]
        model = build_model(cfg)
        params = convert.lm_params_from_numpy(ref["params"], "cpu")
        batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
        tb = dict(batch, labels=batch["tokens"])
        res = {}
        if rank == 0:                                  # the unsharded port
            with torch.no_grad():
                cache, logits = model.prefill(params, batch)
            loss, grads = value_and_grad(model.loss, params, tb)
            res["unsharded"] = {
                "cache": {k: v.numpy() for k, v in cache.items()},
                "logits": logits.numpy(), "loss": float(loss),
                "grads": tree_map(lambda t: t.numpy(), grads)}
        pd = placed(params, specs.tree_placements)
        bd = placed(batch, specs.batch_placements)
        pairs.clear()
        common._visible_q_blocks = counted
        try:
            with FlopCounterMode(display=False) as fc:
                cache, logits, split = shards.sharded_prefill(
                    model.prefill, pd, bd, cfg)
        finally:
            common._visible_q_blocks = visible
        res.update(split=split.name, layout=split.layout,
                   flops=fc.get_total_flops(),
                   pairs=[sum(p[0] for p in pairs), sum(p[1] for p in pairs)],
                   logits=logits.numpy(),
                   cache={k: v.numpy() for k, v in cache.items()})
        # the hand-off: this rank's slice of the decode cache of
        # CACHE_LEN positions, then STEPS split decode steps from it
        dims = shards.batch_dims(bd, mesh)
        cache, _, split = shards.sharded_prefill(model.prefill, pd, bd, cfg,
                                                 cache_len=inp["cache_len"])
        first = {k: v.clone().numpy() for k, v in cache.items()}
        dsplit = specs.model_split_decode(mesh)
        view = shards.model_view(*shards.local_shards(pd), mesh, dims,
                                 dsplit)
        tok = torch.from_numpy(ref["decode_tokens"])
        if "data" in dims:
            row = mesh.get_local_rank("data")
            tok = tok[row:row + 1]
        steps = []
        with torch.no_grad(), common.use_mesh(mesh, dims, dsplit):
            for t in range(tok.shape[1]):
                lg, cache = model.decode_step(view, cache, tok[:, t:t + 1],
                                              batch["tokens"].shape[1] + t)
                steps.append(lg.numpy())
        res["handoff"] = {"split": split.name, "cache": first,
                          "decode_split": dsplit.name, "logits": steps}
        grad_fns = {"grads": value_and_grad}
        if arch == "qwen2_1p5b":
            grad_fns["grads_thread"] = off_thread
        for name, fn in grad_fns.items():
            loss, g, split = sharded_grads(
                lambda p, b, view: fn(model.loss, p, b, view), pd,
                placed(tb, specs.batch_placements), cfg)
            res[name] = {"loss": float(loss), "split": split.name,
                         "grads": whole(g)}
        out[arch] = res

    # the MoE layer under the sequence split on 2 rows: the group's
    # positions gathered in the reference's token order, so that at a
    # capacity that drops (2 slots an expert) the drops are the whole
    # data shard's (at 8 slots this input drops nothing that the order
    # decides)
    from repro_torch.models import common, moe
    mcfg = inp["configs"]["granite_moe_3b_a800m"]
    lp = {k: v.float() for k, v in moe.init_layer_params(
        mcfg, torch.Generator().manual_seed(1)).items()
        if k in ("router", "we_gate", "we_up", "we_down")}
    x = torch.randn((2, 16, mcfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    mine = slice(8 * mesh.get_local_rank("model"),
                 8 * mesh.get_local_rank("model") + 8)
    # and under the zigzag layout: the rank's chunks r and 3 - r of 4
    zig = shards.position_spans(16, 2, mesh.get_local_rank("model"), True)
    with torch.no_grad():
        with common.use_mesh(mesh, ("data", "model"),
                             specs.ModelSplit(2, sequence=True)):
            got = moe.moe_ffn(mcfg, lp, x[:, mine], capacity_factor=0.5)[0]
        with common.use_mesh(mesh, ("data", "model"),
                             specs.ModelSplit(2, sequence=True, zigzag=True)):
            got_zig = moe.moe_ffn(mcfg, lp, shards.take_spans(x, zig),
                                  capacity_factor=0.5)[0]
        with common.use_mesh(mesh, ("data",)):
            shard = moe.moe_ffn(mcfg, lp, x, capacity_factor=0.5)[0]
        undropped = moe.moe_ffn(mcfg, lp, x, capacity_factor=50.0)[0]
    out["moe_order"] = {"equal": bool(torch.equal(got, shard[:, mine])),
                        "dropped": not torch.allclose(shard, undropped)}
    out["moe_order_zigzag"] = bool(torch.equal(
        got_zig, shards.take_spans(shard, zig)))

    # hymba's AdamW step, 2 microbatches of this rank's rows
    cfg = inp["configs"]["hymba_1p5b"]
    model = build_model(cfg)
    opt = adamw(lr=LR, weight_decay=0.0)
    params = convert.lm_params_from_numpy(inp["hymba_1p5b"]["params"], "cpu")
    tok = torch.from_numpy(inp["train_tokens"])
    pd = placed(params, specs.tree_placements)
    step = make_train_step(model, opt, micro_batches=MICRO)
    p1, _, m1 = step(pd, placed(opt.init(pd), specs.tree_placements),
                     placed({"tokens": tok, "labels": tok},
                            specs.batch_placements))
    out["train"] = {"loss": float(m1["loss"]), "split": m1["model_split"],
                    "params": whole(p1)}
    every = [None] * world
    dist.all_gather_object(every, out)
    if rank == 0:
        pickle.dump(every, open(f"{d}/out.pkl", "wb"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    torch.multiprocessing.spawn(run, args=(4, sys.argv[1]), nprocs=4)
'''

@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference):
    """Every rank's results of the 4-rank spawn."""
    d = tmp_path_factory.mktemp("seq")
    with open(d / "in.pkl", "wb") as f:
        pickle.dump({**{a: {k: reference[a][k] for k in ("params", "batch",
                                                          "decode_tokens")}
                        for a in ARCHS},
                     "configs": {a: config(tcfg, a) for a in ARCHS},
                     "cache_len": CACHE_LEN,
                     "train_tokens": reference["train"]["tokens"],
                     "lr": LR, "micro": MICRO}, f)
    (d / "worker.py").write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, str(d / "worker.py"), str(d)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    with open(d / "out.pkl", "rb") as f:
        return pickle.load(f)


def _rows(a, rank, rows):
    """The data shard of ``rank`` of the reference's ``a`` (rows on dim
    0): its row, or the one row both data ranks share."""
    return a if rows == 1 else a[rank["coords"][0]:rank["coords"][0] + 1]


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_prefill_matches_unsharded_and_reference(ranks, reference,
                                                          arch):
    """Every rank takes "sequence" and returns its data shard's last
    logits and whole cache (every position of the self-attention k / v,
    hymba's window, the final SSM and conv states from the rank that
    holds the last position, whisper's cross cache of all 23 frames),
    within rtol 1e-4 / atol 1e-5 of the unsharded port's prefill and of
    the JAX package's."""
    ref = reference[arch]
    rows = ref["batch"]["tokens"].shape[0]
    unsharded = ranks[0][arch]["unsharded"]
    for r in ranks:
        got = r[arch]
        assert got["split"] == "sequence"
        for want in (unsharded, ref):
            np.testing.assert_allclose(
                got["logits"], _rows(want["logits"], r, rows), rtol=1e-4,
                atol=1e-5, err_msg=f"logits {r['coords']}")
            assert sorted(got["cache"]) == sorted(want["cache"])
            for name, w in want["cache"].items():
                w = np.moveaxis(_rows(np.moveaxis(w, 1, 0), r, rows), 0, 1)
                assert got["cache"][name].shape == w.shape, name
                np.testing.assert_allclose(got["cache"][name], w, rtol=1e-4,
                                           atol=1e-5,
                                           err_msg=f"{name} {r['coords']}")


def _block(a, spec, coords, sizes):
    """The block of ``a`` that the mesh rank at ``coords`` ({dim name:
    index}) holds under ``spec``."""
    idx = []
    for d, ax in enumerate(spec):
        if ax is None:
            idx.append(slice(None))
            continue
        per = a.shape[d] // sizes[ax]
        idx.append(slice(coords[ax] * per, (coords[ax] + 1) * per))
    return a[tuple(idx)]


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_prefill_hands_off_to_split_decode(ranks, reference, arch):
    """``sharded_prefill(..., cache_len=40)`` under the sequence split:
    every rank's cache is its slice of the JAX package's prefill cache
    with the self-attention k / v zero-padded to 40 positions, as
    ``specs.decode_cache_spec`` places it on ("data", "model") = (2, 2)
    (its 20 positions of every row, 12 of them past the prompt on rank
    1, whatever the prefill's zigzag; the states and the cross cache by
    their "model" dim), at rtol 1e-4 / atol 1e-5; then 3 split decode
    steps from it, with nothing in between, give the JAX package's
    ``decode_step`` logits on the padded cache (the rank's data rows and
    vocabulary slice) at rtol 1e-4 / atol 1e-5."""
    ref = reference[arch]
    mesh = specs.MeshShape(("data", "model"), (2, 2))
    family = config(tcfg, arch).family
    sizes = {"data": 2, "model": 2}
    for r in ranks:
        coords = dict(zip(("data", "model"), r["coords"]))
        got = r[arch]["handoff"]
        assert got["split"] == "sequence"
        assert got["decode_split"] == "columns"
        assert sorted(got["cache"]) == sorted(ref["padded"])
        for name, want in ref["padded"].items():
            spec = specs.decode_cache_spec(name, want.shape, mesh, family)
            assert "model" in spec, name
            block = _block(want, spec, coords, sizes)
            assert got["cache"][name].shape == block.shape, name
            np.testing.assert_allclose(got["cache"][name], block, rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name} {coords}")
        assert len(got["logits"]) == STEPS
        rows = ref["decode_tokens"].shape[0]
        for t, (g, w) in enumerate(zip(got["logits"], ref["decode_logits"])):
            w = _block(w, ("data" if rows > 1 else None, None, "model"),
                       coords, sizes)
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {t} at {coords}")


DENSE_BOUND = ("qwen2_1p5b", "whisper_tiny")


def _assert_grads(got, want, arch):
    """Each leaf at rtol 1e-4 and, for the dense families, an atol of
    2e-6 of the leaf's largest reference gradient
    (``tests/test_torch_sharding_lm.py``'s ``_assert_grads``); for the
    MoE and the recurrent families an atol of 1e-5 of that largest
    gradient or of 1 (that file's ``test_sharded_moe_gradients_match_
    local``; ``tests/test_torch_train.py`` holds every family's
    unsharded gradients to ``jax.grad`` at atol 1e-5). Their gradients
    of ``A_log`` and the router sum terms that nearly cancel: the
    unsharded port's own already differ from ``jax.grad``'s by 1.9x
    (mamba2's ``A_log``), 3.4x (hymba's) and 1.4x (granite's router) the
    dense bound."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = flatten_with_path(got)[0]
    assert len(flat_g) == len(flat_w)
    for (gp, g), (wp, w) in zip(flat_g, flat_w):
        assert tuple(k.key for k in wp) == gp
        top = float(np.abs(w).max())
        np.testing.assert_allclose(
            g, w, rtol=1e-4, atol=2e-6 * top if arch in DENSE_BOUND
            else 1e-5 * max(1.0, top), err_msg=str(gp))


@pytest.mark.parametrize("case", [(a, "grads") for a in ARCHS]
                         + [("qwen2_1p5b", "grads_thread")], ids="-".join)
def test_sequence_grads_match_unsharded_and_reference(ranks, reference,
                                                      case):
    """The loss and its gradients under the sequence split, summed over
    the data ranks and "model" and cut back to each weight's shard,
    against the unsharded port's and ``jax.grad`` of the JAX package's
    (loss within 1e-5): the attention's keys and values gathered over
    "model" with their gradients reduce-scattered back, the conv's rows
    and the SSD's states exchanged with theirs, the MoE's dispatch over
    the group's tokens in the reference's order. ``grads_thread`` runs
    the backward on another thread than the forward: each layer's
    recompute must see the forward's split (hazard F7)."""
    arch, name = case
    ref, unsharded = reference[arch], ranks[0][arch]["unsharded"]
    for r in ranks:
        got = r[arch][name]
        assert got["split"] == "sequence"
        for want in (unsharded, ref):
            assert abs(got["loss"] - want["loss"]) < 1e-5
            _assert_grads(got["grads"], want["grads"], arch)


def test_sequence_train_step_with_microbatches(ranks, reference):
    """hymba's AdamW step on 4 rows, 2 microbatches: 2 rows a data shard
    do not divide over 2 model ranks x 2 microbatches, so each microbatch
    (a row of each data shard) splits its positions; loss within 1e-3
    and params at rtol 1e-3 / atol 1e-4 of the JAX package's step (as
    ``test_sharded_train_step_matches_reference`` holds the batch
    split's), but where the reference gradient is nonzero and below 10x
    Adam's eps, held to lr."""
    want = reference["train"]
    flat_w = jax.tree_util.tree_flatten_with_path(want["params"])[0]
    flat_d = jax.tree_util.tree_leaves(want["grads"])
    for r in ranks:
        got = r["train"]
        assert got["split"] == "sequence"
        assert abs(got["loss"] - want["loss"]) < 1e-3
        flat_g = flatten_with_path(got["params"])[0]
        assert len(flat_g) == len(flat_w) == len(flat_d)
        n_small = n_all = 0
        for (gp, g), (wp, w), dg in zip(flat_g, flat_w, flat_d):
            assert tuple(k.key for k in wp) == gp
            small = (np.abs(dg) < 10 * ADAM_EPS) & (dg != 0)
            n_small, n_all = n_small + int(small.sum()), n_all + small.size
            assert np.all(np.abs(g - w)[small] <= LR), gp
            np.testing.assert_allclose(g[~small], w[~small], rtol=1e-3,
                                       atol=1e-4, err_msg=str(gp))
        assert n_small <= 1e-3 * n_all


ZIGZAG = ("qwen2_1p5b", "granite_moe_3b_a800m", "whisper_tiny")


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_layout_and_balanced_ranks(ranks, arch):
    """32 positions over 2 model ranks divide into 4 chunks: qwen2,
    granite and whisper's decoder take the zigzag layout (chunks r and
    3 - r), mamba2 and hymba stay contiguous. Every rank's prefill (but
    mamba2's, which attends nowhere) skips key blocks (blocks of 4
    positions: fewer (q block, KV block) pairs visited than there are);
    under zigzag every rank visits as many pairs and counts as many
    FLOPs (``FlopCounterMode``), 18 causal pairs of 32 a layer's
    self-attention: chunks 0 + 3 against 1 + 2."""
    layouts = {r[arch]["layout"] for r in ranks}
    assert layouts == {"zigzag" if arch in ZIGZAG else "contiguous"}
    for r in ranks:
        visited, there = r[arch]["pairs"]
        if arch == "mamba2_2p7b":                 # no attention
            assert visited == there == 0
        else:
            assert 0 < visited < there, r[arch]["pairs"]
    if arch in ZIGZAG:
        assert len({r[arch]["flops"] for r in ranks}) == 1
        assert len({tuple(r[arch]["pairs"]) for r in ranks}) == 1


def test_sequence_moe_dispatch_keeps_token_order_zigzag(ranks):
    """As below, each "model" rank holding its zigzag chunks (r and 3 -
    r of 4 of 4 positions) of both rows: the group's positions are put
    back in global order before the dispatch, and each rank's rows of
    the sum are its own, bit-equal to the whole data shard's dispatch."""
    for r in ranks:
        assert r["moe_order_zigzag"]


def test_sequence_moe_dispatch_keeps_token_order(ranks):
    """granite's MoE layer on 2 rows of 16 positions, each "model" rank
    its 8 positions of both rows, at a capacity that drops assignments:
    bit-equal to the expert-sharded dispatch of the whole data shard
    (the same drops), since the group's positions are gathered back into
    the rows' order before the tokens are flattened."""
    for r in ranks:
        assert r["moe_order"]["dropped"] and r["moe_order"]["equal"]


# ---------------------------------------------------------------------------
# one process: the scan span by span, the attention at a query offset
# ---------------------------------------------------------------------------

class _Rank:
    """A mesh stand-in that knows only its "model" rank."""

    def __init__(self, rank):
        self.rank = rank

    def get_local_rank(self, dim):
        assert dim == "model"
        return self.rank


def test_split_positions_shares_and_refuses_what_does_not_divide():
    """Each of 4 "model" ranks takes its contiguous quarter of 32
    positions of every positional input (other inputs whole, "model"
    added to the data dims); 23 frames are shared as 6 a rank, padded to
    24 (whisper's encoder share); 30 positions, which do not divide by
    4, raise instead of dropping the last 2."""
    split = specs.ModelSplit(4, sequence=True)
    tok = torch.arange(64).reshape(2, 32)
    frames = torch.zeros((2, 23, 8))
    got = [shards.split_positions({"tokens": tok, "labels": tok + 1,
                                   "enc_embeds": frames}, _Rank(r),
                                  ("data",), split) for r in range(4)]
    for r, (b, dims) in enumerate(got):
        assert dims == ("data", "model")
        assert torch.equal(b["tokens"], tok[:, 8 * r:8 * (r + 1)])
        assert torch.equal(b["labels"], tok[:, 8 * r:8 * (r + 1)] + 1)
        assert b["enc_embeds"] is frames
    assert torch.equal(torch.cat([b["tokens"] for b, _ in got], 1), tok)
    assert [shards.position_spans(23, 4, r) for r in range(4)] == [
        [(0, 6)], [(6, 6)], [(12, 6)], [(18, 6)]]
    with pytest.raises(ValueError, match="do not divide"):
        shards.split_positions({"tokens": tok[:, :30]}, _Rank(0), (), split)


def test_span_ssd_matches_whole_scan():
    """A 96-position sequence scanned as 3 spans of 32, each from a zero
    state, the earlier spans' final states and total decays folded into
    each (``mamba2.carry_in``, what each "model" rank does with the
    states it gathers), equals ``ssd_chunked`` over the whole sequence in
    f32 to 1e-5, the outputs and the final state; chunks of 16, so that
    the spans' chunk boundaries are the whole scan's."""
    g = torch.Generator().manual_seed(5)
    b, s, h, p, n, spans = 2, 96, 3, 4, 8, 3
    x = torch.randn((b, s, h, p), generator=g)
    Bm, Cm = (torch.randn((b, s, n), generator=g) for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g))
    A = -torch.linspace(0.5, 2.0, h)
    D = torch.randn((h,), generator=g)
    cfg = None
    old = mamba2.CHUNK
    mamba2.CHUNK = 16
    try:
        y_all, h_all = mamba2.ssd_chunked(cfg, x, Bm, Cm, dt, A, D)
        per = s // spans
        parts = [mamba2.ssd_chunked(cfg, *(t[:, i * per:(i + 1) * per]
                                           for t in (x, Bm, Cm, dt)), A, D)
                 for i in range(spans)]
    finally:
        mamba2.CHUNK = old
    a_cum = [torch.cumsum(dt[:, i * per:(i + 1) * per] * A, dim=1)
             for i in range(spans)]
    states = torch.stack([hh for _, hh in parts])
    decays = torch.stack([torch.exp(a[:, -1]) for a in a_cum])
    ys = []
    for i, (y, hh) in enumerate(parts):
        y, hh = mamba2.carry_in(y, hh, Cm[:, i * per:(i + 1) * per],
                                a_cum[i], states, decays, i)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, 1), y_all, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(hh, h_all, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None)])
def test_offset_attention_is_the_whole_attentions_rows(causal, window):
    """Queries 32-63 and 64-95 of a 96-position sequence (blocks of 32)
    at their offset over all 96 keys and values give the whole
    attention's rows bit for bit in f32, and so does their dq for a
    gradient on those rows; their dk and dv (GQA: 4 query heads over 2
    KV heads) sum, with the first span's, to the whole's within f32
    reassociation (each span sums its own queries' share)."""
    g = torch.Generator().manual_seed(6)
    q = torch.randn((2, 96, 4, 16), generator=g)
    k, v = (torch.randn((2, 96, 2, 16), generator=g) for _ in range(2))
    dout = torch.randn((2, 96, 4, 16), generator=g)
    kw = dict(causal=causal, window=window, q_block=32, kv_block=32)

    def run(lo, hi):
        qs, ks, vs = (t.clone().requires_grad_() for t in (q[:, lo:hi], k, v))
        out = common.blockwise_attention(qs, ks, vs, q_offset=lo, **kw)
        out.backward(dout[:, lo:hi])
        return out.detach(), qs.grad, ks.grad, vs.grad

    whole = run(0, 96)
    spans = [run(lo, lo + 32) for lo in (0, 32, 64)]
    for i, (out, dq, _, _) in enumerate(spans):
        rows = slice(32 * i, 32 * (i + 1))
        assert torch.equal(out, whole[0][:, rows]), i
        assert torch.equal(dq, whole[1][:, rows]), i
    for j in (2, 3):
        torch.testing.assert_close(sum(sp[j] for sp in spans), whole[j],
                                   rtol=1e-6, atol=1e-6)

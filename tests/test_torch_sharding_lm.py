"""The LM substrate's sharding in the port against the JAX package:
``sharding.specs`` rules, ``launch.roofline``'s arithmetic, the twins
of ``tests/test_distributed.py``'s LM cases (sharded train step, sharded
MoE, elastic restore) and one dry-run cell.

* Specs: every leaf of all ten archs' params and AdamW / Adafactor
  state (the port's meta ``param_specs``), every batch input and decode
  cache, at meshes (16, 16), (2, 16, 16), (4, 2) and (1, 16), equal to
  the reference's ``PartitionSpec`` entry for entry. The reference's
  rules read only ``mesh.axis_names`` and ``mesh.devices.shape``, so a
  duck-typed mesh serves there, with no forced devices.
* Roofline: ``analytic_costs``, ``model_flops``, ``param_count`` and
  ``roofline_terms`` (the same cost, collective dict and hardware table
  given to both) equal the reference's for every arch and shape.
* Distributed: one spawn of 4 CPU ranks over gloo on a ("data",
  "model") = (2, 2) mesh (the reference's tests use (4, 2) and (2, 4) on
  8 forced host devices; 4 ranks keep the host's load light), run in a
  subprocess so no process group is left in the test process. The
  sharded train step on qwen2 reduced, f32, from the reference's init
  against the JAX single-device step (loss within 1e-3, params at rtol
  1e-3 / atol 1e-4), and its gradients against ``jax.grad`` (also with
  labels masked on one data shard, and with leaves sharded on "data");
  the sharded granite MoE (the expert-sharded branch, E_pad 16 / 2) on
  each rank's data shard against the single-device one at rtol 1e-4 /
  atol 1e-5, its gradients too; a checkpoint saved from a ("data",) =
  (4,) mesh restored bit-equal onto ("a", "b") = (2, 2) with spec
  ("b", "a").
* The split decode (``ModelSplit.columns``), in the same spawn: for
  each family (reduced qwen2, granite, mamba2, hymba and whisper, f32),
  4 decode steps of the port on each rank's slice of a cache made by the
  JAX package's prefill, placed by ``specs.decode_cache_spec``, against
  the JAX package's single-device ``decode_step`` (logits and each
  rank's slice of the updated cache at rtol 1e-4 / atol 1e-5); the
  column product bit-equal to the unsharded one.
* The hand-off, in the same spawn: the port's prefill through
  ``shards.sharded_prefill(..., cache_len=16)`` under the batch split
  (each family, 4 rows), Megatron's heads with the KV heads split
  (qwen2, 2 rows) and with each rank's one KV head picked (qwen2 with 1
  KV head, 2 rows): each rank's slice against the JAX package's grown
  prefill cache cut by ``decode_cache_spec``, then the split decode
  steps from it against the JAX package's; under the batch split
  qwen2's slice bit-equal to the port's own unsharded prefill of the
  same rows, grown and placed by ``specs.distribute_tree``.
* Dry run: one cell of reduced qwen2 (train, 8 x 64) on a fake group of
  8 ranks, mesh (2, 4), in a subprocess: ok, and its argument bytes are
  those of the reference's shard shapes; the traced peak of a train
  step at 2 and 6 layers, which grows per layer by less than a whole
  layer (the weights are gathered layer by layer); a decode cell of
  reduced qwen2 on (1, 4) under the columns split against the same cell
  traced with no split; a prefill cell of reduced hymba on (1, 4)
  under the sequence split against the same cell with no split; and
  the traced peak of a 16-layer reduced qwen2's sequence-split prefill
  with the hand-off and without it.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.launch import roofline as jrl
from repro.models.api import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.sharding import specs as jspecs
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import configs as tcfg
from repro_torch.launch import roofline as trl
from repro_torch.models.api import build_model as tbuild
from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.adamw import adamw
from repro_torch.sharding import specs
from repro_torch.tree import flatten_with_path, leaves

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "4x2": (("data", "model"), (4, 2)),
          "1x16": (("data", "model"), (1, 16))}
LR = 1e-2                      # the reference test's AdamW step


def _duck(names, shape):
    """What the reference's rules read of a mesh."""
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, np.int8))


def _jpath(path):
    return tuple(jax.tree_util.DictKey(k) if isinstance(k, str)
                 else jax.tree_util.SequenceKey(k) for k in path)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", tcfg.ARCH_IDS)
def test_specs_match_reference(arch, mesh, monkeypatch):
    names, shape = MESHES[mesh]
    duck, port = _duck(names, shape), specs.MeshShape(names, shape)
    cfg = tcfg.get_config(arch)
    params = tbuild(cfg).param_specs()
    trees = {"params": params,
             "adamw": adamw(state_dtype="bfloat16").state_specs(params),
             "adafactor": adafactor().state_specs(params)}
    n = 0
    for name, tree in trees.items():
        for path, leaf in flatten_with_path(tree)[0]:
            want = tuple(jspecs.leaf_spec(_jpath(path), tuple(leaf.shape),
                                          duck))
            got = specs.leaf_spec(path, tuple(leaf.shape), port)
            assert got == want, (name, path, tuple(leaf.shape))
            n += 1
    assert n > 20
    # batch inputs and decode caches, at every shape the arch supports
    monkeypatch.setattr(jspecs, "NamedSharding", lambda m, spec: spec)
    jc = jcfg.get_config(arch)
    for sname, sh in tcfg.SHAPES.items():
        ins = tcfg.input_specs(cfg, sh)
        inputs = flatten_with_path(ins.get("batch", {}))[0]
        if "token" in ins:
            inputs.append((("token",), ins["token"]))
        for path, leaf in inputs:
            assert specs.batch_spec(tuple(leaf.shape), port) == tuple(
                jspecs.batch_spec(tuple(leaf.shape), duck)), (sname, path)
        if sh.kind == "decode":
            want = jspecs.cache_shardings(
                jcfg.cache_specs(jc, sh.batch, sh.seq), duck)
            got = {k: specs.cache_spec(tuple(v.shape), port) for k, v in
                   tcfg.cache_specs(cfg, sh.batch, sh.seq).items()}
            assert got == {k: tuple(v) for k, v in want.items()}, sname


@pytest.mark.parametrize("shape", list(tcfg.SHAPES))
@pytest.mark.parametrize("arch", tcfg.ARCH_IDS)
def test_roofline_arithmetic_matches_reference(arch, shape):
    cfg, jc = tcfg.get_config(arch), jcfg.get_config(arch)
    sh, jsh = tcfg.SHAPES[shape], jcfg.SHAPES[shape]
    assert trl.analytic_costs(cfg, sh) == jrl.analytic_costs(jc, jsh)
    assert trl.model_flops(cfg, sh) == jrl.model_flops(jc, jsh)
    for active in (False, True):
        assert trl.param_count(cfg, active) == jrl.param_count(jc, active)
    assert trl.cpu_upcast_estimate(cfg, 256) == jrl.cpu_upcast_estimate(
        jc, 256)
    coll = {"all-gather": 3e9, "all-reduce": 1e6, "total": 3.001e9}
    cost = {"flops": 1e15, "bytes accessed": 2e11}
    for chips in (256, 512):
        assert trl.roofline_terms(cost, coll, chips, cfg, sh, hw=trl.HW) \
            == jrl.roofline_terms(cost, coll, chips, jc, jsh, hw=trl.HW)
    assert trl.roofline_terms(cost, coll, 256) == jrl.roofline_terms(
        cost, coll, 256, hw=trl.HW)


SPLIT_CELLS = {                       # (arch, shape): split, split leaves
    ("qwen2_1p5b", "train_4k"): ("batch", {"lm_head": (None, None),
                                           "wq": (None, None)}),
    ("command_r_35b", "prefill_32k"): ("heads+ffn", {
        "wq": (None, "model"), "wk": (None, None), "wo": ("model", None),
        "w_gate": (None, "model"), "w_up": (None, "model"),
        "w_down": ("model", None), "lm_head": (None, "model"),
        "ln1_g": (None,)}),
    ("qwen2_1p5b", "prefill_32k"): ("sequence", {
        "wq": (None, None), "bq": (None,), "wk": (None, None),
        "wo": (None, None), "w_gate": (None, None),
        "w_down": (None, None), "lm_head": (None, None)}),
    ("granite_moe_3b_a800m", "prefill_32k"): ("sequence", {
        "wq": (None, None), "router": (None, None),
        "we_gate": ("model", None, None), "we_down": ("model", None, None),
        "lm_head": (None, None)}),
    ("mamba2_2p7b", "prefill_32k"): ("sequence", {
        "in_proj": (None, None), "conv_w": (None, None),
        "out_proj": (None, None), "lm_head": (None, None)}),
    ("hymba_1p5b", "prefill_32k"): ("sequence", {
        "wq": (None, None), "ssm_in": (None, None), "w_up": (None, None),
        "lm_head": (None, None)}),
    ("hymba_1p5b", "train_4k"): ("sequence", {
        "wk": (None, None), "ssm_out": (None, None), "lm_head": (None, None)}),
    ("whisper_tiny", "prefill_32k"): ("sequence", {
        "xq": (None, None), "wq": (None, None), "w_up": (None, None),
        "lm_head": (None, None)}),
    ("command_r_35b", "decode_32k"): ("columns", {
        "wq": (None, "model"), "wk": (None, "model"), "wo": (None, "model"),
        "w_down": (None, "model"), "ln1_g": (None,),
        "embed": (None, "model"), "lm_head": (None, "model")}),
    ("granite_moe_3b_a800m", "decode_32k"): ("columns", {
        "router": (None, "model"), "we_gate": (None, None, "model"),
        "we_down": (None, None, "model"), "wo": (None, "model")}),
    ("mamba2_2p7b", "long_500k"): ("columns", {
        "in_proj": (None, "model"), "conv_w": (None, "model"),
        "out_proj": (None, "model"), "A_log": (None,), "norm_g": (None,)}),
    ("hymba_1p5b", "decode_32k"): ("columns", {
        "ssm_in": ("model", None), "ssm_out": (None, "model"),
        "wq": (None, "model"), "Dd": (None,)}),
    ("whisper_tiny", "decode_32k"): ("columns", {
        "xq": (None, "model"), "xo": (None, "model"),
        "w_up": (None, "model"), "b_up": (None,)}),
}
DECODE_CACHE = {                      # (arch, shape): decode_cache_spec
    ("command_r_35b", "decode_32k"): {
        "k": (None, "data", "model", None, None)},
    ("granite_moe_3b_a800m", "decode_32k"): {
        "v": (None, "data", "model", None, None)},
    ("mamba2_2p7b", "long_500k"): {
        "ssm_state": (None, None, None, None, "model"),
        "conv_state": (None, None, None, "model")},
    ("hymba_1p5b", "decode_32k"): {
        "k": (None, "data", None, None, "model"),
        "ssm_state": (None, "data", None, None, "model")},
    ("whisper_tiny", "decode_32k"): {
        "v": (None, "data", "model", None, None),
        "cross_k": (None, "data", None, None, "model")},
}


@pytest.mark.parametrize("cell", list(SPLIT_CELLS), ids="-".join)
def test_model_split_rule(cell):
    """Which split a step takes at the pod mesh (16 x 16), and which
    weights ``compute_spec`` splits there: qwen2 ``train_4k`` (16 rows a
    data shard) splits its batch; command-r ``prefill_32k`` (2 rows)
    its 64 heads (the 8 KV heads: each rank the one its 4 query heads
    read) and its FFN dim; qwen2 and granite ``prefill_32k`` (12 and 24
    heads do not divide over 16), mamba2, hymba (25 heads) and whisper
    ``prefill_32k`` (2 rows) and hymba ``train_4k`` (16 rows in 2
    microbatches do not divide over 16 x 2) their 32,768 or 4,096
    positions, with every weight whole but the MoE's experts (each rank
    its own, as under the batch split). Every decode cell takes the columns
    split, whatever its rows or heads: each weight where the rules put
    "model" (hymba's ``ssm_in``, 3,257 columns, on its input dim;
    granite's expert weights on their last dim), norm gains and biases
    whole; its cache by
    ``decode_cache_spec``: the long ``k`` / ``v`` by positions, hymba's
    window, whisper's cross cache and the SSM state as the reference
    places them."""
    arch, shape = cell
    want, leaves = SPLIT_CELLS[cell]
    mesh = specs.MeshShape(("data", "model"), (16, 16))
    cfg, sh = tcfg.get_config(arch), tcfg.SHAPES[shape]
    params = tbuild(cfg).param_specs()
    if sh.kind == "decode":
        split = specs.model_split_decode(mesh)
    else:
        split = specs.model_split(cfg, sh.batch // 16, mesh,
                                  cfg.micro_batches if sh.kind == "train"
                                  else 1, sh.seq)
    assert split.name == want
    for name, spec in leaves.items():
        shp = (params[name].shape if name in ("lm_head", "embed")
               else params["layers"][name].shape[1:])
        assert specs.compute_spec(name, tuple(shp), mesh, split) == spec, \
            name
    caches = tcfg.cache_specs(cfg, sh.batch, sh.seq)
    for name, spec in DECODE_CACHE.get(cell, {}).items():
        assert specs.decode_cache_spec(name, tuple(caches[name].shape), mesh,
                                       cfg.family) == spec, name


@pytest.mark.parametrize("arch,want", [("qwen2_1p5b", "ffn"),
                                       ("command_r_35b", "heads+ffn"),
                                       ("granite_moe_3b_a800m", "none"),
                                       ("mamba2_2p7b", "none")])
def test_model_split_where_positions_do_not_divide(arch, want):
    """2 rows a data shard of 32,767 positions on the pod mesh: neither
    the rows nor the positions divide over 16 model ranks, so qwen2 (12
    heads) splits only its FFN dim, command-r still its heads and FFN
    dim, and granite (its 24 heads, and no FFN split beside its
    experts') and mamba2 (no heads) nothing."""
    mesh = specs.MeshShape(("data", "model"), (16, 16))
    split = specs.model_split(tcfg.get_config(arch), 2, mesh, 1, 32767)
    assert split.name == want and not split.sequence


DECODE_CELLS = [(a, s) for a in tcfg.ARCH_IDS
                for s, sh in tcfg.SHAPES.items() if sh.kind == "decode"
                and tcfg.supports(tcfg.get_config(a), sh)[0]]


@pytest.mark.parametrize("cell", DECODE_CELLS, ids="-".join)
def test_every_decode_cell_takes_columns(cell):
    """At the pod mesh (16 x 16) every decode cell takes the columns
    split. ``decode_cache_spec`` is the reference's ``cache_spec`` but
    for the self-attention ``k`` / ``v`` of every family but the
    hybrid's, whose positions take "model" in place of the head dim;
    ``compute_spec`` keeps every weight of two or more dims, the MoE's
    expert weights too, on the dim ``leaf_spec`` put on "model" (no
    weight crosses "model"; ``lm_head`` keeps its vocabulary rule) and
    gathers 1-D weights whole."""
    arch, shape = cell
    mesh = specs.MeshShape(("data", "model"), (16, 16))
    cfg, sh = tcfg.get_config(arch), tcfg.SHAPES[shape]
    split = specs.model_split_decode(mesh)
    assert split.name == "columns" and split.n == 16
    for name, leaf in tcfg.cache_specs(cfg, sh.batch, sh.seq).items():
        shp = tuple(leaf.shape)
        got = specs.decode_cache_spec(name, shp, mesh, cfg.family)
        ref = specs.cache_spec(shp, mesh)
        if name in ("k", "v") and cfg.family != "hybrid":
            assert got == ref[:2] + ("model", None, None), name
        else:
            assert got == ref, name
    n = 0
    for path, leaf in flatten_with_path(tbuild(cfg).param_specs())[0]:
        if path[-1] == "lm_head":
            continue
        lo = int(path[0] in ("layers", "enc_layers"))
        shp = tuple(leaf.shape)[lo:]
        want = [None] * len(shp)
        if len(shp) >= 2:
            for d, ax in enumerate(specs.leaf_spec(path, tuple(leaf.shape),
                                                   mesh)):
                if ax == "model":
                    want[d - lo] = "model"
                    n += 1
        assert specs.compute_spec(path[-1], shp, mesh, split) == tuple(
            want), path
    assert n > 3


def test_roofline_table_is_the_h100s():
    assert trl.HW["peak_flops"] == 989.4e12 and trl.HW["hbm_bw"] == 3.35e12
    assert trl.HW["link_bw"] == 450e9 and "H100" in trl.HW["name"]


# ---------------------------------------------------------------------------
# the twins of tests/test_distributed.py, on 4 gloo ranks
# ---------------------------------------------------------------------------

WORKER = r'''
import dataclasses, os, pickle, sys, threading
import numpy as np
import torch
import torch.distributed as dist


def run(rank, world, d):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/pg",
                            rank=rank, world_size=world)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import convert
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import common, moe
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import adamw
    from repro_torch.sharding import specs
    from repro_torch.train.step import (make_train_step, sharded_grads,
                                        value_and_grad)
    from repro_torch.tree import tree_map
    out = {}
    inp = pickle.load(open(f"{d}/in.pkl", "rb"))
    mesh = make_host_mesh(model=2)                    # (2, 2)

    # the sharded train step, qwen2 reduced, f32
    cfg = dataclasses.replace(reduced(get_config("qwen2_1p5b")),
                              dtype="float32")
    model = build_model(cfg)
    opt = adamw(lr=1e-2, weight_decay=0.0)
    params = convert.lm_params_from_numpy(inp["params"], "cpu")
    st = opt.init(params)
    tok = torch.from_numpy(inp["tokens"])
    batch = {"tokens": tok, "labels": tok}
    pd = specs.distribute_tree(params, specs.tree_placements(params, mesh))
    sd = specs.distribute_tree(st, specs.tree_placements(st, mesh))
    bd = specs.distribute_tree(batch, specs.batch_placements(batch, mesh))
    step = make_train_step(model, opt)
    p2, s2, m2 = step(pd, sd, bd)
    full = tree_map(lambda t: t.full_tensor().numpy(), p2)
    out["train"] = {"loss": float(m2["loss"]), "params": full,
                    "placements": str(pd["layers"]["wq"].placements),
                    "split": m2["model_split"]}
    # the Megatron split: 2 x 32 tokens, one row a data shard
    tok_tp = tok[:2]
    bd_tp = specs.distribute_tree(
        {"tokens": tok_tp, "labels": tok_tp},
        specs.batch_placements({"tokens": tok_tp, "labels": tok_tp}, mesh))
    p3, _, m3 = step(pd, sd, bd_tp)
    out["train_megatron"] = {
        "loss": float(m3["loss"]), "split": m3["model_split"],
        "params": tree_map(lambda t: t.full_tensor().numpy(), p3)}

    # the sharded gradients themselves: as placed by the rules; with
    # labels masked on one data shard only (shards of unequal label
    # counts); and with every leaf of >= 256 elements also sharded on
    # "data" (gradients reduce-scattered there)
    def off_thread(loss_fn, params, batch, view):
        """``value_and_grad`` with the backward, and so each layer's
        recompute, on another thread, as autograd runs it on the card."""
        from repro_torch.tree import flatten, unflatten
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

    def grads(params, labels, tok=tok, grad_fn=value_and_grad):
        pd = specs.distribute_tree(params, specs.tree_placements(params,
                                                                 mesh))
        b = {"tokens": tok, "labels": labels}
        bd = specs.distribute_tree(b, specs.batch_placements(b, mesh))
        loss, g, split = sharded_grads(
            lambda p, b, view: grad_fn(model.loss, p, b, view), pd, bd, cfg)
        return {"loss": float(loss),
                "grads": tree_map(lambda t: t.full_tensor().numpy(), g),
                "placements": str(pd["layers"]["wq"].placements),
                "split": split.name}

    out["grads"] = grads(params, tok)
    out["grads_masked"] = grads(params, torch.from_numpy(inp["masked"]))
    out["grads_megatron"] = grads(params, tok_tp, tok_tp)
    out["grads_megatron_thread"] = grads(params, tok_tp, tok_tp, off_thread)
    specs.FSDP_MIN = 256
    out["grads_fsdp"] = grads(params, tok)

    # the split decode: each family's 4 steps on this rank's slices of
    # the reference's cache (leaves of >= 256 elements also sharded on
    # "data" still, so each layer's weights are gathered over "data")
    from repro_torch.models import shards
    split = specs.model_split_decode(mesh)
    rows = slice(2 * mesh.get_local_rank("data"),
                 2 * mesh.get_local_rank("data") + 2)
    out["coords"] = (mesh.get_local_rank("data"),
                     mesh.get_local_rank("model"))
    out["decode"] = {}
    for arch, ref in inp["decode"].items():
        dcfg = dataclasses.replace(reduced(get_config(arch)),
                                   dtype="float32")
        dmodel = build_model(dcfg)
        dp = convert.lm_params_from_numpy(ref["params"], "cpu")
        view = shards.model_view(*shards.local_shards(specs.distribute_tree(
            dp, specs.tree_placements(dp, mesh))), mesh, ("data",), split)
        cache = convert.lm_params_from_numpy(ref["cache"], "cpu")
        local = shards.local_shards(specs.distribute_tree(
            cache, specs.decode_cache_placements(cache, mesh,
                                                 dcfg.family)))[0]
        dtok = torch.from_numpy(ref["tokens"])[rows]
        logits = []
        with torch.no_grad(), common.use_mesh(mesh, ("data",), split):
            for t in range(dtok.shape[1]):
                lg, local = dmodel.decode_step(view, local, dtok[:, t:t + 1],
                                               ref["prompt"] + t)
                logits.append(lg.numpy())
        out["decode"][arch] = {"split": split.name, "logits": logits,
                               "cache": {k: v.numpy()
                                         for k, v in local.items()}}

    # the hand-off: each case's prefill through ``sharded_prefill`` with
    # the decode cache's length, then the split decode steps from this
    # rank's slice; under the batch split qwen2's slice against the
    # port's own unsharded prefill of each rank's rows, grown and placed
    def grown(cache, length):
        return {k: torch.cat([v, v.new_zeros(v.shape[:2] + (
            length - v.shape[2],) + v.shape[3:])], 2)
            if k in ("k", "v") and v.shape[2] < length else v
            for k, v in cache.items()}

    out["handoff"] = {}
    for (arch, kind, rows), ref in inp["handoff"].items():
        hcfg = dataclasses.replace(reduced(get_config(arch)),
                                   dtype="float32")
        if kind == "pick":
            hcfg = dataclasses.replace(hcfg, num_kv_heads=1)
        hmodel = build_model(hcfg)
        hp = convert.lm_params_from_numpy(ref["params"], "cpu")
        hpd = specs.distribute_tree(hp, specs.tree_placements(hp, mesh))
        hb = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
        hbd = specs.distribute_tree(hb, specs.batch_placements(hb, mesh))
        cache, _, hsplit = shards.sharded_prefill(
            hmodel.prefill, hpd, hbd, hcfg, cache_len=inp["cache_len"])
        got = {"split": hsplit.name, "kv": hsplit.kv,
               "cache": {k: v.clone().numpy() for k, v in cache.items()}}
        if (arch, kind) == ("qwen2_1p5b", "batch"):
            per = rows // world
            with torch.no_grad():
                own = [hmodel.prefill(hp, {k: v[i:i + per]
                                           for k, v in hb.items()})[0]
                       for i in range(0, rows, per)]
            own = grown({k: torch.cat([c[k] for c in own], 1)
                         for k in own[0]}, inp["cache_len"])
            placed = specs.distribute_tree(own, specs.decode_cache_placements(
                own, mesh, hcfg.family))
            got["bit_equal"] = {k: torch.equal(cache[k], v.to_local())
                                for k, v in placed.items()}
        view = shards.model_view(*shards.local_shards(hpd), mesh, ("data",),
                                 split)
        per = rows // mesh.size(0)
        lo = per * mesh.get_local_rank("data")
        htok = torch.from_numpy(ref["tokens"])[lo:lo + per]
        got["logits"] = []
        with torch.no_grad(), common.use_mesh(mesh, ("data",), split):
            for t in range(htok.shape[1]):
                lg, cache = hmodel.decode_step(view, cache,
                                               htok[:, t:t + 1],
                                               ref["prompt"] + t)
                got["logits"].append(lg.numpy())
        out["handoff"][(arch, kind, rows)] = got

    # the column product against the unsharded one, and the row product
    g = torch.Generator().manual_seed(3)
    xs = torch.randn((4, 1, 64), generator=g)
    w = torch.randn((64, 148), generator=g)
    mr = mesh.get_local_rank("model")
    cols = {}
    with torch.no_grad(), common.use_mesh(mesh, ("data",), split):
        for dt in (torch.float32, torch.bfloat16):
            a, b = xs.to(dt), w.to(dt)
            cols[str(dt)] = torch.equal(
                common.split_matmul(a, b[:, mr * 74:(mr + 1) * 74], 148),
                common.matmul(a, b))
        rows_err = float((common.split_matmul(xs, w[mr * 32:(mr + 1) * 32],
                                              148) - xs @ w).abs().max())
    out["columns"] = {"bit_equal": cols, "rows_err": rows_err}

    # the sharded MoE (expert-sharded branch) against the local one
    mcfg = dataclasses.replace(reduced(get_config("granite_moe_3b_a800m")),
                               moe_dispatch="biglittle")
    lp_full = moe.init_layer_params(mcfg, torch.Generator().manual_seed(1))
    lp = {k: lp_full[k].float()
          for k in ("router", "we_gate", "we_up", "we_down")}
    x = torch.randn((8, 16, mcfg.d_model),
                    generator=torch.Generator().manual_seed(2)) * 0.5
    local, _ = moe.moe_ffn(mcfg, lp, x, capacity_factor=50.0)
    # this rank's data shard under the mesh, and on one device; the
    # outputs gathered from the model rank 0 of each data rank
    lo = mesh.get_local_rank("data") * 4
    grads, outs = [], []
    for m in (mesh, None):
        xs = x[lo:lo + 4].clone().requires_grad_()
        ws = {k: v.clone().requires_grad_() for k, v in lp.items()}
        with common.use_mesh(m):
            o, a = moe.moe_ffn(mcfg, ws, xs, capacity_factor=50.0)
        (o * o).sum().backward()
        grads.append([xs.grad] + [ws[k].grad for k in sorted(ws)])
        outs.append(o.detach())
    parts = [torch.empty_like(outs[0]) for _ in range(world)]
    dist.all_gather(parts, outs[0].contiguous())
    sharded = torch.cat([parts[r] for r in mesh.mesh[:, 0].tolist()])
    out["moe"] = {"local": local.numpy(),
                  "sharded": sharded.numpy(),
                  "grad_err": max(float((a - b).abs().max()) for a, b in
                                  zip(*grads)),
                  "grad_max": max(float(b.abs().max()) for b in grads[1])}

    # the batch split over "model": each model rank its half of its data
    # shard's rows, the group's rows gathered for the dispatch. Against
    # the single device on the data shard (its rows of the output and of
    # the input's gradient; the weights' gradients, partial over
    # "model", summed there as the step's ``shards`` sums them); and at
    # a capacity that drops assignments, bit for bit against the
    # expert-sharded dispatch of the whole data shard (the same drops)
    mine = slice(2 * mesh.get_local_rank("model"),
                 2 * mesh.get_local_rank("model") + 2)
    xs = x[lo:lo + 4][mine].clone().requires_grad_()
    ws = {k: v.clone().requires_grad_() for k, v in lp.items()}
    with common.use_mesh(mesh, ("data", "model")):
        o, _ = moe.moe_ffn(mcfg, ws, xs, capacity_factor=50.0)
    (o * o).sum().backward()
    got = [xs.grad] + [common._all_reduce(ws[k].grad, mesh, ("model",))
                       for k in sorted(ws)]
    want = [grads[1][0][mine]] + grads[1][1:]
    low = {}
    for dims, rows in ((("data", "model"), mine), (("data",), slice(0, 4))):
        with common.use_mesh(mesh, dims), torch.no_grad():
            low[dims[-1]] = moe.moe_ffn(mcfg, lp, x[lo:lo + 4][rows],
                                        capacity_factor=1.0)[0]
    with torch.no_grad():
        undropped = moe.moe_ffn(mcfg, lp, x[lo:lo + 4],
                                capacity_factor=50.0)[0]
    out["moe_rows"] = {
        "out_close": bool(torch.allclose(o.detach(), outs[1][mine],
                                         rtol=1e-4, atol=1e-5)),
        "grad_err": max(float((a - b).abs().max())
                        for a, b in zip(got, want)),
        "grad_max": max(float(b.abs().max()) for b in want),
        "drops_equal": bool(torch.equal(low["model"], low["data"][mine])),
        "dropped": not torch.allclose(low["data"], undropped)}

    # elastic restore onto another mesh layout
    tree = {"w": torch.arange(64.0).reshape(8, 8)}
    mesh1 = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    t1 = specs.distribute_tree(tree, specs.Layout(mesh1, ("data",)))
    mgr = CheckpointManager(f"{d}/ckpt")
    mgr.save(5, t1, blocking=True)
    mesh2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("a", "b"))
    step, back = mgr.restore(
        like=tree, placements={"w": specs.Layout(mesh2, ("b", "a"))})
    out["restore"] = {"step": step, "w": back["w"].full_tensor().numpy(),
                      "local_shape": tuple(back["w"].to_local().shape),
                      "placements": str(back["w"].placements)}

    # constraints: a DTensor redistributed to the reference's spec
    logits = specs.distribute(torch.arange(8 * 3 * 6.0).reshape(8, 3, 6),
                              specs.replicated(mesh))
    c = common.constrain_logits(logits)
    a = common.constrain_act(logits[:, :, :5].redistribute(
        mesh, logits.placements))
    out["constrain"] = {"logits": str(c.placements),
                        "act": str(a.placements),
                        "equal": bool(torch.equal(c.full_tensor(),
                                                  logits.full_tensor()))}
    every = [None] * world
    dist.all_gather_object(every, {k: out[k] for k in
                                   ("coords", "decode", "columns",
                                    "handoff")})
    out["ranks"] = every
    if rank == 0:
        pickle.dump(out, open(f"{d}/out.pkl", "wb"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    torch.multiprocessing.spawn(run, args=(4, sys.argv[1]), nprocs=4)
'''


def _env():
    return {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def reference_step():
    """The JAX single-device train step of tests/test_distributed.py."""
    cfg = dataclasses.replace(jcfg.reduced(jcfg.get_config("qwen2_1p5b")),
                              dtype="float32")
    model = jbuild(cfg)
    opt = jadamw.adamw(lr=LR, weight_decay=0.0)
    params = model.init(jax.random.key(0))
    rs = np.random.RandomState(0)
    tok = rs.randint(0, cfg.vocab_size, (8, 32)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok)}
    p1, _, m1 = jax.jit(jmake_train_step(model, opt))(
        params, opt.init(params), batch)
    grads = jax.grad(model.loss)(params, batch)
    # labels masked on the first data shard's rows only (mesh (2, 2):
    # rows 0-3), so the two shards hold unequal label counts
    masked = tok.copy()
    masked[:3, :20] = -1
    mbatch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(masked)}
    mloss, mgrads = jax.value_and_grad(model.loss)(params, mbatch)
    # the first 2 rows: one row a data shard, the Megatron split
    tbatch = {"tokens": jnp.asarray(tok[:2]), "labels": jnp.asarray(tok[:2])}
    p_tp, _, m_tp = jax.jit(jmake_train_step(model, opt))(
        params, opt.init(params), tbatch)
    tloss, tgrads = jax.value_and_grad(model.loss)(params, tbatch)
    return (jax.tree.map(np.asarray, params), tok, float(m1["loss"]),
            jax.tree.map(np.asarray, p1), jax.tree.map(np.asarray, grads),
            masked, float(mloss), jax.tree.map(np.asarray, mgrads),
            float(m_tp["loss"]), jax.tree.map(np.asarray, p_tp),
            float(tloss), jax.tree.map(np.asarray, tgrads))


DECODE_ARCHS = ["qwen2_1p5b", "granite_moe_3b_a800m", "mamba2_2p7b",
                "hymba_1p5b", "whisper_tiny"]
DECODE = (4, 6, 4, 16)         # batch, prompt, decode steps, cache positions


@pytest.fixture(scope="module")
def decode_reference():
    """Per family, reduced and in f32: the JAX package's prefill of a
    4 x 6 prompt, its self-attention ``k`` / ``v`` grown to 16 positions
    (so that, split over 2 model ranks, the 4 steps write positions 6-9
    across the ranks' boundary), then its single-device ``decode_step``
    on 4 teacher-forced tokens. The reduced configs' splits at n = 2:
    the 16 positions, hymba's 16-wide head dim (its 32-entry window and
    whisper's 24-frame cross cache keep the reference's layout), N = 8
    of mamba2 and hymba, mamba2's 80 conv channels, and every product's
    columns (mamba2's and hymba's 148-wide input projections included)
    divide by 2."""
    B, P, T, S = DECODE
    out = {}
    for arch in DECODE_ARCHS:
        cfg = dataclasses.replace(jcfg.reduced(jcfg.get_config(arch)),
                                  dtype="float32")
        model = jbuild(cfg)
        params = model.init(jax.random.key(0))
        rs = np.random.RandomState(1)
        tok = rs.randint(0, cfg.vocab_size, (B, P + T)).astype(np.int32)
        batch = {"tokens": jnp.asarray(tok[:, :P])}
        if cfg.frontend == "audio":
            batch["enc_embeds"] = jnp.asarray(
                rs.randn(B, cfg.encoder_seq, cfg.d_model), jnp.float32)
        cache, _ = jax.jit(model.prefill)(params, batch)
        if cfg.family != "hybrid":
            cache = {k: (jnp.pad(v, [(0, 0), (0, 0), (0, S - P)]
                                 + [(0, 0)] * (v.ndim - 3))
                         if k in ("k", "v") else v) for k, v in cache.items()}
        first = jax.tree.map(np.asarray, cache)
        step = jax.jit(model.decode_step)
        logits = []
        for t in range(T):
            lg, cache = step(params, cache,
                             jnp.asarray(tok[:, P + t:P + t + 1]),
                             jnp.int32(P + t))
            logits.append(np.asarray(lg))
        out[arch] = {"params": jax.tree.map(np.asarray, params),
                     "cache": first, "tokens": tok[:, P:], "prompt": P,
                     "logits": logits,
                     "final": jax.tree.map(np.asarray, cache),
                     "batch": jax.tree.map(np.asarray, batch)}
    return out


@pytest.fixture(scope="module")
def pick_reference():
    """As :func:`decode_reference` for reduced qwen2 with one KV head (4
    query heads) on 2 rows: one row a data shard on (2, 2), where
    Megatron's split gives each model rank 2 query heads and the one KV
    head they read ("pick")."""
    B, P, T, S = DECODE
    cfg = dataclasses.replace(jcfg.reduced(jcfg.get_config("qwen2_1p5b")),
                              dtype="float32", num_kv_heads=1)
    model = jbuild(cfg)
    params = model.init(jax.random.key(0))
    tok = np.random.RandomState(2).randint(
        0, cfg.vocab_size, (2, P + T)).astype(np.int32)
    cache, _ = jax.jit(model.prefill)(params, {"tokens": jnp.asarray(
        tok[:, :P])})
    cache = {k: jnp.pad(v, [(0, 0), (0, 0), (0, S - P), (0, 0), (0, 0)])
             for k, v in cache.items()}
    first = jax.tree.map(np.asarray, cache)
    step = jax.jit(model.decode_step)
    logits = []
    for t in range(T):
        lg, cache = step(params, cache, jnp.asarray(tok[:, P + t:P + t + 1]),
                         jnp.int32(P + t))
        logits.append(np.asarray(lg))
    return {"params": jax.tree.map(np.asarray, params), "cache": first,
            "tokens": tok[:, P:], "prompt": P, "logits": logits,
            "batch": {"tokens": tok[:, :P]}}


# the hand-off's cases: (arch, the prefill's split, its rows of the
# reference's batch); "pick" reads :func:`pick_reference`
HANDOFF = ([(a, "batch", 4) for a in DECODE_ARCHS]
           + [("qwen2_1p5b", "heads", 2), ("qwen2_1p5b", "pick", 2)])


def _handoff_reference(decode_reference, pick_reference, case):
    """The reference of a :data:`HANDOFF` case, cut to its rows."""
    arch, kind, rows = case
    ref = pick_reference if kind == "pick" else decode_reference[arch]
    return {"params": ref["params"], "prompt": ref["prompt"],
            "batch": {k: v[:rows] for k, v in ref["batch"].items()},
            "tokens": ref["tokens"][:rows],
            "cache": {k: v[:, :rows] for k, v in ref["cache"].items()},
            "logits": [lg[:rows] for lg in ref["logits"]]}


@pytest.fixture(scope="module")
def distributed(tmp_path_factory, reference_step, decode_reference,
                pick_reference):
    d = tmp_path_factory.mktemp("dist")
    params, tok = reference_step[:2]
    with open(d / "in.pkl", "wb") as f:
        pickle.dump({"params": params, "tokens": tok,
                     "masked": reference_step[5],
                     "decode": {a: {k: r[k] for k in ("params", "cache",
                                                      "tokens", "prompt")}
                                for a, r in decode_reference.items()},
                     "handoff": {case: {k: v for k, v in _handoff_reference(
                         decode_reference, pick_reference, case).items()
                         if k in ("params", "batch", "tokens", "prompt")}
                         for case in HANDOFF},
                     "cache_len": DECODE[3]}, f)
    (d / "worker.py").write_text(WORKER)
    r = subprocess.run([sys.executable, str(d / "worker.py"), str(d)],
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    with open(d / "out.pkl", "rb") as f:
        return pickle.load(f)


ADAM_EPS = 1e-8                # its eps


def _assert_step(got, loss, want, grads):
    """:func:`test_sharded_train_step_matches_reference`'s bounds."""
    assert abs(got["loss"] - loss) < 1e-3
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_d = jax.tree_util.tree_leaves(grads)
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


def test_sharded_train_step_matches_reference(distributed, reference_step):
    """Loss within 1e-3 and params at rtol 1e-3 / atol 1e-4 of the JAX
    single-device step, as the reference's test holds its own sharded
    step, but for the elements whose reference gradient is below 10x
    Adam's eps. A first AdamW step moves an element by lr * g / (|g| +
    eps): +-lr wherever |g| >> eps, whatever the rounding, but where
    |g| is near eps (here ``bk``'s lowest-frequency RoPE dims, which
    barely rotate over 32 positions and so barely move the scores) the
    step is proportional to g itself, and g's rounding, which depends on
    the order of the batch sum (the data ranks' partial sums here),
    moves it by up to lr * rounding / eps. Those elements (at most 0.1 %
    of them) are held to Adam's bound, lr; their gradients are held to
    ``jax.grad`` directly in :func:`test_sharded_grads_match_reference`.
    Elements whose gradient is exactly zero (the padded vocabulary rows)
    stay under the tolerance: they do not move in either package. With
    4 rows a data shard on 2 model ranks, the step splits the batch over
    "model" too (2 rows a rank)."""
    _, _, loss, want, grads = reference_step[:5]
    got = distributed["train"]
    assert "Shard" in got["placements"]          # the params were sharded
    assert got["split"] == "batch"
    _assert_step(got, loss, want, grads)


def test_megatron_train_step_matches_reference(distributed, reference_step):
    """The step on 2 x 32 tokens, one row a data shard, which does not
    divide over 2 model ranks: Megatron's split of the heads (2 of 4 a
    rank, 1 of 2 KV heads) and the FFN dim (64 of 128), held to the JAX
    single-device step on the same batch at the bounds above."""
    loss, want = reference_step[8:10]
    got = distributed["train_megatron"]
    assert got["split"] == "heads+ffn"
    _assert_step(got, loss, want, reference_step[11])


def _assert_grads(got, want):
    """Each leaf at rtol 1e-4 and an atol of 2e-6 of the leaf's largest
    reference gradient. The unsharded port's own gradients already
    differ from ``jax.grad``'s by up to 5.4e-7 on ``embed`` (largest
    gradient 0.48: its scatter-add sums the tokens' rows in another
    order), beyond a flat 1e-7; a gradient off by a data rank's share
    is off by half."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = flatten_with_path(got)[0]
    assert len(flat_g) == len(flat_w)
    for (gp, g), (wp, w) in zip(flat_g, flat_w):
        assert tuple(k.key for k in wp) == gp
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=2e-6 * float(np.abs(w).max()),
                                   err_msg=str(gp))


@pytest.mark.parametrize("case", ["grads", "grads_masked", "grads_fsdp",
                                  "grads_megatron", "grads_megatron_thread"])
def test_sharded_grads_match_reference(distributed, reference_step, case):
    """The sharded step's gradients, summed over the data ranks and cut
    back to each weight's shard, against ``jax.grad`` of the reference
    on one device (:func:`_assert_grads`): with the rules' placements;
    with labels masked on one data shard only, so that the loss must be
    the global batch's mean, not the mean of the shards' means; with
    leaves of >= 256 elements also sharded on "data" (these three split
    the batch over "model" too); and on 2 x 32 tokens, where the step
    takes Megatron's split of the heads and the FFN dim, also with the
    backward on another thread than the forward, as autograd runs it on
    the card (each layer's recompute must see the forward's split)."""
    got = distributed[case]
    megatron = case.startswith("grads_megatron")
    if case == "grads_masked":
        loss, want = reference_step[6], reference_step[7]
    elif megatron:
        loss, want = reference_step[10], reference_step[11]
    else:
        loss, want = reference_step[2], reference_step[4]
    assert abs(got["loss"] - loss) < 1e-5
    assert got["split"] == ("heads+ffn" if megatron else "batch")
    if case == "grads_fsdp":          # wq is sharded on both mesh dims
        assert got["placements"] == "(Shard(dim=1), Shard(dim=2))"
    _assert_grads(got["grads"], want)


def test_sharded_moe_matches_local(distributed):
    m = distributed["moe"]
    assert np.allclose(m["local"], m["sharded"], rtol=1e-4, atol=1e-5)


def test_sharded_moe_gradients_match_local(distributed):
    """The expert-sharded branch's backward: its entry sums the ranks'
    partial input gradients over "model", so every rank holds the
    single-device gradients of its data shard."""
    m = distributed["moe"]
    assert m["grad_max"] > 0
    assert m["grad_err"] <= 1e-5 * max(1.0, m["grad_max"])


def test_sharded_moe_batch_split_matches_local(distributed):
    """The expert-sharded branch under the batch split over "model":
    each rank's rows of the output and of the input's gradient, and the
    weights' gradients summed over "model", against the single device on
    the data shard at rtol 1e-4 / atol 1e-5 (gradients as
    :func:`test_sharded_moe_gradients_match_local` holds them); at a
    capacity that drops assignments, bit-equal to the dispatch of the
    whole data shard: the group's rows are gathered, so the capacities
    and drops are the data shard's."""
    m = distributed["moe_rows"]
    assert m["out_close"]
    assert m["grad_max"] > 0
    assert m["grad_err"] <= 1e-5 * max(1.0, m["grad_max"])
    assert m["dropped"] and m["drops_equal"]


def test_elastic_checkpoint_restore_new_mesh(distributed):
    r = distributed["restore"]
    assert r["step"] == 5
    np.testing.assert_array_equal(r["w"], np.arange(64.0).reshape(8, 8))
    assert r["local_shape"] == (4, 4)
    assert r["placements"] == "(Shard(dim=1), Shard(dim=0))"


def test_constraints_redistribute_dtensors(distributed):
    """``constrain_logits`` puts the batch on "data" and the vocab on
    "model"; ``constrain_act`` the batch on "data" (a dim that does not
    divide stays replicated); the values do not change. On a plain
    tensor both are the identity."""
    from repro_torch.models import common
    c = distributed["constrain"]
    assert c["logits"] == "(Shard(dim=0), Shard(dim=2))"
    assert c["act"] == "(Shard(dim=0), Replicate())"
    assert c["equal"]
    x = torch.ones(4, 3, 6)
    assert common.constrain_logits(x) is x and common.constrain_act(x) is x


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


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_split_decode_matches_reference(distributed, decode_reference, arch):
    """4 decode steps under the columns split on ("data", "model") = (2,
    2), each rank on its slice of the reference prefill's cache placed by
    ``decode_cache_spec`` (positions 6-9 written across the model ranks'
    boundary of 8), against the JAX package's single-device
    ``decode_step``: each step's logits (the rank's data rows and its
    vocabulary slice) and each rank's slice of the updated cache at rtol
    1e-4 / atol 1e-5."""
    ref = decode_reference[arch]
    mesh = specs.MeshShape(("data", "model"), (2, 2))
    cfg = tcfg.reduced(tcfg.get_config(arch))
    for r in distributed["ranks"]:
        coords = dict(zip(("data", "model"), r["coords"]))
        got = r["decode"][arch]
        assert got["split"] == "columns"
        for t, (g, w) in enumerate(zip(got["logits"], ref["logits"])):
            assert g.shape[-1] == cfg.vocab_padded // 2
            np.testing.assert_allclose(
                g, _block(w, ("data", None, "model"), coords,
                          {"data": 2, "model": 2}),
                rtol=1e-4, atol=1e-5, err_msg=f"step {t} at {coords}")
        assert len(got["logits"]) == DECODE[2]
        for name, want in ref["final"].items():
            spec = specs.decode_cache_spec(name, want.shape, mesh, cfg.family)
            assert "model" in spec, name
            block = _block(want, spec, coords, {"data": 2, "model": 2})
            assert got["cache"][name].shape == block.shape, name
            np.testing.assert_allclose(got["cache"][name], block, rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name} {coords}")


@pytest.mark.parametrize("case", HANDOFF, ids=lambda c: f"{c[0]}-{c[1]}")
def test_prefill_hands_off_to_split_decode(distributed, decode_reference,
                                           pick_reference, case):
    """``sharded_prefill(..., cache_len=16)`` on ("data", "model") = (2,
    2), in the prefill's split: "batch" (4 rows, each model rank its
    row of its data shard's 2; its rows sent to every rank, each its 8
    positions), Megatron's "heads" with the KV heads split (qwen2's 2
    over 2 ranks) or picked (1 KV head, read by both ranks' query
    heads, sent by one of them); each rank's cache is its slice of the
    JAX package's prefill cache grown to 16 positions, cut by
    ``decode_cache_spec``, at rtol 1e-4 / atol 1e-5, and the split
    decode steps from it give the JAX package's ``decode_step`` logits
    at :func:`test_split_decode_matches_reference`'s bounds."""
    arch, kind, rows = case
    ref = _handoff_reference(decode_reference, pick_reference, case)
    mesh = specs.MeshShape(("data", "model"), (2, 2))
    family = tcfg.get_config(arch).family
    sizes = {"data": 2, "model": 2}
    for r in distributed["ranks"]:
        coords = dict(zip(("data", "model"), r["coords"]))
        got = r["handoff"][case]
        assert got["split"] == {"batch": "batch"}.get(kind, "heads+ffn")
        assert got["kv"] == {"batch": ""}.get(kind, kind.replace(
            "heads", "split"))
        assert sorted(got["cache"]) == sorted(ref["cache"])
        for name, want in ref["cache"].items():
            spec = specs.decode_cache_spec(name, want.shape, mesh, family)
            block = _block(want, spec, coords, sizes)
            assert got["cache"][name].shape == block.shape, name
            np.testing.assert_allclose(got["cache"][name], block, rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name} {coords}")
        assert len(got["logits"]) == DECODE[2]
        for t, (g, w) in enumerate(zip(got["logits"], ref["logits"])):
            np.testing.assert_allclose(
                g, _block(w, ("data", None, "model"), coords, sizes),
                rtol=1e-4, atol=1e-5, err_msg=f"step {t} at {coords}")


def test_batch_handoff_is_bit_equal_to_distributed_cache(distributed):
    """Under the batch split each rank computes its own row as the
    unsharded prefill of that row does, so the hand-off only moves
    values: qwen2's slice on every rank equals, bit for bit,
    ``specs.distribute_tree`` of the port's unsharded prefill caches of
    the ranks' rows (grown to 16 positions) by the decode placements."""
    for r in distributed["ranks"]:
        got = r["handoff"][("qwen2_1p5b", "batch", 4)]["bit_equal"]
        assert got == {"k": True, "v": True}, r["coords"]


def test_column_product_is_bit_equal(distributed):
    """Under the columns split a product with this rank's columns of a
    (64, 148) weight, all-gathered, equals the unsharded ``matmul`` bit
    for bit, in f32 and bf16; a product with its rows (64 / 2) is the
    unsharded one within f32 reassociation."""
    for r in distributed["ranks"]:
        c = r["columns"]
        assert c["bit_equal"] == {"torch.float32": True,
                                  "torch.bfloat16": True}
        assert c["rows_err"] <= 1e-4


# ---------------------------------------------------------------------------
# one dry-run cell on a fake group
# ---------------------------------------------------------------------------

DRYRUN = r'''
import dataclasses, json, sys
import torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ShapeSpec, get_config, input_specs, reduced
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.models.api import build_model
from repro_torch.sharding import specs
model_split = specs.model_split
dryrun.init_fake_group(8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
rec = dryrun.trace_cell(reduced(get_config("qwen2_1p5b")),
                        ShapeSpec("train_small", "train", 64, 8), mesh)
# the same cell with every rank on "data": what a rank's share is
m81 = init_device_mesh("cpu", (8, 1), mesh_dim_names=("data", "model"))
rec81 = dryrun.trace_cell(reduced(get_config("qwen2_1p5b")),
                          ShapeSpec("train_small", "train", 64, 8), m81)
# the traced peak of a train step at 2 and 6 layers of a wider config
peaks = {}
m18 = init_device_mesh("cpu", (1, 8), mesh_dim_names=("data", "model"))
for layers in (2, 6):
    cfg = dataclasses.replace(reduced(get_config("qwen2_1p5b"), layers),
                              d_model=256, d_ff=1024)
    r = dryrun.trace_cell(cfg, ShapeSpec("t", "train", 16, 8), m18)
    stack = build_model(cfg).param_specs()["layers"]
    peaks[layers] = [r["memory"]["peak_traced_bytes"],
                     sum(v.numel() * v.element_size()
                         for v in stack.values()) // layers]
meshes = {}
m = tmesh.make_host_mesh(model=4, device_type="cpu")
meshes["host"] = [list(m.mesh_dim_names), list(m.mesh.shape)]
# a decode cell on (1, 4): the columns split, and the same with none
dryrun.init_fake_group(4)
m14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
dsh = ShapeSpec("decode_small", "decode", 64, 8)
decode = {"columns": dryrun.trace_cell(reduced(get_config("qwen2_1p5b")),
                                      dsh, m14)}
# the same cell as traced before the split: every model rank the group's
# whole work on the whole cache
specs.model_split_decode = lambda mesh: specs.ModelSplit(4)
decode["none"] = dryrun.trace_cell(reduced(get_config("qwen2_1p5b")), dsh, m14)
# a prefill of reduced hymba (1 row of 2,048) on (1, 4): each rank its
# positions, traced as rank 0 and as rank 3; and the same cell with no
# split
psh = ShapeSpec("prefill_small", "prefill", 2048, 1)
prefill = {"sequence": dryrun.trace_ranks(
    reduced(get_config("hymba_1p5b")), psh,
    lambda: init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model")),
    4)}
dryrun.init_fake_group(4)
m14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
specs.model_split = lambda *a, **k: specs.ModelSplit(4)
prefill["none"] = dryrun.trace_cell(reduced(get_config("hymba_1p5b")), psh,
                                    m14)
# a 16-layer reduced qwen2's prefill of 1 row of 1,024 positions on
# (1, 4), 3 query heads over 1 KV head ("sequence"): the traced peak
# with the hand-off to the split decode and without it
from repro_torch.models import shards
from repro_torch.tree import leaves
specs.model_split = model_split
dryrun.init_fake_group(4)
m14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
hcfg = dataclasses.replace(reduced(get_config("qwen2_1p5b"), 16),
                           num_heads=3, num_kv_heads=1)
hmodel = build_model(hcfg)
hp = hmodel.param_specs()
hpd = specs.distribute_tree(hp, specs.tree_placements(hp, m14))
hb = input_specs(hcfg, ShapeSpec("p", "prefill", 1024, 1))["batch"]
hbd = specs.distribute_tree(hb, specs.batch_placements(hb, m14))
handoff = {}
for cache_len in (None, 1024):
    mem = dryrun.MemoryTracker([t for t in leaves(shards.local_shards(
        (hpd, hbd))[0]) if isinstance(t, torch.Tensor)])
    with mem:
        cache, _, hsplit = shards.sharded_prefill(hmodel.prefill, hpd, hbd,
                                                  hcfg, cache_len=cache_len)
    handoff[str(cache_len)] = {
        "peak": mem.peak, "split": hsplit.name,
        "cache_bytes": sum(t.numel() * t.element_size()
                           for t in cache.values())}
    del cache
for world, multi in ((256, False), (512, True)):
    dryrun.init_fake_group(world)
    m = tmesh.make_production_mesh(multi_pod=multi, device_type="cpu")
    meshes[str(world)] = [list(m.mesh_dim_names), list(m.mesh.shape)]
print(json.dumps({"rec": rec, "rec81": rec81, "meshes": meshes,
                  "peaks": peaks, "decode": decode, "prefill": prefill,
                  "handoff": handoff}))
'''


@pytest.fixture(scope="module")
def dryrun_out():
    r = subprocess.run([sys.executable, "-c", DRYRUN], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return json.loads(r.stdout.strip().splitlines()[-1])


def _shard_bytes(tree, duck, rule):
    sizes = dict(zip(duck.axis_names, duck.devices.shape))
    total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = tuple(rule(path, leaf))
        n = int(np.prod(leaf.shape))
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                n //= sizes.get(a, 1) if a else 1
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def test_dryrun_cell_on_fake_group(dryrun_out):
    rec = dryrun_out["rec"]
    # the reference's shard shapes of the same step's arguments
    cfg = jcfg.reduced(jcfg.get_config("qwen2_1p5b"))
    duck = _duck(("data", "model"), (2, 4))
    psds = jbuild(cfg).param_specs()
    ssds = jadamw.adamw(lr=3e-4, state_dtype="bfloat16").state_specs(psds)
    batch = jcfg.input_specs(cfg, jcfg.ShapeSpec("t", "train", 64, 8))[
        "batch"]
    leaf = lambda p, l: jspecs.leaf_spec(p, l.shape, duck)      # noqa: E731
    want = (_shard_bytes(psds, duck, leaf) + _shard_bytes(ssds, duck, leaf)
            + _shard_bytes(batch, duck,
                           lambda p, l: jspecs.batch_spec(l.shape, duck)))
    assert rec["memory"]["argument_bytes"] == want
    assert rec["memory"]["alias_bytes"] > 0
    # weights gathered for use; grads averaged over "data" (no leaf of
    # the reduced config is big enough to shard on "data" too)
    assert rec["collectives"]["all-gather"] > 0
    assert rec["collectives"]["all-reduce"] > 0
    assert rec["traced_flops_per_rank"] > 0


def test_dryrun_batch_split_over_model(dryrun_out):
    """On (2, 4) each data shard's 4 rows split over the 4 model ranks
    (one row a rank), so a rank traces within 5 % of the FLOPs a rank
    of (8, 1) traces for the same step (before the split: ≈4x, the
    model group repeating its compute); the record names the split and
    the roofline's analytic share a rank."""
    rec, rec81 = dryrun_out["rec"], dryrun_out["rec81"]
    assert rec["model_split"] == "batch" and rec81["model_split"] == "none"
    ratio = rec["traced_flops_per_rank"] / rec81["traced_flops_per_rank"]
    assert abs(ratio - 1) <= 0.05, ratio
    assert rec["analytic_flops_per_rank"] == rec81["analytic_flops_per_rank"]
    assert rec["analytic_flops_per_rank"] == trl.analytic_costs(
        tcfg.reduced(tcfg.get_config("qwen2_1p5b")),
        tcfg.ShapeSpec("t", "train", 64, 8))["flops_exec"] / 8


def test_dryrun_step_holds_one_layer_gathered(dryrun_out):
    """ZeRO-3: a layer's whole weights are gathered only while it runs,
    so the traced peak of a train step on 8 model ranks grows per layer
    by the layer's shards, params, AdamW state and gradient (about half
    a whole layer here), not by its whole weights and gradient (two
    whole layers and more, were the step to gather the model)."""
    (p2, layer), (p6, _) = (dryrun_out["peaks"][k] for k in ("2", "6"))
    assert 0 < (p6 - p2) / 4 < layer


def test_dryrun_decode_split_over_model(dryrun_out):
    """Reduced qwen2's decode step (8 rows, a 64-position cache) on a
    fake (1, 4) mesh: under the columns split a rank's arguments are
    exactly its shards (the reference's ``leaf_spec`` for the params,
    ``decode_cache_spec`` for the cache, whole token and length); what
    it all-gathers (1-D weights and activations) is less than one
    layer's whole weights, so no weight crossed "model"; and it traces
    at most half the FLOPs of the same cell with no split (ideal: above
    a quarter, the vocabulary of ``lm_head`` being split in both)."""
    dec, none = dryrun_out["decode"]["columns"], dryrun_out["decode"]["none"]
    assert dec["model_split"] == "columns" and none["model_split"] == "none"
    jc = jcfg.reduced(jcfg.get_config("qwen2_1p5b"))
    cfg = tcfg.reduced(tcfg.get_config("qwen2_1p5b"))
    duck = _duck(("data", "model"), (1, 4))
    port = specs.MeshShape(("data", "model"), (1, 4))
    want = _shard_bytes(jbuild(jc).param_specs(), duck,
                        lambda p, l: jspecs.leaf_spec(p, l.shape, duck))
    for name, leaf in tcfg.cache_specs(cfg, 8, 64).items():
        spec = specs.decode_cache_spec(name, tuple(leaf.shape), port,
                                       cfg.family)
        assert spec[2] == "model", name
        want += leaf.numel() * leaf.element_size() // 4
    want += 8 * 4 + 4                            # token (8, 1), length
    assert dec["memory"]["argument_bytes"] == want
    stack = tbuild(cfg).param_specs()["layers"]
    layer = sum(v.numel() * v.element_size()
                for v in stack.values()) // cfg.num_layers
    assert 0 < dec["collectives"]["all-gather"] < layer
    ratio = dec["traced_flops_per_rank"] / none["traced_flops_per_rank"]
    assert 0.25 < ratio <= 0.5, ratio


def test_dryrun_prefill_sequence_split(dryrun_out):
    """Reduced hymba's prefill of 1 row of 2,048 positions on a fake (1,
    4) mesh: the row does not divide over 4 model ranks and hymba splits
    no heads, so each rank takes 512 contiguous positions ("sequence",
    one query block of the attention) and the heavier of ranks 0 and 3
    (rank 0's windowed queries skip one more key block) traces at most
    0.3 of the FLOPs of the same cell with no split (ideal: a quarter;
    the SSD's carried state and the last position's logits add a
    little); what it all-gathers beside the weights (the keys and
    values, the states) is counted."""
    seq, none = (dryrun_out["prefill"][k] for k in ("sequence", "none"))
    assert seq["model_split"] == "sequence" and none["model_split"] == "none"
    assert seq["position_layout"] == "contiguous"
    by = {r: x["traced_flops"] for r, x in seq["traced_by_rank"].items()}
    assert set(by) == {"0", "3"} and by["0"] < by["3"]
    assert seq["traced_flops_per_rank"] == by["3"]
    ratio = seq["traced_flops_per_rank"] / none["traced_flops_per_rank"]
    assert 0.25 <= ratio <= 0.3, ratio
    assert seq["collectives"]["all-gather"] > 0


def test_dryrun_prefill_handoff_peak(dryrun_out):
    """A sequence-split prefill that hands its cache off to the split
    decode keeps only each layer's slice of the keys and values: its
    traced peak (``dryrun.MemoryTracker``, meta tensors, 16 layers of
    reduced qwen2 on a fake (1, 4) mesh) sits below the same prefill's
    without the hand-off by at least half the whole cache's bytes (the
    whole cache there is every rank's result; the slice a quarter of
    it, with the positions on "model")."""
    whole, cut = (dryrun_out["handoff"][k] for k in ("None", "1024"))
    assert whole["split"] == cut["split"] == "sequence"
    assert 4 * cut["cache_bytes"] == whole["cache_bytes"] > 0
    assert whole["peak"] - cut["peak"] >= whole["cache_bytes"] / 2, (
        whole, cut)


def test_meshes_on_fake_groups(dryrun_out):
    """The production meshes (256 and 512 ranks) and a host mesh over 8
    ranks have the reference's shapes and dim names."""
    assert dryrun_out["meshes"] == {
        "host": [["data", "model"], [2, 4]],
        "256": [["data", "model"], [16, 16]],
        "512": [["pod", "data", "model"], [2, 16, 16]]}

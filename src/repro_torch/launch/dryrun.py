"""Dry run of every (arch, shape, mesh) cell at the production meshes,
with nothing allocated: the reference's ``launch/dryrun.py``, which
AOT-lowers each cell at 512 forced host devices, as a meta-device trace
on a fake process group.

    python -m repro_torch.launch.dryrun --arch qwen2_1p5b --shape train_4k \\
        --mesh pod

One process stands for one rank of a fake group (``FakeStore``, backend
``"fake"``) of 256 ranks (``--mesh pod``: 16 x 16, ("data", "model")) or
512 (``multipod``: 2 x 16 x 16, ("pod", "data", "model")): rank 0, then
the last "model" rank of data group 0 (:func:`trace_ranks`). Params,
optimizer state, batch and cache are meta DTensors placed by
``sharding.specs``; the train step (``train.step.make_train_step``),
prefill or decode step runs on them under a :class:`CollectiveCounter`
and ``torch.utils.flop_counter.FlopCounterMode``. A cell's record has
the reference's shape, with these differences:

  * the record is the traced rank's with more FLOPs (under the sequence
    split ranks skip different attention blocks), its peak the larger
    rank's, and ``traced_by_rank`` has both ranks' FLOPs and peaks;
  * ``memory.argument_bytes`` / ``output_bytes`` are exact: the bytes of
    the rank's local shards of the step's arguments and results;
    ``alias_bytes`` are those of the results that replace donated
    arguments (params and state in training, the cache in decode);
  * the reference's ``temp_bytes`` / ``peak_estimate_bytes`` come from
    the compiler's buffer assignment (``memory_analysis()``), which a
    meta trace does not have: they are left out. In their place a
    :class:`MemoryTracker` follows every tensor storage the traced
    program makes and frees: ``peak_traced_bytes`` is the arguments plus
    the most that was live at once beyond them (the layer's gathered
    weights, activations, gradients, the new params and state), and
    ``fits_80g_hbm`` holds it against the H100 80GB HBM3. It counts no
    allocator slack, communication buffers of the collectives' backends
    or CUDA workspaces;
  * ``cpu_bf16_upcast_estimate_bytes`` is not subtracted: meta tensors
    keep their dtype;
  * ``collectives`` are the counted functional collectives of the
    rank's program, under the reference's names; ``traced_flops_per_rank`` is
    ``FlopCounterMode``'s count of that program, beside
    ``analytic_flops_per_rank``, the roofline's ``flops_exec`` over the
    chips (what a rank would run were the work split evenly), and
    ``traced_flops_by_op``, the count by aten op (``mm`` the products,
    ``bmm`` the attention's and the SSD's einsums and the MoE's experts);
  * ``model_split`` names what a rank computes of its "model" group's
    work (``specs.ModelSplit``): "batch" (its rows of the data shard),
    Megatron's "heads+ffn", "heads" or "ffn", "sequence" (its share of
    each row's positions, the train and prefill steps of any family
    where neither the rows nor the heads divide), "columns" (every decode
    step on a "model" dim of more than one rank: each weight used where
    its shard lives, the cache placed by ``specs.decode_cache_spec``
    and each rank handed its local slice), or "none" (every rank the
    group's whole work); ``position_layout`` how "sequence" lays out
    a rank's positions ("zigzag" or "contiguous");
  * a prefill cell hands its cache off to the split decode
    (``shards.sharded_prefill(..., cache_len=seq)``, ``cache_layout``
    "decode" and ``cache_len`` in the record): its results are the
    rank's slice of the decode cache of ``seq`` positions that the
    shape's decode cell reads, and the last position's logits.

A cell that raises is recorded with its error and the run goes on (the
reference's ``run_cell``); the run exits 1 if any cell errors. Results go
to ``results/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCH_IDS, SHAPES, get_config, input_specs, supports
from ..models import common, shards
from ..models.api import build_model
from ..optim.adafactor import adafactor
from ..optim.adamw import adamw
from ..sharding import specs
from ..train.step import make_train_step
from ..tree import leaves, tree_map
from . import roofline as rl
from .mesh import make_production_mesh

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
WORLD = {False: 256, True: 512}


def make_optimizer(cfg):
    if cfg.optimizer == "adafactor":
        return adafactor(lr=1e-3)
    return adamw(lr=3e-4, state_dtype="bfloat16")


def init_fake_group(world: int, rank: int = 0) -> None:
    """Make this process rank ``rank`` of a fake group of ``world`` ranks
    (a group of another size, or where this process is another rank, is
    replaced)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_rank() == rank:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


class MemoryTracker(TorchDispatchMode):
    """Bytes of the tensor storages that the ops dispatched while it is
    active make, followed until each storage is freed: ``live`` now and
    ``peak``. A storage is counted once however many tensors view it;
    the storages of ``existing`` (the arguments' local tensors) are not
    counted, nor views of them."""

    def __init__(self, existing=()):
        super().__init__()
        self.live = self.peak = 0
        self._sizes: dict = {}
        for t in existing:
            self._track(t.untyped_storage(), 0)

    def _track(self, st, nbytes):
        self._sizes[id(st)] = nbytes
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, id(st))

    def _free(self, key):
        self.live -= self._sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if type(t) is not torch.Tensor:
                continue
            st = t.untyped_storage()
            if id(st) not in self._sizes:
                self._track(st, st.nbytes())
        return out


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    total = 0
    for t in leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _batch_local(x):
    """A DTensor as the plain tensor of this rank's batch shard: dims
    sharded over a data dim stay split, the rest gathered."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    names = x.device_mesh.mesh_dim_names
    keep = [pl if names[i] in ("pod", "data") else Replicate()
            for i, pl in enumerate(x.placements)]
    return x.redistribute(x.device_mesh, keep).to_local()


def _view(params, mesh, dims, split):
    """The tree a model reads from DTensor ``params``: its layers
    gathered one at a time as the model runs (``shards.model_view``)."""
    local, placements = shards.local_shards(params)
    return shards.model_view(local, placements, mesh, dims, split)


def _reshard(local, like):
    """This rank's batch shard ``local`` (gathered elsewhere) placed back
    on ``like``'s placements: slicing, no communication."""
    from torch.distributed.tensor import DTensor, Replicate
    names = like.device_mesh.mesh_dim_names
    keep = [pl if names[i] in ("pod", "data") else Replicate()
            for i, pl in enumerate(like.placements)]
    return DTensor.from_local(local, like.device_mesh, keep).redistribute(
        like.device_mesh, like.placements)


def trace_cell(cfg, shape, mesh) -> dict:
    """The step of ``cfg`` x ``shape`` on meta DTensors over ``mesh``:
    what this rank of the group holds, moves and computes. Returns the
    record's ``memory``, ``collectives`` and ``traced_flops_per_rank``. A decode
    step under a split without ``columns`` (a "model" dim of one rank)
    reads the cache placed by the reference's ``specs.cache_spec``,
    gathered to its data shard."""
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import FlopCounterMode
    model = build_model(cfg)
    params = model.param_specs()
    pd = specs.distribute_tree(params, specs.tree_placements(params, mesh))
    ins = input_specs(cfg, shape)
    if shape.kind == "train":
        opt = make_optimizer(cfg)
        st = opt.state_specs(params)
        sd = specs.distribute_tree(st, specs.tree_placements(st, mesh))
        bd = specs.distribute_tree(
            ins["batch"], specs.batch_placements(ins["batch"], mesh))
        step = make_train_step(model, opt, micro_batches=cfg.micro_batches,
                               accum_dtype=cfg.grad_accum_dtype)
        args = (pd, sd, bd)
    elif shape.kind == "prefill":
        bd = specs.distribute_tree(
            ins["batch"], specs.batch_placements(ins["batch"], mesh))
        args = (pd, bd)
    else:
        split = specs.model_split_decode(mesh)
        cd = specs.distribute_tree(ins["cache"], (
            specs.decode_cache_placements(ins["cache"], mesh, cfg.family)
            if split.columns else
            specs.cache_placements(ins["cache"], mesh)))
        tok = specs.distribute(ins["token"], specs.Layout(
            mesh, specs.batch_spec(tuple(ins["token"].shape), mesh)))
        dims = shards.batch_dims(tok, mesh)
        args = (pd, cd, tok, ins["length"])
    counter = rl.CollectiveCounter()
    flops = FlopCounterMode(display=False)
    mem = MemoryTracker([t for t in leaves(shards.local_shards(args)[0])
                         if isinstance(t, torch.Tensor)])
    with flops, counter, mem:
        if shape.kind == "train":
            new_p, new_s, metrics = step(pd, sd, bd)
            outs, alias = (new_p, new_s, metrics), (new_p, new_s)
            split_name = metrics["model_split"]
            layout = metrics.get("position_layout", "")
        elif shape.kind == "prefill":
            cache, logits, split = shards.sharded_prefill(
                model.prefill, pd, bd, cfg, cache_len=shape.seq)
            outs, alias, split_name = (cache, logits), (), split.name
            layout = split.layout
        else:
            local = (shards.local_shards(cd)[0] if split.columns
                     else tree_map(_batch_local, cd))
            with torch.no_grad(), common.use_mesh(mesh, dims, split):
                logits, cache = model.decode_step(
                    _view(pd, mesh, dims, split), local, _batch_local(tok),
                    shape.seq - 1)
            if split.columns:             # each rank's slice as it is
                new_cache = tree_map(lambda t, like: DTensor.from_local(
                    t, like.device_mesh, like.placements, run_check=False),
                    cache, cd)
            else:
                new_cache = tree_map(_reshard, cache, cd)
            outs, alias = (logits, new_cache), new_cache
            split_name, layout = split.name, split.layout
    arg_b, out_b, alias_b = (_local_bytes(args), _local_bytes(outs),
                             _local_bytes(alias))
    peak = arg_b + mem.peak
    handoff = ({"cache_layout": "decode", "cache_len": shape.seq}
               if shape.kind == "prefill" else {})
    return {
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "alias_bytes": alias_b,
            "peak_traced_bytes": peak,
            "fits_80g_hbm": bool(peak <= rl.HW["hbm_bytes"]),
            "not_measured": (
                "temp_bytes and peak_estimate_bytes: a meta-device trace "
                "has no buffer assignment (the reference reads them from "
                "compiled.memory_analysis()); peak_traced_bytes follows "
                "the traced program's tensor storages instead and counts "
                "no allocator slack, collective buffers or workspaces; "
                "cpu_bf16_upcast_estimate_bytes: meta tensors keep their "
                "dtype, nothing to subtract"),
        },
        "collectives": counter.result(),
        "traced_flops_per_rank": float(flops.get_total_flops()),
        "traced_flops_by_op": {str(op): float(n) for op, n in
                               flops.get_flop_counts()["Global"].items()},
        "analytic_flops_per_rank":
            rl.analytic_costs(cfg, shape)["flops_exec"] / mesh.size(),
        "model_split": split_name,
        "position_layout": layout,
        **handoff,
    }


def trace_ranks(cfg, shape, make_mesh, world: int) -> dict:
    """:func:`trace_cell` as rank 0 and as the last "model" rank of data
    group 0 of a fake group of ``world`` ranks (``make_mesh()`` builds
    the mesh on the group): under the sequence split the ranks' queries
    skip different attention blocks, so rank 0 alone need not speak for
    every rank. The record is the rank's with more traced FLOPs, its
    ``memory`` peak the larger of the two, and ``traced_by_rank`` has
    both ranks' FLOPs and peaks."""
    init_fake_group(world)
    mesh = make_mesh()
    n = mesh.size(mesh.mesh_dim_names.index("model"))
    recs = {0: trace_cell(cfg, shape, mesh)}
    last = int(mesh.mesh.flatten()[n - 1])
    if last:
        init_fake_group(world, last)
        recs[last] = trace_cell(cfg, shape, make_mesh())
    rec = max(recs.values(), key=lambda r: r["traced_flops_per_rank"])
    peak = max(r["memory"]["peak_traced_bytes"] for r in recs.values())
    rec["memory"].update(peak_traced_bytes=peak,
                         fits_80g_hbm=bool(peak <= rl.HW["hbm_bytes"]))
    rec["traced_by_rank"] = {
        str(r): {"traced_flops": x["traced_flops_per_rank"],
                 "peak_traced_bytes": x["memory"]["peak_traced_bytes"]}
        for r, x in recs.items()}
    return rec


def lower_cell(arch: str, shape_name: str, multi_pod: bool):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = supports(cfg, shape)
    if not ok:
        return {"status": "skipped", "reason": reason}
    def make_mesh():
        return make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    t0 = time.time()
    rec = trace_ranks(cfg, shape, make_mesh, WORLD[multi_pod])
    t_trace = time.time() - t0
    mesh = make_mesh()
    chips = mesh.size()
    return {
        "status": "ok",
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, mesh.mesh.shape)),
        "chips": chips,
        "trace_s": round(t_trace, 1),
        **rec,
        "roofline": rl.roofline_terms(
            {"flops": rec["traced_flops_per_rank"]}, rec["collectives"],
            chips, cfg, shape),
        "hw": rl.HW["name"],
    }


def cell_path(arch, shape_name, multi_pod, tag=""):
    m = "multipod" if multi_pod else "pod"
    t = f".{tag}" if tag else ""
    return RESULTS / f"{arch}.{shape_name}.{m}{t}.json"


def run_cell(arch, shape_name, multi_pod, force=False, tag=""):
    RESULTS.mkdir(parents=True, exist_ok=True)
    out = cell_path(arch, shape_name, multi_pod, tag)
    if out.exists() and not force:
        rec = json.loads(out.read_text())
        print(f"[cached] {out.name}: {rec.get('status')}")
        return rec
    print(f"=== {arch} x {shape_name} x "
          f"{'multipod' if multi_pod else 'singlepod'} ===", flush=True)
    try:
        rec = lower_cell(arch, shape_name, multi_pod)
    except Exception as e:  # noqa: BLE001 — recorded, dry-run must continue
        rec = {"status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    rec.setdefault("arch", arch)
    rec.setdefault("shape", shape_name)
    rec["multi_pod"] = multi_pod
    out.write_text(json.dumps(rec, indent=1))
    print(f"[{rec['status']}] {out.name}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="both")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    summary = {"ok": 0, "skipped": 0, "error": 0}
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, force=args.force,
                               tag=args.tag)
                summary[rec["status"]] = summary.get(rec["status"], 0) + 1
    print("SUMMARY:", summary)
    if summary.get("error"):
        raise SystemExit(1)


if __name__ == "__main__":
    main()

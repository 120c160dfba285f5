"""Train-step factory: loss and grads by autograd + optimizer update,
with optional microbatch gradient accumulation and loss/grad-norm
metrics (the reference's ``src/repro/train/step.py``).

The same step runs on DTensor params, optimizer state and batch placed
by ``sharding.specs`` (the reference's ``jax.jit(step,
in_shardings=...)``). Where GSPMD partitions every op, the port computes
on what the specs place in the ZeRO-3 manner (``models/shards.py``):

  * each rank runs the model on its batch shard (the dims the batch is
    split on are the data-parallel ones) over its weight shards, each
    layer's weights gathered while the layer runs and gathered again
    for its backward, never all at once, so the model code sees plain
    tensors and needs no DTensor op coverage;
  * a rank computes 1/n of its "model" group's work
    (``specs.model_split``): its 1/n of the data shard's rows where they
    divide ("model" is then a data-parallel dim too, and the MoE gathers
    the group's rows for its dispatch), else its 1/n of the attention
    heads and the FFN dim (Megatron) where those divide, else its 1/n of
    each row's positions where they divide ("model" a data-parallel dim
    again; the attention gathers every position's keys and values, the
    recurrences carry their state across ranks); a part that divides by
    none of these is computed by every rank of the group. The metrics
    name the split (``model_split``), and under "sequence" its layout of
    the positions (``position_layout``);
  * the loss is the global batch's mean (``common.cross_entropy`` sums
    the NLL and the labelled tokens over the data dims), and each
    gradient is summed over the data dims and cut back to its weight's
    shard (a reduce-scatter, or an all-reduce where the weight is not
    sharded on a data dim);
  * the optimizer updates the DTensor params and state in place of
    their shards (ZeRO-1 for free), its global-norm clip a full
    reduction over every shard.

With ``micro_batches`` > 1 each rank's microbatch ``i`` is the ``i``-th
slice of its own rows (at its own positions under the sequence split),
and each microbatch's loss is the mean over those slices of every data
rank.
"""
from __future__ import annotations

import torch

from ..configs import torch_dtype
from ..models import common, shards
from ..optim.adamw import global_norm
from ..tree import flatten, leaves, tree_map, unflatten


def value_and_grad(loss_fn, params, batch, view=None):
    """(loss, grads) of ``loss_fn(params, batch)``: each float leaf goes
    in as a fresh leaf with ``requires_grad`` (a detached view, no copy),
    and a leaf the loss does not use gets a zero gradient, as
    ``jax.grad`` gives it. ``view`` maps those leaves' tree to what the
    loss reads (the identity by default)."""
    flat, treedef = flatten(params)
    live = [p.detach().requires_grad_(p.is_floating_point()) for p in flat]
    with torch.enable_grad():
        tree = unflatten(treedef, live)
        loss = loss_fn(view(tree) if view else tree, batch)
        wrt = [p for p in live if p.requires_grad]
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for p in live:
        g = next(got) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
    return loss.detach(), unflatten(treedef, grads)


def make_train_step(model, optimizer, micro_batches: int = 1,
                    accum_dtype=None):
    """accum_dtype: microbatch gradient-accumulation dtype (a torch dtype
    or its name). f32 default; bf16 halves the accumulator — the
    optimizer's own state/update still runs in f32."""
    loss_fn = model.loss

    def compute_grads(params, batch, view=None):
        if micro_batches <= 1:
            return value_and_grad(loss_fn, params, batch, view)
        micro = {k: v.reshape(micro_batches, v.shape[0] // micro_batches,
                              *v.shape[1:]) for k, v in batch.items()}
        adt = accum_dtype or torch.float32
        adt = torch_dtype(adt) if isinstance(adt, str) else adt
        dev = flatten(params)[0][0].device
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        grad_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=adt,
                                                  device=p.device), params)
        for i in range(micro_batches):
            loss, grads = value_and_grad(
                loss_fn, params, {k: v[i] for k, v in micro.items()}, view)
            loss_acc = loss_acc + loss
            grad_acc = tree_map(lambda a, g: a + g.to(a.dtype), grad_acc,
                                grads)
        scale = 1.0 / micro_batches
        return loss_acc * scale, tree_map(lambda g: g * scale, grad_acc)

    def train_step(params, opt_state, batch):
        split = None
        if _dtensor_leaves(params):
            loss, grads, split = sharded_grads(
                compute_grads, params, batch, model.cfg, micro_batches)
        else:
            loss, grads = compute_grads(params, batch)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        with torch.no_grad():
            metrics = {"loss": loss,
                       "grad_norm": _whole(global_norm(grads))}
        if split is not None:
            metrics["model_split"] = split.name
            if split.sequence:
                metrics["position_layout"] = split.layout
        return new_params, new_opt, metrics

    return train_step


def make_eval_step(model):
    @torch.no_grad()
    def eval_step(params, batch):
        return {"loss": model.loss(params, batch)}
    return eval_step


# ---------------------------------------------------------------------------
# DTensor params: shards gathered layer by layer, grads back to shards
# ---------------------------------------------------------------------------

def _dtensor_leaves(tree) -> list:
    from torch.distributed.tensor import DTensor
    return [l for l in leaves(tree) if isinstance(l, DTensor)]


def _whole(x):
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def sharded_grads(compute_grads, params, batch, cfg, micro_batches=1):
    """(loss, grads, split) of DTensor ``params`` on ``batch`` (DTensors
    placed by ``specs.batch_placements``, or plain tensors every rank
    shares): each rank's batch shard through ``compute_grads`` on its
    weight shards, gathered layer by layer (``shards.model_view``) to
    their compute layout under ``split``, the ``specs.ModelSplit`` of
    ``cfg`` at this shard's rows and positions (``shards.local_step``);
    each gradient comes back summed over the data dims on its weight's
    placements (a plain weight's plain)."""
    from torch.distributed.tensor import DTensor
    mesh, local, placements, local_batch, data_dims, split = \
        shards.local_step(params, batch, cfg, micro_batches)
    with common.use_mesh(mesh, data_dims, split):
        loss, grads = compute_grads(
            local, local_batch,
            lambda live: shards.model_view(live, placements, mesh,
                                           data_dims, split))

    def place(g, p):
        return (DTensor.from_local(g, mesh, p.placements, run_check=False)
                if isinstance(p, DTensor) else g)

    return loss, tree_map(place, grads, params), split

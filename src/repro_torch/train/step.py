"""Train-step factory: loss and grads by autograd + optimizer update,
with optional microbatch gradient accumulation and loss/grad-norm
metrics (the reference's ``src/repro/train/step.py``)."""
from __future__ import annotations

import torch

from ..configs import torch_dtype
from ..optim.adamw import global_norm
from ..tree import flatten, tree_map, unflatten


def value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``: each float leaf goes
    in as a fresh leaf with ``requires_grad`` (a detached view, no copy),
    and a leaf the loss does not use gets a zero gradient, as
    ``jax.grad`` gives it."""
    flat, treedef = flatten(params)
    live = [p.detach().requires_grad_(p.is_floating_point()) for p in flat]
    with torch.enable_grad():
        loss = loss_fn(unflatten(treedef, live), batch)
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

    def compute_grads(params, batch):
        if micro_batches <= 1:
            return value_and_grad(loss_fn, params, batch)
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
                loss_fn, params, {k: v[i] for k, v in micro.items()})
            loss_acc = loss_acc + loss
            grad_acc = tree_map(lambda a, g: a + g.to(a.dtype), grad_acc,
                                grads)
        scale = 1.0 / micro_batches
        return loss_acc * scale, tree_map(lambda g: g * scale, grad_acc)

    def train_step(params, opt_state, batch):
        loss, grads = compute_grads(params, batch)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        with torch.no_grad():
            metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        return new_params, new_opt, metrics

    return train_step


def make_eval_step(model):
    @torch.no_grad()
    def eval_step(params, batch):
        return {"loss": model.loss(params, batch)}
    return eval_step

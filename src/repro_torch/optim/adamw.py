"""AdamW with dtype-configurable moment states, SGD with momentum, and the
global gradient norm: the reference's functional optimizers
(``src/repro/optim/adamw.py``) over dict trees of tensors.

``update`` returns new trees (nothing is written in place) and runs under
``torch.no_grad()``, so params, moments and step compare with the
reference's leaf for leaf. ``step`` is an int32 0-d tensor on the params'
device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..configs import torch_dtype
from ..tree import flatten, flatten_up_to, leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable        # params -> state
    update: Callable      # (grads, state, params) -> (new_params, new_state)

    def state_specs(self, params):
        """Meta-tensor tree of the state (no allocation)."""
        return self.init(tree_map(
            lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
            params))


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)


def lr_at(lr, step):
    """``lr(step)`` for a schedule, else the constant."""
    return lr(step) if callable(lr) else lr


def adamw(lr: Any = 3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          state_dtype=None, grad_clip: Optional[float] = 1.0) -> Optimizer:
    """lr may be a float or a schedule fn(step)->float. Moments are
    ``state_dtype`` (a torch dtype or its name), by default the param's
    dtype promoted with f32."""
    sdt = (torch_dtype(state_dtype) if isinstance(state_dtype, str)
           else state_dtype)

    def init(params):
        z = lambda p: torch.zeros_like(
            p, dtype=sdt or torch.promote_types(p.dtype, torch.float32))
        return {"m": tree_map(z, params), "v": tree_map(z, params),
                "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_at(lr, step)
        scale = None
        if grad_clip is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
        sf = step.float()
        bc1 = 1 - b1 ** sf
        bc2 = 1 - b2 ** sf

        def upd(p, g, m, v):
            # one leaf at a time, so at most one leaf's f32 temporaries
            # are live; the reference's g * scale promotes bf16 to f32
            if scale is not None:
                g = g.to(torch.promote_types(g.dtype, scale.dtype)) * scale
            gf = g.to(m.dtype)
            m2 = b1 * m + (1 - b1) * gf
            v2 = b2 * v + (1 - b2) * torch.square(gf)
            del g, gf
            delta = (m2.float() / bc1) / (torch.sqrt(v2.float() / bc2)
                                          + eps)
            delta = delta + weight_decay * p.float()
            return (p.float() - lr_t * delta).to(p.dtype), m2, v2

        flat_p, tdef = flatten(params)
        outs = [upd(*a) for a in zip(flat_p, *(flatten_up_to(tdef, t) for t
                                               in (grads, state["m"],
                                                   state["v"])))]
        pick = lambda i: unflatten(tdef, [o[i] for o in outs])
        return pick(0), {"m": pick(1), "v": pick(2), "step": step}

    return Optimizer(init, update)


def sgd_momentum(lr=0.1, momentum=0.9) -> Optimizer:
    def init(params):
        return {"m": tree_map(torch.zeros_like, params),
                "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        lr_t = lr_at(lr, state["step"] + 1)
        m = tree_map(lambda m, g: momentum * m + g, state["m"], grads)
        p = tree_map(lambda p, m: (p - lr_t * m).to(p.dtype), params, m)
        return p, {"m": m, "step": state["step"] + 1}

    return Optimizer(init, update)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares, in f32, added leaf by leaf in the
    reference's leaf order (sorted dict keys)."""
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in leaves(tree)))

"""Adafactor (Shazeer & Stern 2018) — factored second moments, over dict
trees of tensors (the reference's ``src/repro/optim/adafactor.py``).

Memory: O(r+c) per (r,c) matrix instead of O(r*c). No first moment
(beta1=0 variant).
"""
from __future__ import annotations

import torch

from ..tree import flatten, flatten_up_to, tree_map, unflatten
from .adamw import Optimizer, _step0, lr_at


def adafactor(lr=1e-3, decay=0.8, eps1=1e-30, eps2=1e-3,
              clip_threshold=1.0, weight_decay=0.0) -> Optimizer:
    def _factored(p):
        return p.ndim >= 2

    def init(params):
        def st(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"s": tree_map(st, params), "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_at(lr, step)
        beta = 1.0 - step.float() ** (-decay)

        def upd(p, g, s):
            gf = g.float()
            g2 = torch.square(gf) + eps1
            if _factored(p):
                vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = (vr[..., None] / torch.clamp(
                    vr.mean(dim=-1, keepdim=True)[..., None], min=eps1)) \
                    * vc[..., None, :]
                u = gf * torch.rsqrt(torch.clamp(denom, min=eps1))
                ns = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = gf * torch.rsqrt(torch.clamp(v, min=eps1))
                ns = {"v": v}
            # relative update clipping
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            scale = torch.clamp(
                torch.sqrt(torch.mean(torch.square(p.float()))), min=eps2)
            new_p = p.float() - lr_t * scale * u
            if weight_decay:
                new_p = new_p - lr_t * weight_decay * p.float()
            return new_p.to(p.dtype), ns

        flat_p, tdef = flatten(params)
        flat_g = flatten_up_to(tdef, grads)
        flat_s = flatten_up_to(tdef, state["s"])
        outs = [upd(p, g, s) for p, g, s in zip(flat_p, flat_g, flat_s)]
        return (unflatten(tdef, [o[0] for o in outs]),
                {"s": unflatten(tdef, [o[1] for o in outs]), "step": step})

    return Optimizer(init, update)

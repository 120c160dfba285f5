"""Learning-rate schedules (fns of the step: a Python int or a 0-d
tensor), computed in f32 as the reference's
(``src/repro/optim/schedule.py``) and returned as a Python float."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).detach().to("cpu", torch.float32)


def warmup_cosine(peak=3e-4, warmup=1000, total=100_000, floor=0.1):
    def f(step):
        s = _f32(step)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return float(peak * torch.minimum(warm, cos))
    return f


def constant(lr=3e-4):
    lr32 = float(torch.tensor(lr, dtype=torch.float32))
    return lambda step: lr32

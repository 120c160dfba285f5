"""Unified model API: build_model(cfg) → Model(init, forward, loss,
prefill, decode_step). Family dispatch:
  dense, vlm      → transformer (vlm consumes stubbed patch embeds)
  moe             → moe
  ssm             → mamba2
  hybrid          → hymba
  audio           → whisper (enc-dec; stubbed frame embeds)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from . import hymba, mamba2, moe, transformer, whisper

_FAMILY = {
    "dense": transformer,
    "vlm": transformer,
    "moe": moe,
    "ssm": mamba2,
    "hybrid": hymba,
    "audio": whisper,
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable          # (torch.Generator) -> params on its device
    forward: Callable       # (params, batch) -> logits
    loss: Callable          # (params, batch) -> scalar
    prefill: Callable       # (params, batch) -> (cache, last_logits)
    decode_step: Callable   # (params, cache, token, length) -> (logits, cache)
    init_params: Callable   # (cfg, generator) -> params on the default device

    def param_specs(self):
        """Meta-tensor tree of params (no allocation)."""
        with torch.device("meta"):
            return self.init_params(self.cfg, torch.Generator())


def _init(mod, cfg, gen: torch.Generator):
    with torch.device(gen.device):
        return mod.init_params(cfg, gen)


def build_model(cfg) -> Model:
    mod = _FAMILY[cfg.family]
    return Model(
        cfg=cfg,
        init=lambda gen: _init(mod, cfg, gen),
        forward=lambda params, batch: _fwd(mod, cfg, params, batch),
        loss=lambda params, batch: mod.loss_fn(cfg, params, batch),
        prefill=lambda params, batch: mod.prefill(cfg, params, batch),
        decode_step=lambda params, cache, token, length:
            mod.decode_step(cfg, params, cache, token, length),
        init_params=mod.init_params,
    )


def _fwd(mod, cfg, params, batch):
    out = mod.forward(cfg, params, batch)
    # moe.forward returns (logits, aux)
    return out[0] if isinstance(out, tuple) else out

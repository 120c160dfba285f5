"""Batched serving engine (prefill + decode waves).

Wave-based continuous batching: queued requests are grouped into waves
(left-padded to a shared prompt length), prefilled once, then decoded in
lockstep; finished sequences are masked out and the wave ends when all
sequences hit EOS/max-new-tokens, at which point freed slots are refilled
from the queue. The reference's engine (``src/repro/serve/engine.py``)
jit-compiles prefill and decode; here they run eagerly under
``torch.inference_mode()``.

Sampling is greedy at ``temperature <= 0``. Above that it draws from a
``torch.Generator`` the caller seeds (``run_wave(..., rng=)``; seed 0
by default, as the reference's ``key(0)``): the draws are not JAX's, so
sampled tokens differ from the reference's while greedy tokens match.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..kernels.ops import resolve_device


@dataclasses.dataclass
class Request:
    tokens: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int = 32
    eos_id: int = -1              # -1: never
    out: Optional[np.ndarray] = None
    ttft_s: float = 0.0
    done: bool = False


class ServeEngine:
    """Serves ``model`` with ``params`` on ``device`` (``cuda`` unless the
    caller passes ``device="cpu"``; raises without a card otherwise).
    ``params`` must already be on that device."""

    def __init__(self, model, params, max_batch: int = 8, max_seq: int = 512,
                 temperature: float = 0.0, pad_id: int = 0, device=None):
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.temperature = temperature
        self.pad_id = pad_id
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine serves on {self.device}")

    def _sample(self, logits, rng):
        lf = logits[:, -1, :self.cfg.vocab_size].float()
        if self.temperature <= 0:
            return torch.argmax(lf, dim=-1).to(torch.int32)
        probs = torch.softmax(lf / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=rng)[:, 0] \
            .to(torch.int32)

    def _grow_cache(self, cache, extra: int):
        """Extend the KV time axis (axis 2) so decode can write new
        positions."""
        def grow(x):
            if x.ndim >= 3 and x.shape[2] in range(1, self.max_seq * 4):
                shape = list(x.shape)
                shape[2] = extra
                return torch.cat([x, x.new_zeros(shape)], dim=2)
            return x
        if self.cfg.family in ("ssm", "hybrid"):
            return cache  # recurrent state: nothing to grow
        return {k: grow(v) for k, v in cache.items()}

    @torch.inference_mode()
    def run_wave(self, reqs: List[Request],
                 rng: Optional[torch.Generator] = None) -> List[Request]:
        """Prefill and decode one wave. ``ttft_s`` runs from the start of
        the prefill to the first sampled tokens on the host."""
        if rng is None:
            rng = torch.Generator(self.device).manual_seed(0)
        B = len(reqs)
        plen = max(r.tokens.shape[0] for r in reqs)
        toks = np.full((B, plen), self.pad_id, np.int32)
        for i, r in enumerate(reqs):
            toks[i, -r.tokens.shape[0]:] = r.tokens  # left-pad
        max_new = max(r.max_new_tokens for r in reqs)
        t0 = time.perf_counter()
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        cache, logits = self.model.prefill(self.params, batch)
        cache = self._grow_cache(cache, max_new + 1)
        cur = self._sample(logits, rng)
        outs = [[t] for t in cur.tolist()]
        ttft = time.perf_counter() - t0
        done = np.zeros(B, bool)
        for step in range(max_new - 1):
            logits, cache = self.model.decode_step(self.params, cache,
                                                   cur[:, None], plen + step)
            cur = self._sample(logits, rng)
            for i, tok in enumerate(cur.tolist()):
                if done[i]:
                    continue
                outs[i].append(tok)
                if tok == reqs[i].eos_id or \
                        len(outs[i]) >= reqs[i].max_new_tokens:
                    done[i] = True
            if done.all():
                break
        for i, r in enumerate(reqs):
            r.out = np.asarray(outs[i], np.int32)
            r.ttft_s = ttft
            r.done = True
        return reqs

    def serve(self, requests: List[Request]) -> dict:
        """Drain a queue in waves of max_batch; returns throughput stats."""
        t0 = time.perf_counter()
        pending = list(requests)
        n_tokens = 0
        while pending:
            wave = pending[:self.max_batch]
            pending = pending[self.max_batch:]
            self.run_wave(wave)
            n_tokens += sum(len(r.out) for r in wave)
        dt = time.perf_counter() - t0
        return {
            "requests": len(requests),
            "generated_tokens": n_tokens,
            "wall_s": dt,
            "tokens_per_s": n_tokens / max(dt, 1e-9),
            "mean_ttft_s": float(np.mean([r.ttft_s for r in requests])),
        }

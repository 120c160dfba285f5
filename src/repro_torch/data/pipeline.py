"""Deterministic sharded token pipeline with skip-to-step resume.

The reference's ``src/repro/data/pipeline.py``, copied: it is numpy
only, and the port imports nothing of the reference package.

Production data loading for LM training without external deps:
  * a seeded synthetic corpus (mixture of Zipf unigrams + repeated spans,
    enough structure for a LM to show decreasing loss) OR a binary token
    file (np.memmap) when a real corpus is available;
  * deterministic (seed, step) -> batch mapping: any host can materialise
    any step's global batch slice — this is what makes checkpoint-restart
    and elastic rescaling exact (no data repeated or skipped after a
    failure, regardless of the new host count);
  * per-host sharding: host h of H draws rows [h*B/H, (h+1)*B/H) of the
    global batch.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_exponent: float = 1.2
    span_repeat_p: float = 0.3     # chance a span is a repeat (learnable)
    token_file: Optional[str] = None


class TokenPipeline:
    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
        assert cfg.global_batch % num_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        self._mm = (np.memmap(cfg.token_file, dtype=np.int32, mode="r")
                    if cfg.token_file else None)
        # Zipf unigram table (stable across hosts)
        r = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        w = r ** (-cfg.zipf_exponent)
        self._probs = w / w.sum()

    def _row(self, step: int, row: int) -> np.ndarray:
        """Deterministic tokens for (step, global row)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, row]))
        if self._mm is not None:
            n = self._mm.shape[0] - cfg.seq_len - 1
            off = int(rng.integers(0, max(n, 1)))
            return np.asarray(self._mm[off:off + cfg.seq_len + 1],
                              dtype=np.int32)
        out = np.empty(cfg.seq_len + 1, np.int32)
        pos = 0
        while pos < out.shape[0]:
            span = int(rng.integers(8, 64))
            span = min(span, out.shape[0] - pos)
            if pos > span and rng.random() < cfg.span_repeat_p:
                back = int(rng.integers(1, pos - span + 1))
                out[pos:pos + span] = out[pos - back - span:pos - back]
            else:
                out[pos:pos + span] = rng.choice(
                    cfg.vocab_size, size=span, p=self._probs)
            pos += span
        return out

    def batch(self, step: int) -> dict:
        """Local shard of the global batch for ``step``."""
        lo = self.host_id * self.local_batch
        rows = [self._row(step, lo + i) for i in range(self.local_batch)]
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1].copy(), "labels": arr[:, 1:].copy()}

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        """Resume-aware iterator — start_step comes from the checkpoint."""
        step = start_step
        while True:
            yield self.batch(step)
            step += 1

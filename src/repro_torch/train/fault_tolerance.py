"""Fault-tolerance machinery for 1000+-node runs.

The reference's ``src/repro/train/fault_tolerance.py``, copied: it is
numpy only, and the port imports nothing of the reference package.

On a real multi-pod deployment each host runs this next to the train
loop. Pieces:

  * HeartbeatMonitor — per-host liveness via mtime files on shared
    storage (the same pattern GCS/NFS-coordinated TPU pods use). A host
    that misses ``timeout`` is declared dead; the monitor's decision is
    deterministic from the file states, so every surviving host reaches
    the same verdict without a coordinator.
  * StragglerDetector — per-step wall-time EWMA; a host slower than
    ``threshold`` x median is flagged so the launcher can pre-emptively
    drain/replace it (straggler mitigation, not just failure).
  * ElasticPlan — given the surviving host set, recompute the mesh and
    per-host batch shard; together with the deterministic data pipeline
    and elastic checkpoint restore this is full elastic scaling: restart
    on N' != N hosts resumes bit-exact data order at the same step.
  * retry_step — bounded retry with re-raise for genuinely fatal errors.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np


class HeartbeatMonitor:
    def __init__(self, run_dir, host_id: int, timeout: float = 60.0):
        self.dir = Path(run_dir) / "heartbeats"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.host_id = host_id
        self.timeout = timeout

    def beat(self, step: int):
        p = self.dir / f"host_{self.host_id}.json"
        p.write_text(json.dumps({"step": step, "time": time.time()}))

    def alive_hosts(self) -> List[int]:
        now = time.time()
        out = []
        for p in sorted(self.dir.glob("host_*.json")):
            try:
                rec = json.loads(p.read_text())
            except (json.JSONDecodeError, OSError):
                continue  # torn write — treat as missed beat this round
            if now - rec["time"] <= self.timeout:
                out.append(int(p.stem.split("_")[1]))
        return out

    def dead_hosts(self, expected: List[int]) -> List[int]:
        alive = set(self.alive_hosts())
        return [h for h in expected if h not in alive]


class StragglerDetector:
    """Flags hosts whose step time drifts above threshold x median."""

    def __init__(self, alpha: float = 0.2, threshold: float = 1.5):
        self.alpha = alpha
        self.threshold = threshold
        self.ewma: Dict[int, float] = {}

    def record(self, host_id: int, step_seconds: float):
        prev = self.ewma.get(host_id, step_seconds)
        self.ewma[host_id] = (1 - self.alpha) * prev \
            + self.alpha * step_seconds

    def stragglers(self) -> List[int]:
        if len(self.ewma) < 2:
            return []
        med = float(np.median(list(self.ewma.values())))
        return [h for h, t in self.ewma.items()
                if t > self.threshold * med]


class ElasticPlan:
    """Recompute layout after membership change."""

    def __init__(self, global_batch: int):
        self.global_batch = global_batch

    def plan(self, alive: List[int]) -> dict:
        n = len(alive)
        assert n > 0, "no hosts alive"
        # largest per-host batch that tiles the global batch
        while self.global_batch % n:
            n -= 1  # drop spare hosts (kept warm as standbys)
        active = sorted(alive)[:n]
        return {
            "active_hosts": active,
            "local_batch": self.global_batch // n,
            "host_rank": {h: i for i, h in enumerate(active)},
        }


def retry_step(fn: Callable, max_retries: int = 2,
               retryable=(RuntimeError,)) -> Callable:
    """Bounded retry for transient step failures (preempted collective,
    DMA timeout). Deterministic steps make a retry safe: inputs are pure
    functions of (params, step)."""

    def wrapped(*a, **kw):
        for attempt in range(max_retries + 1):
            try:
                return fn(*a, **kw)
            except retryable:
                if attempt == max_retries:
                    raise
                time.sleep(0.1 * 2 ** attempt)
    return wrapped

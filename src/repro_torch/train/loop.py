"""Training loop: checkpoint/restart, heartbeats, straggler hooks,
deterministic resume (the reference's ``src/repro/train/loop.py``). The
same loop ``launch/train.py`` drives; tests run it at toy scale. Runs on
``cuda`` unless the caller passes ``device="cpu"``."""
from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..data.pipeline import DataConfig, TokenPipeline
from ..kernels.ops import resolve_device
from ..optim.adamw import Optimizer
from . import fault_tolerance as ft
from .step import make_train_step


class Trainer:
    def __init__(
        self,
        model,
        optimizer: Optimizer,
        data_cfg: DataConfig,
        run_dir: str,
        micro_batches: int = 1,
        checkpoint_every: int = 50,
        host_id: int = 0,
        num_hosts: int = 1,
        batch_transform: Optional[Callable] = None,
        device=None,
    ):
        self.model = model
        self.optimizer = optimizer
        self.device = resolve_device(device)
        self.run_dir = Path(run_dir)
        self.ckpt = CheckpointManager(self.run_dir / "ckpt")
        self.pipeline = TokenPipeline(data_cfg, host_id, num_hosts)
        self.heartbeat = ft.HeartbeatMonitor(self.run_dir, host_id)
        self.straggler = ft.StragglerDetector()
        self.checkpoint_every = checkpoint_every
        self.host_id = host_id
        self.batch_transform = batch_transform or (lambda b: b)
        self.step_fn = make_train_step(model, optimizer, micro_batches)

    def init_state(self, seed: int = 0):
        params = self.model.init(
            torch.Generator(self.device).manual_seed(seed))
        opt_state = self.optimizer.init(params)
        return params, opt_state

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def run(self, num_steps: int, params=None, opt_state=None,
            log_every: int = 10, on_step: Optional[Callable] = None):
        # ---- restore ----------------------------------------------------
        start = 0
        if params is None:
            params, opt_state = self.init_state()
            step0, restored = self.ckpt.restore(
                like={"params": params, "opt": opt_state})
            if restored is not None:
                params, opt_state = restored["params"], restored["opt"]
                start = step0 + 1
            # hold no second reference to the first state: each step
            # replaces params and opt_state with new tensors
            del restored
        losses = []
        for step in range(start, num_steps):
            t0 = time.perf_counter()
            batch = self._to_device(
                self.batch_transform(self.pipeline.batch(step)))
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.straggler.record(self.host_id, dt)
            self.heartbeat.beat(step)
            losses.append(loss)
            if on_step:
                on_step(step, metrics)
            if log_every and step % log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"{dt*1e3:.0f}ms", flush=True)
            if self.checkpoint_every and step and \
                    step % self.checkpoint_every == 0:
                self.ckpt.save(step, {"params": params, "opt": opt_state})
        self.ckpt.save(num_steps - 1, {"params": params, "opt": opt_state},
                       blocking=True)
        return params, opt_state, np.asarray(losses)

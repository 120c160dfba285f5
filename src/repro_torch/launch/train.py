"""Training launcher: ``python -m repro_torch.launch.train --arch
qwen2_1p5b --steps 200 --scale reduced``.

``--scale reduced`` trains the CPU-feasible config; ``--scale full``
trains the full config on one card, unsharded. The reference's launcher
builds no mesh either (its docstring promises one); sharded training is
``train.step.make_train_step`` on DTensor params placed by
``sharding.specs`` over a ``launch.mesh`` mesh. A config that does not
fit the card stops with an out-of-memory message. Runs on the card
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..configs import get_config, reduced
from ..data.pipeline import DataConfig
from ..kernels.ops import resolve_device
from ..models.api import build_model
from ..optim.adafactor import adafactor
from ..optim.adamw import adamw
from ..optim.schedule import warmup_cosine
from ..train.loop import Trainer


def build_optimizer(cfg, steps: int):
    lr = warmup_cosine(peak=3e-4, warmup=min(100, steps // 10 + 1),
                       total=steps)
    if cfg.optimizer == "adafactor":
        return adafactor(lr=lr)
    return adamw(lr=lr)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_1p5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--scale", choices=["reduced", "full"],
                    default="reduced")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--run-dir", default="runs/train")
    ap.add_argument("--micro-batches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (default; needs a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.scale == "reduced":
        cfg = reduced(cfg, layers=args.layers)
        if args.d_model:
            cfg = dataclasses.replace(cfg, d_model=args.d_model)
    model = build_model(cfg)
    opt = build_optimizer(cfg, args.steps)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)

    def transform(b):
        if cfg.frontend == "vision":
            d = np.random.default_rng(0).normal(
                size=(b["tokens"].shape[0], args.seq, cfg.d_model))
            return {"embeds": d.astype("float32"), "labels": b["labels"]}
        if cfg.frontend == "audio":
            d = np.random.default_rng(0).normal(
                size=(b["tokens"].shape[0], cfg.encoder_seq, cfg.d_model))
            return {"enc_embeds": d.astype("float32"),
                    "tokens": b["tokens"], "labels": b["labels"]}
        return b

    trainer = Trainer(model, opt, data_cfg, args.run_dir,
                      micro_batches=args.micro_batches,
                      batch_transform=transform, device=device)
    try:
        params, _, losses = trainer.run(args.steps)
    except torch.cuda.OutOfMemoryError as exc:
        raise SystemExit(
            f"{cfg.name} ({args.scale}) does not fit on {device}: out of "
            f"memory ({exc}); this launcher does not shard") from exc
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}) over "
          f"{len(losses)} steps")
    return losses


if __name__ == "__main__":
    main()

"""Serving launcher: ``python -m repro_torch.launch.serve --arch qwen2_1p5b``
— spins up the wave-batched engine on a reduced config and runs a
synthetic request burst, printing throughput/TTFT stats. Runs on the
card unless ``--device cpu``."""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_config, reduced
from ..kernels.ops import resolve_device
from ..models.api import build_model
from ..serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_1p5b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; needs a card) or cpu")
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch))
    if cfg.family in ("vlm", "audio"):
        raise SystemExit("serve launcher demo targets token-input archs")
    device = resolve_device(args.device)
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0))

    eng = ServeEngine(model, params, max_batch=args.batch,
                      max_seq=args.prompt_len + args.max_new,
                      temperature=args.temperature, device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(tokens=rng.integers(
        0, cfg.vocab_size, args.prompt_len).astype(np.int32),
        max_new_tokens=args.max_new) for _ in range(args.requests)]
    stats = eng.serve(reqs)
    stats["device"] = str(device)
    print({k: (round(v, 4) if isinstance(v, float) else v)
           for k, v in stats.items()})
    return stats


if __name__ == "__main__":
    main()

"""KV-cache utilities for batched serving."""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig, cache_specs
from ..kernels.ops import resolve_device


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device=None):
    """Zero-initialised decode state matching configs.cache_specs, on
    ``device`` (``cuda`` unless the caller passes ``device="cpu"``)."""
    dev = resolve_device(device)
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
            for k, s in cache_specs(cfg, batch, max_seq).items()}


def cache_bytes(cfg: ArchConfig, batch: int, max_seq: int) -> int:
    return sum(s.element_size() * s.numel()
               for s in cache_specs(cfg, batch, max_seq).values())


def trim_left_pad(cache_entry, new_len: int):
    """Keep the trailing new_len positions (sliding retention policy)."""
    return cache_entry[:, :, -new_len:]

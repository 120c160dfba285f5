"""Hymba-1.5B — parallel attn+mamba heads, SWA [arXiv:2411.13676; hf].
d_inner=1600 so the SSM path has 25 heads of 64 — mirroring the 25
attention heads running in parallel."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, d_inner=1600, ssm_head_dim=64,
    sliding_window=1024,
    micro_batches=2,
    source="arXiv:2411.13676; hf",
)

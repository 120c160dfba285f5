"""Mamba2-2.7B — SSD, attention-free [arXiv:2405.21060; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, d_inner=5120, ssm_head_dim=64,
    attn_free=True,
    source="arXiv:2405.21060; unverified",
)

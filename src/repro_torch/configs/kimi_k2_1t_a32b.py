"""Kimi K2 — trillion-param MoE (paper-table) [arXiv:2501.kimi2; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840,
    num_experts=384, top_k=8, moe_d_ff=2048,
    optimizer="adafactor",          # the reference's choice: Adam m+v for 1T params is too large
    moe_dispatch="biglittle",       # the paper's technique, first-class (DESIGN.md §5)
    micro_batches=8,
    grad_accum_dtype="bfloat16",   # the reference's choice: halves the accumulator
    kv_cache_dtype="float8_e4m3fn",  # halves the decode memory term
    source="arXiv:2501.kimi2; unverified",
)

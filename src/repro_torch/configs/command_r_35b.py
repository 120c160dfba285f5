"""Cohere Command-R 35B — GQA, no bias, parallel attn+FFN, LayerNorm
[hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22528, vocab_size=256000,
    parallel_block=True, norm="layernorm",
    micro_batches=4,
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)

"""ChatGLM3-6B — 2D (partial) RoPE, GQA, QKV bias [arXiv:2406.12793; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", family="dense",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=65024,
    qkv_bias=True, rotary_pct=0.5,
    source="arXiv:2406.12793; hf",
)

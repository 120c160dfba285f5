"""LLaVA-NeXT (Mistral-7B backbone) — anyres tiling frontend is a STUB:
input_specs() provides precomputed patch embeddings
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    frontend="vision",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)

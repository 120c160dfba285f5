"""Whisper-tiny — enc-dec, conv frontend stubbed to frame embeddings
[arXiv:2212.04356; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    is_encoder_decoder=True, encoder_layers=4, encoder_seq=1500,
    frontend="audio", norm="layernorm", mlp="gelu",
    source="arXiv:2212.04356; unverified",
)

"""IBM Granite MoE — 40 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab_size=49155,
    num_experts=40, top_k=8, moe_d_ff=512,
    moe_dispatch="biglittle",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)

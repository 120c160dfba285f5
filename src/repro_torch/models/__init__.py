"""LM model families (dense, vlm and MoE transformers) over param trees."""

"""LM serving: the wave-batched engine and KV-cache utilities."""

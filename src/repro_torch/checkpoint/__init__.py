"""Atomic, async checkpoints of dict trees of tensors."""

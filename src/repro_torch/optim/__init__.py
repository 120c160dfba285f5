"""Optimizers, learning-rate schedules and gradient compression over
dict trees of tensors."""

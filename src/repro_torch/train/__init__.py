"""The train step, the training loop and its fault-tolerance pieces."""

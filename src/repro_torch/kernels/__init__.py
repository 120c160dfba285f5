"""The GAS kernel (CUDA), its plain PyTorch version and dispatch."""

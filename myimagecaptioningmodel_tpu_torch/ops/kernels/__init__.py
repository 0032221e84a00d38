"""Hand-written CUDA kernels for the decode and training paths, each beside its plain PyTorch version."""

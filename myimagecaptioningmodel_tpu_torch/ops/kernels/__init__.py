"""Hand-written CUDA kernels for the decode path, each beside its plain PyTorch version."""

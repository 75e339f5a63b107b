"""PyTorch wrappers of the CUDA kernels, each beside its plain version."""

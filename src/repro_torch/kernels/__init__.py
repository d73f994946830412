"""Hand-written CUDA kernels of the package, each beside its plain PyTorch
version (see :mod:`repro_torch.kernels.group_reduce`)."""

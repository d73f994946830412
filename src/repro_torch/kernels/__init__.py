"""Hand-written CUDA kernels of the package, each beside its plain PyTorch
version: the annealing score's group reduces
(:mod:`repro_torch.kernels.group_reduce`) and the model stack's
:mod:`~repro_torch.kernels.rmsnorm`,
:mod:`~repro_torch.kernels.flash_attention` and
:mod:`~repro_torch.kernels.selective_scan`."""

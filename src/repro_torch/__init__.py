"""Pipette configurator, PyTorch/CUDA package.

The planner's main path — ``Planner.plan`` over enumerate, memory prune,
profiles, pre-score and simulated-annealing worker dedication — with the
annealing engine and the memory estimator on an NVIDIA GPU; and the
generation path of the dense and Mamba1 model families
(``launch.generate``: prefill and greedy decode).  The package
imports ``torch`` and ``numpy`` only.  Entry points that touch tensors take
an explicit ``device`` argument; ``None`` means the CUDA device and raises
when there is none (see :mod:`repro_torch._device`).
"""

"""State carried across from the JAX package.

Four kinds of state cross between the packages.  ``Plan`` JSON needs no
converter: both packages read and write the same schema, byte for byte (and
so do checkpoint directories: ``checkpoint/manager.py``).  A fitted memory
estimator does: :func:`estimator_from_reference` rebuilds it from plain
NumPy arrays.  So do model weights: :func:`params_from_reference` turns the
reference's parameter pytree, as nested dicts of NumPy arrays, into the
port's dict of tensors with the same keys and shapes; and the optimizer's
state: :func:`opt_state_from_reference` does the same for an ``AdamWState``.
This module imports nothing of the other package — the caller pulls the
arrays out of the reference objects.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .core.memory import MemoryEstimator
from .optim.adamw import AdamWState


def estimator_from_reference(params_numpy: Sequence[Mapping[str, np.ndarray]],
                             x_mean: np.ndarray, x_std: np.ndarray,
                             y_mean: float, y_std: float,
                             **fields) -> MemoryEstimator:
    """Build the port's :class:`MemoryEstimator` from a reference one.

    Args:
        params_numpy: the reference MLP's layers, first to last, each
            ``{"w": (fan_in, fan_out) array, "b": (fan_out,) array}``
            (``[{k: np.asarray(v) for k, v in l.items()} for l in
            est.params]`` on the reference estimator).
        x_mean / x_std / y_mean / y_std: its feature and target
            normalisation.
        **fields: its remaining dataclass fields (``soft_margin``,
            ``residual``, ``workload_seq``, ``with_cp``, ``fit_gpu_mem``,
            ``fit_gpus_per_node``).

    Returns:
        An estimator whose ``predict_batch`` computes the same function
        (to float32 rounding: the two frameworks order the matrix-product
        sums and evaluate ``tanh`` differently in the last bits).
    """
    params = []
    for layer in params_numpy:
        w = np.asarray(layer["w"], np.float32)
        b = np.asarray(layer["b"], np.float32)
        if w.ndim != 2 or b.shape != (w.shape[1],):
            raise ValueError(
                f"layer shapes do not form an MLP: w {w.shape}, b {b.shape}")
        params.append({"w": torch.from_numpy(w.copy()),
                       "b": torch.from_numpy(b.copy())})
    return MemoryEstimator(params, np.asarray(x_mean, np.float64),
                           np.asarray(x_std, np.float64),
                           float(y_mean), float(y_std), **fields)


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # NumPy has no bfloat16 of its own (the reference's arrays carry
        # ml_dtypes'); the bits go across as int16 and are reinterpreted
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_reference(tree: Mapping[str, Any],
                          device: DeviceLike = None) -> dict:
    """The reference's model parameters as the port's.

    Args:
        tree: the reference's parameter pytree as nested dicts of NumPy
            arrays (``jax.tree.map(np.asarray, params)``): ``tok_embed``,
            ``final_norm``, ``lm_head`` and ``layers`` with layer-stacked
            ``(L, ...)`` arrays.  float32 and bfloat16 arrays keep their
            type.
        device: where the tensors go (the CUDA device by default).

    Returns:
        The same nested dict with every array a tensor of the same shape
        and type, ready for :mod:`repro_torch.models.model`.
    """
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        return _tensor(node, device)

    return walk(tree)


def opt_state_from_reference(step: Any, m: Mapping[str, Any],
                             v: Mapping[str, Any],
                             device: DeviceLike = None) -> AdamWState:
    """The reference's ``AdamWState(step, m, v)`` as the port's.

    Args:
        step: its step counter (an int32 scalar array or an int).
        m, v: its first and second moments, nested dicts of float32 NumPy
            arrays with the parameters' keys and shapes.
        device: where the tensors go (the CUDA device by default).

    Returns:
        An :class:`~repro_torch.optim.adamw.AdamWState` with an int32 0-d
        ``step`` and ``m``, ``v`` as :func:`params_from_reference` converts
        them.
    """
    device = resolve_device(device)
    step_t = torch.full((), int(np.asarray(step)), dtype=torch.int32,
                        device=device)
    return AdamWState(step_t, params_from_reference(m, device),
                      params_from_reference(v, device))

"""Minimal PyTorch MLP + Adam used by the memory estimator (paper §VI: five
layers, 200 hidden units, trained on profiled configurations).

Parameters are a plain list of ``{"w": (a, b), "b": (b,)}`` float32 tensor
dicts.  The matrix products are ``torch.matmul`` in full float32: TF32 would
cost about three decimal digits of the prediction, so the functions here
refuse to run with ``torch.backends.cuda.matmul.allow_tf32`` switched on.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F


def _assert_full_f32() -> None:
    assert not torch.backends.cuda.matmul.allow_tf32, \
        "the memory estimator needs full-float32 matrix products " \
        "(torch.backends.cuda.matmul.allow_tf32 must be False)"


def init_mlp(gen: torch.Generator, sizes: List[int], *, device=None):
    """He-normal weights (``std = sqrt(2 / fan_in)``) and zero biases.

    ``gen`` supplies the random bits (seed it for a reproducible fit); the
    draws are made on the generator's device and moved to ``device``.
    """
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((a, b), generator=gen, dtype=torch.float32,
                        device=gen.device) * float(np.sqrt(2.0 / a))
        params.append({"w": w.to(device),
                       "b": torch.zeros((b,), dtype=torch.float32,
                                        device=device)})
    return params


def mlp_forward(params, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` per layer with tanh-approximated GELU between layers
    (the approximation the reference estimator was defined with)."""
    _assert_full_f32()
    for i, layer in enumerate(params):
        x = torch.matmul(x, layer["w"]) + layer["b"]
        if i + 1 < len(params):
            x = F.gelu(x, approximate="tanh")
    return x


def pad_batch_rows(x: np.ndarray, minimum: int = 8) -> np.ndarray:
    """Zero-pad ``x`` along axis 0 to the next power-of-two row count.

    Bounds the number of distinct batch shapes the forward ever sees (log2
    of the largest batch), and makes the scalar ``predict`` literally the
    padded one-row case of ``predict_batch``.

    Args:
        x: ``(n, f)`` feature matrix.
        minimum: smallest bucket size.

    Returns:
        ``(m, f)`` array with ``m = max(minimum, 2**ceil(log2(n)))``.
    """
    n = x.shape[0]
    m = max(minimum, 1 << (n - 1).bit_length())
    if m == n:
        return x
    return np.concatenate(
        [x, np.zeros((m - n,) + x.shape[1:], x.dtype)], axis=0)


def mse_loss(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The training objective: mean squared error of the scalar head."""
    pred = mlp_forward(params, x)[:, 0]
    return torch.mean((pred - y) ** 2)


def train_mlp(params, x: torch.Tensor, y: torch.Tensor, *,
              steps: int = 20_000, lr: float = 1e-3):
    """Full-batch Adam regression on (x, y) with cosine LR decay.

    Adam is written out (``b1 = 0.9``, ``b2 = 0.999``, explicit bias
    correction, ``eps = 1e-8`` added outside the square root) with the
    schedule ``lr * (0.02 + 0.98 * 0.5 * (1 + cos(pi * t / steps)))``;
    these are not ``torch.optim.Adam``'s defaults.  Runs on the device of
    ``params``; returns new parameter tensors (the inputs are not
    modified).
    """
    p = [t.detach().clone().requires_grad_(True)
         for layer in params for t in (layer["w"], layer["b"])]
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]

    def as_layers(flat):
        return [{"w": flat[2 * i], "b": flat[2 * i + 1]}
                for i in range(len(flat) // 2)]

    for t in range(1, steps + 1):
        loss = mse_loss(as_layers(p), x, y)
        grads = torch.autograd.grad(loss, p)
        cur_lr = lr * (0.02 + 0.98 * 0.5 *
                       (1 + math.cos(math.pi * t / steps)))
        c1, c2 = 1 - 0.9 ** t, 1 - 0.999 ** t
        with torch.no_grad():
            for a, mm, vv, g in zip(p, m, v, grads):
                mm.mul_(0.9).add_(g, alpha=0.1)
                vv.mul_(0.999).add_(g * g, alpha=0.001)
                a.sub_(cur_lr * (mm / c1) / (torch.sqrt(vv / c2) + 1e-8))
    return as_layers([t.detach() for t in p])

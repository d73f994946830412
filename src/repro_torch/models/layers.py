"""Shared layer math: norms, RoPE, activations, initialisers.

Plain functions over explicit tensors, as in the JAX package's
``models/layers.py``.  Norms and softmax-adjacent reductions run in float32
whatever the activation type.  :func:`rms_norm` goes through the
``rmsnorm`` kernel (CUDA on the card, its plain version on the CPU), and
:func:`residual_norm` through its residual form ``add_rmsnorm`` when a
branch output is still to be added to the residual stream.  The
initialisers draw from an explicit ``torch.Generator`` on the generator's
device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..kernels.rmsnorm import add_rmsnorm, rmsnorm


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """``(x * rsqrt(mean(x**2) + eps)) * weight`` in float32, cast back to
    ``x.dtype``."""
    return rmsnorm(x, weight, eps)


def residual_norm(x: torch.Tensor, pending: Optional[torch.Tensor],
                  weight: torch.Tensor, eps: float = 1e-5) -> tuple:
    """``(x + pending, rms_norm(x + pending))`` in one launch, or ``(x,
    rms_norm(x))`` when no branch output is pending (``pending`` None).

    The model's blocks hand their output on as ``pending`` instead of
    adding it to the residual stream ``x`` themselves, so that the add
    and the next norm are one call of the ``add_rmsnorm`` kernel; the sum
    is bit-equal to ``x + pending``."""
    if pending is None:
        return x, rmsnorm(x, weight, eps)
    return add_rmsnorm(x, pending, weight, eps)


def pick_chunk(s: int, target: int) -> int:
    """Largest divisor of ``s`` that is at most ``target`` (at least 1): the
    chunk length of the chunked attention and of Mamba2's SSD, as the
    reference picks it."""
    c = min(s, target)
    while s % c:
        c -= 1
    return c


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` as the reference computes it.  JAX's sigmoid
    is ``1 / (1 + exp(-x))`` with each op in ``x``'s type, so in bfloat16
    the ``exp``, the add and the divide each round; this replays them,
    where ``torch.sigmoid`` rounds once (a third of bfloat16 values one
    step away).  float32 keeps ``torch.sigmoid``."""
    if x.dtype == torch.float32:
        return x * torch.sigmoid(x)
    return x * (1 / (1 + torch.exp(-x)))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = silu(x @ w_gate)
    u = x @ w_up
    return (g * u) @ w_down


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    """Inverse frequencies ``(head_dim // 2,)`` in float32."""
    # scalars as 0-d tensors made by ``torch.full`` (a fill on the device;
    # ``torch.tensor`` would copy from the host and wait for the device),
    # and tensor / tensor, the IEEE divide — ``scalar / tensor`` is not
    # (torch evaluates it as a reciprocal times the scalar)
    def scalar(v):
        return torch.full((), float(v), dtype=torch.float32, device=device)

    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / scalar(head_dim)
    return torch.ones_like(exponent) / scalar(theta) ** exponent


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate ``x`` ``(..., seq, heads, head_dim)`` by position-dependent
    angles (rotate-half layout); ``positions`` is ``(..., seq)``."""
    dtype = x.dtype
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                         # (hd/2,)
    ang = positions[..., None].to(torch.float32) * inv            # (..., S, hd/2)
    sin = torch.sin(ang)[..., :, None, :]                         # (..., S, 1, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


# ---------------------------------------------------------------------------
# Initialisers (explicit shapes; stacked (L, ...) tensors when n is set)
# ---------------------------------------------------------------------------

def normal(gen: torch.Generator, shape: Sequence[int], scale: float,
           dtype: torch.dtype) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in float32 and cast to ``dtype``.  A stacked
    shape is drawn one leading slice at a time, so the float32 temporary is
    one layer's size, not the whole stack's."""
    out = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    if out.is_meta:                      # shapes only (``param_shapes``)
        return out
    slices = out if len(shape) > 2 else out[None]
    for s in slices:
        s.copy_(torch.randn(s.shape, generator=gen, dtype=torch.float32,
                            device=gen.device) * scale)
    return out


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, n: int = 0,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    shape = (n, d_in, d_out) if n else (d_in, d_out)
    return normal(gen, shape, float(1.0 / np.sqrt(d_in)), dtype)

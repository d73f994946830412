"""Mamba1 block: causal depthwise convolution, selective scan and gate.

Port of the Mamba1 half of the JAX package's ``models/mamba.py``.  The
sequence scan of :func:`mamba1_block` goes through the ``selective_scan``
kernel (CUDA on the card, its plain time-major recurrence on the CPU); the
reference computes the same recurrence as a chunked associative scan, so the
two agree to float32 rounding.  A decode step runs the one-step recurrence
:func:`selective_scan_step` in plain PyTorch, as the reference does.
Mamba2 (``ssd_scan``, ``ssd_step``, ``mamba2_block``) waits for the hybrid
slice (ROADMAP Queue A 8).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.selective_scan import selective_scan
from .layers import silu


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it —
    ``logaddexp(x, 0)`` in float32, cast back — and not ``F.softplus``,
    which returns ``x`` itself above 20."""
    xf = x.to(torch.float32)
    return torch.logaddexp(xf, torch.zeros_like(xf)).to(x.dtype)


# ---------------------------------------------------------------------------
# causal depthwise conv
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` ``(B, S, C)``; ``w`` ``(W, C)`` depthwise; left-padded causal
    convolution, summed over the ``W`` taps in float32 and rounded once to
    ``x``'s type (what a convolution with float32 accumulation returns).

    The taps are written out rather than handed to ``F.conv1d``: cuDNN
    would run a float32 convolution in TF32 unless a global flag is turned
    off, and four taps cost four elementwise passes.
    """
    width = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x.to(torch.float32), (0, 0, width - 1, 0))       # (B, S+W-1, C)
    wf = w.to(x.dtype).to(torch.float32)
    y = xp[:, :s] * wf[0]
    for i in range(1, width):
        y = y + xp[:, i:i + s] * wf[i]
    y = y.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def causal_conv1d_step(x_t: torch.Tensor, cache: torch.Tensor,
                       w: torch.Tensor, b: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  ``x_t`` ``(B, C)``; ``cache`` ``(B, W-1, C)`` past
    inputs.  Returns ``(y (B, C), new cache)``."""
    window = torch.cat([cache, x_t[:, None]], dim=1)            # (B, W, C)
    y = torch.einsum("bwc,wc->bc", window.to(torch.float32),
                     w.to(torch.float32))
    if b is not None:
        y = y + b.to(torch.float32)
    return y.to(x_t.dtype), window[:, 1:]


# ---------------------------------------------------------------------------
# one-step recurrence (decode)
# ---------------------------------------------------------------------------

def selective_scan_step(x, dt, B, C, A, h):
    """One decode step.  ``x, dt`` ``(b, D)``; ``B, C`` ``(b, N)``; ``h``
    ``(b, D, N)`` float32.  Returns ``(y (b, D), h_new)``, float32."""
    a = torch.exp(dt.to(torch.float32)[..., None] * A.to(torch.float32))
    h_new = a * h + (dt * x).to(torch.float32)[..., None] \
        * B[:, None, :].to(torch.float32)
    y = torch.einsum("bdn,bn->bd", h_new, C.to(torch.float32))
    return y, h_new


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def mamba1_block(x, p, cfg, *, h0=None, conv0=None, single_step=False):
    """``x`` ``(B, S, d_model)``, or ``(B, d_model)`` when ``single_step``.

    Params ``p``: in_proj (d, 2*di), conv_w (W, di), conv_b (di,),
    x_proj (di, dt_rank+2N), dt_w (dt_rank, di), dt_bias (di,),
    A_log (di, N), D (di,), out_proj (di, d).
    Returns ``(y, (h, conv_cache))``.
    """
    n = cfg.ssm_state
    A = -torch.exp(p["A_log"].to(torch.float32))
    splits = [cfg.dt_rank, n, n]

    xz = x @ p["in_proj"]
    xi, z = torch.chunk(xz, 2, dim=-1)
    if single_step:
        xi, conv_cache = causal_conv1d_step(xi, conv0, p["conv_w"],
                                            p["conv_b"])
    else:
        # decode cache; a copy, or the view would keep all of xz alive
        conv_cache = xi[:, -(cfg.ssm_conv - 1):, :].clone()
        xi = causal_conv1d(xi, p["conv_w"], p["conv_b"])
    xi = silu(xi)
    proj = xi @ p["x_proj"]
    dt, B_, C_ = torch.split(proj, splits, dim=-1)
    dt = softplus(dt @ p["dt_w"] + p["dt_bias"].to(dt.dtype))
    if single_step:
        y, h = selective_scan_step(xi, dt, B_, C_, A, h0)
    else:
        y, h = selective_scan(xi, dt, B_, C_, A, h0)
    y = y + p["D"].to(torch.float32) * xi.to(torch.float32)
    y = y * silu(z.to(torch.float32))
    return y.to(x.dtype) @ p["out_proj"], (h, conv_cache)

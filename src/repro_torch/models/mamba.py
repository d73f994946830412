"""Mamba1 block: causal depthwise convolution, selective scan and gate.

Port of the Mamba1 half of the JAX package's ``models/mamba.py``.  Both
branches of :func:`mamba1_block` — the sequence and a decode step — go
through the fused form of the ``selective_scan`` kernel
(``selective_scan_fused``: the bias add, softplus, ``-exp(A_log)``, the
recurrence, the ``D`` skip and the gate in one launch on the card; on the
CPU the ATen sequence it replaces, op for op).  Training takes the
sequence branch's gradient on the card from the scan's backward kernel,
through ``SelectiveScanFusedFn``; the decode step is never differentiated.
The reference computes the sequence's recurrence as a chunked associative
scan, so the two agree to float32 rounding.  ``softplus`` and the one-step recurrence
``selective_scan_step`` live beside the kernel's plain versions in
``kernels/selective_scan.py`` and are re-exported here.  Mamba2
(``ssd_scan``, ``ssd_step``, ``mamba2_block``) waits for the hybrid slice
(ROADMAP Queue A 8).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.selective_scan import (selective_scan_fused,  # noqa: F401
                                      selective_scan_step, softplus)
from .layers import silu


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
    inputs.  Returns ``(y (B, C), new cache)``; ``y`` is contiguous (the
    einsum may hand back a transposed layout, and the scan reads rows of
    unit stride), made so by the cast where there is one (bfloat16) and by
    a copy otherwise."""
    window = torch.cat([cache, x_t[:, None]], dim=1)            # (B, W, C)
    y = torch.einsum("bwc,wc->bc", window.to(torch.float32),
                     w.to(torch.float32))
    if b is not None:
        y = y + b.to(torch.float32)
    y = y.to(x_t.dtype, memory_format=torch.contiguous_format)
    return y.contiguous(), window[:, 1:]


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def mamba1_block(x, p, cfg, *, h0=None, conv0=None, single_step=False,
                 h_out=None):
    """``x`` ``(B, S, d_model)``, or ``(B, d_model)`` when ``single_step``.

    Params ``p``: in_proj (d, 2*di), conv_w (W, di), conv_b (di,),
    x_proj (di, dt_rank+2N), dt_w (dt_rank, di), dt_bias (di,),
    A_log (di, N), D (di,), out_proj (di, d).
    Returns ``(y, (h, conv_cache))``.  With ``h_out`` (``(B, di, N)``
    float32) the final state is written into it and ``h`` is ``h_out``;
    it may be ``h0`` itself, which is then updated in place.
    """
    n = cfg.ssm_state
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
    dt = dt @ p["dt_w"]
    if single_step:                 # a sequence of one, viewed in place
        xi, dt, B_, C_, z = (t[:, None] for t in (xi, dt, B_, C_, z))
    y, h = selective_scan_fused(xi, dt, p["dt_bias"], B_, C_, p["A_log"],
                                p["D"], z, h0, h_out, step=single_step)
    if single_step:
        y = y[:, 0]
    return y @ p["out_proj"], (h, conv_cache)

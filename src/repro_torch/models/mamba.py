"""Mamba1 (selective scan) and Mamba2 (SSD) blocks: causal depthwise
convolution, the recurrence and the gate.

Port of the JAX package's ``models/mamba.py``.  Both branches of
:func:`mamba1_block` — the sequence and a decode step — go through the
fused form of the ``selective_scan`` kernel (``selective_scan_fused``: the
bias add, softplus, ``-exp(A_log)``, the recurrence, the ``D`` skip and the
gate in one launch on the card; on the CPU the ATen sequence it replaces,
op for op).  Training takes the sequence branch's gradient on the card
from the scan's backward kernel, through ``SelectiveScanFusedFn``; the
decode step is never differentiated.  The reference computes the
sequence's recurrence as a chunked associative scan, so the two agree to
float32 rounding.  ``softplus`` and the one-step recurrence
``selective_scan_step`` live beside the kernel's plain versions in
``kernels/selective_scan.py`` and are re-exported here.

Mamba2 (:func:`ssd_scan`, :func:`ssd_step`, :func:`mamba2_block`) is plain
torch, on the card too: the reference computes it in plain jnp, with no
Pallas kernel.  :func:`ssd_scan` is the chunked dual form — within a chunk
a decay-masked ``(Q x Q)`` product, across chunks a state recurrence —
with the mask applied inside the exponent, so that its gradient stays
finite.  Its float32 sums run in another order than XLA's (the cumulative
sum, the three-operand contraction), so it agrees with the reference to
float32 rounding.  The block's gated norm goes through the ``rmsnorm``
kernel (a float32 input with the config's weight type).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.selective_scan import (selective_scan_fused,  # noqa: F401
                                      selective_scan_step, softplus)
from .layers import pick_chunk, rms_norm, silu


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


# ---------------------------------------------------------------------------
# Mamba2 SSD (chunked dual form)
# ---------------------------------------------------------------------------

def ssd_scan(x, dt, B, C, A, *, h0=None, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 state-space dual scan, in float32.

    ``x`` ``(b, S, H, P)``; ``dt`` ``(b, S, H)``; ``B, C`` ``(b, S, N)``
    (one group); ``A`` ``(H,)``, negative; ``h0`` ``(b, H, P, N)`` or None
    (zeros).  The sequence runs in chunks of the largest divisor of ``S``
    that is at most ``chunk``.  Returns ``y`` ``(b, S, H, P)`` and the
    final state ``(b, H, P, N)``, both float32.

    Within a chunk, with ``l`` the inclusive cumulative sum of ``dt A``,
    position ``i`` takes ``sum_{j <= i} (C_i . B_j) exp(l_i - l_j) dt_j
    x_j`` plus ``exp(l_i) C_i . state``; the decay is laid out head-major,
    ``(b, H, i, j)``, so that the sum over ``j`` is one batched product.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = pick_chunk(s, chunk)
    nc = s // q
    f32 = torch.float32
    xf = x.to(f32).reshape(b, nc, q, h, p)
    dtf = dt.to(f32).reshape(b, nc, q, h)
    Bf = B.to(f32).reshape(b, nc, q, n)
    Cf = C.to(f32).reshape(b, nc, q, n)
    A32 = A.to(f32)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32))
    ys = []
    for c in range(nc):
        xq, dtq, bq, cq = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        l = torch.cumsum(dtq * A32, dim=1)                       # (b,q,h)
        lh = l.transpose(1, 2)                                   # (b,h,q)
        # decay(j -> i) = exp(l_i - l_j), j <= i; masked inside the
        # exponent (a masked exp(+big) would overflow to inf, and its
        # gradient 0 * inf is NaN)
        delta = lh[:, :, :, None] - lh[:, :, None, :]            # (b,h,i,j)
        decay = torch.exp(torch.where(causal, delta, -torch.inf))
        cb = torch.einsum("bin,bjn->bij", cq, bq)                # (b,q,q)
        m = cb[:, None] * decay                                  # (b,h,i,j)
        xdt = xq * dtq[..., None]                                # (b,q,h,p)
        y_intra = (m @ xdt.transpose(1, 2)).transpose(1, 2)      # (b,q,h,p)
        # inter-chunk: position i gets exp(l_i) * (C_i . state)
        y_inter = torch.exp(l)[..., None] * torch.einsum(
            "bhpn,bin->bihp", state, cq)
        # h_last = exp(l_last) state + sum_j exp(l_last - l_j) dt_j x_j B_j
        tail = torch.exp(l[:, -1:, :] - l)                       # (b,q,h)
        state = torch.exp(l[:, -1])[:, :, None, None] * state + \
            torch.einsum("bjhp,bjn,bjh->bhpn", xq, bq, dtq * tail)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y, state


def ssd_step(x, dt, B, C, A, state, h_out: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  ``x`` ``(b, H, P)``; ``dt`` ``(b, H)``; ``B, C``
    ``(b, N)``; ``state`` ``(b, H, P, N)`` float32.  Returns ``(y (b, H,
    P), new state)`` in float32.  With ``h_out`` the new state is written
    into it and returned; it may be ``state`` itself, which is then
    updated in place."""
    f32 = torch.float32
    a = torch.exp(dt.to(f32) * A.to(f32))                        # (b,H)
    upd = torch.einsum("bhp,bn->bhpn", (x * dt[..., None]).to(f32),
                       B.to(f32))
    s_new = a[:, :, None, None] * state + upd
    y = torch.einsum("bhpn,bn->bhp", s_new, C.to(f32))
    if h_out is not None:
        h_out.copy_(s_new)
        s_new = h_out
    return y, s_new


def mamba2_block(x, p, cfg, *, h0=None, conv0=None, single_step=False,
                 h_out=None):
    """Mamba2 / SSD block.  ``x`` ``(B, S, d_model)``, or ``(B, d_model)``
    when ``single_step``.

    Params ``p``: in_proj (d, 2*di+2N+H), conv_w (W, di+2N), conv_b
    (di+2N,), A_log (H,), D (H,), dt_bias (H,), norm_w (di,), out_proj
    (di, d).  The projection splits as ``z, x, B, C, dt``; the convolution
    runs over ``x‖B‖C``.  Returns ``(y, (h, conv_cache))``; with ``h_out``
    (``(B, H, P, N)`` float32, decode only) the new state is written into
    it and ``h`` is ``h_out``.
    """
    di, n, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    nh = di // hd
    A = -torch.exp(p["A_log"].to(torch.float32))

    zxbcdt = x @ p["in_proj"]
    z, xi, B_, C_, dt = torch.split(zxbcdt, [di, di, n, n, nh], dim=-1)
    xbc = torch.cat([xi, B_, C_], dim=-1)                        # (.., di+2N)
    if single_step:
        xbc, conv_cache = causal_conv1d_step(xbc, conv0, p["conv_w"],
                                             p["conv_b"])
    else:
        conv_cache = xbc[:, -(cfg.ssm_conv - 1):, :].clone()     # decode cache
        xbc = causal_conv1d(xbc, p["conv_w"], p["conv_b"])
    xbc = silu(xbc)
    xi, B_, C_ = torch.split(xbc, [di, n, n], dim=-1)
    dt = softplus(dt + p["dt_bias"].to(dt.dtype))                # (.., H)
    xh = xi.reshape(*xi.shape[:-1], nh, hd)
    if single_step:
        y, h = ssd_step(xh, dt, B_, C_, A, h0, h_out)
    else:
        y, h = ssd_scan(xh, dt, B_, C_, A, h0=h0)
    y = y + p["D"].to(torch.float32)[:, None] * xh.to(torch.float32)
    y = y.reshape(*y.shape[:-2], di)
    y = rms_norm(y * silu(z.to(torch.float32)), p["norm_w"], cfg.norm_eps)
    return y.to(x.dtype) @ p["out_proj"], (h, conv_cache)


#: The block of each Mamba layer kind (``layer_plan``'s ``"kind"``).
BLOCKS = {"mamba1": mamba1_block, "mamba2": mamba2_block}

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
float32 rounding.  With ``cfg.scan_dtype = "bfloat16"`` the reference
computes each chunk's prefix in bfloat16; the port replays that on the
CPU (``selective_scan_chunked_ref``) and on the card in the fused
kernel's bfloat16 working-type instance (under a gradient
``SelectiveScanFusedBf16Fn``, with its backward kernel).  ``softplus``
and the one-step recurrence ``selective_scan_step`` live beside the
kernel's plain versions in ``kernels/selective_scan.py`` and are
re-exported here.

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

def _scan_work_kw(cfg, single_step: bool) -> dict:
    """The fused scan's keyword for the sequence's working type,
    ``cfg.scan_dtype`` (``"float32"`` or ``"bfloat16"``), as the
    reference's ``mamba1_block`` passes it to ``selective_scan``: none for
    float32 (the call as it was), ``work_dtype`` for bfloat16; a decode
    step ignores the knob, as the reference's ``selective_scan_step``
    does."""
    if cfg.scan_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"scan_dtype must be 'float32' or 'bfloat16', got "
                         f"{cfg.scan_dtype!r}")
    if single_step or cfg.scan_dtype == "float32":
        return {}
    return {"work_dtype": torch.bfloat16}


def mamba1_block(x, p, cfg, *, ctx=None, h0=None, conv0=None,
                 single_step=False, h_out=None):
    """``x`` ``(B, S, d_model)``, or ``(B, d_model)`` when ``single_step``.

    Params ``p``: in_proj (d, 2*di), conv_w (W, di), conv_b (di,),
    x_proj (di, dt_rank+2N), dt_w (dt_rank, di), dt_bias (di,),
    A_log (di, N), D (di,), out_proj (di, d).
    Returns ``(y, (h, conv_cache))``.  With ``h_out`` (``(B, di, N)``
    float32) the final state is written into it and ``h`` is ``h_out``;
    it may be ``h0`` itself, which is then updated in place.

    Under an active context ``p`` is this rank's blocks and the block runs
    channel-parallel (:func:`_mamba1_sharded`); ``h0``, ``conv0``,
    ``h_out`` and the returned caches are this rank's blocks of the
    decode cache (``model.cache_pspecs``).
    """
    if ctx is not None and ctx.active:
        return _mamba1_sharded(x, p, cfg, ctx, h0, conv0, single_step,
                               h_out)
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
                                p["D"], z, h0, h_out, step=single_step,
                                **_scan_work_kw(cfg, single_step))
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


def mamba2_block(x, p, cfg, *, ctx=None, h0=None, conv0=None,
                 single_step=False, h_out=None):
    """Mamba2 / SSD block.  ``x`` ``(B, S, d_model)``, or ``(B, d_model)``
    when ``single_step``.

    Params ``p``: in_proj (d, 2*di+2N+H), conv_w (W, di+2N), conv_b
    (di+2N,), A_log (H,), D (H,), dt_bias (H,), norm_w (di,), out_proj
    (di, d).  The projection splits as ``z, x, B, C, dt``; the convolution
    runs over ``x‖B‖C``.  Returns ``(y, (h, conv_cache))``; with ``h_out``
    (``(B, H, P, N)`` float32, decode only) the new state is written into
    it and ``h`` is ``h_out``.

    Under an active context ``p`` is this rank's blocks and the block runs
    head-parallel (:func:`_mamba2_sharded`); the caches in and out are
    this rank's blocks of the decode cache.
    """
    if ctx is not None and ctx.active:
        return _mamba2_sharded(x, p, cfg, ctx, h0, conv0, single_step,
                               h_out)
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


# ---------------------------------------------------------------------------
# under an active ShardCtx
# ---------------------------------------------------------------------------
#
# The projection ``in_proj`` is stored cut over the model axis as one
# packed matrix (``x‖z``, or ``z‖x‖B‖C‖dt``), so a contiguous cut does not
# give a rank matching channels of each part (at tp 2, Mamba1's rank 0
# holds all of ``x`` and rank 1 all of ``z``).  Each rank computes its
# column block of the packed activation with its stored block, the blocks
# are gathered over the model axis (``gather_over``: the gradient is
# summed over the axis, then cut), and each rank takes its own channels of
# every part.  The rest of the weights are cut along the channels (Mamba1)
# or heads (Mamba2), in line with that choice, except Mamba2's
# convolution, whose ``di + 2N`` channels are cut out of line with the
# heads: it is used whole.  A config whose channels (Mamba1) or heads
# (Mamba2) do not divide the model axis runs the block replicated, each
# weight whole.


def _conv_cut(cfg, ctx) -> bool:
    """Whether the decode cache's ``conv`` rows are cut over the model
    axis (``cache_pspecs``' ``P(None, b, None, tp)`` when the conv
    channels divide it)."""
    width = cfg.d_inner + (2 * cfg.ssm_state if cfg.ssm_variant == "mamba2"
                           else 0)
    return width % ctx.n(ctx.tp) == 0


def _whole_params(p, cfg, ctx):
    """Every weight of a layer whole over the model axis, for the block
    computed alike on every model rank."""
    from . import sharding as sh
    sp = sh.use_specs(cfg, ctx)
    return {k: sh.replicated_whole(sh.fsdp_gather(v, sp[k], ctx), sp[k], ctx)
            for k, v in p.items()}


def _conv_whole(conv0, cfg, ctx):
    """This rank's ``conv`` cache block, whole over the model axis."""
    from ..launch import collectives as C
    if not _conv_cut(cfg, ctx):
        return conv0
    return C.all_gather(conv0, ctx.mesh, ctx.tp, conv0.dim() - 1, "tp")


def _conv_block(whole, cfg, ctx):
    """This rank's block of a whole ``conv`` tail ``(b, W - 1, channels)``,
    a tensor of its own."""
    from . import sharding as sh
    if _conv_cut(cfg, ctx):
        whole = sh.model_block(whole, ctx, whole.dim() - 1)
    return whole.clone()


def split_gated_norm(g, w, width: int, eps: float, sum_fn):
    """Mamba2's gated norm on a block of its ``width`` channels: ``g``
    float32 ``(..., block)``, ``w`` the weight's block.  The block's sum
    of squares goes through ``sum_fn`` (the sum over the blocks: over the
    model axis under a context, its cotangent summed back), then each
    channel is scaled as the ``rmsnorm`` kernel scales it, ``(g *
    rsqrt(mean + eps)) * w`` in float32."""
    ss = sum_fn(torch.sum(g * g, dim=-1, keepdim=True))
    return g * torch.rsqrt(ss / width + eps) * w.to(torch.float32)


def _mamba1_sharded(x, p, cfg, ctx, h0, conv0, single_step, h_out):
    """This rank's part of :func:`mamba1_block`, channel-parallel: of the
    ``di`` channels it runs ``[m di / tp, (m + 1) di / tp)``.  ``x`` (the
    stream, replicated over the model axis) enters through ``copy_to``;
    the packed ``x‖z`` is gathered from the ranks' column blocks and each
    rank takes its channels of ``x`` and of ``z``; the convolution,
    ``dt_w``, ``dt_bias``, ``A_log`` and ``D`` are in line with them;
    ``x_proj`` is row-parallel, its ``dt_rank + 2N`` outputs summed over
    the model axis (and, since every rank's channels read them, their
    cotangents summed too); the scan runs on the rank's channels (``z``
    a strided view of the gathered tensor: the kernel's 16-byte copies
    take it where it is aligned, element copies elsewhere), and
    ``out_proj`` is row-parallel, summed.  The state and conv rows are
    this rank's channels: its blocks of the cache."""
    from ..launch import collectives as C
    from . import sharding as sh
    mesh, tp = ctx.mesh, ctx.tp
    di, n, nm = cfg.d_inner, cfg.ssm_state, ctx.n(tp)
    if di % nm:                    # the cache rows are whole too
        return mamba1_block(x, _whole_params(p, cfg, ctx), cfg, h0=h0,
                            conv0=conv0, single_step=single_step,
                            h_out=h_out)
    sp = sh.use_specs(cfg, ctx)
    dl = di // nm
    c0 = sh.coord(ctx, tp) * dl
    w_in = sh.fsdp_gather(p["in_proj"], sp["in_proj"], ctx)
    xz = C.gather_over(C.copy_to(x, mesh, tp) @ w_in, mesh, tp, -1, "tp")
    xi, z = xz[..., c0:c0 + dl], xz[..., di + c0:di + c0 + dl]
    if single_step:
        xi, conv_cache = causal_conv1d_step(xi, conv0, p["conv_w"],
                                            p["conv_b"])
    else:
        conv_cache = xi[:, -(cfg.ssm_conv - 1):, :].clone()
        xi = causal_conv1d(xi, p["conv_w"], p["conv_b"])
    xi = silu(xi)
    proj = C.copy_to(C.sum_over(xi @ p["x_proj"], mesh, tp), mesh, tp)
    dt, B_, C_ = torch.split(proj, [cfg.dt_rank, n, n], dim=-1)
    dt = dt @ p["dt_w"]
    if single_step:
        xi, dt, B_, C_, z = (t[:, None] for t in (xi, dt, B_, C_, z))
    y, h = selective_scan_fused(xi, dt, p["dt_bias"], B_, C_, p["A_log"],
                                p["D"], z, h0, h_out, step=single_step,
                                **_scan_work_kw(cfg, single_step))
    if single_step:
        y = y[:, 0]
    w_out = sh.fsdp_gather(p["out_proj"], sp["out_proj"], ctx)
    return C.sum_over(y @ w_out, mesh, tp), (h, conv_cache)


def _mamba2_sharded(x, p, cfg, ctx, h0, conv0, single_step, h_out):
    """This rank's part of :func:`mamba2_block`, head-parallel: of the
    ``H`` heads it runs ``[m H / tp, (m + 1) H / tp)`` and their channels
    of ``x`` and ``z``.  The packed ``z‖x‖B‖C‖dt`` is gathered from the
    ranks' column blocks (computed whole, its weight marked replicated,
    where its width does not divide the axis); the convolution's weight
    and bias are gathered whole (58 KB at zamba2-7b) and each rank
    convolves its ``x`` channels and all of ``B`` and ``C`` (one group);
    ``dt_bias``, ``A_log`` and ``D`` are cut along the heads.  The gated
    norm's mean over all ``d_inner`` channels is split: the rank's
    float32 sum of squares is summed over the model axis (``b * s``
    floats, its cotangent summed back), then each rank scales its
    channels by its ``norm_w`` block, in the order of the one-process
    norm.  ``out_proj`` is row-parallel, summed.  The state rows are this
    rank's heads; the conv tail (``di + 2N`` channels, cut out of line
    with the heads) is re-cut from the gathered activation in a prefill,
    and gathered whole from the ranks' blocks, stepped and cut again in a
    decode step."""
    from ..launch import collectives as C
    from . import sharding as sh
    mesh, tp = ctx.mesh, ctx.tp
    di, n, hd, nm = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim, ctx.n(tp)
    nh = di // hd
    if single_step:
        conv_in = _conv_whole(conv0, cfg, ctx)
    if nh % nm:
        y, (h, tail) = mamba2_block(
            x, _whole_params(p, cfg, ctx), cfg, h0=h0,
            conv0=conv_in if single_step else None,
            single_step=single_step, h_out=h_out)
        return y, (h, _conv_block(tail, cfg, ctx))
    sp = sh.use_specs(cfg, ctx)
    hl = nh // nm
    dl = hl * hd
    c0 = sh.coord(ctx, tp) * dl
    xin = C.copy_to(x, mesh, tp)
    w_in = sh.fsdp_gather(p["in_proj"], sp["in_proj"], ctx)
    if tp in sh.axes_of(sp["in_proj"]):
        zxbcdt = C.gather_over(xin @ w_in, mesh, tp, -1, "tp")
    else:
        zxbcdt = xin @ C.copy_to(w_in, mesh, tp)
    z = zxbcdt[..., c0:c0 + dl]
    xbc_all = zxbcdt[..., di:2 * di + 2 * n]                 # x‖B‖C, whole
    xbc = torch.cat([zxbcdt[..., di + c0:di + c0 + dl],
                     zxbcdt[..., 2 * di:2 * di + 2 * n]], dim=-1)
    d0 = 2 * di + 2 * n + c0 // hd                          # dt's heads
    dt = zxbcdt[..., d0:d0 + hl]
    cw, cb = (sh.model_whole(sh.fsdp_gather(p[k], sp[k], ctx), sp[k], ctx)
              for k in ("conv_w", "conv_b"))
    cw = torch.cat([cw[..., c0:c0 + dl], cw[..., di:]], dim=-1)
    cb = torch.cat([cb[c0:c0 + dl], cb[di:]], dim=-1)
    if single_step:
        window = torch.cat([conv_in[..., c0:c0 + dl], conv_in[..., di:]],
                           dim=-1)
        xbc, _ = causal_conv1d_step(xbc, window, cw, cb)
        tail = torch.cat([conv_in[:, 1:], xbc_all[:, None]], dim=1)
    else:
        tail = xbc_all[:, -(cfg.ssm_conv - 1):, :]
        xbc = causal_conv1d(xbc, cw, cb)
    conv_cache = _conv_block(tail, cfg, ctx)
    xbc = silu(xbc)
    xi, B_, C_ = torch.split(xbc, [dl, n, n], dim=-1)
    dt = softplus(dt + p["dt_bias"].to(dt.dtype))
    A = -torch.exp(p["A_log"].to(torch.float32))
    xh = xi.reshape(*xi.shape[:-1], hl, hd)
    if single_step:
        y, h = ssd_step(xh, dt, B_, C_, A, h0, h_out)
    else:
        y, h = ssd_scan(xh, dt, B_, C_, A, h0=h0)
    y = y + p["D"].to(torch.float32)[:, None] * xh.to(torch.float32)
    g = split_gated_norm(
        y.reshape(*y.shape[:-2], dl) * silu(z.to(torch.float32)),
        p["norm_w"], di, cfg.norm_eps,
        lambda t: C.copy_to(C.sum_over(t, mesh, tp), mesh, tp))
    w_out = sh.fsdp_gather(p["out_proj"], sp["out_proj"], ctx)
    return C.sum_over(g.to(x.dtype) @ w_out, mesh, tp), (h, conv_cache)


#: The block of each Mamba layer kind (``layer_plan``'s ``"kind"``).
BLOCKS = {"mamba1": mamba1_block, "mamba2": mamba2_block}

"""Decoder stack of the dense, MoE, SSM (Mamba1, Mamba2), hybrid, vlm and
audio families.

Port of the JAX package's ``models/transformer.py``.  Parameters are one
dict with the reference's keys and its layer-stacked ``(L, ...)`` shapes, so
a reference pytree converts key for key
(:func:`repro_torch.convert.params_from_reference`); the training step
hands ``params["layers"]`` in as a list of per-layer dicts instead (leaves of
their own, so that no layer's backward writes a gradient the size of the
whole stack; :func:`layer_params` takes either).  :func:`run_stack` is a
plain Python loop over layers in place of the reference's ``lax.scan``.
When the config asks for remat and a gradient is being taken, each layer
runs under ``torch.utils.checkpoint`` (non-reentrant), as the reference
wraps its scanned body in ``jax.checkpoint(..., nothing_saveable)``: only
the layer's inputs are kept, and its forward runs again in the backward.
Prefill and decode take no gradient and run each layer once.

Full-sequence attention goes through the ``flash_attention`` kernel and
every norm through the ``rmsnorm`` kernel.  Each block's output is carried
to the next norm as a pending residual, which that norm adds in the same
launch (``layers.residual_norm``); :func:`run_stack` completes the stream
before it returns.  The ``vlm`` and ``audio`` families are dense backbones
(their frontends are stubs, ``models/frontends.py``); an ``moe`` layer
runs ``models/moe.py::moe_block`` in place of the MLP.  The ``hybrid``
family (zamba2) stacks Mamba2 layers and runs one weight-tied attention +
MLP block, ``params["shared"]``, after every ``hybrid_attn_period``-th
layer (:func:`shared_attn_apply`); as in the reference that block runs
outside the per-layer remat, and the pending residual carries across it.

Under an active :class:`~repro_torch.models.sharding.ShardCtx` (every
family) each rank runs its part of every layer on its blocks of the
weights (``sharding.shard_params``), as GSPMD partitions the reference's
program: each weight is first gathered over the FSDP axes its spec
names; the attention's projections are column- and its out-projection
row-parallel over the model axis when the head count divides it, else
every model rank computes Q and the output of its share of the rows (the
kernel's ``q_offset``) against K and V of the rows up to its share's
last, and the rows are gathered; the MLP's ``gate`` and ``up`` are
column- and ``down`` row-parallel; an MoE layer runs ``moe_block``'s
expert-parallel path; a Mamba1 layer runs channel-parallel and a Mamba2
layer head-parallel (``mamba.py``), the hybrid's weight-tied block as an
attention layer does.  The residual stream and the norms stay replicated
over the model axis.  A weight replicated over the model axis whose use
is split over it enters through ``copy_to``, so its gradient is summed
over the axis in the backward.  Every collective is issued under a
condition that holds alike on every rank (the config and the sequence
length), so remat's recompute issues them in the same order everywhere.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, resolve_device
from ..kernels.flash_attention import flash_attention
from . import mamba as mam
from .config import ModelConfig
from .layers import apply_rope, dense_init, normal, residual_norm, swiglu
from .moe import moe_block
from . import sharding as sh
from .sharding import P, ShardCtx

#: Families whose layers the port has not yet, and the ROADMAP item that
#: brings each (none: every family of the JAX package is ported).
NOT_PORTED: Dict[str, str] = {}
#: Families whose layers are attention + MLP (or attention + MoE)
ATTENTION_FAMILIES = ("dense", "vlm", "audio", "moe")


def check_family(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family this package cannot run
    (one listed in :data:`NOT_PORTED`)."""
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to the "
            f"PyTorch package yet; it comes with {NOT_PORTED[cfg.family]}")


# ---------------------------------------------------------------------------
# layer plan
# ---------------------------------------------------------------------------

def layer_plan(cfg: ModelConfig) -> Tuple[List[Dict[str, Any]],
                                          Dict[str, Any]]:
    """Static per-layer description (kind, cache slot, window, theta)."""
    plan = []
    full_rows = ring_rows = ssm_rows = 0
    for i in range(cfg.n_layers):
        if cfg.family == "ssm" or (cfg.family == "hybrid"):
            kind = cfg.ssm_variant or "mamba1"
            entry = {"kind": kind, "ssm_row": ssm_rows, "window": 0,
                     "theta": cfg.rope_theta}
            ssm_rows += 1
        elif cfg.family == "moe":
            entry = {"kind": "moe", "window": cfg.layer_window(i),
                     "theta": cfg.rope_theta}
        else:
            entry = {"kind": "attn", "window": cfg.layer_window(i),
                     "theta": cfg.rope_theta}
        if entry["kind"] in ("attn", "moe"):
            if cfg.local_global_period and cfg.layer_is_global_attn(i) \
                    and cfg.rope_theta_global:
                entry["theta"] = cfg.rope_theta_global
            if entry["window"] > 0:
                entry["cache"] = ("ring", ring_rows, entry["window"])
                ring_rows += 1
            else:
                entry["cache"] = ("full", full_rows)
                full_rows += 1
        plan.append(entry)
    # zamba2-style shared attention applications
    shared_at = []
    if cfg.hybrid_attn_period:
        shared_at = [i for i in range(cfg.n_layers)
                     if i % cfg.hybrid_attn_period
                     == cfg.hybrid_attn_period - 1]
    return plan, {"full": full_rows, "ring": ring_rows, "ssm": ssm_rows,
                  "shared_at": shared_at}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _attn_init(gen, cfg: ModelConfig, n: int, dtype, device):
    h, kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    p = {
        "wq": dense_init(gen, d, h * hd, n=n, dtype=dtype).reshape(n, d, h, hd),
        "wk": dense_init(gen, d, kv * hd, n=n, dtype=dtype).reshape(n, d, kv, hd),
        "wv": dense_init(gen, d, kv * hd, n=n, dtype=dtype).reshape(n, d, kv, hd),
        "wo": dense_init(gen, h * hd, d, n=n, dtype=dtype).reshape(n, h, hd, d),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((n, h, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((n, kv, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((n, kv, hd), dtype=dtype, device=device)
    return p


def _mlp_init(gen, cfg: ModelConfig, n: int, dtype):
    d, f = cfg.d_model, cfg.d_ff
    return {"gate": dense_init(gen, d, f, n=n, dtype=dtype),
            "up": dense_init(gen, d, f, n=n, dtype=dtype),
            "down": dense_init(gen, f, d, n=n, dtype=dtype)}


def _moe_init(gen, cfg: ModelConfig, n: int, dtype):
    """Router (float32, as the reference keeps it) and the experts'
    stacked ``(n, E, ...)`` weights, each ``N(0, 1) / sqrt(fan_in)``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": dense_init(gen, d, e, n=n, dtype=torch.float32),
            "e_gate": normal(gen, (n, e, d, f), float(d ** -0.5), dtype),
            "e_up": normal(gen, (n, e, d, f), float(d ** -0.5), dtype),
            "e_down": normal(gen, (n, e, f, d), float(f ** -0.5), dtype)}


def _mamba_init(gen, cfg: ModelConfig, n: int, dtype, device):
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    f32 = torch.float32
    if cfg.ssm_variant == "mamba2":
        nh, conv_dim = cfg.n_ssm_heads, di + 2 * N
        a0 = torch.log(torch.arange(1, nh + 1, dtype=f32, device=device))
        return {
            "in_proj": dense_init(gen, d, 2 * di + 2 * N + nh, n=n,
                                  dtype=dtype),
            "conv_w": dense_init(gen, cfg.ssm_conv, conv_dim, n=n,
                                 dtype=dtype),
            "conv_b": torch.zeros((n, conv_dim), dtype=dtype, device=device),
            "A_log": a0.expand(n, nh).contiguous(),
            "D": torch.ones((n, nh), dtype=f32, device=device),
            "dt_bias": torch.zeros((n, nh), dtype=f32, device=device),
            "norm_w": torch.ones((n, di), dtype=dtype, device=device),
            "out_proj": dense_init(gen, di, d, n=n, dtype=dtype),
        }
    a0 = torch.log(torch.arange(1, N + 1, dtype=f32, device=device))
    return {
        "in_proj": dense_init(gen, d, 2 * di, n=n, dtype=dtype),
        "conv_w": dense_init(gen, cfg.ssm_conv, di, n=n, dtype=dtype),
        "conv_b": torch.zeros((n, di), dtype=dtype, device=device),
        "x_proj": dense_init(gen, di, cfg.dt_rank + 2 * N, n=n, dtype=dtype),
        "dt_w": dense_init(gen, cfg.dt_rank, di, n=n, dtype=dtype),
        "dt_bias": torch.zeros((n, di), dtype=f32, device=device),
        "A_log": a0.expand(n, di, N).contiguous(),
        "D": torch.ones((n, di), dtype=f32, device=device),
        "out_proj": dense_init(gen, di, d, n=n, dtype=dtype),
    }


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random weights of the reference's shapes and types, drawn on
    ``device`` (the CUDA device by default) from ``torch.Generator`` seeded
    with ``seed``.  The draws differ from the reference's ``jax.random``
    ones; the tests take the reference's weights through
    :func:`repro_torch.convert.params_from_reference` instead."""
    check_family(cfg)
    device = resolve_device(device)
    if device.type == "meta":
        gen = _MetaGenerator()
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    n = cfg.n_layers
    vp = cfg.padded_vocab
    # phantom vocabulary rows (padded_vocab > vocab_size) are zero
    params: Dict[str, Any] = {
        "tok_embed": dense_init(gen, vp, cfg.d_model, dtype=dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    params["tok_embed"][cfg.vocab_size:] = 0
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, vp, dtype=dtype)
        params["lm_head"][:, cfg.vocab_size:] = 0

    norm = torch.ones((n, cfg.d_model), dtype=dtype, device=device)
    layers: Dict[str, Any] = {"ln1": norm}
    if cfg.family in ATTENTION_FAMILIES:
        layers.update(_attn_init(gen, cfg, n, dtype, device))
        layers["ln2"] = norm.clone()
        if cfg.family == "moe":
            layers.update(_moe_init(gen, cfg, n, dtype))
        else:
            layers.update(_mlp_init(gen, cfg, n, dtype))
    else:                                               # ssm, hybrid
        layers.update(_mamba_init(gen, cfg, n, dtype, device))
    params["layers"] = layers

    if cfg.hybrid_attn_period:
        # the weight-tied block: one set of weights, no layer axis
        shared = {"ln1": torch.ones((cfg.d_model,), dtype=dtype,
                                    device=device)}
        shared.update({k: v[0] for k, v in _attn_init(
            gen, cfg, 1, dtype, device).items()})
        shared["ln2"] = shared["ln1"].clone()
        shared.update({k: v[0] for k, v in _mlp_init(gen, cfg, 1,
                                                     dtype).items()})
        params["shared"] = shared
    return params


class _MetaGenerator:
    """Stands in for ``torch.Generator``, which has no meta device: the
    initialisers allocate on its ``device`` and draw nothing there."""
    device = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A leaf's shape and type, without its values (the reference's
    ``jax.ShapeDtypeStruct``); ``spec`` is its partition spec, where one
    is attached (``launch/pp_step.py``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Any = None


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """A :class:`ShapeDtype` for every leaf of :func:`init_params`, in the
    same tree, with nothing drawn or allocated (the reference's
    ``jax.eval_shape(init_params)``): the parameters are made on the meta
    device, so that kimi-k2's trillion parameters cost no memory, and out
    of sight of any dispatch mode (the dry run's counters): a shape read
    is no work of the step that asks for it."""
    from torch.utils._python_dispatch import _disable_current_modes
    from .._tree import tree_map
    with _disable_current_modes():
        whole = init_params(cfg, device="meta")
    return tree_map(lambda t: ShapeDtype(tuple(t.shape), t.dtype), whole)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _proj(x, w):
    """``x`` ``(b, s, d)`` @ ``w`` ``(d, heads, hd)`` -> ``(b, s, heads,
    hd)``."""
    b, s, d = x.shape
    return (x @ w.reshape(d, -1)).view(b, s, w.shape[1], w.shape[2])


def _proj_qkv(x, p, cfg, positions, theta, rows=None):
    """``x`` ``(b, s, d)`` -> q ``(b, s, H, hd)``, k and v ``(b, s, KV, hd)``,
    biased and (q, k) rotated; with ``rows`` (a slice of the sequence) q
    of those rows only."""
    xq, q_pos = (x, positions) if rows is None else \
        (x[:, rows], positions[:, rows])
    q, k, v = _proj(xq, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = apply_rope(q, q_pos, theta)
    k = apply_rope(k, positions, theta)
    return q, k, v


def _out_proj(o, wo):
    """``o`` ``(b, s, H, hd)`` @ ``wo`` ``(H, hd, d)`` -> ``(b, s, d)``."""
    b, s = o.shape[:2]
    return o.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])


def attn_block(x, p, cfg, ctx: ShardCtx, positions, window, theta):
    """Full-sequence causal attention through the ``flash_attention``
    kernel.  Returns ``(out, (k, v))`` for cache capture.

    The kernel takes ``(B, H, S, D)`` with strides, so the model's
    ``(b, s, H, hd)`` tensors go in as transposed views, and the output
    comes back in the same memory order.  Under an active context
    :func:`_attn_sharded` runs this rank's part."""
    if ctx is not None and ctx.active:
        return _attn_sharded(x, p, cfg, ctx, positions, window, theta)
    q, k, v = _proj_qkv(x, p, cfg, positions, theta)
    return _attend(q, k, v, p["wo"], window), (k, v)


def _attend(q, k, v, wo, window, q_offset: int = 0):
    """Causal attention of ``q`` ``(b, sq, H, hd)`` (query ``i`` at
    position ``q_offset + i``) over ``k, v`` ``(b, sk, KV, hd)`` through
    the kernel, then the out-projection ``wo``."""
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True, window=int(window),
                        q_offset=q_offset)
    return _out_proj(o.transpose(1, 2), wo)


def _kv_heads(h0: int, n_loc: int, group: int) -> Tuple[Any, int]:
    """``(index, group)``: the KV heads that query heads ``h0 .. h0 +
    n_loc - 1`` read (head ``h`` reads ``h // group``), as a slice or an
    index list, and the group size among the local heads."""
    if n_loc % group == 0:                 # whole groups
        return slice(h0 // group, h0 // group + n_loc // group), group
    if group % n_loc == 0:                 # inside one group
        return slice(h0 // group, h0 // group + 1), n_loc
    return [(h0 + j) // group for j in range(n_loc)], 1


def attn_mode(cfg, ctx: ShardCtx, s: int) -> str:
    """How :func:`_attn_sharded` splits an attention over ``s`` rows on
    the model axis: ``"heads"`` (the head count divides it), ``"rows"``
    (the sequence does), or ``"whole"`` (replicated)."""
    if ctx.tp in sh.axes_of(sh.use_specs(cfg, ctx)["wq"]):
        return "heads"
    nm = ctx.n(ctx.tp)
    return "whole" if s % nm or s < nm else "rows"


def _kv_index(cfg, ctx: ShardCtx) -> Any:
    """In the ``"heads"`` mode with the KV heads held whole: the KV heads
    that each model rank's ``(k, v)`` carries, concatenated in model-axis
    order (``_kv_heads``' choice per rank)."""
    nm = ctx.n(ctx.tp)
    n_loc, group = cfg.n_heads // nm, cfg.n_heads // cfg.n_kv_heads
    out: List[int] = []
    for m in range(nm):
        idx, _ = _kv_heads(m * n_loc, n_loc, group)
        out += list(range(cfg.n_kv_heads))[idx] if isinstance(idx, slice) \
            else idx
    return out


def kv_whole(k, cfg, ctx: ShardCtx, s: int, kind: str = "tp"):
    """A rank's keys or values ``(..., rows, heads, hd)`` of an attention
    over ``s`` rows under an active context, as :func:`_attn_sharded`
    returns them, made whole ``(..., s, KV, hd)`` on every rank of the
    model axis: the heads gathered over it (each KV head once, where
    several ranks hold one), or the rows of each rank's share gathered,
    or ``k`` itself when the attention ran replicated.  No gradient."""
    from ..launch import collectives as C
    mode = attn_mode(cfg, ctx, s)
    if mode == "whole":
        return k
    mesh, tp, nm = ctx.mesh, ctx.tp, ctx.n(ctx.tp)
    if mode == "rows":
        r0 = sh.coord(ctx, tp) * (s // nm)
        return C.all_gather(k.narrow(-3, r0, s // nm), mesh, tp, k.dim() - 3,
                            kind)
    k = C.all_gather(k, mesh, tp, k.dim() - 2, kind)
    if tp in sh.axes_of(sh.use_specs(cfg, ctx)["wk"]):
        return k
    held = _kv_index(cfg, ctx)
    first = torch.as_tensor([held.index(j) for j in range(cfg.n_kv_heads)],
                            device=k.device)
    return k.index_select(k.dim() - 2, first)


def _local_heads(w, bias, cfg, ctx: ShardCtx) -> Dict[str, Any]:
    """The projections and biases of this rank's ``H / tp`` query heads in
    the ``"heads"`` mode: ``w`` (the FSDP-gathered ``wq, wk, wv, wo``
    blocks) and ``bias`` as stored, with the KV weights held whole cut
    to the KV heads those query heads read and the biases (replicated
    over the model axis) to this rank's heads, through ``copy_to`` (the
    model ranks' cuts of one weight sum their gradients)."""
    from ..launch import collectives as C
    mesh, tp = ctx.mesh, ctx.tp
    nm, m = ctx.n(tp), sh.coord(ctx, tp)
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    n_loc = h // nm
    h0 = m * n_loc
    w, bias = dict(w), dict(bias)
    if tp in sh.axes_of(sh.use_specs(cfg, ctx)["wk"]):
        kv0 = m * (kvh // nm)
        bias.update({k: C.copy_to(bias[k], mesh, tp)[kv0:kv0 + kvh // nm]
                     for k in ("bk", "bv") if k in bias})
    else:                                  # KV held whole
        kv_idx, _ = _kv_heads(h0, n_loc, h // kvh)
        w.update({k: C.copy_to(w[k], mesh, tp)[:, kv_idx]
                  for k in ("wk", "wv")})
        bias.update({k: C.copy_to(bias[k], mesh, tp)[kv_idx]
                     for k in ("bk", "bv") if k in bias})
    if "bq" in bias:
        bias["bq"] = C.copy_to(bias["bq"], mesh, tp)[h0:h0 + n_loc]
    return {**w, **bias}


def _attn_sharded(x, p, cfg, ctx: ShardCtx, positions, window, theta):
    """This rank's part of :func:`attn_block` under an active context, on
    the stream ``x`` (this data shard's rows, replicated over the model
    axis); returns the whole attention output, replicated over the model
    axis, and this rank's ``(k, v)`` (in the sequence-sharded case those
    of the rows up to its share's last).

    When the head count divides the model axis the rank computes its
    ``H / tp`` heads: ``wq`` (and ``wk``, ``wv`` when the KV heads divide
    too) column-parallel, ``wo`` row-parallel and its partial output
    summed over the axis; KV weights held whole give the local query
    heads their global KV heads ``h // (H / KV)``.  Otherwise, when the
    sequence divides the axis, every rank computes Q of its contiguous
    share of the rows, K and V of the rows up to its share's last, the
    attention of its rows (query ``i`` at position ``offset + i``)
    against those keys, and ``wo`` on them; the rows are gathered (the
    reference's q-block sharding, ``transformer.py`` ``min_q_blocks``).
    A sequence that does not divide the axis leaves the attention
    replicated, as the reference's does."""
    from ..launch import collectives as C
    sp = sh.use_specs(cfg, ctx)
    mesh, tp = ctx.mesh, ctx.tp
    nm, m = ctx.n(tp), sh.coord(ctx, tp)
    w = {k: sh.fsdp_gather(p[k], sp[k], ctx)
         for k in ("wq", "wk", "wv", "wo")}
    bias = {k: p[k] for k in ("bq", "bk", "bv") if k in p}
    s = x.shape[1]
    mode = attn_mode(cfg, ctx, s)
    if mode == "heads":                        # heads over the model axis
        xin = C.copy_to(x, mesh, tp)
        q, k, v = _proj_qkv(xin, _local_heads(w, bias, cfg, ctx), cfg,
                            positions, theta)
        out = _attend(q, k, v, w["wo"], window)
        return C.sum_over(out, mesh, tp), (k, v)
    if mode == "whole":                        # replicated, as the reference
        q, k, v = _proj_qkv(x, {**w, **bias}, cfg, positions, theta)
        return _attend(q, k, v, w["wo"], window), (k, v)
    # sequence-sharded: the weights are replicated over the model axis and
    # each rank uses them on its rows, so their gradients sum over it
    xin = C.copy_to(x, mesh, tp)
    p = {k: C.copy_to(v, mesh, tp) for k, v in {**w, **bias}.items()}
    r0, r1 = m * (s // nm), (m + 1) * (s // nm)
    # the keys past this share's last row are masked for all of its rows,
    # so K and V are projected up to that row only
    q, k, v = _proj_qkv(xin[:, :r1], p, cfg, positions[:, :r1], theta,
                        rows=slice(r0, r1))
    out = _attend(q, k, v, p["wo"], window, q_offset=r0)
    return C.gather_rows(out, mesh, tp, 1), (k, v)


def mlp_block(x, p, cfg: Optional[ModelConfig] = None,
              ctx: Optional[ShardCtx] = None):
    """SwiGLU MLP.  Under an active context: ``gate`` and ``up``
    column-parallel and ``down`` row-parallel over the model axis (when
    ``d_ff`` divides it; else replicated), after their FSDP gathers."""
    if ctx is None or not ctx.active:
        return swiglu(x, p["gate"], p["up"], p["down"])
    from ..launch import collectives as C
    sp = sh.use_specs(cfg, ctx)
    gate, up, down = (sh.fsdp_gather(p[k], sp[k], ctx)
                      for k in ("gate", "up", "down"))
    if ctx.tp not in sh.axes_of(sp["gate"]):
        return swiglu(x, gate, up, down)
    y = swiglu(C.copy_to(x, ctx.mesh, ctx.tp), gate, up, down)
    return C.sum_over(y, ctx.mesh, ctx.tp)


def shared_attn_apply(x, pending, shared, cfg: ModelConfig, ctx: ShardCtx,
                      positions):
    """The hybrid's weight-tied block on the stream ``x`` plus the previous
    layer's ``pending`` output: attention (full, causal, the config's
    theta) and MLP, each behind its norm.  Returns ``(x, pending, (k,
    v))``: the MLP's output is left pending for the next norm, as a
    layer's is."""
    x, h = residual_norm(x, pending, shared["ln1"], cfg.norm_eps)
    a, kv = attn_block(h, shared, cfg, ctx, positions, 0, cfg.rope_theta)
    x, h = residual_norm(x, a, shared["ln2"], cfg.norm_eps)
    return x, mlp_block(h, shared, cfg, ctx), kv


def moe_mlp(x, p, cfg: ModelConfig, ctx: ShardCtx, **knobs):
    """The MoE block of a layer ``p`` on ``x`` ``(b, s, d)``.  ``knobs``
    are ``moe_block``'s ``f32_combine`` and ``gather_dispatch``: prefill
    and training pass the config's, decode leaves the defaults, as the
    reference does.

    Under an active context, ``moe_block``'s expert-parallel path with the
    reference's arguments (``mesh``, ``data_axes=ctx.dp``,
    ``model_axis=ctx.tp``, ``fsdp``), on the layout it wants
    (``moe.shard_moe_params``): when the experts do not divide the model
    axis the spec holds them whole over it, so this rank's cut of the
    zero-padded expert dim is taken here (through ``copy_to``, the model
    ranks' cuts of the one weight summing their gradients); an FSDP cut
    of ``f`` over other axes than ``ctx.dp`` is gathered here."""
    moe_p = {"router": p["router"], "gate": p["e_gate"], "up": p["e_up"],
             "down": p["e_down"]}
    kw = dict(k=cfg.experts_per_token, n_experts=cfg.n_experts,
              capacity_factor=cfg.capacity_factor, **knobs)
    if ctx is None or not ctx.active:
        return moe_block(x, moe_p, **kw)
    from ..launch import collectives as C
    from .moe import pad_experts
    sp = sh.use_specs(cfg, ctx)
    fsdp = sh.spec_axes(sp["e_gate"][2]) == tuple(ctx.dp) and bool(ctx.fsdp)
    nm = ctx.n(ctx.tp)
    for name, key in (("gate", "e_gate"), ("up", "e_up"),
                      ("down", "e_down")):
        wt = moe_p[name]
        if not fsdp:
            wt = sh.fsdp_gather(wt, sp[key], ctx)
        if ctx.tp not in sh.axes_of(sp[key]):
            m = sh.coord(ctx, ctx.tp)
            wt = pad_experts(C.copy_to(wt, ctx.mesh, ctx.tp), nm)
            per = wt.shape[0] // nm
            wt = wt[m * per:(m + 1) * per]
        moe_p[name] = wt
    return moe_block(x, moe_p, mesh=ctx.mesh, data_axes=ctx.dp,
                     model_axis=ctx.tp, fsdp=fsdp, **kw)


# ---------------------------------------------------------------------------
# forward (prefill): a loop over layers
# ---------------------------------------------------------------------------

def _residual_spec(ctx: ShardCtx, cfg=None) -> P:
    """Spec of the residual stream ``(b, s, d)``: the batch over the data
    axes, and with ``cfg.seq_shard_residuals`` the sequence over the model
    axis (Megatron-style sequence parallelism), as the reference's.  The
    port's layers keep the stream replicated over the model axis whatever
    this says (no shipped config sets ``seq_shard_residuals``): only the
    layout of the saved activations would differ, not the result."""
    if cfg is not None and cfg.seq_shard_residuals:
        return P(ctx.dp if ctx.dp else None, ctx.tp, None)
    return P(ctx.dp if ctx.dp else None, None, None)


def _layer_body(x, pending, lp, cfg: ModelConfig, ctx: ShardCtx, entry,
                positions):
    """One layer on the residual stream ``x`` plus the previous layer's
    ``pending`` output (None before the first layer).  Returns ``(x,
    pending, cache_ys)``: the stream so far, this layer's last block output
    (not yet added), and the layer's ``(k, v)`` or ``(ssm state, conv
    tail)``."""
    x, h = residual_norm(x, pending, lp["ln1"], cfg.norm_eps)
    if entry["kind"] in ("attn", "moe"):
        a, kv_cache = attn_block(h, lp, cfg, ctx, positions, entry["window"],
                                 entry["theta"])
        x, h = residual_norm(x, a, lp["ln2"], cfg.norm_eps)
        if entry["kind"] == "moe":
            m = moe_mlp(h, lp, cfg, ctx,
                        f32_combine=cfg.moe_combine_f32_materialize,
                        gather_dispatch=cfg.moe_gather_dispatch)
        else:
            m = mlp_block(h, lp, cfg, ctx)
        return x, m, kv_cache
    y, (hstate, conv_tail) = mam.BLOCKS[entry["kind"]](h, lp, cfg, ctx=ctx)
    return x, y, (hstate, conv_tail)


def layer_params(params, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s slice of the stacked ``params["layers"]``, or its dict
    when ``params["layers"]`` is a list of per-layer dicts."""
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        return layers[i]
    return {k: v[i] for k, v in layers.items()}


def _takes_grad(x, params) -> bool:
    """Whether a gradient is being taken through the stack: grad mode on,
    and the input or the first layer's parameters require one."""
    if not torch.is_grad_enabled():
        return False
    return x.requires_grad or any(
        t.requires_grad for t in layer_params(params, 0).values())


def _remat_layer(x, pending, lp, cfg, ctx, entry, positions):
    """:func:`_layer_body` without its cache output, for the checkpoint."""
    x, pending, _ = _layer_body(x, pending, lp, cfg, ctx, entry, positions)
    return x, pending


def run_stack(x, params, cfg: ModelConfig, ctx: ShardCtx, positions,
              collect_cache: bool = False):
    """``x`` ``(b, s, d)`` -> ``(x, caches)``; with ``collect_cache`` the
    caches are the per-layer ``(k, v)`` or ``(ssm state, conv tail)``
    stacked over layers (the reference's scan outputs), else ``()``.

    A hybrid config runs the shared block after each layer in
    ``meta["shared_at"]``, outside the layer's remat, as the reference runs
    it between its scanned segments; its caches are then ``((ssm, conv),
    (k, v))`` with the shared block's ``(k, v)`` stacked over its
    applications (the layers' caches alone when it runs nowhere).

    Under an active context ``x`` is this data shard's rows and ``params``
    this rank's blocks; the caches are each rank's own: an attention
    layer's ``(k, v)`` as :func:`attn_block` returns them (:func:`kv_whole`
    puts them together), a Mamba layer's state and conv rows as its
    blocks of the decode cache."""
    check_family(cfg)
    plan, meta = layer_plan(cfg)
    shared_at = set(meta["shared_at"])
    remat = cfg.remat and not collect_cache and _takes_grad(x, params)
    caches, shared_kv = [], []
    pending = None
    for i, entry in enumerate(plan):
        lp = layer_params(params, i)
        if remat:
            x, pending = checkpoint(_remat_layer, x, pending, lp, cfg, ctx,
                                    entry, positions, use_reentrant=False)
        else:
            x, pending, c = _layer_body(x, pending, lp, cfg, ctx, entry,
                                        positions)
            if collect_cache:
                caches.append(c)
        if i in shared_at:
            x, pending, kv = shared_attn_apply(x, pending, params["shared"],
                                               cfg, ctx, positions)
            if collect_cache:
                shared_kv.append(kv)
    if pending is not None:
        x = x + pending
    if not collect_cache:
        return x, ()
    stacked = tuple(torch.stack(parts, 0) for parts in zip(*caches))
    if shared_at:
        return x, (stacked, tuple(torch.stack(parts, 0)
                                  for parts in zip(*shared_kv)))
    return x, stacked

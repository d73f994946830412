"""Spec trees of every (arch x shape) dry-run cell: each leaf's global
shape, type and partition spec, with nothing allocated.

Port of the JAX package's ``launch/specs.py``.  The reference attaches a
``NamedSharding`` to each ``jax.ShapeDtypeStruct`` so that ``jax.jit(step)
.lower(**specs)`` needs no other sharding; the port's leaves are
:class:`~repro_torch.models.transformer.ShapeDtype` (shape, torch type,
:class:`~repro_torch.models.sharding.P`), built from ``param_shapes``,
``tree_pspecs`` and ``model.cache_specs`` on the meta device.  A rank of a
mesh stores the block of each leaf that its spec gives it
(:func:`shard_sizes`, :func:`blocks`); the training steps store
their state so (``launch/steps.py``, ``launch/pp_step.py``), and the dry
run (``launch/dryrun.py``) runs them on meta tensors of those blocks.

ZeRO-1 (``opt_spec(..., zero1=True)``) keeps the parameters as their
specs lay them out and shards AdamW's float32 moments over the axis named
``"data"`` as well (literally that axis: on the multi-pod mesh the
``pod`` axis does not shard them), on the largest dim that no axis cuts
yet and that the axis divides, the first on a tie (:func:`z1_spec`).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from .._tree import tree_map
from ..models import model as M
from ..models.config import ModelConfig, ShapeSpec
from ..models.sharding import P, ShardCtx, spec_axes, tree_pspecs
from ..models.transformer import ShapeDtype, param_shapes
from ..optim.adamw import AdamW, AdamWState

#: The axis ZeRO-1 shards the moments over (the reference names it so).
ZERO1_AXIS = "data"


def largest_dividing(shape, parts, n: int) -> Optional[int]:
    """The largest dim among ``parts``' free (None) dims that ``n``
    divides, the first on a tie; None when there is none."""
    cands = [i for i, ax in enumerate(parts) if ax is None
             and shape[i] % n == 0]
    return max(cands, key=lambda i: shape[i]) if cands else None


def z1_spec(shape, spec, n: int, axis: str = ZERO1_AXIS) -> P:
    """``spec`` (padded with None to the rank of ``shape``) with ``axis``
    (of size ``n``) added on :func:`largest_dividing`'s dim, unless the
    spec names ``axis`` already or no free dim divides: the reference's
    ZeRO-1 rule for a moment."""
    parts = list(spec or ()) + [None] * (len(shape) - len(spec or ()))
    used = {a for ax in parts for a in spec_axes(ax)}
    if axis not in used:
        i = largest_dividing(shape, parts, n)
        if i is not None:
            parts[i] = axis
    return P(*parts)


def zero1_dim(spec: P, z1: P, axis: str = ZERO1_AXIS) -> Optional[int]:
    """The dim a moment's ZeRO-1 spec ``z1`` cuts over ``axis`` that its
    parameter's ``spec`` does not: None when they cut alike."""
    for i, ax in enumerate(z1):
        before = spec[i] if i < len(spec) else None
        if axis in spec_axes(ax) and axis not in spec_axes(before):
            return i
    return None


def _attach(shapes, specs):
    """The :class:`ShapeDtype` tree ``shapes`` with each leaf's spec from
    the tree ``specs`` (keyed alike)."""
    if isinstance(shapes, dict):
        return {k: _attach(v, specs[k]) for k, v in shapes.items()}
    return ShapeDtype(tuple(shapes.shape), shapes.dtype, specs)


def params_spec(cfg: ModelConfig, ctx: ShardCtx):
    """Every parameter's global shape and type (``init_params``' tree),
    with its spec under ``ctx`` (``tree_pspecs``; None without a mesh)."""
    shapes = param_shapes(cfg)
    if ctx.mesh is None:
        return shapes
    return _attach(shapes, tree_pspecs(shapes, cfg, ctx))


def opt_spec(cfg: ModelConfig, ctx: ShardCtx, opt: AdamW, *,
             zero1: bool = False) -> AdamWState:
    """AdamW's state for :func:`params_spec`: the step, replicated, and the
    float32 moments ``m``, ``v`` with the parameters' specs, or with
    ZeRO-1's (:func:`z1_spec`) when ``zero1``.  ``opt`` is the optimizer
    the state belongs to (its state's shapes do not depend on it)."""
    del opt
    p = params_spec(cfg, ctx)
    f32 = torch.float32
    if ctx.mesh is None:
        m = tree_map(lambda s: ShapeDtype(s.shape, f32), p)
        return AdamWState(ShapeDtype((), torch.int32), m, m)
    if zero1:
        n = ctx.n(ZERO1_AXIS)
        m = tree_map(lambda s: ShapeDtype(s.shape, f32,
                                          z1_spec(s.shape, s.spec, n)), p)
    else:
        m = tree_map(lambda s: ShapeDtype(s.shape, f32, s.spec), p)
    return AdamWState(step=ShapeDtype((), torch.int32, P()), m=m,
                      v=tree_map(lambda s: s, m))


def batch_spec(cfg: ModelConfig, shape: ShapeSpec,
               ctx: ShardCtx) -> Dict[str, Any]:
    """The global batch of a cell: int32 ``tokens`` (a vlm's text after
    its image tokens, and its bfloat16 ``img_embeds``), and ``labels`` for
    a training cell, each split over the data axes."""
    dp = P(ctx.dp if ctx.dp else None)
    spec = dp if ctx.mesh is not None else None
    b, s = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {}
    if cfg.frontend == "vlm":
        out["tokens"] = ShapeDtype((b, s - cfg.n_img_tokens), torch.int32,
                                   spec)
        out["img_embeds"] = ShapeDtype(
            (b, cfg.n_img_tokens, cfg.d_model), torch.bfloat16,
            P(dp[0], None, None) if spec is not None else None)
    else:
        out["tokens"] = ShapeDtype((b, s), torch.int32, spec)
    if shape.kind == "train":
        out["labels"] = ShapeDtype((b, s), torch.int32, spec)
    return out


def cache_spec(cfg: ModelConfig, shape: ShapeSpec,
               ctx: ShardCtx) -> Dict[str, ShapeDtype]:
    """The decode cache of a cell (``init_cache`` at its global batch and
    length) with ``model.cache_specs``' layout."""
    whole = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                         device="meta")
    if ctx.mesh is None:
        return {k: ShapeDtype(tuple(v.shape), v.dtype)
                for k, v in whole.items()}
    specs = M.cache_specs(cfg, ctx, shape.global_batch, shape.seq_len)
    return {k: ShapeDtype(tuple(v.shape), v.dtype, specs[k])
            for k, v in whole.items()}


def decode_inputs(cfg: ModelConfig, shape: ShapeSpec,
                  ctx: ShardCtx) -> Tuple[ShapeDtype, Dict[str, ShapeDtype],
                                          ShapeDtype]:
    """``(token, cache, pos)`` of a decode cell: the ``(b, 1)`` token over
    the data axes when the batch divides them, the cache, the position."""
    b = shape.global_batch
    nd = 1
    for a in (ctx.dp or ()):
        nd *= ctx.n(a)
    if ctx.mesh is None:
        tok_spec = pos_spec = None
    else:
        tok_spec = P(ctx.dp) if (b % max(nd, 1) == 0 and nd > 1) \
            else P(None)
        pos_spec = P()
    token = ShapeDtype((b, 1), torch.int32, tok_spec)
    return token, cache_spec(cfg, shape, ctx), ShapeDtype((), torch.int32,
                                                          pos_spec)


# ---------------------------------------------------------------------------
# a rank's blocks
# ---------------------------------------------------------------------------

def block_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a ``shape`` leaf under ``spec``
    (``ValueError`` when a dim does not divide over its axes)."""
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if spec is not None and i < len(spec) else None
        n = 1
        for a in spec_axes(entry):
            n *= mesh.shape[a]
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {n} ({entry!r})")
        out.append(dim // n)
    return tuple(out)


def shard_sizes(spec_tree, mesh, rank: int):
    """The bytes ``rank`` of ``mesh`` stores for each leaf of a tree of
    :class:`ShapeDtype` under its spec, in the same tree (every rank's
    block of a leaf has one size: ``rank`` is checked to be on the
    mesh)."""
    mesh.coords(rank)

    def size(s):
        elems = math.prod(block_shape(s.shape, s.spec, mesh))
        return elems * torch.empty((), dtype=s.dtype).element_size()
    return tree_map(size, spec_tree)


def blocks(spec_tree, mesh, device="meta", lead: int = 0):
    """Zeros of one rank's block of each :class:`ShapeDtype` leaf of
    ``spec_tree`` (or of one leaf) on ``device``, ``lead`` leading dims
    dropped (a pipeline's stored stage has no pipe dim): the meta device
    allocates nothing."""
    return tree_map(lambda s: torch.zeros(
        block_shape(s.shape, s.spec, mesh)[lead:], dtype=s.dtype,
        device=device), spec_tree)


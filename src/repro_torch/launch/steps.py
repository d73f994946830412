"""Train, prefill and decode steps used by the launchers (``train.py``,
``generate.py``).

The reference wraps these in ``jax.jit``; PyTorch runs them eagerly, so a
step is a plain closure over the config.  Under an active context the
train step runs on one rank of the mesh, on its blocks of the parameters
(``models/sharding.py::shard_params``) and its rows of the batch
(:func:`shard_batch`); the collectives that GSPMD inserts into the
reference's step are written out here and in the model's layers.  With
``zero1`` (no FSDP) the rank keeps AdamW's moments as its ZeRO-1 blocks
(``launch/specs.py::opt_spec(zero1=True)``, :func:`init_sharded`) and
takes ZeRO-1's step from ``launch/zero1.py``: the gradients are
reduce-scattered over the data axis, AdamW updates this rank's block of
each parameter, and the blocks are gathered back.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .._tree import leaves, structure, tree_map, unflatten
from ..models import model as M
from ..models.config import ModelConfig
from ..models import sharding as sh
from ..models.sharding import ShardCtx
from ..optim.adamw import AdamW, AdamWState
from . import collectives as C
from . import specs as SP
from . import zero1 as Z


def _leaves_for_grad(params) -> tuple:
    """``(p, flat)``: the parameters as the loss takes them, every tensor a
    detached leaf that requires a gradient and shares its storage, with
    ``p["layers"]`` a list of per-layer dicts; and those leaves in a fixed
    order: every entry but ``layers`` in the reference's leaf order (keys
    sorted, recursively: a hybrid's ``shared`` block is a dict of its
    own), then layer by layer, keys sorted.

    Slicing a stacked ``(L, ...)`` leaf inside the graph would make the
    backward of every slice a zero tensor of the whole stack's size (four
    of 815 M elements at qwen2-7b's width and four layers); per-layer
    leaves give each layer a gradient of its own size."""
    top = tree_map(lambda v: v.detach().requires_grad_(),
                   {k: v for k, v in params.items() if k != "layers"})
    stacked = params["layers"]
    n = next(iter(stacked.values())).shape[0]
    layers = [{k: v[i].detach().requires_grad_() for k, v in stacked.items()}
              for i in range(n)]
    flat = leaves(top)
    flat += [lp[k] for lp in layers for k in sorted(lp)]
    return dict(top, layers=layers), flat


def _to_device(batch: Dict[str, Any], device: torch.device) -> dict:
    """The loader's NumPy batch on ``device``: integer arrays (tokens,
    labels) as int64 tensors, float arrays (a vlm's ``img_embeds``) in
    their own type."""
    out = {}
    for k, v in batch.items():
        t = v.to(device) if isinstance(v, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(v)).to(device)
        out[k] = t if t.is_floating_point() else t.long()
    return out


def _named(tree) -> list:
    """``(leaf name, tensor)`` of every leaf of a parameter tree (layers
    stacked), in the tree's own order: a nested dict's leaves (the
    ``layers``, a hybrid's ``shared`` block) by their own names."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _named(v)
        else:
            out.append((k, v))
    return out


def zero1_dims(cfg: ModelConfig, ctx: ShardCtx):
    """The tree of the parameters (layers stacked) with, for each leaf, the
    dim its moments' ZeRO-1 spec cuts over the data axis
    (``specs.opt_spec(zero1=True)``), or None where they stay whole (no
    free dim divides): where ``zero1.scatter`` cuts the gradient and
    ``zero1.update`` the parameter (without FSDP no parameter is cut over
    the data axis already)."""
    return Z.block_dims(SP.params_spec(cfg, ctx),
                        SP.opt_spec(cfg, ctx, None, zero1=True).m,
                        SP.ZERO1_AXIS)


def init_sharded(params, cfg: ModelConfig, ctx: ShardCtx) -> AdamWState:
    """AdamW's zero state for a rank's parameter blocks ``params`` under
    ZeRO-1: each moment its block under ``specs.opt_spec(zero1=True)``, a
    tensor of its own."""
    return Z.init_state(SP.blocks(SP.opt_spec(cfg, ctx, None, zero1=True).m,
                                  ctx.mesh, leaves(params)[0].device))


def _zero1_sync(acc, dims, cfg: ModelConfig, ctx: ShardCtx):
    """ZeRO-1's gradient reduction of a rank's float32 accumulators: summed
    over every data axis but the ZeRO-1 one (as :func:`sync_grads`), then
    ``zero1.scatter`` over it (sums).  Returns the tree of those blocks
    and whole gradients; the tree ``acc`` is emptied, so that each
    accumulator is freed as soon as its blocks are sent."""
    specs = sh.use_specs(cfg, ctx)
    for a in ctx.dp:
        if a != SP.ZERO1_AXIS:
            C.all_reduce([g for name, g in _named(acc)
                          if a not in sh.axes_of(specs[name])], ctx.mesh, a,
                         "sum", "data")
    treedef, flat = structure(acc), leaves(acc)
    _release(acc)               # the accumulators live in ``flat`` alone now
    return unflatten(treedef, Z.scatter(flat, leaves(dims), ctx.mesh,
                                        SP.ZERO1_AXIS, "sum"))


def _release(tree) -> None:
    """Empty every dict of ``tree`` in place, dropping its references to
    the tensors (their holders elsewhere keep them)."""
    for v in tree.values():
        if isinstance(v, dict):
            _release(v)
    tree.clear()


def _zero1_sq_norm(grads, dims, cfg: ModelConfig,
                   ctx: ShardCtx) -> torch.Tensor:
    """The squared norm of the whole gradient from a rank's ZeRO-1 blocks
    (:func:`_zero1_sync`), the same bits on every rank: each leaf's
    float32 sum of squares, the leaves grouped by the axes that cut what
    the rank holds (its spec's, and the data axis for a block); a group's
    sum is reduced over its axes other than the data axis, then, over the
    data axis, gathered and folded in coordinate order; the groups are
    added in sorted order."""
    specs = sh.use_specs(cfg, ctx)
    groups = {}
    names = [n for n, _ in _named(tree_map(lambda g: g, grads))]
    for name, g, d in zip(names, leaves(grads), leaves(dims)):
        axes = set(sh.axes_of(specs[name]))
        if d is not None:
            axes.add(SP.ZERO1_AXIS)
        g = g.float()
        groups.setdefault(tuple(sorted(axes)), []).append(torch.sum(g * g))
    total = 0
    for axes in sorted(groups):
        part = torch.stack(groups[axes]).sum()
        for a in axes:
            if a == SP.ZERO1_AXIS:
                part = Z.fold(part[None], ctx.mesh, a)[0]
            else:
                C.all_reduce([part], ctx.mesh, a, "sum",
                             "tp" if a == ctx.tp else "data")
        total = total + part
    return total


def sync_grads(grads, cfg: ModelConfig, ctx: ShardCtx) -> None:
    """Sum, in place, each gradient of a rank's blocks (the tree of the
    parameters, layers stacked) over every data axis that its spec does
    not name: a leaf replicated over a data axis holds that data shard's
    part of its gradient, while an FSDP leaf's gather already summed its
    gradient over the axis in the backward.  (Over the model axis the
    layers already summed, through ``copy_to``, every leaf whose use they
    split.)  One bucketed all-reduce per axis."""
    if ctx is None or not ctx.active:
        return
    specs = sh.use_specs(cfg, ctx)
    for a in ctx.dp:
        part = [g for name, g in _named(grads)
                if a not in sh.axes_of(specs[name])]
        C.all_reduce(part, ctx.mesh, a, "sum", "data")


def grad_sq_norm(grads, cfg: ModelConfig, ctx: ShardCtx) -> torch.Tensor:
    """The squared norm of the whole model's gradient from a rank's blocks
    (after :func:`sync_grads`), the same bits on every rank: the leaves'
    float32 sums of squares added per set of axes their specs name, each
    such sum reduced over those axes (a leaf replicated over an axis
    counts once), and the sets folded in sorted order."""
    specs = sh.use_specs(cfg, ctx)
    groups = {}
    for name, g in _named(grads):
        axes = tuple(sorted(set(sh.axes_of(specs[name]))))
        g = g.float()
        groups.setdefault(axes, []).append(torch.sum(g * g))
    total = 0
    for axes in sorted(groups):
        part = torch.stack(groups[axes]).sum()
        for a in axes:
            C.all_reduce([part], ctx.mesh, a, "sum",
                         "tp" if a == ctx.tp else "data")
        total = total + part
    return total


def shard_batch(batch: Dict[str, Any], ctx: ShardCtx, rank: int,
                n_micro: int = 1) -> Dict[str, Any]:
    """``rank``'s rows of a global batch for :func:`make_train_step` under
    ``ctx``: of each of the ``n_micro`` microbatches of consecutive rows
    (the reference's split), the block of its data coordinates (the data
    axes major to minor), so that the step's microbatch ``j`` on every
    data rank together is the reference's microbatch ``j``."""
    n, idx = 1, 0
    c = ctx.mesh.coords(rank)
    for a in ctx.dp:
        idx = idx * ctx.n(a) + c[a]
        n *= ctx.n(a)
    out = {}
    for k, v in batch.items():
        rows = v.shape[0]
        if rows % (n_micro * n):
            raise ValueError(f"{rows} rows do not split into {n_micro} "
                             f"microbatches over {n} data ranks")
        per = rows // (n_micro * n)
        v = v.reshape((n_micro, n, per) + tuple(v.shape[1:]))[:, idx]
        out[k] = v.reshape((n_micro * per,) + tuple(v.shape[2:]))
    return out


def make_train_step(cfg: ModelConfig, ctx: ShardCtx, opt: AdamW,
                    n_micro: int = 1, *, zero1: bool = False):
    """Microbatch-accumulation training step (Pipette's ``bs_micro``
    knob), as the reference's.

    ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss": loss})``: the batch (the loader's NumPy arrays) goes to the
    parameters' device and splits into ``n_micro`` microbatches of
    consecutive rows; each one's forward and backward (each layer under
    remat when the config asks) adds its gradients, cast to float32, into
    float32 accumulators of the parameters' stacked shapes, which are
    divided by ``n_micro`` (with ``n_micro == 1`` the cast gradients are
    used as they are); then one AdamW update.  The loss is the microbatch
    losses' mean.

    Under an active context ``params`` and ``opt_state`` are this rank's
    blocks and ``batch`` its rows (:func:`shard_batch`); the accumulators
    take the blocks' shapes, each gradient is summed once over the data
    axes that still hold part of it (:func:`sync_grads`), the grad clip
    takes the whole model's norm (:func:`grad_sq_norm`), and the loss is
    the global batch's.

    ``zero1`` (an active context without FSDP, whose data axes include
    ``"data"``) is the layout of the reference's ``opt_spec(zero1=True)``:
    ``params`` are the rank's blocks as without it, ``opt_state`` holds
    the moments as ZeRO-1 blocks (:func:`init_sharded`); the accumulators
    are reduce-scattered over the data axis (:func:`_zero1_sync`), the
    clip takes :func:`_zero1_sq_norm`, AdamW updates the rank's block of
    each parameter, and the new blocks are gathered over the data axis
    (kind ``zero1``).  Leaves that the data axis does not divide stay
    whole, with whole moments."""
    if n_micro < 1:
        raise ValueError(f"n_micro must be at least 1, got {n_micro}")
    dims = None
    if zero1:
        if ctx is None or not ctx.active or ctx.fsdp \
                or SP.ZERO1_AXIS not in ctx.dp:
            raise ValueError("zero1 needs an active ShardCtx without fsdp "
                             f"whose data axes include {SP.ZERO1_AXIS!r}")
        dims = zero1_dims(cfg, ctx)

    def micro_grads(params, mb, acc, first: bool):
        p, flat = _leaves_for_grad(params)
        loss, _ = M.loss_fn(p, cfg, ctx, mb)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        # the accumulators in the order of ``flat``
        targets = leaves({k: v for k, v in acc.items() if k != "layers"})
        targets += [acc["layers"][k][i]
                    for i in range(len(p["layers"]))
                    for k in sorted(acc["layers"])]
        for t, g in zip(targets, grads):
            if g is None:                  # not reached by the loss
                if first:
                    t.zero_()
            elif first:
                t.copy_(g)
            else:
                t.add_(g.float())
        return loss.detach()

    def train_step(params, opt_state: AdamWState, batch: Dict[str, Any]):
        device = params["tok_embed"].device
        batch = _to_device(batch, device)
        acc = tree_map(lambda v: torch.empty(v.shape, dtype=torch.float32,
                                             device=device), params)
        if n_micro == 1:
            loss = micro_grads(params, batch, acc, True)
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % n_micro:
                raise ValueError(f"batch of {rows} rows does not split into "
                                 f"{n_micro} microbatches")
            size = rows // n_micro
            lsum = torch.zeros((), dtype=torch.float32, device=device)
            for j in range(n_micro):
                mb = {k: v[j * size:(j + 1) * size] for k, v in batch.items()}
                lsum = lsum + micro_grads(params, mb, acc, j == 0)
            div = torch.full((), float(n_micro), dtype=torch.float32,
                             device=device)
            for t in leaves(acc):
                t.div_(div)
            loss = lsum / div
        sq_norm = None
        if dims is not None:
            return _zero1_update(params, opt_state, acc, loss)
        if ctx is not None and ctx.active:
            sync_grads(acc, cfg, ctx)
            if opt.grad_clip > 0:
                sq_norm = grad_sq_norm(acc, cfg, ctx)
        new_params, new_opt = opt.update(acc, opt_state, params,
                                         sq_norm=sq_norm)
        return new_params, new_opt, {"loss": loss}

    def _zero1_update(params, opt_state, acc, loss):
        grads = _zero1_sync(acc, dims, cfg, ctx)
        del acc
        sq_norm = (_zero1_sq_norm(grads, dims, cfg, ctx)
                   if opt.grad_clip > 0 else None)
        new_params, new_opt = Z.update(opt, grads, opt_state, params, dims,
                                       ctx.mesh, SP.ZERO1_AXIS, sq_norm)
        return new_params, new_opt, {"loss": loss}

    return train_step


def make_prefill_step(cfg: ModelConfig, ctx: ShardCtx):
    def prefill_step(params, inputs: Dict[str, Any], **kw):
        """``(last_token_logits, cache)`` of ``inputs``' ``tokens`` (and
        ``img_embeds``).  ``kw`` goes to ``prefill`` (``batch`` under an
        active context)."""
        logits, cache = M.prefill(params, cfg, ctx, inputs["tokens"],
                                  inputs.get("img_embeds"), **kw)
        return logits, cache
    return prefill_step


def greedy_token(logits, cfg: ModelConfig, ctx: ShardCtx) -> torch.Tensor:
    """The greedy next token ``(b, 1)`` of a decode step's logits (under an
    active context this rank's vocabulary block): the lowest index among
    the largest logits, ``jnp.argmax``'s rule, over the whole vocabulary.
    Under a context the largest value is taken over the model axis
    (``max_over``), then the least global index among the blocks that
    reach it (a ``max_over`` of its negation): every model rank gets the
    same token."""
    cut = M._vocab_cut(cfg, ctx)
    if cut is None:
        return torch.argmax(logits, dim=-1)[:, None]
    v0, _ = cut
    mesh, tp = ctx.mesh, ctx.tp
    lf = logits.float()                   # exact for bfloat16 logits
    top = lf.amax(dim=-1)
    best = C.max_over(top, mesh, tp, "decode")
    idx = v0 + torch.argmax(lf, dim=-1)
    cand = torch.where(top == best, idx, torch.full_like(idx, cfg.padded_vocab))
    return (-C.max_over(-cand, mesh, tp, "decode"))[:, None]


def make_decode_step(cfg: ModelConfig, ctx: ShardCtx):
    def serve_step(params, cache, token, pos: int, **kw):
        """Greedy step: returns ``(next_token (b, 1), logits, cache)``; the
        cache is updated in place.  ``kw`` goes to ``decode_step``
        (``batch``, ``seq_len`` under an active context)."""
        logits, cache = M.decode_step(params, cfg, ctx, token, cache, pos,
                                      **kw)
        return greedy_token(logits, cfg, ctx), logits, cache
    return serve_step

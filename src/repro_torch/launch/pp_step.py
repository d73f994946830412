"""Pipeline-parallel train step: a Pipette (pp, dp) configuration as
ranks.

Port of the JAX package's ``launch/pp_step.py``.  The reference lowers one
SPMD program on the production mesh, with the model axis as the pipeline
axis by default; here every rank runs :func:`make_pp_train_step`'s step on
its own stage.  A dense layer takes the port's path, as
``transformer.py::attn_block`` does: both norms through the ``rmsnorm``
kernel and the attention through the ``flash_attention`` kernel (its
``FlashAttentionFn`` under a gradient), where the reference calls the
plain ``chunked_attention`` (kept in ``models/attention.py`` as the
kernel's oracle).  On the CPU the wrappers' plain versions run.

Each rank stores what the spec trees give it, the reference's layout:
its stage's layers whole (stages over the pipe axis), its FSDP block of
each shared leaf (embedding, final norm, head: over the data axis, on the
largest dim it divides) and its ZeRO-1 block of every AdamW moment (over
the data axis too, on the largest free dim it divides).  A step gathers
the shared leaves its stage uses (the embedding on the first stage, the
final norm and head on the last) before the pipeline runs,
reduce-scatters every gradient over the data axis after the pipe sum (the
data mean), runs AdamW on the moment blocks, and gathers the stage
parameters' updated blocks over the data axis: ZeRO-1's reduction, norm
fold and update are ``launch/zero1.py``'s, as in the tensor-parallel
step.  :func:`shard_pp_params` and :func:`init_pp_state` cut a rank's
initial state; every number a step computes is what whole storage
computed.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from .._tree import leaves, structure, tree_map, unflatten
from ..models.config import ModelConfig
from ..models.layers import rms_norm, swiglu
from ..models.sharding import P, shard_leaf
from ..models.transformer import (ShapeDtype, _out_proj, _proj_qkv,
                                  param_shapes)
from ..kernels.flash_attention import flash_attention
from ..optim.adamw import AdamW, AdamWState
from . import collectives as C
from . import specs as SP
from . import zero1 as Z
from .pipeline import pipeline_loss_fn

#: The reference's global batch and sequence of the batch spec.
SPEC_BATCH, SPEC_SEQ = 256, 4096


def _dense_layer(lp, x, cfg: ModelConfig):
    """One dense layer on the complete residual stream ``x`` ``(b, s,
    d)``: norm, attention (causal), residual add, norm, SwiGLU MLP,
    residual add."""
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _proj_qkv(h, lp, cfg, positions, cfg.rope_theta)
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True)
    x = x + _out_proj(o.transpose(1, 2), lp["wo"])
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + swiglu(h, lp["gate"], lp["up"], lp["down"])


def make_head_loss(cfg: ModelConfig):
    """The reference's head loss: final norm, bfloat16 logits (promoted
    with a float32 head, as jnp promotes), float32 ``logsumexp`` minus the
    label's logit, averaged over every position (no label is masked)."""
    def head_loss_fn(shared, hfin, labels):
        hfin = rms_norm(hfin, shared["final_norm"], cfg.norm_eps)
        head = shared["lm_head"]
        rt = torch.promote_types(torch.bfloat16, head.dtype)
        logits = (hfin.to(torch.bfloat16).to(rt) @ head.to(rt)).float()
        lse = torch.logsumexp(logits, dim=-1)
        # the one-hot einsum adds exact zeros to the label's logit
        picked = torch.gather(logits, -1,
                              labels.clamp_min(0).long()[..., None])[..., 0]
        return torch.mean(lse - picked)
    return head_loss_fn


def shard_pp_params(params, params_spec, mesh, rank: int):
    """``rank``'s stored parameters from ``{"stages": its stage's layers
    (L / pp, ...), "shared": the shared leaves whole}``: the stage as it
    is, each shared leaf cut to its FSDP block (a tensor of its own)."""
    return {"stages": dict(params["stages"]),
            "shared": {k: shard_leaf(v, params_spec["shared"][k].spec, mesh,
                                     rank).clone(
                                         memory_format=torch.contiguous_format)
                       for k, v in params["shared"].items()}}


def init_pp_state(params, opt_spec, mesh) -> AdamWState:
    """AdamW's zero state for a rank's stored ``params``: every moment its
    ZeRO-1 block of ``opt_spec`` (a stage leaf's without the pipe dim)."""
    device = params["shared"]["tok_embed"].device
    m = opt_spec.m
    return Z.init_state({"stages": SP.blocks(m["stages"], mesh, device, 1),
                         "shared": SP.blocks(m["shared"], mesh, device)})


def make_pp_train_step(cfg: ModelConfig, mesh, opt: AdamW, *,
                       pipe_axis: str = "model", data_axis: str = "data",
                       n_mb: int = 16, remat: bool = True):
    """Returns ``(train_step, params_spec, opt_spec, batch_spec)``.

    ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss": loss})`` runs on every rank of ``mesh``: ``params`` is
    ``{"stages": {key: (L/pp, ...)}, "shared": {"tok_embed",
    "final_norm", "lm_head"}}`` with this rank's stage whole and its FSDP
    blocks of the shared leaves (:func:`shard_pp_params`), ``opt_state``
    its ``AdamWState`` of ZeRO-1 moment blocks (:func:`init_pp_state`),
    ``batch`` ``{"tokens_mb", "labels_mb"}`` this rank's data shard
    ``(n_mb, mb / dp, S)``.  The shared leaves the stage uses are
    gathered over the data axis (the others stand as zeros, whose
    gradient the pipe sum adds); the pipeline loss
    (:func:`~repro_torch.launch.pipeline.pipeline_loss_fn`) leaves the
    gradients summed over the pipe; they are reduce-scattered (averaged)
    over the data axis to the moments' blocks and cast to bfloat16, as the
    reference's, and AdamW updates this rank's block of each parameter,
    its grad clip on the norm of the whole model's gradient: each leaf's
    (each layer's) float32 sum of squares over its blocks, gathered over
    the data axis and folded in coordinate order, the layers' gathered
    over the pipe group, folded in the reference's leaf order, layer by
    layer (the same bits whatever ``pp``).  The stage's updated blocks
    are gathered over the data axis (kind ``zero1``).

    The spec trees hold a :class:`~repro_torch.models.transformer.
    ShapeDtype` (global shape, type, :class:`P`) per leaf, the
    reference's ``ShapeDtypeStruct``s with their ``NamedSharding``s."""
    pp, nd = mesh.shape[pipe_axis], mesh.shape[data_axis]

    def embed_fn(shared, toks):
        # F.embedding: a backward that sums in one order (models/model.py)
        return F.embedding(toks, shared["tok_embed"])

    def stage_fn(stage, x):
        for lp in stage:
            x = _dense_layer(lp, x, cfg)
        return x

    loss_fn = pipeline_loss_fn(embed_fn, stage_fn, make_head_loss(cfg),
                               mesh, axis=pipe_axis, remat=remat,
                               data_axis=data_axis)

    def sq_norm(grads) -> torch.Tensor:
        """The whole gradient's squared norm from this rank's blocks: the
        shared leaves', then each stage leaf's layer by layer, in global
        layer order, as one left fold in the reference's leaf order (keys
        sorted)."""
        total = 0
        for k in sorted(grads["shared"]):
            g = grads["shared"][k].float()
            part = torch.sum(g * g)
            if cut["shared"][k] is not None:
                part = Z.fold(part[None], mesh, data_axis)[0]
            total = total + part
        for k in sorted(grads["stages"]):
            g, d = grads["stages"][k], cut["stages"][k]
            mine = torch.stack([torch.sum(gl.float() * gl.float())
                                for gl in g])
            if d == 0:          # whole layers: this rank's run of them
                mine = C.all_gather(mine, mesh, data_axis, 0, "data")
            elif d is not None:
                mine = Z.fold(mine, mesh, data_axis)
            for part in C.all_gather(mine, mesh, pipe_axis, 0):
                total = total + part
        return total

    def train_step(params, opt_state: AdamWState, batch: Dict[str, Any]):
        stages, shared_in = params["stages"], params["shared"]
        device = shared_in["tok_embed"].device
        stage = mesh.coords(C.rank())[pipe_axis]
        uses = {"tok_embed": stage == 0, "final_norm": stage == pp - 1,
                "lm_head": stage == pp - 1}
        n = next(iter(stages.values())).shape[0]
        # per-layer leaves sharing the stacked storage: each layer's
        # gradient has its own size
        layers = [{k: v[i].detach().requires_grad_()
                   for k, v in stages.items()} for i in range(n)]
        shared = {}
        for k, blk in shared_in.items():
            d = fsdp_dims[k]
            if not uses[k]:
                full = torch.zeros(params_spec["shared"][k].shape,
                                   dtype=blk.dtype, device=device)
            elif d is None:
                full = blk
            else:
                full = C.all_gather(blk, mesh, data_axis, d, "fsdp")
            shared[k] = full.detach().requires_grad_()
        toks, lbls = (torch.as_tensor(np.asarray(batch[k]) if not
                                      isinstance(batch[k], torch.Tensor)
                                      else batch[k]).to(device).long()
                      for k in ("tokens_mb", "labels_mb"))
        loss = loss_fn(layers, shared, toks, lbls)
        whole = {"shared": {k: v.grad for k, v in shared.items()},
                 "stages": {k: torch.stack([lp[k].grad for lp in layers])
                            for k in stages}}
        del layers, shared
        # the data mean, to the moments' blocks (each whole gradient freed
        # once staged); cast to bfloat16, as the reference's gradients
        treedef, flat = structure(whole), leaves(whole)
        whole.clear()
        grads = tree_map(lambda g: g.to(torch.bfloat16), unflatten(
            treedef, Z.scatter(flat, leaves(cut), mesh, data_axis, "mean")))
        norm = sq_norm(grads) if opt.grad_clip > 0 else None
        new, new_opt = Z.update(opt, grads, opt_state, params, block_dims,
                                mesh, data_axis, norm)
        return new, new_opt, {"loss": loss}

    # ---- the spec trees ------------------------------------------------
    full = param_shapes(cfg)

    def stage_shard(s):
        shape = (pp, s.shape[0] // pp) + tuple(s.shape[1:])
        return ShapeDtype(shape, s.dtype,
                          P(pipe_axis, *([None] * (len(shape) - 1))))

    def shared_shard(s):
        parts = [None] * len(s.shape)
        i = SP.largest_dividing(s.shape, parts, nd)
        if i is not None:
            parts[i] = data_axis
        return ShapeDtype(tuple(s.shape), s.dtype, P(*parts))

    def z1_shard(s):
        return ShapeDtype(tuple(s.shape), torch.float32,
                          SP.z1_spec(s.shape, s.spec, nd, data_axis))

    params_spec = {
        "stages": tree_map(stage_shard, full["layers"]),
        "shared": {k: shared_shard(full[k])
                   for k in ("tok_embed", "final_norm", "lm_head")}}
    opt_spec = AdamWState(step=ShapeDtype((), torch.int32, P()),
                          m=tree_map(z1_shard, params_spec),
                          v=tree_map(z1_shard, params_spec))
    mb = SPEC_BATCH // n_mb
    bs = P(None, data_axis, None)
    batch_spec = {k: ShapeDtype((n_mb, mb, SPEC_SEQ), torch.int32, bs)
                  for k in ("tokens_mb", "labels_mb")}
    # where each gradient is reduce-scattered (the moment's data dim) and
    # where each parameter is narrowed and gathered (none for the shared
    # leaves, stored as their FSDP blocks)
    fsdp_dims = Z.cut_dims(params_spec["shared"], data_axis)
    cut = {"stages": Z.cut_dims(opt_spec.m["stages"], data_axis, 1),
           "shared": Z.cut_dims(opt_spec.m["shared"], data_axis)}
    block_dims = {
        "stages": Z.block_dims(params_spec["stages"], opt_spec.m["stages"],
                               data_axis, 1),
        "shared": Z.block_dims(params_spec["shared"], opt_spec.m["shared"],
                               data_axis)}
    return train_step, params_spec, opt_spec, batch_spec

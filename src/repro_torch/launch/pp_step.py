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

At run time each rank holds its stage's layers, and the shared leaves
(embedding, final norm, head) and all their AdamW moments, whole.  The
spec trees describe the reference's layout: stages over the pipe axis,
the shared leaves FSDP-sharded over the data axis and the moments ZeRO-1
sharded; storing them so (FSDP, ZeRO-1) is ROADMAP Queue A 11d.  Results
do not change with it; per-rank memory does.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .._tree import tree_map
from ..models.config import ModelConfig
from ..models.layers import rms_norm, swiglu
from ..models.sharding import P, spec_axes
from ..models.transformer import (ShapeDtype, _out_proj, _proj_qkv,
                                  param_shapes)
from ..kernels.flash_attention import flash_attention
from ..optim.adamw import AdamW, AdamWState
from . import collectives as C
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


def _largest_dividing(shape, parts, n: int):
    """The largest dim among ``parts``' free (None) dims that ``n``
    divides, the first on a tie; None when there is none."""
    cands = [i for i, ax in enumerate(parts) if ax is None
             and shape[i] % n == 0]
    return max(cands, key=lambda i: shape[i]) if cands else None


def make_pp_train_step(cfg: ModelConfig, mesh, opt: AdamW, *,
                       pipe_axis: str = "model", data_axis: str = "data",
                       n_mb: int = 16, remat: bool = True):
    """Returns ``(train_step, params_spec, opt_spec, batch_spec)``.

    ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss": loss})`` runs on every rank of ``mesh``: ``params`` is
    ``{"stages": {key: (L/pp, ...)}, "shared": {"tok_embed",
    "final_norm", "lm_head"}}`` with this rank's stage, ``opt_state`` its
    ``AdamWState`` of the same tree, ``batch`` ``{"tokens_mb",
    "labels_mb"}`` this rank's data shard ``(n_mb, mb / dp, S)``.  The
    pipeline loss (:func:`~repro_torch.launch.pipeline.pipeline_loss_fn`)
    leaves the gradients; they are cast to bfloat16, as the reference's,
    and AdamW updates the parameters, its grad clip on the norm of the
    whole model's gradient (the stages' per-layer sums gathered over the
    pipe group, folded in the reference's leaf order, layer by layer: the
    same bits whatever ``pp``).

    The spec trees hold a :class:`~repro_torch.models.transformer.
    ShapeDtype` (global shape, type, :class:`P`) per leaf, the
    reference's ``ShapeDtypeStruct``s with their ``NamedSharding``s."""
    pp = mesh.shape[pipe_axis]

    def embed_fn(shared, toks):
        return shared["tok_embed"][toks]

    def stage_fn(stage, x):
        for lp in stage:
            x = _dense_layer(lp, x, cfg)
        return x

    loss_fn = pipeline_loss_fn(embed_fn, stage_fn, make_head_loss(cfg),
                               mesh, axis=pipe_axis, remat=remat,
                               data_axis=data_axis)

    def sq_norm(grads) -> torch.Tensor:
        """The whole gradient's squared norm: the shared leaves', then each
        stage leaf's layer by layer, in global layer order, as one left
        fold in the reference's leaf order (keys sorted)."""
        total = 0
        for k in sorted(grads["shared"]):
            g = grads["shared"][k].float()
            total = total + torch.sum(g * g)
        for k in sorted(grads["stages"]):
            g = grads["stages"][k]
            mine = torch.stack([torch.sum(gl.float() * gl.float())
                                for gl in g])
            for part in C.all_gather(mine, mesh, pipe_axis, 0):
                total = total + part
        return total

    def train_step(params, opt_state: AdamWState, batch: Dict[str, Any]):
        stages, shared_in = params["stages"], params["shared"]
        device = shared_in["tok_embed"].device
        n = next(iter(stages.values())).shape[0]
        # per-layer leaves sharing the stacked storage: each layer's
        # gradient has its own size
        layers = [{k: v[i].detach().requires_grad_()
                   for k, v in stages.items()} for i in range(n)]
        shared = {k: v.detach().requires_grad_()
                  for k, v in shared_in.items()}
        toks, lbls = (torch.as_tensor(np.asarray(batch[k]) if not
                                      isinstance(batch[k], torch.Tensor)
                                      else batch[k]).to(device).long()
                      for k in ("tokens_mb", "labels_mb"))
        loss = loss_fn(layers, shared, toks, lbls)
        bf = torch.bfloat16
        grads = {"shared": {k: v.grad.to(bf) for k, v in shared.items()},
                 "stages": {k: torch.stack([lp[k].grad for lp in layers])
                            .to(bf) for k in stages}}
        del layers, shared
        new_params, new_opt = opt.update(grads, opt_state, params,
                                         sq_norm=sq_norm(grads))
        return new_params, new_opt, {"loss": loss}

    # ---- the spec trees ------------------------------------------------
    full = param_shapes(cfg)
    nd = mesh.shape[data_axis]

    def stage_shard(s):
        shape = (pp, s.shape[0] // pp) + tuple(s.shape[1:])
        return ShapeDtype(shape, s.dtype,
                          P(pipe_axis, *([None] * (len(shape) - 1))))

    def shared_shard(s):
        parts = [None] * len(s.shape)
        i = _largest_dividing(s.shape, parts, nd)
        if i is not None:
            parts[i] = data_axis
        return ShapeDtype(tuple(s.shape), s.dtype, P(*parts))

    def z1_shard(s):
        parts = list(s.spec) + [None] * (len(s.shape) - len(s.spec))
        used = {a for ax in parts for a in spec_axes(ax)}
        if data_axis not in used:
            i = _largest_dividing(s.shape, parts, nd)
            if i is not None:
                parts[i] = data_axis
        return ShapeDtype(tuple(s.shape), torch.float32, P(*parts))

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
    return train_step, params_spec, opt_spec, batch_spec

"""Functional AdamW and the cosine learning-rate schedule.

Port of the JAX package's ``optim/adamw.py``.  The state holds ``m`` and
``v`` in float32 with the parameters' tree structure; the update runs in
float32 and casts each new parameter back to its type.  It is plain torch
on whatever device the tensors lie (the reference's AdamW is plain jnp, no
Pallas kernel).  The update returns new parameters, as the reference's,
but writes the new moments over the old ones in place (the returned state
holds the same ``m`` and ``v`` tensors) and applies the grad-clip scale
leaf by leaf: a functional update of qwen2-7b at four layers would hold
two copies of its 16 GB of moments and of its 8 GB of float32 gradients
at once.

Each operation is the reference's, in its order and types: Python scalars
enter as float32 (a weak type in JAX, a wrapped number in torch), and every
divide has a tensor on both sides, because torch turns ``tensor / scalar``
into a multiply by the reciprocal on the card.  The grad-clip norm sums the
leaves in the reference's leaf order (``jax.tree.flatten``: dict keys
sorted), as a left fold from 0.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from .._tree import leaves, structure, tree_map, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor        # int32, 0-d
    m: Any
    v: Any


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor on ``like``'s device (a fill, not a copy from
    the host)."""
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


@dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        device = leaves(params)[0].device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          zeros, tree_map(torch.clone, zeros))

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.full((), float(self.lr), dtype=torch.float32,
                          device=step.device)

    def update(self, grads, state: AdamWState, params,
               sq_norm: Optional[torch.Tensor] = None):
        """``(new_params, new_state)`` from ``grads`` (any float type; cast
        to float32 first), ``state`` and ``params``.  ``state.m`` and
        ``state.v`` are updated in place; ``grads`` and ``params`` are left
        as they are.  ``sq_norm``, when given, is the float32 squared norm
        of the whole gradient that the grad clip takes, in place of the
        sum over ``grads`` (a pipeline stage or a tensor-parallel rank
        holds part of the model's gradient; ``launch/pp_step.py`` and
        ``launch/steps.py::grad_sq_norm`` sum the rest)."""
        flat_p, flat_g = leaves(params), leaves(grads)
        flat_m, flat_v = leaves(state.m), leaves(state.v)
        if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
            raise ValueError("grads, state and params differ in structure")
        scale = None
        if self.grad_clip > 0:
            total = sq_norm
            if total is None:
                total = 0
                for g in flat_g:
                    g = g.float()
                    total = total + torch.sum(g * g)
            norm = torch.sqrt(total)
            scale = torch.clamp_max(
                _scalar(self.grad_clip, norm) / (norm + 1e-9), 1.0)
        step = state.step + 1
        t = step.float()
        lr = self._lr(step)
        bc1 = 1.0 - self.b1 ** t
        bc2 = 1.0 - self.b2 ** t

        def upd(p, g, m, v):
            # the reference's expressions, each product and sum rounded as
            # there, with the moments' results written in place
            g = g.float() if scale is None else g.float() * scale
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            den = v / bc2
            u = (m / bc1).div_(den.sqrt_().add_(self.eps))
            del den
            u.add_(self.weight_decay * p.float())
            return (p.float() - u.mul_(lr)).to(p.dtype)

        new_p = unflatten(structure(params), [
            upd(p, g, m, v) for p, g, m, v in zip(flat_p, flat_g, flat_m,
                                                   flat_v)])
        return new_p, AdamWState(step, state.m, state.v)


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> Callable:
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine down
    to ``floor_frac * peak`` at ``total``; a function of the step tensor,
    in float32."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak * s / _scalar(max(warmup, 1), s)
        prog = torch.clamp((s - warmup) / _scalar(max(total - warmup, 1), s),
                           0.0, 1.0)
        cos = peak * (floor_frac + (1 - floor_frac) * 0.5 *
                      (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup, warm, cos)
    return lr

"""Pipeline parallelism over a mesh axis, one process per rank.

Port of the JAX package's ``launch/pipeline.py``.  The reference runs the
GPipe rotation inside ``shard_map``: every tick each stage runs, and
``ppermute`` hands its output to the next stage; ``jax.grad`` of the whole
program gives the gradients.  Torch's autograd does not span processes,
and a differentiable hand-off would leave stage 0's graph unconnected (it
discards what it receives), so the schedule is written out instead:

* forward, microbatch by microbatch: stage 0 embeds, every other stage
  receives its input from the previous one; the stage runs; its output
  goes to the next stage, or, on the last stage, to the head loss (run
  once, under grad, on a detached copy of the output, as the reference's
  head is outside ``jax.checkpoint``);
* backward, in reverse microbatch order: the last stage takes the
  gradient of its output from the head loss's graph, every other stage
  receives it from the next one; the stage runs ``torch.autograd.
  backward`` and sends the gradient of its input to the previous stage.

Bubble ticks of the rotation carry nothing the loss reads, so they do not
run.  With ``remat`` the forward runs under ``no_grad`` and keeps only
each microbatch's input; the backward recomputes the stage under grad
(``jax.checkpoint(stage_fn)``).  Activations cross between stages with
:func:`~repro_torch.launch.collectives.send` and ``recv``.
"""
from __future__ import annotations

from typing import Callable, List

import torch

from .._tree import leaves
from . import collectives as C


def stage_params_split(layer_params, pp: int):
    """Stacked ``(L, ...)`` layer params -> ``(pp, L/pp, ...)``
    stage-major; ``[s]`` of a leaf is stage ``s``'s layers."""
    def split(a):
        n = a.shape[0]
        assert n % pp == 0, f"n_layers {n} must divide pp {pp}"
        return a.reshape(pp, n // pp, *a.shape[1:])
    return {k: split(v) if not isinstance(v, dict)
            else stage_params_split(v, pp) for k, v in layer_params.items()}


def _grad_leaves(tree) -> List[torch.Tensor]:
    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)
            and t.requires_grad]


def pipeline_loss_fn(embed_fn: Callable, stage_fn: Callable,
                     head_loss_fn: Callable, mesh, *, axis: str = "pipe",
                     remat: bool = True, data_axis: str = ""):
    """Builds ``loss(stage_params, shared, tokens_mb, labels_mb)``, called
    on every rank of ``mesh`` with its own stage's parameters (its block
    of the reference's ``params["stages"]``), the shared ones (embedding,
    head) whole, and its data shard of ``(n_mb, mb, S)`` tokens and
    labels.

    ``embed_fn(shared, tokens)`` gives a microbatch's stage-0 input,
    ``stage_fn(stage_params, x)`` runs a stage, ``head_loss_fn(shared,
    h, labels)`` gives a microbatch's float32 loss.

    Returns the reference's loss on every rank: the sum of the valid
    microbatch losses in order, over the pipe group (only the last stage's
    is nonzero), averaged over ``data_axis`` when it is set, divided by
    ``n_mb``.  Leaves in ``.grad`` of every parameter that requires one
    (replacing what was there) this data rank's part of the gradient
    ``jax.grad`` of the reference gives: a stage parameter's from its
    stage, a shared one's summed over the pipe group.  With ``data_axis``
    the caller averages the gradients over it (``pp_step.py``
    reduce-scatters them to its ZeRO-1 blocks)."""
    pp = mesh.shape[axis]

    def loss(stage_params, shared, tokens_mb, labels_mb):
        rank = C.rank()
        line = mesh.axis_ranks(axis, rank)
        s = line.index(rank)
        first, last = s == 0, s == pp - 1
        n_mb = tokens_mb.shape[0]
        params = _grad_leaves(stage_params) + _grad_leaves(shared)
        for p in params:
            p.grad = None
        with torch.no_grad():
            like = embed_fn(shared, tokens_mb[0])
        device = like.device
        scale = torch.full((), 1.0 / n_mb, dtype=torch.float32,
                           device=device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        pending: List[C._Pending] = []
        inputs, outs, heads = [], [], []

        # forward, microbatch by microbatch
        for m in range(n_mb):
            if first:
                with torch.set_grad_enabled(not remat):
                    x = embed_fn(shared, tokens_mb[m]).to(like.dtype)
            else:
                x = C.recv(like.shape, like.dtype, device,
                           line[s - 1]).requires_grad_(not remat)
            with torch.set_grad_enabled(not remat):
                out = stage_fn(stage_params, x)
            inputs.append(x)
            outs.append(None if remat else out)
            if last:
                h = out.detach().requires_grad_()
                mb_loss = head_loss_fn(shared, h, labels_mb[m])
                loss_sum = loss_sum + mb_loss.detach()
                heads.append((h, mb_loss))
            else:
                pending.append(C.send(out.detach(), line[s + 1]))

        # backward, in reverse microbatch order
        for m in reversed(range(n_mb)):
            if last:
                h, mb_loss = heads.pop()
                torch.autograd.backward(mb_loss, scale)
                g = h.grad
            else:
                g = C.recv(like.shape, like.dtype, device, line[s + 1])
            x, out = inputs.pop(), outs.pop()
            if remat:
                if first:
                    x = embed_fn(shared, tokens_mb[m]).to(like.dtype)
                else:
                    x = x.requires_grad_()
                out = stage_fn(stage_params, x)
            torch.autograd.backward(out, g)
            del out, g
            if not first:
                pending.append(C.send(x.grad, line[s - 1]))
        C.wait_all(pending)

        # shared gradients summed over the pipe group; the loss averaged
        # over the data group
        shared_ps = _grad_leaves(shared)
        for p in shared_ps:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        C.all_reduce([p.grad for p in shared_ps], mesh, axis, "sum")
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        total = loss_sum.clone()
        C.all_reduce([total], mesh, axis, "sum")
        if data_axis:
            C.all_reduce([total], mesh, data_axis, "mean")
        return total / torch.full((), float(n_mb), dtype=torch.float32,
                                  device=device)

    return loss

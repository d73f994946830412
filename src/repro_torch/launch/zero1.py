"""ZeRO-1 over a data axis: the one policy both training steps use.

``steps.make_train_step(zero1=True)`` and ``pp_step.make_pp_train_step``
keep AdamW's float32 moments as a rank's block of each leaf, cut over the
data axis on the dim its moment spec names that axis
(``specs.z1_spec``), or whole where no dim divides.  A step:

1. reduces the gradients over the axis straight to those blocks
   (:func:`scatter`: one bucketed reduce-scatter, an all-reduce of the
   leaves kept whole);
2. takes the clip's squared norm from per-block sums of squares, folded
   over the axis in coordinate order (:func:`fold`), so that every rank
   gets the same bits;
3. runs AdamW on the rank's block of each parameter and gathers the new
   blocks over the axis, kind ``zero1`` (:func:`update`).

A leaf whose parameter is already cut over the axis (a pipeline's FSDP
shared leaves) is stored as that block: it is neither narrowed nor
gathered (its block dim, :func:`block_dims`, is None).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from .._tree import leaves, tree_map
from ..models.sharding import spec_axes
from ..optim.adamw import AdamW, AdamWState
from . import collectives as C
from . import specs as SP


def _named_dim(spec, axis: str, lead: int) -> Optional[int]:
    for i, ax in enumerate(spec):
        if axis in spec_axes(ax):
            return i - lead
    return None


def cut_dims(moment_specs, axis: str, lead: int = 0):
    """For each :class:`ShapeDtype` leaf of ``moment_specs``, the dim its
    spec cuts over ``axis`` (less ``lead`` leading dims that the stored
    block drops), or None: where :func:`scatter` cuts each gradient."""
    return tree_map(lambda s: _named_dim(s.spec, axis, lead), moment_specs)


def block_dims(param_specs, moment_specs, axis: str, lead: int = 0):
    """For each leaf, the dim the moment's spec cuts over ``axis`` and the
    parameter's does not (less ``lead``), or None: where :func:`update`
    narrows a parameter to its block and gathers the new block."""
    def one(p, m):
        d = SP.zero1_dim(p.spec, m.spec, axis)
        return None if d is None else d - lead
    return tree_map(one, param_specs, moment_specs)


def init_state(moments) -> AdamWState:
    """AdamW's zero state over the tree ``moments`` of zero blocks
    (``specs.blocks``): ``m`` is that tree, ``v`` a copy."""
    device = leaves(moments)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      moments, tree_map(torch.clone, moments))


def block(t: torch.Tensor, dim: Optional[int], mesh, axis: str,
          coord: int) -> torch.Tensor:
    """The block at ``coord`` of ``axis`` of ``t`` along ``dim`` (a view;
    ``t`` itself when ``dim`` is None)."""
    if dim is None:
        return t
    size = t.shape[dim] // mesh.shape[axis]
    return t.narrow(dim, coord * size, size)


def scatter(grads: List[torch.Tensor], dims: List[Optional[int]], mesh,
            axis: str, op: str) -> List[torch.Tensor]:
    """Each gradient reduced (``op``: ``"sum"`` or ``"mean"``) over this
    rank's line of ``axis``: the rank's block along its dim of ``dims``
    (one bucketed :func:`~repro_torch.launch.collectives.reduce_scatter`),
    or the whole, all-reduced in place, where its dim is None.  The list
    ``grads`` is handed over and emptied, so that each gradient is freed
    as soon as its blocks are staged.  Kind ``data``."""
    cut = [i for i, d in enumerate(dims) if d is not None]
    out: List[Optional[torch.Tensor]] = list(grads)
    C.all_reduce([g for g, d in zip(grads, dims) if d is None], mesh, axis,
                 op, "data")
    sent = [grads[i] for i in cut]
    grads.clear()
    for i in cut:
        out[i] = None
    for i, b in zip(cut, C.reduce_scatter(sent, mesh, axis,
                                          [dims[i] for i in cut], op,
                                          "data")):
        out[i] = b
    return out


def fold(parts: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """This rank's partial sums ``(k,)``, and the same of every rank of its
    line of ``axis``, added in the line's coordinate order (a left fold:
    the same bits on every rank).  Kind ``data``."""
    got = C.all_gather(parts, mesh, axis, 0, "data").view(
        mesh.shape[axis], -1)
    total = got[0]
    for row in got[1:]:
        total = total + row
    return total


def update(opt: AdamW, grads, state: AdamWState, params, dims, mesh,
           axis: str, sq_norm: Optional[torch.Tensor] = None):
    """``(new_params, new_state)``: AdamW on this rank's block of each
    parameter of ``params`` (narrowed along its dim of the tree ``dims``,
    :func:`block_dims`) with the gradient blocks ``grads`` and the moment
    blocks of ``state``; each new block is then gathered over ``axis``
    (kind ``zero1``) where its dim is not None."""
    me = mesh.coords(C.rank())[axis]
    mine = tree_map(lambda p, d: block(p, d, mesh, axis, me), params, dims)
    new, new_state = opt.update(grads, state, mine, sq_norm=sq_norm)
    del mine
    return tree_map(lambda b, d: b if d is None else C.all_gather(
        b, mesh, axis, d, "zero1"), new, dims), new_state

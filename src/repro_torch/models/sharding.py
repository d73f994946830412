"""Sharding policy: partition specs of parameters and activations on a
rank mesh.

Port of the JAX package's ``models/sharding.py``.  The policy is the
reference's, rule for rule:

  * TP (the model axis): attention heads (replicated when the head count
    does not divide the axis), MLP hidden, expert dim, vocabulary.
  * FSDP (the data axes named in ``fsdp``): the d_model-ish dim of each
    weight.
  * Activations: batch over the data axes; the residual stream replicated
    over the model axis.

A spec is a :class:`P`, one entry per tensor dim: ``None``, an axis name,
or a tuple of names (split major to minor).  The reference hands its
specs to XLA, which partitions the program.  The port runs one process
per rank, so a spec is used to cut a whole tensor down to one rank's
block (:func:`shard_leaf`, :func:`shard_params`; :func:`gather_params`
puts the blocks back together) and to describe it as
``torch.distributed`` placements (:func:`tree_shardings`).

Under an active context each rank holds its blocks of the parameters and
its data shard of the batch, and the model's layers (``transformer.py``,
``model.py``) write by hand what XLA partitions implicitly: the FSDP
gather of a weight before its use (:func:`fsdp_gather`), the column- and
row-parallel products with their sums over the model axis, the
vocabulary-parallel embedding and loss, and the sequence-sharded
attention where the heads do not divide the model axis, the Mamba
blocks' channel- (Mamba1) and head-parallel (Mamba2) forms, and the
decode cache's sequence blocks with their partial-softmax combine.
:meth:`ShardCtx.constrain` stays the identity: the port never lays out an
activation other than the layers' code puts it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "data"))``.  A tuple of
    one name is that name (``P(("data",)) == P("data")``), as
    ``jax.sharding.PartitionSpec`` normalises it."""

    def __new__(cls, *parts):
        norm = []
        for p in parts:
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                if len(p) == 1:
                    p = p[0]
            norm.append(p)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def spec_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, major first (``()`` for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Mesh and axis roles of the model functions.  ``mesh`` is a
    :class:`repro_torch.launch.mesh.Mesh` or any object with a ``shape``
    dict (axis name -> size); ``dp`` the batch axes, ``tp`` the model
    axis, ``fsdp`` the weight-shard axes (a subset of ``dp``)."""
    mesh: Optional[Any] = None
    dp: Tuple[str, ...] = ()
    tp: str = ""
    fsdp: Tuple[str, ...] = ()

    @property
    def active(self) -> bool:
        return self.mesh is not None

    def n(self, axis: str) -> int:
        return self.mesh.shape[axis] if self.mesh else 1

    def constrain(self, x, spec=None):
        return x


def _div(dim: int, ctx: ShardCtx, axis) -> bool:
    if not ctx.active or not axis:
        return False
    ns = 1
    for a in spec_axes(axis):
        ns *= ctx.n(a)
    return dim % ns == 0


def head_specs(ctx: ShardCtx, n_heads: int, head_dim: int,
               layer_stacked: bool):
    """Specs of the in-projections ``(L, d, H, hd)`` and the out-projection
    ``(L, H, hd, d)``: the model axis on ``H`` when it divides the head
    count, else the heads stay replicated over it (sharding ``hd`` would
    make every score block a model-axis all-reduce)."""
    lead = (None,) if layer_stacked else ()
    f = ctx.fsdp if ctx.fsdp else None
    if _div(n_heads, ctx, ctx.tp):
        return P(*lead, f, ctx.tp, None), P(*lead, ctx.tp, None, f)
    return P(*lead, f, None, None), P(*lead, None, None, f)


def param_spec(name: str, shape, cfg, ctx: ShardCtx) -> P:
    """Partition spec of one named parameter (leaf names are unique): the
    reference's table, trimmed or padded to the leaf's rank, with every
    axis that does not divide its dim dropped."""
    if not ctx.active:
        return P()
    t, f = ctx.tp, (ctx.fsdp if ctx.fsdp else None)
    L = (None,)                                    # stacked-layer dim
    hs_in, hs_out = head_specs(ctx, cfg.n_heads or 1, cfg.hd or 1, True)
    table = {
        "tok_embed": P(t, f), "lm_head": P(f, t), "final_norm": P(None),
        "wq": hs_in, "wk": hs_in, "wv": hs_in, "wo": hs_out,
        "bq": P(*L, None, None), "bk": P(*L, None, None),
        "bv": P(*L, None, None),
        "ln1": P(*L, None), "ln2": P(*L, None),
        "gate": P(*L, f, t), "up": P(*L, f, t), "down": P(*L, t, f),
        "router": P(*L, None, None),
        "e_gate": P(*L, t, None, f), "e_up": P(*L, t, None, f),
        "e_down": P(*L, t, f, None),
        "in_proj": P(*L, f, t), "out_proj": P(*L, t, f),
        "conv_w": P(*L, None, t), "conv_b": P(*L, t),
        "x_proj": P(*L, t, None), "dt_w": P(*L, None, t),
        "dt_bias": P(*L, t),
        "A_log": P(*L, t, None) if len(shape) == 3 else P(*L, t),
        "D": P(*L, t), "norm_w": P(*L, t),
    }
    if name not in table:
        return P(*([None] * len(shape)))
    parts = list(table[name])
    if len(parts) > len(shape):
        parts = parts[len(parts) - len(shape):]
    return drop_non_dividing(P(*parts), shape, ctx)


def drop_non_dividing(spec: P, shape, ctx: ShardCtx) -> P:
    """``spec`` padded with ``None`` to the rank of ``shape``, with every
    entry whose axes do not divide its dim dropped (the reference's rule
    for parameters, and ``launch/specs.py``'s for the decode cache)."""
    parts = list(spec)[:len(shape)]
    parts += [None] * (len(shape) - len(parts))
    clean = []
    for dim, ax in zip(shape, parts):
        n = 1
        for a in spec_axes(ax):
            n *= ctx.n(a)
        clean.append(ax if ax is None or dim % n == 0 else None)
    return P(*clean)


def _shape_of(leaf) -> tuple:
    """A leaf's shape: a tensor's, an array's or a ``ShapeDtype``'s
    (:func:`~repro_torch.models.transformer.param_shapes`)."""
    return tuple(leaf.shape)


def tree_pspecs(params, cfg, ctx: ShardCtx):
    """The spec of every leaf of a nested dict, keyed by its leaf name."""
    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return param_spec(prefix, _shape_of(node), cfg, ctx)
    return walk(params, "")


def placements(spec: P, mesh, ndim: int) -> tuple:
    """``torch.distributed`` placements of ``spec`` on ``mesh``, one per
    mesh dim in axis order: ``Shard(i)`` where the axis names tensor dim
    ``i``, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    dims = {}
    for i, entry in enumerate(tuple(spec) + (None,) * (ndim - len(spec))):
        for a in spec_axes(entry):
            dims[a] = i
    return tuple(Shard(dims[a]) if a in dims else Replicate()
                 for a in mesh.axis_names)


def tree_shardings(params, cfg, ctx: ShardCtx):
    """Every leaf's placements on ``ctx.mesh`` (:func:`placements` of its
    :func:`tree_pspecs` spec)."""
    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        shape = _shape_of(node)
        return placements(param_spec(prefix, shape, cfg, ctx), ctx.mesh,
                          len(shape))
    return walk(params, "")


def shard_leaf(x, spec: P, mesh, rank: int):
    """``rank``'s local block of the whole tensor ``x`` under ``spec`` on
    ``mesh`` (a view of ``x``: a block along the leading dims is
    contiguous and still holds all of ``x``'s storage).  A dim split over a tuple of axes is split major to minor (the
    first axis the slowest), as JAX splits it."""
    coords = mesh.coords(rank)
    index = []
    for i, dim in enumerate(x.shape):
        entry = spec[i] if i < len(spec) else None
        idx, n = 0, 1
        for a in spec_axes(entry):
            idx = idx * mesh.shape[a] + coords[a]
            n *= mesh.shape[a]
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(x.shape)} does not divide "
                             f"{n} ({entry!r})")
        size = dim // n
        index.append(slice(idx * size, (idx + 1) * size))
    return x[tuple(index)]


# ---------------------------------------------------------------------------
# the model's parameters under an active context
# ---------------------------------------------------------------------------

def shard_params(params, cfg, ctx: ShardCtx, rank: int):
    """``rank``'s blocks of the whole parameters ``params`` (the tree of
    ``init_params``, layers stacked) under :func:`tree_pspecs`, each a
    tensor of its own: what the reference's ``jax.device_put(params,
    tree_shardings(params, cfg, ctx))`` puts on that device."""
    import torch
    specs = tree_pspecs(params, cfg, ctx)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        return shard_leaf(node, spec, ctx.mesh, rank).clone(
            memory_format=torch.contiguous_format)
    return walk(params, specs)


def gather_params(blocks: List[Any], cfg, ctx: ShardCtx):
    """The whole tree from every rank's blocks (``blocks[r]`` is rank
    ``r``'s tree, as :func:`shard_params` cuts it, or a tree of its
    gradients of the same shapes): the inverse of :func:`shard_params`.
    Every rank's block lands at its place; ranks that hold the same block
    must hold the same values (``ValueError`` otherwise)."""
    import torch
    from .transformer import param_shapes
    shapes = param_shapes(cfg)
    specs = tree_pspecs(shapes, cfg, ctx)

    def walk(parts, shape, spec):
        if isinstance(shape, dict):
            return {k: walk([p[k] for p in parts], shape[k], spec[k])
                    for k in parts[0]}
        whole = torch.empty(tuple(shape.shape), dtype=parts[0].dtype,
                            device=parts[0].device)
        seen = torch.zeros(tuple(shape.shape), dtype=torch.bool,
                           device=parts[0].device)
        for r, part in enumerate(parts):
            dst = shard_leaf(whole, spec, ctx.mesh, r)
            was = shard_leaf(seen, spec, ctx.mesh, r)
            if bool(was.any()) and not torch.equal(dst, part):
                raise ValueError(f"ranks disagree on a replicated block "
                                 f"(rank {r}, spec {spec!r})")
            dst.copy_(part)
            was.fill_(True)
        return whole
    return walk(blocks, shapes, specs)


@functools.lru_cache(maxsize=None)
def use_specs(cfg, ctx: ShardCtx) -> Dict[str, P]:
    """The spec of every parameter as a layer uses it, by leaf name: the
    top-level leaves' specs, each layer leaf's without its stacked layer
    dim (one layer's slice of the stored block), and the leaves of a
    nested block (the hybrid's weight-tied ``shared``), which have no
    layer dim.  A name that two places give different specs is refused
    (no shipped config has one: the hybrid's layers carry no attention or
    MLP leaves, and its ``ln1`` is ``P(None)`` in both)."""
    from .transformer import param_shapes
    out: Dict[str, P] = {}

    def put(name, spec):
        if out.setdefault(name, spec) != spec:
            raise ValueError(f"leaf {name!r} has two use-specs: "
                             f"{out[name]!r} and {spec!r}")

    for k, v in param_shapes(cfg).items():
        if k == "layers":
            for name, sd in v.items():
                put(name, P(*param_spec(name, sd.shape, cfg, ctx)[1:]))
        elif isinstance(v, dict):
            for name, sd in v.items():
                put(name, param_spec(name, sd.shape, cfg, ctx))
        else:
            put(k, param_spec(k, v.shape, cfg, ctx))
    return out


def axes_of(spec: P) -> Tuple[str, ...]:
    """Every axis a spec names, in the order of its entries."""
    return tuple(a for entry in spec for a in spec_axes(entry))


def coord(ctx: ShardCtx, axis: str) -> int:
    """This process's coordinate along ``axis`` of ``ctx.mesh`` (its rank
    in the default process group, which must be up, or the rank a dry run
    stands for: ``collectives.dry``)."""
    import torch.distributed as dist
    from ..launch import collectives as C
    if C.is_dry():
        return ctx.mesh.coords(C.rank())[axis]
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("the model under an active ShardCtx runs one "
                           "process per rank: no torch.distributed process "
                           "group is up (launch/collectives.init_group)")
    return ctx.mesh.coords(dist.get_rank())[axis]


def fsdp_gather(w, spec: P, ctx: ShardCtx):
    """The weight ``w`` (this rank's block under ``spec``) gathered over
    every FSDP axis the spec names, minor axis first (a dim split major to
    minor), so that only its model-axis cut remains; the gradient goes
    back summed over those axes (``collectives.gather_over``)."""
    from ..launch import collectives as C
    for dim, entry in enumerate(spec):
        for a in reversed([a for a in spec_axes(entry) if a in ctx.fsdp]):
            w = C.gather_over(w, ctx.mesh, a, dim)
    return w


def _model_dim(spec: P, ctx: ShardCtx) -> Optional[int]:
    """The dim of ``spec`` that names the model axis, or None."""
    for dim, entry in enumerate(spec):
        if ctx.tp in spec_axes(entry):
            return dim
    return None


def model_whole(w, spec: P, ctx: ShardCtx):
    """The weight ``w`` (gathered over its FSDP axes) whole over the model
    axis, for a use that each model rank makes in part (its share of the
    channels or heads): gathered where ``spec`` cuts it over that axis,
    else marked replicated; either way its gradient is summed over the
    axis (``collectives.gather_over``, ``copy_to``)."""
    from ..launch import collectives as C
    dim = _model_dim(spec, ctx)
    if dim is None:
        return C.copy_to(w, ctx.mesh, ctx.tp)
    return C.gather_over(w, ctx.mesh, ctx.tp, dim, "tp")


def replicated_whole(w, spec: P, ctx: ShardCtx):
    """The weight ``w`` (gathered over its FSDP axes) whole over the model
    axis, for a use that every model rank makes alike (a block computed
    replicated): gathered where ``spec`` cuts it, with this rank's block
    of the cotangent as its gradient, not summed (every rank holds the
    whole cotangent, ``collectives.gather_rows``)."""
    from ..launch import collectives as C
    dim = _model_dim(spec, ctx)
    if dim is None:
        return w
    return C.gather_rows(w, ctx.mesh, ctx.tp, dim, "tp")


def block_index(entry, ctx: ShardCtx) -> int:
    """This process's block along a dim whose spec entry is ``entry``
    (its axes major to minor, as :func:`shard_leaf` cuts it)."""
    idx = 0
    for a in spec_axes(entry):
        idx = idx * ctx.n(a) + coord(ctx, a)
    return idx


def model_block(x, ctx: ShardCtx, dim: int):
    """This rank's block of ``x`` (whole over the model axis) along
    ``dim``, cut in model-axis coordinate order; ``x`` itself when the
    dim does not divide the axis (a spec that drops it)."""
    n = ctx.n(ctx.tp)
    if x.shape[dim] % n:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, coord(ctx, ctx.tp) * size, size)

"""Top-k MoE with capacity-based, sort-free dispatch.

Port of the JAX package's ``models/moe.py``, local path.  The reference
computes it in plain jnp, outside any Pallas kernel, so it is plain torch
here, on the card too (the expert products are batched matrix products).

Dispatch is one-hot + cumsum (no sort): a token's slot within its expert
is the exclusive running count over the flattened ``(T * k)`` assignments,
token-major and then rank within the token, and assignments past the
expert's capacity are dropped — the same (token, rank) pairs as the
reference drops.  The router's top-k keeps ``jax.lax.top_k``'s order:
largest gate first, the lower expert id first on a tie (a stable
descending sort; ``torch.topk`` promises no tie order).

Determinism on the card.  The reference sends every dropped assignment
to slot (0, 0) with a zero contribution and adds; here a dropped
assignment goes to a sentinel row past the buffer's end, which is cut
off, so every kept (expert, slot) pair is written once: the dispatch
scatters the repeated tokens into the capacity buffer and the combine
scatters the buffer's rows back to their (token, rank) places, both
``index_put`` without accumulation (the same values as the reference's
sums of exact zeros), whose backward is a gather.  No float atomic and no
sort decides a bit, and a resumed training run repeats the uninterrupted
one.  (``index_add``, ``gather``, ``index_select`` and ``scatter_add``
would use atomics on CUDA.)  Only the gather dispatch reads ``x`` by
advanced indexing, whose backward sums a token's k slots with the
accumulating ``index_put``, which on CUDA sorts its indices and sums
each run in order.

Expert parallelism.  Given a mesh, :func:`moe_block` runs the body of
the reference's ``shard_map`` on this rank: its data shard of the tokens,
replicated over the model axis, is routed to every expert, and only the
rank's own experts (``e_pad / n_model`` of the expert dim padded to the
model axis) are computed; with ``fsdp`` their weights are first gathered
over the data axes.  The partial outputs are summed over the model group.
:func:`shard_moe_params` cuts a rank's blocks out of the whole weights.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .layers import silu


def router_topk(x: torch.Tensor, w_router: torch.Tensor, k: int):
    """Softmax-normalised top-k gates.  ``x`` ``(T, d)`` -> ids ``(T, k)``
    int32 and float32 gates ``(T, k)``, largest first, the lower id first
    on a tie (``jax.lax.top_k``'s order)."""
    logits = x.float() @ w_router.float()
    gates_all = torch.softmax(logits, dim=-1)
    order = torch.sort(gates_all, dim=-1, descending=True,
                       stable=True).indices[:, :k]
    gates = torch.take_along_dim(gates_all, order, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return order.to(torch.int32), gates


def _capacity(n_tokens: int, k: int, n_experts: int, cf: float) -> int:
    return max(4, int(-(-n_tokens * k * cf // n_experts)))


def moe_apply_local(x: torch.Tensor, w_router: torch.Tensor,
                    w_gate: torch.Tensor, w_up: torch.Tensor,
                    w_down: torch.Tensor, *, k: int, n_experts: int,
                    expert_offset: int, capacity_factor: float,
                    f32_combine: bool = True,
                    gather_dispatch: bool = False) -> torch.Tensor:
    """Routes the tokens ``x`` ``(T, d)`` and computes the experts this
    shard owns (``w_gate, w_up`` ``(E_loc, d, f)``, ``w_down`` ``(E_loc,
    f, d)``, the first one ``expert_offset`` of ``n_experts``); returns
    this shard's partial output ``(T, d)`` in ``x``'s type.

    ``gather_dispatch`` scatters token indices into the capacity buffer
    and gathers the activations, instead of scattering the k-times repeated
    activations; ``f32_combine`` weights the expert rows by the gates in
    float32 and sums over k there, where the other form is an einsum that
    accumulates in float32 after casting the gates to ``x``'s type.  Both
    pairs of forms give the reference's results."""
    t, d = x.shape
    e_loc = w_gate.shape[0]
    cap = _capacity(t, k, n_experts, capacity_factor)

    ids, gates = router_topk(x, w_router, k)                  # (T, k)
    local_ids = ids.reshape(-1).long() - expert_offset        # (T*k,)
    flat_gates = gates.reshape(-1)
    mine = (local_ids >= 0) & (local_ids < e_loc)
    onehot = torch.nn.functional.one_hot(
        torch.where(mine, local_ids, 0), e_loc) * mine[:, None]
    # exclusive running count of the assigned expert -> slot within expert
    # (the scan runs along the contiguous axis of the transposed one-hot)
    count = torch.cumsum(onehot.t().contiguous(), dim=1).t()  # (T*k, E_loc)
    slot = ((count - onehot) * onehot).sum(dim=-1)            # (T*k,)
    keep = mine & (slot < cap)
    # each kept assignment's row of the (E_loc * cap) buffer; a dropped one
    # goes to the sentinel row E_loc * cap
    dest = torch.where(keep, local_ids * cap + slot, e_loc * cap)
    # each buffer row's flat (token, rank) position; an empty one the
    # sentinel T*k (the reference's scatter-min of positions)
    pos = torch.full((e_loc * cap + 1,), t * k, dtype=torch.long,
                     device=x.device)
    pos = pos.index_put((dest,), torch.arange(t * k, device=x.device))
    pos = pos[:e_loc * cap]

    if gather_dispatch:
        valid = (pos < t * k).view(e_loc, cap)
        tok_idx = torch.clamp_max(torch.div(pos, k, rounding_mode="floor"),
                                  t - 1).view(e_loc, cap)
        buf = torch.where(valid[..., None], x[tok_idx], torch.zeros(
            (), dtype=x.dtype, device=x.device))
    else:
        xk = torch.repeat_interleave(x, k, dim=0)             # (T*k, d)
        buf = x.new_zeros((e_loc * cap + 1, d)).index_put(
            (dest,), xk)[:e_loc * cap].view(e_loc, cap, d)

    h = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_up)
    y_buf = torch.bmm(silu(h) * u, w_down)                    # (E_loc, cap, d)

    # every kept assignment's expert row at its place, 0 where dropped
    y_rows = y_buf.new_zeros((t * k + 1, d)).index_put(
        (pos,), y_buf.reshape(e_loc * cap, d))[:t * k]        # (T*k, d)
    if f32_combine:
        y = (y_rows.float() * flat_gates[:, None]).reshape(t, k, d).sum(1)
    else:
        # bf16 x bf16 products are exact in float32: the einsum with a
        # float32 accumulator
        g = flat_gates.to(y_rows.dtype).float().reshape(t, k, 1)
        y = (y_rows.float().reshape(t, k, d) * g).sum(1)
    return y.to(x.dtype)


def _expert_specs(data_axes: Sequence[str], model_axis: str, fsdp: bool):
    """Specs of ``gate``/``up`` ``(E, d, f)`` and ``down`` ``(E, f, d)``:
    experts over the model axis, with ``fsdp`` ``f`` over the data axes."""
    from .sharding import P
    da = tuple(data_axes) if fsdp else None
    return P(model_axis, None, da), P(model_axis, da, None)


def pad_experts(w: torch.Tensor, n_model: int) -> torch.Tensor:
    """The expert dim (dim 0) padded with zero experts to a multiple of
    ``n_model`` (granite's 40 experts on a 16-way axis: 48).  The router
    never routes to them, so the result is exact."""
    e = w.shape[0]
    e_pad = -(-e // n_model) * n_model
    if e_pad == e:
        return w
    return torch.cat([w, w.new_zeros((e_pad - e,) + tuple(w.shape[1:]))])


def shard_moe_params(params, mesh, rank: int, *,
                     data_axes: Sequence[str] = (),
                     model_axis: str = "model", fsdp: bool = False):
    """``rank``'s blocks of whole MoE weights (``router`` ``(d, E)``,
    ``gate``, ``up`` ``(E, d, f)``, ``down`` ``(E, f, d)``), as the
    reference's ``shard_map`` hands them to its body: the router whole,
    the expert dim padded to the model axis and cut over it, and with
    ``fsdp`` the ``f`` dim cut over the data axes."""
    from .sharding import shard_leaf
    s3, sd = _expert_specs(data_axes, model_axis, fsdp)
    n_model = mesh.shape[model_axis]
    return {"router": params["router"],
            **{k: shard_leaf(pad_experts(params[k], n_model),
                             sd if k == "down" else s3, mesh,
                             rank).contiguous()
               for k in ("gate", "up", "down")}}


def _check_mesh(mesh) -> None:
    """``mesh`` must be a port :class:`~repro_torch.launch.mesh.Mesh` with
    a process group of its size up."""
    import torch.distributed as dist
    from ..launch import collectives as C
    from ..launch.mesh import Mesh
    if not isinstance(mesh, Mesh):
        raise TypeError(f"moe_block's mesh must be a repro_torch.launch.mesh"
                        f".Mesh, got {type(mesh).__name__}")
    if not C.is_dry() and not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("moe_block's expert-parallel path runs one "
                           "process per rank: no torch.distributed process "
                           "group is up (launch/collectives.init_group)")


def moe_block(x: torch.Tensor, params, *, k: int, n_experts: int,
              capacity_factor: float, mesh: Optional[object] = None,
              data_axes: Sequence[str] = (), model_axis: str = "model",
              fsdp: bool = False, f32_combine: bool = True,
              gather_dispatch: bool = False) -> torch.Tensor:
    """MoE layer on ``x`` ``(B, S, d)``: ``params`` holds ``router``
    ``(d, E)``, ``gate``, ``up`` ``(E, d, f)`` and ``down`` ``(E, f, d)``.

    With ``mesh`` (a port ``Mesh``, a process group up), the
    expert-parallel path on this rank: ``x`` is its block ``(B / dp, S,
    d)`` (the batch over ``data_axes``, replicated over ``model_axis``),
    ``params`` its blocks (:func:`shard_moe_params`), and the result its
    block of the output.  Under grad, the gradient of ``x`` and of the
    router is summed over the model group (every model rank's experts
    read them), and with ``fsdp`` an expert weight's over the data group
    (the gather's reduce-scatter); a weight replicated over the data axes
    keeps this data shard's part, which the training step reduces."""
    b, s, d = x.shape
    if mesh is None:
        y = moe_apply_local(
            x.reshape(-1, d), params["router"], params["gate"],
            params["up"], params["down"], k=k, n_experts=n_experts,
            expert_offset=0, capacity_factor=capacity_factor,
            f32_combine=f32_combine, gather_dispatch=gather_dispatch)
        return y.reshape(b, s, d)
    _check_mesh(mesh)
    from ..launch import collectives as C
    ma = model_axis
    e_per = -(-n_experts // mesh.shape[ma])
    w_gate, w_up, w_down = params["gate"], params["up"], params["down"]
    if fsdp:
        for ax in reversed(tuple(data_axes)):
            w_gate = C.gather_over(w_gate, mesh, ax, 2)
            w_up = C.gather_over(w_up, mesh, ax, 2)
            w_down = C.gather_over(w_down, mesh, ax, 1)
    my = mesh.coords(C.rank())[ma] * e_per
    x_in = C.copy_to(x, mesh, ma)
    router = C.copy_to(params["router"], mesh, ma)
    y = moe_apply_local(
        x_in.reshape(-1, d), router, w_gate, w_up, w_down, k=k,
        n_experts=n_experts, expert_offset=my,
        capacity_factor=capacity_factor, f32_combine=f32_combine,
        gather_dispatch=gather_dispatch)
    y = C.sum_over(y, mesh, ma)
    return y.reshape(b, s, d)

"""Rank bodies of ``tests/test_torch_distributed.py``, in a module of their
own so that the spawned ranks import ``torch`` and the PyTorch package
only (not ``jax``, which the test module imports).  Each body takes its
rank, the world size and NumPy inputs, and returns NumPy results."""
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.pipeline import pipeline_loss_fn


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def tanh_pipeline(rank, world, case):
    """The reference's pipeline case on this rank: ``case`` holds the
    mapping and axis names, the ``(L, d, d)`` stage weights, the shared
    ``embed`` and ``head``, the ``(n_mb, mb, S)`` tokens and labels, and
    the data axis (``""`` for none).  Returns the loss, this rank's stage
    gradient, the shared gradients, and its pipe and data lines."""
    mesh = Mesh(case["ranks"], case["axes"])
    axis, data_axis = "pipe", case["data_axis"]
    pp = mesh.shape[axis]
    c = mesh.coords(rank)
    L = case["w"].shape[0]
    per = L // pp
    w = _t(case["w"][c[axis] * per:(c[axis] + 1) * per]).requires_grad_()
    shared = {k: _t(case[k]).requires_grad_() for k in ("embed", "head")}
    toks, lbls = _t(case["tokens"]), _t(case["labels"])
    if data_axis:
        nd = mesh.shape[data_axis]
        mb = toks.shape[1] // nd
        cut = slice(c[data_axis] * mb, (c[data_axis] + 1) * mb)
        toks, lbls = toks[:, cut], lbls[:, cut]

    def embed_fn(sh, t):
        return sh["embed"][t]

    def stage_fn(st, x):
        for j in range(st["w"].shape[0]):
            x = torch.tanh(x @ st["w"][j])
        return x

    def head_loss_fn(sh, h, lbl):
        lg = h @ sh["head"]
        lse = torch.logsumexp(lg, -1)
        pick = torch.gather(lg, -1, lbl[..., None].long())[..., 0]
        return torch.mean(lse - pick)

    loss_fn = pipeline_loss_fn(embed_fn, stage_fn, head_loss_fn, mesh,
                               axis=axis, remat=case["remat"],
                               data_axis=data_axis)
    loss = loss_fn({"w": w}, shared, toks, lbls)
    if data_axis:           # the data mean is the caller's
        C.all_reduce([w.grad] + [p.grad for p in shared.values()], mesh,
                     data_axis, "mean")
    out = {"loss": float(loss), "stage": c[axis], "w": w.grad.numpy(),
           "embed": shared["embed"].grad.numpy(),
           "head": shared["head"].grad.numpy(),
           "pipe_line": mesh.axis_ranks(axis, rank),
           "pipe_group": dist.get_process_group_ranks(mesh.group(axis))}
    if data_axis:
        out["data_line"] = mesh.axis_ranks(data_axis, rank)
        out["data_group"] = dist.get_process_group_ranks(
            mesh.group(data_axis))
        dm = mesh.device_mesh("cpu")
        out["device_mesh"] = {
            a: dist.get_process_group_ranks(dm.get_group(a))
            for a in mesh.axis_names}
    return out


def _count_kernel_calls() -> dict:
    """Count the calls of the ``rmsnorm`` and ``flash_attention`` wrappers
    on the pipeline step's path: ``fwd`` every call (a forward launch on
    the card), ``bwd`` those under grad with an input that requires one
    (a call through the autograd Function: one backward launch)."""
    from repro_torch.launch import pp_step
    from repro_torch.models import layers
    counts = {}

    def spy(mod, name):
        real = getattr(mod, name)
        counts[name] = {"fwd": 0, "bwd": 0}

        def call(*args, **kw):
            counts[name]["fwd"] += 1
            if torch.is_grad_enabled() and any(
                    isinstance(a, torch.Tensor) and a.requires_grad
                    for a in args):
                counts[name]["bwd"] += 1
            return real(*args, **kw)
        setattr(mod, name, call)

    spy(layers, "rmsnorm")
    spy(pp_step, "flash_attention")
    return counts


def _stored_bytes(*trees) -> int:
    """The bytes of every storage the tensors of ``trees`` hold, each
    once (a view that keeps a whole tensor alive counts it all)."""
    from repro_torch._tree import leaves
    held = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for tree in trees for t in leaves(tree)}
    return sum(held.values())


def pp_train_step(rank, world, case):
    """One step of ``make_pp_train_step`` on this rank: returns the loss,
    this rank's parameters after the update (its FSDP blocks of the
    shared leaves), the bytes it stores before and after the step
    (parameters and AdamW's state) and those the spec trees give it
    (``specs.shard_sizes``)."""
    from repro_torch._tree import leaves
    from repro_torch.launch import specs as SP
    from repro_torch.launch.pp_step import (init_pp_state, make_pp_train_step,
                                            shard_pp_params)
    from repro_torch.optim.adamw import AdamW
    mesh = Mesh(case["ranks"], case["axes"])
    cfg = case["cfg"]
    counts = _count_kernel_calls()
    opt = AdamW(lr=1e-3, eps=case["eps"])
    step, p_spec, o_spec, _ = make_pp_train_step(
        cfg, mesh, opt, pipe_axis=case["pipe_axis"],
        data_axis=case["data_axis"], n_mb=case["n_mb"], remat=case["remat"])
    c = mesh.coords(rank)
    pp = mesh.shape[case["pipe_axis"]]
    per = cfg.n_layers // pp
    s = c[case["pipe_axis"]]
    params = shard_pp_params(
        {"stages": {k: _t(v[s * per:(s + 1) * per]).clone()
                    for k, v in case["layers"].items()},
         "shared": {k: _t(v).clone() for k, v in case["shared"].items()}},
        p_spec, mesh, rank)
    nd = mesh.shape[case["data_axis"]]
    mb = case["tokens"].shape[1] // nd
    cut = slice(c[case["data_axis"]] * mb, (c[case["data_axis"]] + 1) * mb)
    batch = {"tokens_mb": case["tokens"][:, cut],
             "labels_mb": case["labels"][:, cut]}
    state = init_pp_state(params, o_spec, mesh)
    before = _stored_bytes(params, state)
    C.reset_stats()
    new, state, m = step(params, state, batch)
    stats = dict(C.STATS)
    spec_bytes = sum(leaves(SP.shard_sizes(p_spec, mesh, rank))
                     + leaves(SP.shard_sizes(o_spec, mesh, rank)))
    return {"loss": float(m["loss"]), "stage": s,
            "calls": {k: dict(v) for k, v in counts.items()},
            "coords": c, "stored_before": before, "stats": stats,
            "stored_after": _stored_bytes(new, state),
            "spec_bytes": spec_bytes,
            "stages": {k: v.numpy() for k, v in new["stages"].items()},
            "shared": {k: v.numpy() for k, v in new["shared"].items()}}


def reduce_scatter_case(rank, world, case):
    """``collectives.reduce_scatter`` on this rank against ``all_reduce``
    then this rank's block, over the lines of a permuted (data 2, model 2)
    mesh and of a permuted line of 4: float32 and bfloat16 tensors cut on
    different dims in one call, ``sum`` and ``mean``.  Returns both
    results (as bits) for each line, and the inputs the rank used."""
    out = {}
    for name, ranks, axes, axis in (
            ("data2", case["ranks2"], ("data", "model"), "data"),
            ("line4", case["ranks4"], ("data",), "data")):
        mesh = Mesh(ranks, axes)
        xs = [_t(a[rank]).to(getattr(torch, dt))
              for a, dt in zip(case["inputs"], case["dtypes"])]
        for op in ("sum", "mean"):
            got = C.reduce_scatter([x.clone() for x in xs], mesh, axis,
                                   case["dims"], op)
            whole = [x.clone() for x in xs]
            C.all_reduce(whole, mesh, axis, op)
            c, n = mesh.coords(rank)[axis], mesh.shape[axis]
            want = [w.narrow(d, c * (w.shape[d] // n), w.shape[d] // n)
                    for w, d in zip(whole, case["dims"])]
            out[name, op] = ([g.float().numpy() for g in got],
                             [w.float().numpy() for w in want],
                             mesh.axis_ranks(axis, rank))
    return out


def four_rank_cases(rank, world, cases):
    """The 4-rank cases of one spawn, in turn: the two pipelines, the
    train steps (whose wrapper spies stay installed in this process), the
    reduce-scatter."""
    return {"pp4": tanh_pipeline(rank, world, cases["pp4"]),
            "pp2dp2": tanh_pipeline(rank, world, cases["pp2dp2"]),
            "step": pp_train_step(rank, world, cases["step"]),
            "step_pp4": pp_train_step(rank, world, cases["step_pp4"]),
            "reduce_scatter": reduce_scatter_case(rank, world,
                                                  cases["reduce_scatter"])}


def moe_expert_parallel(rank, world, case):
    """``moe_block`` on the (data, model) mesh for every case of
    ``case["cases"]``: this rank's output block and the gradients of its
    ``x`` block and expert blocks (and of the router) under the loss
    ``sum(y * cot)``."""
    from repro_torch.models.moe import moe_block, shard_moe_params
    mesh = Mesh(case["ranks"], ("data", "model"))
    c = mesh.coords(rank)
    out = []
    for cs in case["cases"]:
        nd = mesh.shape["data"]
        b = cs["x"].shape[0] // nd
        cut = slice(c["data"] * b, (c["data"] + 1) * b)
        x = _t(cs["x"][cut]).requires_grad_()
        whole = {k: _t(cs[k]) for k in ("router", "gate", "up", "down")}
        local = shard_moe_params(whole, mesh, rank, data_axes=("data",),
                                 fsdp=cs["fsdp"])
        local = {k: v.clone().requires_grad_() for k, v in local.items()}
        y = moe_block(x, local, k=cs["k"], n_experts=cs["e"],
                      capacity_factor=8.0, mesh=mesh, data_axes=("data",),
                      model_axis="model", fsdp=cs["fsdp"])
        torch.sum(y * _t(cs["cot"][cut])).backward()
        out.append({"y": y.detach().numpy(), "dx": x.grad.numpy(),
                    **{"d" + k: v.grad.numpy() for k, v in local.items()}})
    return {"coords": c, "cases": out}


def staged_p2p_on_gpu(rank, world, arrays):
    """Rank 0 sends each CUDA tensor to rank 1 through the host staging of
    ``gloo``; rank 1 returns what it received, as NumPy bits."""
    dev = torch.device("cuda", 0)
    got = []
    for name, (a, dtype) in arrays.items():
        t = _t(a).view(getattr(torch, dtype))
        if rank == 0:
            C.send(t.to(dev), 1).wait()
        else:
            r = C.recv(t.shape, t.dtype, dev, 0)
            got.append((name, r.cpu().view(torch.int16 if dtype ==
                                           "bfloat16" else torch.int32)
                        .numpy()))
    return got


# ---------------------------------------------------------------------------
# the model under an active ShardCtx (tests/test_torch_tensor_parallel.py)
# ---------------------------------------------------------------------------

def _count_model_calls(scan: bool = False) -> dict:
    """Count the calls of the norm and attention wrappers on the model's
    path (``models/layers.py``'s two norms, ``models/transformer.py``'s
    attention; with ``scan``, ``models/mamba.py``'s fused scan too):
    ``fwd`` every call, ``bwd`` those under grad with an input that
    requires one."""
    from repro_torch.models import layers, mamba, transformer
    counts = {"rmsnorm": {"fwd": 0, "bwd": 0},
              "flash_attention": {"fwd": 0, "bwd": 0}}
    if scan:
        counts["selective_scan"] = {"fwd": 0, "bwd": 0}

    def spy(mod, name, key):
        real = getattr(mod, name)

        def call(*args, **kw):
            counts[key]["fwd"] += 1
            if torch.is_grad_enabled() and any(
                    isinstance(a, torch.Tensor) and a.requires_grad
                    for a in args):
                counts[key]["bwd"] += 1
            return real(*args, **kw)
        setattr(mod, name, call)

    spy(layers, "rmsnorm", "rmsnorm")
    spy(layers, "add_rmsnorm", "rmsnorm")
    spy(transformer, "flash_attention", "flash_attention")
    if scan:
        spy(mamba, "selective_scan_fused", "selective_scan")
    return counts


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().numpy()


_MESHES = {}


def tp_model_case(rank, world, case):
    """One case of the model under ``ShardCtx(mesh, dp=("data",),
    tp="model", fsdp=...)`` on this rank: ``case`` holds the config's
    keyword arguments, the mesh's ranks, ``fsdp``, the reference's whole
    parameters (NumPy) and the global batch.  ``kind == "grad"``: the
    loss of this rank's rows and the gradients of its blocks (summed over
    the data axes, ``steps.sync_grads``); ``kind == "step"``: one
    ``make_train_step`` step with ``n_micro`` microbatches and AdamW
    (lr 1e-3, ``eps``), its loss and this rank's blocks after it.  Also
    the bytes staged by kind and the wrapper calls."""
    from repro_torch._tree import tree_map
    from repro_torch.convert import params_from_reference
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models import sharding as sh
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim.adamw import AdamW
    # one Mesh per rank layout, so its groups are made once for all cases
    key = (case["ranks"].shape, case["ranks"].tobytes())
    mesh = _MESHES.setdefault(key, Mesh(case["ranks"], ("data", "model")))
    ctx = sh.ShardCtx(mesh=mesh, dp=("data",), tp="model",
                      fsdp=("data",) if case["fsdp"] else ())
    cfg = ModelConfig(**case["cfg"])
    local = sh.shard_params(params_from_reference(case["params"], "cpu"),
                            cfg, ctx, rank)
    counts = _count_model_calls(scan=cfg.family == "ssm")
    C.reset_stats()
    n_micro = case.get("n_micro", 1)
    batch = steps.shard_batch(case["batch"], ctx, rank, n_micro)
    out = {"coords": mesh.coords(rank)}
    if case["kind"] == "grad":
        p = tree_map(lambda t: t.detach().requires_grad_(), local)
        loss, aux = M.loss_fn(p, cfg, ctx, {k: _t(v) if v.dtype.kind == "f"
                                             else _t(v).long()
                                             for k, v in batch.items()})
        loss.backward()
        grads = tree_map(lambda t: t.grad if t.grad is not None
                         else torch.zeros_like(t), p)
        steps.sync_grads(grads, cfg, ctx)
        out.update(loss=float(loss.detach()), tokens=float(aux["tokens"]),
                   grads=_np_tree(grads))
    else:
        opt = AdamW(lr=1e-3, eps=case["eps"],
                    grad_clip=case.get("grad_clip", 1.0))
        zero1 = case.get("zero1", False)
        step = steps.make_train_step(cfg, ctx, opt, n_micro=n_micro,
                                     zero1=zero1)
        state = (steps.init_sharded(local, cfg, ctx) if zero1
                 else opt.init(local))
        new, state, m = step(local, state, batch)
        out.update(loss=float(m["loss"]), params=_np_tree(new),
                   moment_bytes=_stored_bytes(state.m, state.v))
        if zero1:
            from repro_torch._tree import leaves
            from repro_torch.launch import specs as SP
            o = SP.opt_spec(cfg, ctx, opt, zero1=True)
            out["moment_spec_bytes"] = sum(
                leaves(SP.shard_sizes(o.m, mesh, rank))
                + leaves(SP.shard_sizes(o.v, mesh, rank)))
    # a copy: the spies of this case go on counting in the later ones
    out.update(stats=dict(C.STATS),
               calls={k: dict(v) for k, v in counts.items()})
    return out


def tp_model_cases(rank, world, cases):
    """Every case of ``cases`` (name -> case) in turn on this rank."""
    return {name: tp_model_case(rank, world, cs)
            for name, cs in cases.items()}


# ---------------------------------------------------------------------------
# prefill and decode under an active ShardCtx (tests/test_torch_serve_parallel.py)
# ---------------------------------------------------------------------------

def _case_mesh(ranks):
    """One :class:`Mesh` per rank layout (its groups made once for all
    cases), or None for a rank outside it, which makes the same groups
    (``new_group`` is collective over the whole process group) and sits
    the case out."""
    key = (ranks.shape, ranks.tobytes())
    if key not in _MESHES:
        mesh = Mesh(ranks, ("data", "model"))
        if dist.get_rank() in ranks:
            for a in mesh.axis_names:
                mesh.group(a)
        else:
            for i in range(ranks.ndim):
                for line in np.moveaxis(ranks, i, -1).reshape(
                        -1, ranks.shape[i]):
                    dist.new_group([int(r) for r in line])
            mesh = None
        _MESHES[key] = mesh
    return _MESHES[key]


def _serve_rows(a, ctx, rank, batch):
    """The rows of a global ``(batch, ...)`` array this rank computes:
    its data shard's when the batch divides the data axes, else all."""
    nd = ctx.n("data")
    if batch % nd:
        return a
    per = batch // nd
    c = ctx.mesh.coords(rank)["data"]
    return a[c * per:(c + 1) * per]


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    return chip_smoke


def _combine_unscaled():
    """``tools/tp_faults.py``'s ``combine_unscaled`` fault (importing the
    tool plants nothing while ``TP_FAULT`` is unset)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import tp_faults
    return tp_faults.combine_unscaled


def tp_serve_case(rank, world, case):
    """``make_prefill_step`` of the prompt, then teacher-forced
    ``make_decode_step`` steps under ``ShardCtx(mesh, dp=("data",),
    tp="model")`` on this rank, from the reference's whole decode cache
    (cut by ``cache_specs``), or, where ``case["chain"]``, from this
    rank's own prefill cache grown to the decode cache's positions (the
    chip phase's glue, ``chip_smoke._regrow``): the
    prefill logits' vocabulary block and cache blocks, each step's logits
    block and greedy token, and the cache blocks after the last step.
    Also a greedy token over planted ties across the vocabulary blocks,
    the bytes staged by kind and the wrapper calls, and what
    ``chip_smoke.CombineWatch`` reads of each step's combined attention
    (``case["fault"] == "combine_unscaled"`` plants that fault for the
    case's decode steps)."""
    from repro_torch.convert import params_from_reference
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models import sharding as sh
    from repro_torch.models.config import ModelConfig
    mesh = _case_mesh(case["ranks"])
    if mesh is None:
        return None
    ctx = sh.ShardCtx(mesh=mesh, dp=("data",), tp="model")
    cfg = ModelConfig(**case["cfg"])
    params = sh.shard_params(params_from_reference(case["params"], "cpu"),
                             cfg, ctx, rank)
    b = case["tokens"].shape[0]
    counts = _count_model_calls(scan=cfg.family == "ssm")
    C.reset_stats()
    out = {"coords": mesh.coords(rank)}
    with torch.no_grad():
        toks = _t(_serve_rows(case["tokens"], ctx, rank, b)).long()
        logits, cache = steps.make_prefill_step(cfg, ctx)(
            params, {"tokens": toks}, batch=b)
        out["prefill_logits"] = logits.numpy()
        out["prefill_cache"] = {k: v.numpy() for k, v in cache.items()}
        out["prefill_stats"] = dict(C.STATS)
        if case.get("chain"):
            cache = _chip_smoke()._regrow(cache, cfg, ctx, b, toks.shape[1],
                                          case["seq_len"])
        else:
            specs = M.cache_specs(cfg, ctx, b, case["seq_len"])
            cache = {k: sh.shard_leaf(_t(v), specs[k], mesh, rank).clone()
                     for k, v in case["cache"].items()}
        step = steps.make_decode_step(cfg, ctx)
        out["logits"], out["greedy"] = [], []
        real_combine = M.combine_partials
        if case.get("fault") == "combine_unscaled":
            M.combine_partials = _combine_unscaled()
        watch = _chip_smoke().CombineWatch(cfg, ctx, b, case["seq_len"])
        C.reset_stats()
        try:
            with watch:
                for j, tok in enumerate(case["feed"]):
                    tok = _t(_serve_rows(tok, ctx, rank, b)).long()
                    nxt, lg, cache = step(params, cache, tok,
                                          case["pos"] + j, batch=b,
                                          seq_len=case["seq_len"])
                    watch.check()
                    out["logits"].append(lg.numpy())
                    out["greedy"].append(nxt.numpy())
        finally:
            M.combine_partials = real_combine
        out["decode_stats"] = dict(C.STATS)
        out["combine_steps"] = watch.steps
        out["cache"] = {k: v.numpy() for k, v in cache.items()}
        # ties planted across the vocabulary blocks: the lowest index wins
        tied = torch.zeros(2, cfg.padded_vocab)
        tied[0, [3, cfg.padded_vocab - 2]] = 5.0
        tied[1, [cfg.padded_vocab // 2 + 1, cfg.padded_vocab - 1]] = 7.0
        cut = M._vocab_cut(cfg, ctx)
        v0, n = cut if cut is not None else (0, cfg.padded_vocab)
        out["tie"] = steps.greedy_token(tied[:, v0:v0 + n], cfg, ctx).numpy()
    out["calls"] = {k: dict(v) for k, v in counts.items()}
    return out


def tp_serve_cases(rank, world, cases):
    """Every case of ``cases`` (name -> case) in turn on this rank; the
    training cases (``kind`` ``"grad"`` or ``"step"``) go to
    :func:`tp_model_case`."""
    out = {}
    for name, cs in cases.items():
        if cs.get("kind") in ("grad", "step"):
            mesh = _case_mesh(cs["ranks"])
            out[name] = None if mesh is None else \
                tp_model_case(rank, world, cs)
        else:
            out[name] = tp_serve_case(rank, world, cs)
    return out


def zero1_on_gpu(rank, world, case):
    """One ``make_train_step`` step on the card as this rank of a (data 2,
    model 1) mesh, replicated and then ZeRO-1 (``zero1=True``), both
    without the grad clip, from the same weights and rows: each run's loss
    and parameters as bits, and the ZeRO-1 run's stored moment bytes with
    the spec's."""
    from repro_torch._tree import leaves
    from repro_torch.launch import specs as SP
    from repro_torch.launch import steps
    from repro_torch.models import sharding as sh
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamW
    torch.cuda.set_device(0)
    cfg = ModelConfig(**case["cfg"])
    mesh = Mesh(np.arange(2).reshape(2, 1), ("data", "model"))
    ctx = sh.ShardCtx(mesh=mesh, dp=("data",), tp="model")
    batch = steps.shard_batch(case["batch"], ctx, rank, 1)
    out = {}
    for zero1 in (False, True):
        params = sh.shard_params(init_params(cfg, seed=0, device="cuda"),
                                 cfg, ctx, rank)
        opt = AdamW(lr=1e-3, grad_clip=0.0)
        state = (steps.init_sharded(params, cfg, ctx) if zero1
                 else opt.init(params))
        step = steps.make_train_step(cfg, ctx, opt, zero1=zero1)
        new, state, m = step(params, state, batch)
        out[zero1] = {"loss": float(m["loss"]), "bits": [
            t.detach().cpu().view(torch.int16 if t.dtype == torch.bfloat16
                                  else torch.int32).numpy()
            for t in leaves(new)]}
        if zero1:
            o = SP.opt_spec(cfg, ctx, opt, zero1=True)
            out["moment_bytes"] = _stored_bytes(state.m, state.v)
            out["moment_spec_bytes"] = sum(
                leaves(SP.shard_sizes(o.m, mesh, rank))
                + leaves(SP.shard_sizes(o.v, mesh, rank)))
    return out

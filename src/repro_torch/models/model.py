"""Top-level model API: logits, the training loss, prefill, decode.

Port of the JAX package's ``models/model.py`` for every family: dense,
MoE, SSM (Mamba1, Mamba2), hybrid, vlm and audio (a vlm prompt carries
image embeddings ahead of its text, :func:`embed_inputs`).  Decode walks
the layers in the reference's segments (runs of layers with the same
kind, cache kind, window and theta) with a plain loop, so heterogeneous
caches stay exact: full KV rows for global-attention layers, ring buffers
for sliding-window layers (gemma3 locals), SSM state and conv tails for
Mamba layers, and the rows of the hybrid's weight-tied attention block
after the full-attention layers' (one row per application).  :func:`decode_step` updates the cache in
place, where the reference donates it to ``jit`` (``donate_argnums``) and
gets a new one back.  In a decode step each block's output is added to the
residual stream by the norm that follows it, the final norm included (one
``add_rmsnorm`` launch each).  :func:`loss_fn` is the training objective
that ``launch/steps.py::make_train_step`` differentiates.

Under an active context every entry point runs this rank's part: the
embedding looks up the rows of the vocabulary this rank holds and sums
over the model axis, the head computes this rank's vocabulary columns,
and the loss is a vocabulary-parallel cross-entropy whose masked mean is
taken over the global batch.  :func:`prefill` returns this rank's blocks
of the decode cache under :func:`cache_specs` (the reference's
``cache_pspecs``, with the axes that do not divide dropped), and
:func:`decode_step` takes them: a full cache's sequence is cut over the
model axis (and the data axes, where the batch does not divide them),
and each rank attends over its block, the blocks combined as
flash-decoding combines them (``attention.py::combine_partials``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from . import mamba as mam
from .attention import (combine_partials, decode_attention,
                        decode_attention_partial)
from .config import ModelConfig
from .layers import residual_norm, rms_norm
from . import sharding as sh
from .sharding import P, ShardCtx
from .transformer import (_local_heads, _out_proj, _proj_qkv, attn_mode,
                          check_family, init_params, kv_whole, layer_params,
                          layer_plan, mlp_block, moe_mlp, run_stack)

__all__ = ["init_params", "forward_logits", "loss_fn", "prefill",
           "init_cache", "decode_step", "cache_pspecs", "cache_specs"]


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def _vocab_cut(cfg: ModelConfig, ctx) -> Any:
    """``(v0, n)``: the first row and the number of rows of the padded
    vocabulary this rank holds under an active context, or None when the
    vocabulary is not cut over the model axis (or no context is
    active)."""
    if ctx is None or not ctx.active:
        return None
    if ctx.tp not in sh.spec_axes(sh.use_specs(cfg, ctx)["tok_embed"][0]):
        return None
    n = cfg.padded_vocab // ctx.n(ctx.tp)
    return sh.coord(ctx, ctx.tp) * n, n


def embed_inputs(params, cfg: ModelConfig, tokens, img_embeds=None,
                 ctx=None):
    """Token embeddings ``(b, s, d)`` and positions ``(b, s)`` int32; image
    embeddings ``(b, n_img, d)``, when given, go ahead of the text (cast to
    the embeddings' type) and ``s`` counts both.

    Under an active context ``tokens`` and ``img_embeds`` are this data
    shard's rows and ``tok_embed`` this rank's block: gathered over the
    FSDP axes, it looks up the tokens in its rows of the vocabulary,
    zeros stand for the others, and the sum over the model axis adds
    exact zeros, so the embedding is bit-equal to the whole table's.

    The rows are looked up with ``F.embedding``: its backward sums a
    token's gradients in one order on every run, where advanced indexing
    (``table[tokens]``, an accumulating ``index_put_`` backward) sums them
    in the order the CPU's threads reach them."""
    if ctx is not None and ctx.active:
        from ..launch import collectives as C
        table = sh.fsdp_gather(params["tok_embed"],
                               sh.use_specs(cfg, ctx)["tok_embed"], ctx)
        cut = _vocab_cut(cfg, ctx)
        if cut is None:
            x = F.embedding(tokens, table)
        else:
            v0, n = cut
            local = tokens - v0
            inside = (local >= 0) & (local < n)
            x = F.embedding(local.clamp(0, n - 1), table)
            x = torch.where(inside[..., None], x, torch.zeros(
                (), dtype=x.dtype, device=x.device))
            x = C.sum_over(x, ctx.mesh, ctx.tp, "vocab")
    else:
        x = F.embedding(tokens, params["tok_embed"])    # (b, s_text, d)
    if img_embeds is not None:
        x = torch.cat([img_embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    return x, positions


def _head(params, cfg: ModelConfig, ctx=None):
    """The head ``(d, V)`` (under an active context this rank's columns,
    gathered over the FSDP axes): ``lm_head``, or ``tok_embed.T`` when
    the embeddings are tied (whose rows are the same columns)."""
    tied = cfg.tie_embeddings or "lm_head" not in params
    key = "tok_embed" if tied else "lm_head"
    w = params[key]
    if ctx is not None and ctx.active:
        w = sh.fsdp_gather(w, sh.use_specs(cfg, ctx)[key], ctx)
    return w.T if tied else w


def _project_logits(x, params, cfg: ModelConfig, ctx=None):
    """Final projection with phantom-row masking (padded_vocab is exact).

    The reference computes ``x.astype(bfloat16) @ head``; with a float32
    head (a ``reduced()`` config) jnp promotes the product to float32.
    ``torch.matmul`` refuses mixed types, so the promotion is replayed:
    round ``x`` to bfloat16, then multiply in the promoted type.  Under an
    active context, this rank's vocabulary columns (the phantom mask by
    global column)."""
    head = _head(params, cfg, ctx)
    cut = _vocab_cut(cfg, ctx)
    v0, n = (0, cfg.padded_vocab) if cut is None else cut
    rt = torch.promote_types(torch.bfloat16, head.dtype)
    xr = x.to(torch.bfloat16).to(rt)
    if cut is not None:
        # after the casts: the ranks' partial cotangents are summed in the
        # product's type, then rounded to bfloat16 once, as one device does
        from ..launch import collectives as C
        xr = C.copy_to(xr, ctx.mesh, ctx.tp, "vocab")
    logits = xr @ head.to(rt)
    if cfg.padded_vocab != cfg.vocab_size:
        phantom = v0 + torch.arange(n, device=logits.device) \
            >= cfg.vocab_size
        bias = torch.zeros(n, dtype=torch.float32,
                           device=logits.device).masked_fill(phantom, -1e30)
        logits = logits + bias.to(logits.dtype)
    return logits


def forward_logits(params, cfg: ModelConfig, ctx: ShardCtx, tokens,
                   img_embeds=None):
    """Logits ``(b, s, padded_vocab)`` of every position.  Under an
    active context, this rank's block ``(b / dp, s, padded_vocab / tp)``:
    its data shard's rows (``tokens`` and ``img_embeds`` are those rows)
    and its vocabulary columns (all of them when the vocabulary does not
    divide the model axis)."""
    x, positions = embed_inputs(params, cfg, tokens, img_embeds, ctx)
    x, _ = run_stack(x, params, cfg, ctx, positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _project_logits(x, params, cfg, ctx)


def loss_fn(params, cfg: ModelConfig, ctx: ShardCtx, batch
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy over the valid labels (``labels >= 0``;
    negative labels are masked), over the padded vocabulary, in float32.
    Returns ``(loss, {"loss": loss, "tokens": n})``.

    The reference picks each label's logit by an einsum with a one-hot
    ``(b, s, V)`` float32 tensor.  Every term it adds besides the label's
    own is ``logit * 0``, an exact zero (no logit is infinite: phantom rows
    carry -1e30), so taking the label's logit with ``gather`` is bit-equal
    and never makes the one-hot (1.2 GB at qwen2-7b's vocabulary and a
    batch of 4 x 512).

    Under an active context ``batch`` is this data shard's rows and the
    result the global batch's loss, on every rank: a vocabulary-parallel
    cross-entropy (the max and the sum of exponentials over the model
    axis, the label's logit from the rank that holds its column), then
    the sum of ``nll * mask`` and the count of valid labels each summed
    over the data axes before the divide (a mean of the shards' means
    would weigh them wrongly when labels are masked)."""
    from ..launch import collectives as C
    logits = forward_logits(params, cfg, ctx, batch["tokens"],
                            batch.get("img_embeds"))
    labels = batch["labels"]
    lf = logits.float()
    cut = _vocab_cut(cfg, ctx)
    if cut is None:
        lse = torch.logsumexp(lf, dim=-1)
        safe = labels.clamp_min(0).long()
        picked = torch.gather(lf, -1, safe[..., None])[..., 0]
    else:
        v0, n_loc = cut
        mx = C.max_over(lf.amax(dim=-1), ctx.mesh, ctx.tp)
        se = torch.exp(lf - mx[..., None]).sum(dim=-1)
        lse = mx + torch.log(C.sum_over(se, ctx.mesh, ctx.tp, "vocab"))
        local = labels.long() - v0
        inside = (local >= 0) & (local < n_loc)
        picked = torch.gather(lf, -1, local.clamp(0, n_loc - 1)[..., None])
        picked = torch.where(inside, picked[..., 0], torch.zeros(
            (), dtype=lf.dtype, device=lf.device))
        picked = C.sum_over(picked, ctx.mesh, ctx.tp, "vocab")
    nll = lse - picked
    mask = (labels >= 0).float()
    total, n = (nll * mask).sum(), mask.sum()
    if ctx is not None and ctx.active:
        n = n.detach().clone()
        for a in ctx.dp:
            C.all_reduce([n], ctx.mesh, a, "sum", "data")
            total = C.sum_over(total, ctx.mesh, a, "data")
    n = torch.clamp_min(n, 1.0)
    loss = total / n
    return loss, {"loss": loss, "tokens": n}


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, ctx: ShardCtx, tokens,
            img_embeds=None, *, batch=None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full-sequence pass that returns ``(last_token_logits, cache)``.

    The cache holds ``k, v`` ``(n_full, b, S, KV, hd)`` for full-attention
    layers, ``k_ring, v_ring`` ``(n_ring, b, window, KV, hd)`` for
    sliding-window layers (``S`` must be a multiple of the window), and
    ``ssm`` ``(L, b, d_inner, N)`` float32 and ``conv`` ``(L, b, W-1,
    d_inner)`` for Mamba1 layers (``(L, b, H, P, N)`` and ``(L, b, W-1,
    d_inner + 2N)`` for Mamba2).  A hybrid's ``k, v`` are its shared
    block's, one row per application.

    Under an active context ``batch``, the global batch, is required
    (``ValueError`` without it): ``tokens`` (and ``img_embeds``) are the
    rows this rank computes — its data shard's when ``batch`` divides the
    data axes, else every row — and the result is this rank's: the logits
    of its vocabulary block (as :func:`forward_logits`), and its blocks of
    the cache under :func:`cache_specs` (the KV rows put together over
    the model axis, :func:`~repro_torch.models.transformer.kv_whole`, then
    cut along the sequence)."""
    active = ctx is not None and ctx.active
    if active and batch is None:
        raise ValueError("prefill under an active context needs the global "
                         "batch (batch=)")
    x, positions = embed_inputs(params, cfg, tokens, img_embeds, ctx)
    s = x.shape[1]
    x, raw = run_stack(x, params, cfg, ctx, positions, collect_cache=True)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = _project_logits(x, params, cfg, ctx)

    def whole(t):
        return kv_whole(t, cfg, ctx, s) if active else t

    plan, meta = layer_plan(cfg)
    cache: Dict[str, Any] = {}
    if cfg.family in ("ssm", "hybrid"):
        if meta["shared_at"]:
            raw, shared_kv = raw
            cache["k"], cache["v"] = (whole(t) for t in shared_kv)
        cache["ssm"], cache["conv"] = raw
    else:
        k, v = (whole(t) for t in raw)                  # (L, b, S, KV, hd)
        full_rows = [i for i, e in enumerate(plan)
                     if e["cache"][0] == "full"]
        ring_rows = [(i, e["cache"][2]) for i, e in enumerate(plan)
                     if e["cache"][0] == "ring"]
        if full_rows:
            idx = torch.as_tensor(np.array(full_rows), device=k.device)
            cache["k"], cache["v"] = k[idx], v[idx]
        if ring_rows:
            w = ring_rows[0][1]
            idx = torch.as_tensor(np.array([i for i, _ in ring_rows]),
                                  device=k.device)
            if s % w:
                raise ValueError(f"prefill length {s} must be a multiple of "
                                 f"the sliding window {w} (ring caches)")
            cache["k_ring"], cache["v_ring"] = k[idx, :, -w:], v[idx, :, -w:]
    if active and "k" in cache:
        seq = cache_specs(cfg, ctx, int(batch), s)["k"][2]
        for key in ("k", "v"):
            cache[key] = sh.shard_leaf(cache[key], P(None, None, seq),
                                       ctx.mesh, _rank()).contiguous()
    return logits[:, 0], cache


def _rank() -> int:
    from ..launch import collectives as C
    return C.rank()


def cache_pspecs(cfg: ModelConfig, ctx: ShardCtx, batch: int) -> Dict[str, P]:
    """Specs of the decode cache, the reference's: the batch over the data
    axes when it divides them, the sequence dim of full KV rows over the
    model axis (and over the data axes too when the batch does not
    divide), Mamba channels over the model axis."""
    dp = ctx.dp if ctx.dp else None
    nd = 1
    for a in (ctx.dp or ()):
        nd *= ctx.n(a)
    bspec = dp if (batch % max(nd, 1) == 0 and nd > 1) else None
    seq_axes = ctx.tp if bspec is not None else (ctx.tp,) + tuple(ctx.dp)
    specs = {"k": P(None, bspec, seq_axes, None, None),
             "k_ring": P(None, bspec, None, None, None)}
    specs["v"], specs["v_ring"] = specs["k"], specs["k_ring"]
    if cfg.ssm_variant == "mamba2":
        specs["ssm"] = P(None, bspec, ctx.tp, None, None)
    else:
        specs["ssm"] = P(None, bspec, ctx.tp, None)
    specs["conv"] = P(None, bspec, None, ctx.tp)
    return specs


def cache_specs(cfg: ModelConfig, ctx: ShardCtx, batch: int,
                seq_len: int) -> Dict[str, P]:
    """The spec of each leaf of ``init_cache(cfg, batch, seq_len)`` under
    an active context: :func:`cache_pspecs` with every axis that does not
    divide its dim dropped, as the reference's ``launch/specs.py``
    lays the cache out.  ``shard_leaf`` of the whole cache under these
    is a rank's cache; :func:`prefill` returns it and
    :func:`decode_step` takes it."""
    from torch.utils._python_dispatch import _disable_current_modes
    specs = cache_pspecs(cfg, ctx, batch)
    with _disable_current_modes():        # shapes only: no work of a step
        whole = init_cache(cfg, batch, seq_len, device="meta")
    return {k: sh.drop_non_dividing(specs[k], tuple(v.shape), ctx)
            for k, v in whole.items()}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device: DeviceLike = None
               ) -> Dict[str, Any]:
    """Zero caches of the shapes :func:`prefill` returns, for ``seq_len``
    positions of full attention (the hybrid's shared rows after the
    full-attention layers')."""
    check_family(cfg)
    device = resolve_device(device)
    plan, meta = layer_plan(cfg)
    kv, hd = cfg.n_kv_heads, cfg.hd
    cache: Dict[str, Any] = {}

    def z(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    n_full = meta["full"] + len(meta["shared_at"])
    if n_full:
        cache["k"] = z((n_full, batch, seq_len, kv, hd))
        cache["v"] = z((n_full, batch, seq_len, kv, hd))
    if meta["ring"]:
        w = next(e["cache"][2] for e in plan
                 if e.get("cache", ("",))[0] == "ring")
        cache["k_ring"] = z((meta["ring"], batch, w, kv, hd))
        cache["v_ring"] = z((meta["ring"], batch, w, kv, hd))
    if meta["ssm"]:
        if cfg.ssm_variant == "mamba2":
            state = (cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
            conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        else:
            state, conv_dim = (cfg.d_inner, cfg.ssm_state), cfg.d_inner
        cache["ssm"] = z((meta["ssm"], batch) + state, torch.float32)
        cache["conv"] = z((meta["ssm"], batch, cfg.ssm_conv - 1, conv_dim))
    return cache


def _segments(plan, shared_at=()) -> List[Tuple[tuple, List[int], dict]]:
    """Group consecutive layers with identical (kind, cache-kind, window,
    theta) into segments, breaking after shared-attention application
    points.  Returns ``[(sig, [indices], entry)]``."""
    segs = []
    breaks = set(shared_at)
    prev_broke = True
    for i, e in enumerate(plan):
        sig = (e["kind"], e.get("cache", ("ssm",))[0],
               e.get("cache", (None, None, 0))[2]
               if e.get("cache", ("", 0))[0] == "ring" else 0,
               e["theta"])
        if segs and segs[-1][0] == sig and not prev_broke:
            segs[-1][1].append(i)
        else:
            segs.append((sig, [i], e))
        prev_broke = i in breaks
    return segs


def _decode_attn(h, lp, ck, cv, cfg, ctx, pos: int, *, cache_kind, window,
                 theta, seq=None):
    """The attention of one decode step on the normed stream ``h`` ``(b,
    1, d)``: the new token's key and value written into the cache rows
    ``ck, cv`` in place, the attention over them, and the out-projection.

    Under an active context (:func:`_decode_attn_sharded`) ``ck, cv`` are
    this rank's block of the rows and ``seq`` the spec entry of their
    sequence dim."""
    if ctx is not None and ctx.active:
        return _decode_attn_sharded(h, lp, ck, cv, cfg, ctx, pos,
                                    cache_kind=cache_kind, window=window,
                                    theta=theta, seq=seq)
    b = h.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=h.device)
    q, k, v = _proj_qkv(h, lp, cfg, positions, theta)
    if cache_kind == "full":
        slot, last = pos, pos
    else:
        slot, last = pos % window, min(pos, window - 1)
    ck[:, slot:slot + 1] = k.to(ck.dtype)
    cv[:, slot:slot + 1] = v.to(cv.dtype)
    o = decode_attention(q, ck, cv, last)
    return _out_proj(o, lp["wo"])


def _decode_attn_sharded(h, lp, ck, cv, cfg, ctx, pos: int, *, cache_kind,
                         window, theta, seq):
    """This rank's part of a decode step's attention.  Where the heads are
    cut over the model axis the rank projects its query heads and the KV
    heads they read, and q, k and v are gathered over the axis (each KV
    head once); otherwise every rank projects all heads.  A full cache's
    sequence is cut over ``seq``'s axes: only the rank whose block holds
    ``pos`` writes the new key and value, every rank attends over its
    block (:func:`~repro_torch.models.attention.
    decode_attention_partial`), and the blocks are combined over those
    axes (``max_over``, then ``sum_over``: flash-decoding's combine); a
    ring cache, or a sequence that does not divide them, is held whole.
    ``wo`` is row-parallel over the rank's heads where those are cut,
    its partial output summed over the model axis."""
    from ..launch import collectives as C
    sp = sh.use_specs(cfg, ctx)
    mesh, tp = ctx.mesh, ctx.tp
    b = h.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=h.device)
    w = {k: sh.fsdp_gather(lp[k], sp[k], ctx)
         for k in ("wq", "wk", "wv", "wo")}
    bias = {k: lp[k] for k in ("bq", "bk", "bv") if k in lp}
    heads = attn_mode(cfg, ctx, 1) == "heads"
    proj = _local_heads(w, bias, cfg, ctx) if heads else {**w, **bias}
    q, k, v = _proj_qkv(h, proj, cfg, positions, theta)
    if heads:
        q = C.all_gather(q, mesh, tp, 2, "decode")
        k, v = (kv_whole(t, cfg, ctx, 1, "decode") for t in (k, v))
    if cache_kind != "full":
        slot, last = pos % window, min(pos, window - 1)
        ck[:, slot:slot + 1] = k.to(ck.dtype)
        cv[:, slot:slot + 1] = v.to(cv.dtype)
        o = decode_attention(q, ck, cv, last)
    else:
        n_blk = ck.shape[1]
        off = sh.block_index(seq, ctx) * n_blk
        if off <= pos < off + n_blk:
            ck[:, pos - off:pos - off + 1] = k.to(ck.dtype)
            cv[:, pos - off:pos - off + 1] = v.to(cv.dtype)
        axes = sh.spec_axes(seq)
        if not axes:
            o = decode_attention(q, ck, cv, pos)
        else:
            def max_fn(t):
                for a in axes:
                    t = C.max_over(t, mesh, a, "decode")
                return t

            def sum_fn(t):
                for a in axes:
                    t = C.sum_over(t, mesh, a, "decode")
                return t
            m, l, o = decode_attention_partial(q, ck, cv, pos, off)
            o = combine_partials(m, l, o, max_fn, sum_fn, q.dtype)
    if not heads:
        return _out_proj(o, w["wo"])
    n_loc = cfg.n_heads // ctx.n(tp)
    h0 = sh.coord(ctx, tp) * n_loc
    return C.sum_over(_out_proj(o[:, :, h0:h0 + n_loc], w["wo"]), mesh, tp)


def _decode_layer_body(x, pending, lp, ck, cv, cfg, ctx, pos: int, *,
                       kind, cache_kind, window, theta, seq=None):
    """One attention layer of a decode step on the residual stream ``x``
    plus the previous layer's ``pending`` output (None before the first
    layer).  ``ck, cv`` ``(b, S, KV, hd)`` are the layer's cache rows; the
    new token's key and value are written into them in place.  Returns
    ``(x, pending)``: the stream so far and this layer's MLP (or MoE)
    output, not yet added.  An MoE layer runs ``moe_block`` with its
    default combine and dispatch, whatever the config's knobs say, as the
    reference's decode does; under an active context, its
    expert-parallel path, and the MLP column- and row-parallel."""
    x, h = residual_norm(x, pending, lp["ln1"], cfg.norm_eps)
    a = _decode_attn(h, lp, ck, cv, cfg, ctx, pos, cache_kind=cache_kind,
                     window=window, theta=theta, seq=seq)
    x, h = residual_norm(x, a, lp["ln2"], cfg.norm_eps)
    if kind == "moe":
        return x, moe_mlp(h, lp, cfg, ctx)
    return x, mlp_block(h, lp, cfg, ctx)


def decode_step(params, cfg: ModelConfig, ctx: ShardCtx, token, cache,
                pos: int, *, batch=None, seq_len=None):
    """``token`` ``(b, 1)`` at position ``pos``; returns ``(logits (b,
    padded_vocab), cache)``.

    The cache is updated in place and returned (the reference donates its
    buffers to ``jit`` instead): a Mamba layer's scan writes its new state
    over the old one in its ``ssm`` row; full-attention rows need room for
    position ``pos``.  A hybrid runs its shared block after each segment
    that ends in ``meta["shared_at"]``, on cache row ``meta["full"]`` plus
    the number of applications before it.

    Under an active context the global ``batch`` and the cache's
    ``seq_len`` positions are required (``ValueError`` without them):
    ``token`` holds the rows this rank computes (as :func:`prefill`'s),
    ``cache`` is its blocks under :func:`cache_specs` for ``seq_len``
    positions, and the logits are its vocabulary block: the embedding vocabulary-parallel,
    the attention as :func:`_decode_attn_sharded`, the MLP, MoE and
    Mamba blocks as in training (a Mamba step on the rank's state rows,
    in place)."""
    check_family(cfg)
    pos = int(pos)
    plan, meta = layer_plan(cfg)
    seq = None
    if ctx is not None and ctx.active:
        if batch is None or seq_len is None:
            raise ValueError("decode_step under an active context needs the "
                             "global batch and the cache's positions "
                             "(batch=, seq_len=)")
        specs = cache_specs(cfg, ctx, int(batch), int(seq_len))
        seq = specs["k"][2] if "k" in specs else None
        x, _ = embed_inputs(params, cfg, token, None, ctx)
    else:
        x = params["tok_embed"][token]                  # (b, 1, d)
    # each block's output is added to the stream by the next norm
    pending = None
    shared_seen = 0
    for sig, idxs, _ in _segments(plan, meta["shared_at"]):
        kind, cache_kind, window, theta = sig
        for i in idxs:
            lp = layer_params(params, i)
            if kind in ("attn", "moe"):
                ckey, vkey = ("k", "v") if cache_kind == "full" else \
                    ("k_ring", "v_ring")
                row = plan[i]["cache"][1]
                x, pending = _decode_layer_body(
                    x, pending, lp, cache[ckey][row], cache[vkey][row], cfg,
                    ctx, pos, kind=kind, cache_kind=cache_kind,
                    window=window, theta=theta, seq=seq)
            else:                                       # mamba layer
                row = plan[i]["ssm_row"]
                x, h = residual_norm(x, pending, lp["ln1"], cfg.norm_eps)
                ssm = cache["ssm"][row]       # updated in place
                y, (_, cc) = mam.BLOCKS[kind](
                    h[:, 0], lp, cfg, ctx=ctx, h0=ssm,
                    conv0=cache["conv"][row], single_step=True, h_out=ssm)
                cache["conv"][row] = cc.to(cache["conv"].dtype)
                pending = y[:, None]
        if idxs[-1] in meta["shared_at"]:
            # hybrid: the weight-tied attention block, on its own cache row
            row = meta["full"] + shared_seen
            x, pending = _decode_layer_body(
                x, pending, params["shared"], cache["k"][row],
                cache["v"][row], cfg, ctx, pos, kind="attn",
                cache_kind="full", window=0, theta=cfg.rope_theta, seq=seq)
            shared_seen += 1
    _, x = residual_norm(x, pending, params["final_norm"], cfg.norm_eps)
    logits = _project_logits(x, params, cfg, ctx)
    return logits[:, 0], cache

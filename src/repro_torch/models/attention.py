"""Attention outside the prefill kernel: the chunked flash-pattern
attention, single-token decode against a KV cache, and the O(S^2) oracle
of the tests.

All three, and the partial decode over one block of a cache's sequence
with its combine (:func:`decode_attention_partial`,
:func:`combine_partials`), are plain PyTorch, as their counterparts in the JAX package's
``models/attention.py`` compute outside any Pallas kernel.  Full-sequence
attention of a prefill or a training step goes through the
``flash_attention`` kernel (:func:`repro_torch.models.transformer.
attn_block`); :func:`chunked_attention` is the reference's pure-jnp path,
kept as an oracle of the kernel written independently of its plain
version (the pipeline-parallel step, ``launch/pp_step.py``, runs the
kernel where the reference runs this function).  Layouts are
the reference's: ``(b, S, heads, head_dim)``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .layers import pick_chunk

NEG_INF = -1e30


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_offset: int = 0, chunk_q: int = 512,
                      chunk_k: int = 1024, min_q_blocks: int = 1,
                      block_constrain: Optional[Callable] = None
                      ) -> torch.Tensor:
    """Flash-pattern attention in float32: ``q`` ``(b, Sq, H, hd)``, ``k,
    v`` ``(b, Sk, KV, hd)`` (GQA when ``KV < H``); query ``i`` sits at
    position ``q_offset + i``.  Causal and sliding-window (``window > 0``)
    masks; a row with no allowed key comes out as zeros.

    The queries run in ``nq`` blocks of ``cq`` (the largest divisor of
    ``Sq`` at most ``chunk_q``, lowered until ``min_q_blocks`` divides
    ``nq``), all blocks at once as one batched dim (the reference's
    ``vmap``); the keys in blocks of ``ck``, with the online-softmax
    recurrence, so that no ``(Sq, Sk)`` score matrix is made beyond a
    ``(cq, ck)`` tile per block.  ``q`` is scaled by ``1/sqrt(hd)`` in
    float32 before the product; masked scores are ``NEG_INF`` (-1e30).
    Returns ``q``'s type.  ``block_constrain(t, dim)`` (the reference's
    q-block sharding hook) is called where the reference calls it: on the
    scaled query blocks ``(b, nq, cq, KV, G, hd)`` and on the output
    blocks ``(b, nq, KV, G, cq, hd)``, with the q-block dim 1; it returns
    the tensor to go on with (the reference's lays it out over a mesh, a
    layout only).  The model's sequence-sharded attention cuts the rows
    itself (``transformer.py::_attn_sharded``)."""
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    g = h // kv
    scale = 1.0 / (hd ** 0.5)
    f32 = torch.float32

    cq = pick_chunk(sq, chunk_q)
    if min_q_blocks > 1:
        while cq > 1 and (sq // cq) % min_q_blocks:
            cq -= 1
        cq = pick_chunk(sq, cq)
    ck = pick_chunk(sk, chunk_k)
    nq, nk = sq // cq, sk // ck
    window = int(window)

    qc = q.reshape(b, nq, cq, kv, g, hd).to(f32) * scale
    if block_constrain is not None:
        qc = block_constrain(qc, 1)
    kc = k.reshape(b, nk, ck, kv, hd).to(f32)
    vc = v.reshape(b, nk, ck, kv, hd).to(f32)
    q_pos = q_offset + torch.arange(sq, device=q.device).reshape(nq, cq)
    k_pos = torch.arange(sk, device=q.device).reshape(nk, ck)

    m = torch.full((b, nq, kv, g, cq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, nq, kv, g, cq), dtype=f32, device=q.device)
    acc = torch.zeros((b, nq, kv, g, cq, hd), dtype=f32, device=q.device)
    for j in range(nk):
        s = torch.einsum("bnqkgd,bckd->bnkgqc", qc, kc[:, j])
        delta = q_pos[:, :, None] - k_pos[j][None, None, :]      # (nq,cq,ck)
        ok = torch.ones_like(delta, dtype=torch.bool)
        if causal:
            ok &= delta >= 0
        if window > 0:
            ok &= delta < window
        s = torch.where(ok[None, :, None, None], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bnkgqc,bckd->bnkgqd", p, vc[:, j])
        acc = acc * corr[..., None] + pv
        m = m_new
    # rows with no allowed key (padded windows, negative offsets) -> 0
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = torch.where(m[..., None] <= NEG_INF * 0.5, torch.zeros_like(out),
                      out)
    if block_constrain is not None:
        out = block_constrain(out, 1)
    # (b, nq, kv, g, cq, hd) -> (b, nq, cq, kv, g, hd)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, sq, h, hd)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token attention against a KV cache.

    ``q`` is ``(b, 1, H, hd)``, the caches ``(b, S, KV, hd)``; ``pos`` is
    the index of the current token: cache rows ``<= pos`` (and within
    ``window`` of it when ``window > 0``) are attended.
    """
    b, _, h, hd = q.shape
    _, s, kvh, _ = k_cache.shape
    g = h // kvh
    scale = 1.0 / (hd ** 0.5)
    qf = q.reshape(b, kvh, g, hd).to(torch.float32) * scale
    kf = k_cache.to(torch.float32)
    vf = v_cache.to(torch.float32)
    sc = torch.einsum("bkgd,bskd->bkgs", qf, kf)
    k_pos = torch.arange(s, device=q.device)
    ok = k_pos <= pos
    if window > 0:
        ok &= pos - k_pos < window
    sc = torch.where(ok, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    out = torch.einsum("bkgs,bskd->bkgd", p, vf) / p.sum(-1, keepdim=True)
    return out.reshape(b, 1, h, hd).to(q.dtype)


def decode_attention_partial(q: torch.Tensor, k_block: torch.Tensor,
                             v_block: torch.Tensor, pos: int,
                             offset: int = 0) -> tuple:
    """Single-token attention of ``q`` ``(b, 1, H, hd)`` over one block of
    a KV cache's sequence, ``k_block, v_block`` ``(b, S_blk, KV, hd)``
    holding positions ``offset .. offset + S_blk - 1``, unnormalised: per
    query head the block's largest score ``m`` ``(b, H)``, its sum of
    exponentials ``l`` ``(b, H)`` and its weighted values ``o`` ``(b, H,
    hd)``, all float32 (flash-decoding's partial result).  Positions past
    ``pos`` are masked; a block with no allowed position gives ``m =
    -inf``, ``l = 0`` and ``o = 0``.  :func:`combine_partials` puts the
    blocks together."""
    b, _, h, hd = q.shape
    _, s, kvh, _ = k_block.shape
    g = h // kvh
    scale = 1.0 / (hd ** 0.5)
    qf = q.reshape(b, kvh, g, hd).to(torch.float32) * scale
    sc = torch.einsum("bkgd,bskd->bkgs", qf, k_block.to(torch.float32))
    k_pos = offset + torch.arange(s, device=q.device)
    ok = k_pos <= pos
    sc = torch.where(ok, sc, torch.full_like(sc, -torch.inf))
    m = sc.amax(dim=-1)                                          # (b,k,g)
    p = torch.exp(sc - torch.where(torch.isinf(m), 0.0, m)[..., None])
    l = p.sum(-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_block.to(torch.float32))
    return m.reshape(b, h), l.reshape(b, h), o.reshape(b, h, hd)


def combine_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                     max_fn: Callable, sum_fn: Callable,
                     dtype: torch.dtype) -> torch.Tensor:
    """The attention output ``(b, 1, H, hd)`` in ``dtype`` from the
    blocks' partial results of :func:`decode_attention_partial`:
    ``M = max_fn(m)``, then ``sum_fn`` of ``l e^(m - M)`` and of ``o
    e^(m - M)``, then the divide.  ``max_fn`` and ``sum_fn`` reduce over
    the blocks — over a mesh's axes (``collectives.max_over``,
    ``sum_over``), or over a leading dim of stacked blocks — and return
    a result that broadcasts against one block's."""
    big = max_fn(m)
    w = torch.exp(m - big)
    out = sum_fn(o * w[..., None]) / sum_fn(l * w)[..., None]
    b, h, hd = out.shape
    return out.reshape(b, 1, h, hd).to(dtype)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """O(S^2)-memory oracle used only in tests: ``q`` ``(b, Sq, H, hd)``,
    ``k, v`` ``(b, Sk, KV, hd)``; query ``i`` sits at position
    ``q_offset + i``."""
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    g = h // kv
    qf = q.reshape(b, sq, kv, g, hd).to(torch.float32) / (hd ** 0.5)
    s = torch.einsum("bqkgd,bckd->bkgqc", qf, k.to(torch.float32))
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    delta = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones_like(delta, dtype=torch.bool)
    if causal:
        ok &= delta >= 0
    if window and window > 0:
        ok &= delta < window
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bckd->bqkgd", p, v.to(torch.float32))
    return out.reshape(b, sq, h, hd).to(q.dtype)

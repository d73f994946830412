"""Attention outside the prefill kernel: single-token decode against a KV
cache, and the O(S^2) oracle of the tests.

Both are plain PyTorch, as their counterparts in the JAX package's
``models/attention.py`` compute outside any Pallas kernel.  Full-sequence
attention of a prefill goes through the ``flash_attention`` kernel
(:func:`repro_torch.models.transformer.attn_block`).  Layouts are the
reference's: ``(b, S, heads, head_dim)``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


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

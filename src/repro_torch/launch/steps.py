"""Prefill and decode steps used by the generation CLI (``generate.py``).

The reference wraps these in ``jax.jit``; PyTorch runs them eagerly, so a
step is a plain closure over the config.  ``make_train_step`` waits for the
training slice (ROADMAP Queue A 10).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..models import model as M
from ..models.config import ModelConfig
from ..models.sharding import ShardCtx


def make_prefill_step(cfg: ModelConfig, ctx: ShardCtx):
    def prefill_step(params, batch: Dict[str, Any]):
        logits, cache = M.prefill(params, cfg, ctx, batch["tokens"],
                                  batch.get("img_embeds"))
        return logits, cache
    return prefill_step


def make_decode_step(cfg: ModelConfig, ctx: ShardCtx):
    def serve_step(params, cache, token, pos: int):
        """Greedy step: returns ``(next_token (b, 1), logits, cache)``; the
        cache is updated in place."""
        logits, cache = M.decode_step(params, cfg, ctx, token, cache, pos)
        next_tok = torch.argmax(logits, dim=-1)[:, None]
        return next_tok, logits, cache
    return serve_step

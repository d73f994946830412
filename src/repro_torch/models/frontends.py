"""Modality frontend stubs.

Port of the JAX package's ``models/frontends.py``.  The ``vlm`` and
``audio`` configs describe the transformer backbone only: these helpers
make synthetic stand-ins of the inputs a real frontend would hand it, with
the reference's shapes, types and scale.

  * llava-next (anyres): 4 tiles + base image, 576 patches each -> 2880
    patch embeddings of d_model, already projected by the (stubbed)
    vision tower + mm projector.
  * musicgen: EnCodec tokens; the real model interleaves 4 codebooks with
    a delay pattern — the stub flattens them to a single stream over the
    2048-entry codebook vocabulary.

Both draw from an explicit ``torch.Generator`` on its own device.  The
draws differ from ``jax.random``'s, so tests hand both packages the same
NumPy arrays instead.
"""
from __future__ import annotations

import torch


def vlm_patch_embeddings(gen: torch.Generator, batch: int,
                         n_img_tokens: int, d_model: int,
                         dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Synthetic anyres patch embeddings ``(batch, n_img_tokens, d_model)``:
    ``N(0, 1) / sqrt(d_model)`` drawn in float32, cast to ``dtype``."""
    x = torch.randn((batch, n_img_tokens, d_model), generator=gen,
                    dtype=torch.float32, device=gen.device)
    return (x / (d_model ** 0.5)).to(dtype)


def audio_tokens(gen: torch.Generator, batch: int, seq_len: int,
                 vocab: int = 2048) -> torch.Tensor:
    """Synthetic EnCodec token stream ``(batch, seq_len)`` int32 in
    ``[0, vocab)``."""
    return torch.randint(0, vocab, (batch, seq_len), generator=gen,
                         dtype=torch.int32, device=gen.device)

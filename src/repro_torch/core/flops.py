"""Parameter and FLOP accounting shared by the configurator, the roofline
analysis and the benchmarks.

Conventions:
  * ``param_count``       — total trainable parameters.
  * ``active_param_count``— params touched per token (MoE: top-k experts).
  * ``train_flops``       — 6 * N_active * tokens (fwd 2N + bwd 4N) plus the
                            attention term 12 * L * d_head*H * s^2-ish when
                            requested explicitly (MODEL_FLOPS in the roofline
                            table uses the plain 6*N*D convention per spec).
"""
from __future__ import annotations

import numpy as np

from ..models.config import ModelConfig


def _per_layer_params(cfg: ModelConfig) -> int:
    """Trainable parameters of one repeated block (hybrid shared block and
    embedding/head/final-norm excluded)."""
    d = cfg.d_model
    per_layer = d                                # ln1
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        per_layer += d * h * hd + 2 * d * kv * hd + h * hd * d
        if cfg.qkv_bias:
            per_layer += h * hd + 2 * kv * hd
        per_layer += d                           # ln2
        if cfg.family == "moe":
            per_layer += d * cfg.n_experts
            per_layer += cfg.n_experts * 3 * d * cfg.d_ff
        else:
            per_layer += 3 * d * cfg.d_ff
    else:                                        # mamba layers
        di, N = cfg.d_inner, cfg.ssm_state
        if cfg.ssm_variant == "mamba2":
            nh = cfg.n_ssm_heads
            conv_dim = di + 2 * N
            per_layer += d * (2 * di + 2 * N + nh) + cfg.ssm_conv * conv_dim \
                + conv_dim + 3 * nh + di + di * d
        else:
            per_layer += d * 2 * di + cfg.ssm_conv * di + di \
                + di * (cfg.dt_rank + 2 * N) + cfg.dt_rank * di + di \
                + di * N + 2 * di + di * d
    return int(per_layer)


def shared_block_params(cfg: ModelConfig) -> int:
    """The zamba2-style weight-tied shared attention block (0 when the
    config has no ``hybrid_attn_period``).  The parameters exist once, but
    the *compute* is paid at every layer that applies the block."""
    if not cfg.hybrid_attn_period:
        return 0
    d = cfg.d_model
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return int(2 * d + d * h * hd + 2 * d * kv * hd + h * hd * d
               + 3 * d * cfg.d_ff)


def param_count(cfg: ModelConfig) -> int:
    d, L = cfg.d_model, cfg.n_layers
    n = cfg.vocab_size * d                       # embedding
    if not cfg.tie_embeddings:
        n += d * cfg.vocab_size                  # lm head
    n += d                                       # final norm
    n += L * _per_layer_params(cfg)
    n += shared_block_params(cfg)                # zamba2 shared block (once)
    return int(n)


def active_param_count(cfg: ModelConfig) -> int:
    if cfg.family != "moe":
        return param_count(cfg)
    d, L = cfg.d_model, cfg.n_layers
    dense_total = param_count(cfg)
    all_expert = L * cfg.n_experts * 3 * d * cfg.d_ff
    active_expert = L * cfg.experts_per_token * 3 * d * cfg.d_ff
    return int(dense_total - all_expert + active_expert)


def model_flops(cfg: ModelConfig, tokens: int, *, train: bool = True) -> float:
    """The spec's MODEL_FLOPS convention: 6*N*D (dense) / 6*N_active*D."""
    mult = 6.0 if train else 2.0
    return mult * active_param_count(cfg) * tokens


def attention_flops(cfg: ModelConfig, seq: int, tokens: int, *, train: bool = True) -> float:
    """Extra score/value FLOPs not captured by 6*N*D (for MFU context)."""
    if cfg.family == "ssm":
        return 0.0
    L_att = cfg.n_layers if not cfg.hybrid_attn_period else \
        cfg.n_layers // cfg.hybrid_attn_period
    if cfg.family == "hybrid":
        L = L_att
    else:
        L = cfg.n_layers
    per_tok = 0.0
    for i in range(L):
        w = cfg.layer_window(i) if cfg.family != "hybrid" else 0
        span = min(seq, w) if w else seq
        per_tok += 2 * 2 * cfg.n_heads * cfg.hd * span / 2  # qk^T + pv, causal/2
    mult = 3.0 if train else 1.0
    return mult * per_tok * tokens


# ---------------------------------------------------------------------------
# Per-layer vectors: the non-uniform pipeline-partition inputs.
#
# The aggregate accessors above collapse the layer sequence into one
# averaged scalar; the partitioner (core/partition.py) and the non-uniform
# profile path (core/simulator.py) need the sequence itself — attention vs.
# SSM vs. MoE vs. dense layers priced individually, with the embedding and
# LM-head GEMMs pinned to the first/last stage instead of amortized 1/pp.
# ---------------------------------------------------------------------------

def attention_layer_mask(cfg: ModelConfig) -> np.ndarray:
    """Boolean mask of layers that compute attention scores: every layer
    for attention families, none for pure SSM, and the shared-block
    application layers (``i % period == period - 1``) for hybrids."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        return np.zeros(L, dtype=bool)
    if cfg.hybrid_attn_period:
        idx = np.arange(L)
        return (idx % cfg.hybrid_attn_period) == cfg.hybrid_attn_period - 1
    return np.ones(L, dtype=bool)


def layer_param_counts(cfg: ModelConfig) -> np.ndarray:
    """Per-layer *resident* parameter counts (float64, length ``n_layers``).

    The hybrid shared block is excluded — it is one weight-tied copy, so a
    pipeline stage holds it once however many of its layers apply it (see
    ``shared_block_params`` + ``attention_layer_mask`` for stage sums).
    Embedding, LM head, and the final norm are likewise accounted at the
    stage level, not here."""
    return np.full(cfg.n_layers, float(_per_layer_params(cfg)))


def layer_active_param_counts(cfg: ModelConfig) -> np.ndarray:
    """Per-layer *compute-active* parameter counts: MoE layers count only
    the routed ``experts_per_token`` experts, and hybrid shared-block
    layers pay the block's GEMMs at every application (the weights are
    tied, the FLOPs are not)."""
    per = layer_param_counts(cfg)
    d = cfg.d_model
    if cfg.family == "moe":
        per = per - cfg.n_experts * 3.0 * d * cfg.d_ff \
            + cfg.experts_per_token * 3.0 * d * cfg.d_ff
    if cfg.hybrid_attn_period:
        per = per + attention_layer_mask(cfg) * float(shared_block_params(cfg))
    return per


def layer_attention_per_token(cfg: ModelConfig, seq: int) -> np.ndarray:
    """Per-layer score/value attention FLOPs per token (forward, the
    ``attention_flops(train=False)`` convention); zero on SSM layers.
    Sums to ``attention_flops(cfg, seq, 1, train=False)``."""
    L = cfg.n_layers
    out = np.zeros(L)
    mask = attention_layer_mask(cfg)
    for i in range(L):
        if not mask[i]:
            continue
        w = cfg.layer_window(i) if cfg.family != "hybrid" else 0
        span = min(seq, w) if w else seq
        out[i] = 2 * 2 * cfg.n_heads * cfg.hd * span / 2
    return out


def embed_cost_per_token(cfg: ModelConfig) -> float:
    """Forward FLOPs per token of one vocabulary GEMM (embedding *or* LM
    head) under the profile's ``2.0 * 2*V*d / pp`` convention: each end
    costs half the folded total."""
    return 2.0 * cfg.vocab_size * cfg.d_model


def layer_cost_per_token(cfg: ModelConfig, seq: int) -> np.ndarray:
    """Per-layer forward-compute cost vector ``c_i`` (FLOPs per token).

    Decomposes the exact totals ``build_profile`` prices — the 6N*D body
    distributed by per-layer active params, plus each layer's own
    score/value attention term — so that stage sums of this vector (plus
    ``embed_cost_per_token`` on the end stages) reproduce the legacy
    aggregate when the split is uniform."""
    a = layer_active_param_counts(cfg)
    n_active = float(active_param_count(cfg))
    body = max(n_active - 2.0 * cfg.vocab_size * cfg.d_model,
               float(int(0.5 * n_active)))
    body_i = 2.0 * body * (a / a.sum())
    att_i = 2.0 * layer_attention_per_token(cfg, seq) / 2
    return body_i + att_i

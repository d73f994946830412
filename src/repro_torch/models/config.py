"""Model configuration covering all assigned architecture families.

One dataclass describes dense / MoE / SSM / hybrid decoder LMs plus the
VLM/audio frontend stubs.  Every assigned architecture in
``repro_torch.configs`` instantiates this with its exact published numbers.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                     # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # --- attention variants ---
    sliding_window: int = 0          # 0 = full attention
    local_global_period: int = 0     # gemma3: period p => layers i with i%p==p-1 global
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope_theta_global: float = 0.0   # gemma3 global layers use a larger theta
    # --- SSM ---
    ssm_variant: str = ""            # "mamba1" | "mamba2"
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64           # mamba2 channels per head
    hybrid_attn_period: int = 0      # zamba2: shared attn block every k layers
    # --- frontend stubs ---
    frontend: str = ""               # "" | "vlm" | "audio"
    n_img_tokens: int = 0            # vlm: anyres patch embeddings per sample
    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # --- training-system knobs (consumed by launch/, not by the math) ---
    remat: bool = True
    scan_layers: bool = True
    # --- §Perf hillclimb knobs (EXPERIMENTS.md; defaults = baseline) ---
    moe_combine_f32_materialize: bool = True   # baseline: fp32 (T*k, d) combine
    moe_gather_dispatch: bool = False          # index-buffer dispatch (no x-repeat)
    seq_shard_residuals: bool = False          # Megatron-SP saved residuals
    scan_dtype: str = "float32"                # mamba scan working dtype

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Physical vocab rows, padded to a 256 multiple so the embedding
        shards over any mesh axis.  Phantom logits are masked to -inf
        (exact math); only granite's 49155 actually pads."""
        return -(-self.vocab_size // 256) * 256

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads:
            return self.d_model // self.n_heads
        return 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        # mamba1 convention: ceil(d_model / 16)
        return -(-self.d_model // 16)

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for the long_500k decode shape."""
        if self.family in ("ssm", "hybrid"):
            return True
        # mostly-local attention (gemma3 5:1) has a window-bounded cache for
        # all but every p-th layer
        return self.local_global_period > 0

    def layer_is_global_attn(self, i: int) -> bool:
        """gemma3-style local:global pattern; True when layer i is global."""
        if self.local_global_period <= 0:
            return True
        return (i % self.local_global_period) == self.local_global_period - 1

    def layer_window(self, i: int) -> int:
        """Effective sliding window for layer i (0 = full)."""
        if self.local_global_period <= 0:
            return self.sliding_window
        if self.layer_is_global_attn(i):
            return 0
        return self.sliding_window if self.sliding_window else 1024

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if self.hybrid_attn_period == 0 else 6),
            d_model=128,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32 if self.n_heads else 0,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            n_experts=min(self.n_experts, 8),
            experts_per_token=min(self.experts_per_token, 2),
            capacity_factor=8.0,     # no drops -> exact vs dense oracle
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            local_global_period=self.local_global_period,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_variant == "mamba2" else self.ssm_head_dim,
            hybrid_attn_period=min(self.hybrid_attn_period, 3) if self.hybrid_attn_period else 0,
            n_img_tokens=16 if self.frontend == "vlm" else 0,
            dtype="float32",
            remat=False,
        )
        if self.local_global_period:
            kw["sliding_window"] = 16
        kw.update(overrides)
        return self.replace(**kw)


@dataclass(frozen=True)
class ShapeSpec:
    """One (input-shape) cell of the assignment matrix."""
    name: str                  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k":    ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeSpec("long_500k", 524_288, 1, "decode"),
}

"""zamba2-7b [hybrid] — Mamba2 blocks + weight-tied shared attention.
[arXiv:2411.15242; unverified]

81L, d3584, Mamba2 (ssm_state 64, head_dim 64) with a single shared
attention+MLP block (32H kv=32, ff14336) applied every 6th layer —
the Zamba2 shared-block pattern (DESIGN.md §4).  Runs long_500k.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000,
    ssm_variant="mamba2", ssm_state=64, ssm_head_dim=64, ssm_conv=4,
    ssm_expand=2, hybrid_attn_period=6,
)

"""kimi-k2-1t-a32b [moe] — trillion-parameter MoE (paper-table).
[arXiv:2501.kimi2; unverified]

61L, d7168, 64H GQA kv=8, expert ff 2048, vocab 163840, 384 experts top-8.
Expert-parallel over the model axis + FSDP over the data axis (see
DESIGN.md §4): at 512 v5e chips the optimizer state alone exceeds HBM —
the dry-run reports the honest per-device bytes.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab_size=163840,
    n_experts=384, experts_per_token=8,
)

"""command-r-plus-104b [dense] — GQA, no-bias.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab_size=256000,
    rope_theta=75e4,
)

"""granite-moe-3b-a800m [moe] — 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

32L, d1536, 24H GQA kv=8, expert ff 512, vocab 49155, 40e top-8.
vocab % 16 != 0 -> the embedding shards over d_model instead (sharding.py).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    n_experts=40, experts_per_token=8,
)

"""qwen1.5-4b [dense] — MHA (kv=20), QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]

20 heads do not divide the 16-way model axis; the sharding policy falls
back to head_dim (128 % 16 == 0) for the attention projections.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, head_dim=128,
    d_ff=6912, vocab_size=151936,
    qkv_bias=True,
)

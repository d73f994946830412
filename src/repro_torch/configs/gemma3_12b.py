"""gemma3-12b [dense] — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

48L, d3840, 16H GQA kv=8, head_dim 256 (public gemma3 config; d_model/H
would give 240), ff15360, vocab 262144.  Local layers use a 1024-token
sliding window (theta 10k); every 6th layer is global (theta 1M).  Decode
keeps ring-buffer caches for local layers — the reason this arch runs the
long_500k cell.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab_size=262144,
    local_global_period=6, sliding_window=1024,
    rope_theta=1e4, rope_theta_global=1e6,
)

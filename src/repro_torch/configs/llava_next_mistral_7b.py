"""llava-next-mistral-7b [vlm] — anyres tiling backbone.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

Backbone = Mistral-7B (32L, d4096, 32H GQA kv=8, ff14336, vocab 32000).
The vision frontend is a STUB: input_specs() provides 2880 precomputed
anyres patch embeddings (4 tiles + base image x 576 patches), already
projected to d_model.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    frontend="vlm", n_img_tokens=2880,
    rope_theta=1e6,
)

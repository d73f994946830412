"""musicgen-large [audio] — decoder-only over EnCodec tokens.
[arXiv:2306.05284; hf]

48L, d2048, 32H (kv=32 => MHA), ff8192, codebook vocab 2048.  The EnCodec
frontend is a STUB: input_specs() provides the token stream (the real
model interleaves 4 codebooks with a delay pattern; the backbone shapes
are identical).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048,
    frontend="audio",
)

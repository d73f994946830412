"""falcon-mamba-7b [ssm] — attention-free Mamba1.  [arXiv:2410.05355; unverified]

64L, d4096 (d_inner 8192), ssm_state 16, vocab 65024.  Constant-memory
decode state -> runs the long_500k cell.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=65024,
    ssm_variant="mamba1", ssm_state=16, ssm_conv=4, ssm_expand=2,
)

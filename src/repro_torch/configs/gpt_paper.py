"""GPT configurations matching the paper's evaluation sizes (§VII):
1.1B / 3.1B on the mid-range cluster, 8.1B / 11.1B on the high-end one.
Layer/width chosen to hit the stated parameter counts with the standard
GPT-2/3 shape rules (params ~= 12 L d^2 + vocab d)."""
from ..models.config import ModelConfig


def _gpt(name, n_layers, d_model, n_heads):
    return ModelConfig(
        name=name, family="dense", n_layers=n_layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=n_heads, d_ff=4 * d_model,
        vocab_size=51200)


GPT_1_1B = _gpt("gpt-1.1b", 24, 1920, 20)
GPT_3_1B = _gpt("gpt-3.1b", 32, 2816, 22)
GPT_8_1B = _gpt("gpt-8.1b", 40, 4096, 32)
GPT_11_1B = _gpt("gpt-11.1b", 48, 4352, 32)

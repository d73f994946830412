"""Architecture registry: one module per assigned architecture (exact
published numbers) + the paper's own GPT sizes.  ``get(name)`` /
``--arch <id>`` select them."""
from __future__ import annotations

from ..models.config import SHAPES, ModelConfig, ShapeSpec
from .llava_next_mistral_7b import CONFIG as LLAVA_NEXT_MISTRAL_7B
from .musicgen_large import CONFIG as MUSICGEN_LARGE
from .kimi_k2_1t_a32b import CONFIG as KIMI_K2_1T_A32B
from .granite_moe_3b_a800m import CONFIG as GRANITE_MOE_3B_A800M
from .qwen2_7b import CONFIG as QWEN2_7B
from .command_r_plus_104b import CONFIG as COMMAND_R_PLUS_104B
from .qwen15_4b import CONFIG as QWEN15_4B
from .gemma3_12b import CONFIG as GEMMA3_12B
from .falcon_mamba_7b import CONFIG as FALCON_MAMBA_7B
from .zamba2_7b import CONFIG as ZAMBA2_7B
from .gpt_paper import GPT_1_1B, GPT_3_1B, GPT_8_1B, GPT_11_1B

ARCHS = {c.name: c for c in [
    LLAVA_NEXT_MISTRAL_7B, MUSICGEN_LARGE, KIMI_K2_1T_A32B,
    GRANITE_MOE_3B_A800M, QWEN2_7B, COMMAND_R_PLUS_104B, QWEN15_4B,
    GEMMA3_12B, FALCON_MAMBA_7B, ZAMBA2_7B,
]}
PAPER_GPTS = {c.name: c for c in [GPT_1_1B, GPT_3_1B, GPT_8_1B, GPT_11_1B]}


def get(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in PAPER_GPTS:
        return PAPER_GPTS[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS) + sorted(PAPER_GPTS)}")


def cells():
    """The 40 (arch x shape) assignment cells with applicability flags."""
    out = []
    for a in ARCHS.values():
        for s in SHAPES.values():
            skip = ""
            if s.name == "long_500k" and not a.is_subquadratic:
                skip = "pure full-attention arch: 500k dense KV cache excluded per spec"
            out.append((a, s, skip))
    return out

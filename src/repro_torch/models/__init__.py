"""The model stack: configuration dataclasses, and the dense and Mamba1
families' layers, blocks and generation API (prefill and decode)."""

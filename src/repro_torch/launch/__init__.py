"""Entry points that run a model: the prefill and decode steps and the
``generate`` CLI."""

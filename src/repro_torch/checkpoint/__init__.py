"""Checkpoints of the training state (:mod:`~repro_torch.checkpoint.manager`),
laid out as the JAX package lays them out."""

"""Optimizers of the training path: AdamW with the reference's cosine
schedule (:mod:`~repro_torch.optim.adamw`) and PowerSGD gradient
compression with error feedback (:mod:`~repro_torch.optim.compression`)."""

"""The training data path: a deterministic synthetic corpus and its
sharded, prefetching loader (:mod:`~repro_torch.data.pipeline`)."""

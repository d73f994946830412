"""Runtime side of the system: the fault-tolerant training loop
(:mod:`~repro_torch.runtime.trainer`), elastic replanning after a node is
lost, degraded or added (:mod:`~repro_torch.runtime.elastic`), and the churn
simulator that replays a seeded fleet-event trace through it
(:mod:`~repro_torch.runtime.churn`)."""

"""Planning-as-a-service: the async plan server, cache, and client.

A fleet runs *many* training jobs against the same cluster; most plan
requests are identical or near-identical (same workload and fleet,
different microbatch caps or budgets).  This package turns the Planner
into a long-running local daemon that exploits that redundancy:

- :class:`~repro_torch.service.server.PlanServer` — asyncio TCP server
  (newline-delimited JSON on localhost) with a four-layer request path:
  plan cache -> in-flight coalescing -> request batching (one
  :class:`~repro_torch.core.search.BatchSearchContext` per group) ->
  warm-started annealing seeded from the nearest cached neighbor;
- :class:`~repro_torch.service.cache.PlanCache` — LRU + disk store keyed by
  the canonical request fingerprint; hits return byte-identical plans;
- :class:`~repro_torch.service.client.PlanClient` — blocking stdlib client
  with pipelined multi-request submission;
- ``python -m repro_torch.service`` — the ``serve`` / ``submit`` /
  ``cache ls|evict|stats`` CLI.

Everything is standard library + the existing core; no new dependencies.
"""
from .cache import PlanCache
from .client import PlanClient, ServiceError
from .server import PlanServer
from .wire import (AdmissionError, WireError, cluster_digest,
                   decode_plan_request, encode_plan_request,
                   incumbent_perm, request_fingerprint, request_meta,
                   workload_digest)

__all__ = [
    "AdmissionError", "PlanCache", "PlanClient", "PlanServer",
    "ServiceError", "WireError", "cluster_digest", "decode_plan_request",
    "encode_plan_request", "incumbent_perm", "request_fingerprint",
    "request_meta", "workload_digest",
]

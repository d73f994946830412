"""Wire format of the plan service: request/response dicts, fingerprints.

Everything a client sends is one newline-delimited JSON object; a plan
request carries the workload, the cluster (a named preset or an inline
spec), the search-space and budget knobs, the seed, the strategy name,
and the bandwidth realisation ``day``.  This module decodes those dicts
into the typed Planner request — and, crucially, computes the **canonical
fingerprints** the plan cache is keyed on:

- :func:`workload_digest` — SHA-256 of the canonical workload wire dict;
- :func:`cluster_digest` — SHA-256 of the spec's scalar fields plus its
  :func:`~repro_torch.core.cluster.tier_table_fingerprint` (so two specs that
  price identically share a digest, and a re-tiered fleet changes it);
- :func:`request_fingerprint` — SHA-256 over (workload digest, cluster
  digest, space, budget, seed, strategy, day): the full determinism
  domain of a plan.  Identical fingerprints MUST produce byte-identical
  plans, which is exactly what makes the cache sound.

Two error types separate "you sent garbage" from "your cluster is
invalid": :class:`WireError` (malformed request -> ``bad-request``) and
:class:`AdmissionError` (the spec/workload failed the typed constructor
validation -> the server's structured ``admission`` rejection).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Tuple

import numpy as np

from ..core import Budget, PlanRequest, SearchSpace, Workload, mapping_to_perm
from ..core.cluster import ClusterSpec, DeviceTier, tier_table_fingerprint
from ..core.plan import STRATEGIES, _budget_out
from ..core.simulator import Conf  # noqa: F401  (re-export convenience)
from ..models.config import ModelConfig


class WireError(ValueError):
    """Malformed service request (missing/mistyped fields, unknown model
    or strategy name) — maps to the ``bad-request`` error code."""


class AdmissionError(ValueError):
    """The request decoded, but its cluster spec or workload failed the
    typed validation (``ClusterSpec``/``DeviceTier`` named-field checks)
    — maps to the server's structured ``admission`` rejection."""


def canonical_json(obj) -> str:
    """Canonical compact JSON: sorted keys, no whitespace — the hashing
    normal form for every fingerprint below."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      allow_nan=False)


def _sha256(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


# ---------------------------------------------------------------------------
# workload
# ---------------------------------------------------------------------------

def workload_to_wire(w: Workload) -> dict:
    """Serialize a workload: the full inline model config + the scalars."""
    return {"config": dataclasses.asdict(w.cfg), "seq": int(w.seq),
            "bs_global": int(w.bs_global), "grad_bytes": int(w.grad_bytes)}


def workload_from_wire(d: dict) -> Workload:
    """Decode a workload wire dict.

    ``config`` is either an inline :class:`~repro_torch.models.config.ModelConfig`
    field dict or a registered config name (``repro_torch.configs.get``).
    """
    if not isinstance(d, dict):
        raise WireError(f"workload must be an object, got {type(d).__name__}")
    cfg = d.get("config")
    if isinstance(cfg, str):
        from ..configs import get as get_config
        try:
            model = get_config(cfg)
        except KeyError:
            raise WireError(f"unknown model config name {cfg!r}") from None
    elif isinstance(cfg, dict):
        try:
            model = ModelConfig(**cfg)
        except (TypeError, ValueError) as e:
            raise WireError(f"bad inline model config: {e}") from e
    else:
        raise WireError("workload.config must be a name or a config object")
    try:
        return Workload(model, int(d["seq"]), int(d["bs_global"]),
                        grad_bytes=int(d.get("grad_bytes", 4)))
    except (KeyError, TypeError, ValueError) as e:
        raise WireError(f"bad workload: {e!r}") from e


def workload_digest(w: Workload) -> str:
    """SHA-256 of the canonical workload wire dict (name-decoded configs
    and inline configs with identical fields share a digest)."""
    return _sha256(canonical_json(workload_to_wire(w)))


# ---------------------------------------------------------------------------
# cluster
# ---------------------------------------------------------------------------

_SPEC_SCALARS = ("name", "n_nodes", "gpus_per_node", "intra_bw", "inter_bw",
                 "gpu_flops", "gpu_mem", "efficiency", "heterogeneity",
                 "slow_frac", "seed")


def spec_to_wire(spec: ClusterSpec) -> dict:
    """Serialize a cluster spec inline (scalars + tier table)."""
    d = {k: getattr(spec, k) for k in _SPEC_SCALARS}
    d["tiers"] = [[t.flops, t.mem, t.efficiency, t.name] for t in spec.tiers]
    d["node_tiers"] = [int(t) for t in spec.node_tiers]
    return d


def spec_from_wire(d: dict) -> ClusterSpec:
    """Decode a cluster wire dict: ``{"preset": name, "nodes": n}`` or an
    inline spec (:func:`spec_to_wire` shape).

    Raises:
        WireError: structurally malformed / unknown preset.
        AdmissionError: the spec fails the typed ``ClusterSpec`` /
            ``DeviceTier`` validation — the named-field message is
            preserved for the structured rejection.
    """
    if not isinstance(d, dict):
        raise WireError(f"cluster must be an object, got {type(d).__name__}")
    preset = d.get("preset")
    if preset is not None:
        from ..plan import CLUSTERS
        if preset not in CLUSTERS:
            raise WireError(
                f"unknown cluster preset {preset!r} "
                f"(known: {sorted(CLUSTERS)})")
        spec = CLUSTERS[preset]
        nodes = d.get("nodes")
        if nodes is not None:
            try:
                spec = spec.with_nodes(int(nodes))
            except (TypeError, ValueError) as e:
                raise AdmissionError(f"bad node count {nodes!r}: {e}") from e
        return spec
    try:
        tiers = tuple(DeviceTier(*t) for t in d.get("tiers", ()))
        kwargs = {k: d[k] for k in _SPEC_SCALARS if k in d}
        return ClusterSpec(tiers=tiers,
                           node_tiers=tuple(int(t)
                                            for t in d.get("node_tiers", ())),
                           **kwargs)
    except (ValueError,) as e:
        raise AdmissionError(str(e)) from e
    except TypeError as e:
        raise WireError(f"bad cluster spec: {e}") from e


def cluster_digest(spec: ClusterSpec) -> str:
    """SHA-256 over the spec scalars + the tier-table fingerprint.

    The tier table is folded in through
    :func:`~repro_torch.core.cluster.tier_table_fingerprint` — the same recipe
    the plan verifier uses — so the digest moves whenever the fleet
    composition does."""
    doc = {k: getattr(spec, k) for k in _SPEC_SCALARS}
    doc["tier_fp"] = (tier_table_fingerprint(
        [(t.flops, t.mem, t.efficiency, t.name) for t in spec.tiers],
        spec.node_tiers) if spec.tiers else None)
    return _sha256(canonical_json(doc))


# ---------------------------------------------------------------------------
# the full plan request
# ---------------------------------------------------------------------------

def encode_plan_request(req: PlanRequest, *, strategy: str = "pipette",
                        day: int = 0) -> dict:
    """Typed request -> wire dict (the client-side encoder)."""
    return {"op": "plan",
            "workload": workload_to_wire(req.workload),
            "cluster": spec_to_wire(req.spec),
            "space": dataclasses.asdict(req.space),
            "budget": _budget_out(req.budget),
            "seed": int(req.seed),
            "strategy": strategy,
            "day": int(day)}


def decode_plan_request(d: dict) -> Tuple[PlanRequest, str, int]:
    """Wire dict -> ``(PlanRequest, strategy_name, day)``.

    Raises:
        WireError / AdmissionError — see module docstring.
    """
    strategy = d.get("strategy", "pipette")
    if strategy not in STRATEGIES:
        raise WireError(f"unknown strategy {strategy!r} "
                        f"(known: {sorted(STRATEGIES)})")
    workload = workload_from_wire(d.get("workload"))
    spec = spec_from_wire(d.get("cluster"))
    try:
        space = SearchSpace(**(d.get("space") or {}))
        budget = Budget(**(d.get("budget") or {}))
    except TypeError as e:
        raise WireError(f"bad space/budget knobs: {e}") from e
    except ValueError as e:
        raise AdmissionError(str(e)) from e
    try:
        seed = int(d.get("seed", 0))
        day = int(d.get("day", 0))
    except (TypeError, ValueError) as e:
        raise WireError(f"seed/day must be integers: {e}") from e
    return (PlanRequest(workload=workload, spec=spec, space=space,
                        budget=budget, seed=seed),
            strategy, day)


def request_fingerprint(req: PlanRequest, strategy: str, day: int) -> str:
    """The cache key: SHA-256 over the full determinism domain of a plan
    — workload digest, cluster digest, space, budget (including any
    explicit ``warm_start``), seed, strategy, day."""
    doc = {"workload": workload_digest(req.workload),
           "cluster": cluster_digest(req.spec),
           "space": dataclasses.asdict(req.space),
           "budget": _budget_out(req.budget),
           "seed": int(req.seed),
           "strategy": strategy,
           "day": int(day)}
    return _sha256(canonical_json(doc))


def request_meta(req: PlanRequest, strategy: str, day: int) -> dict:
    """The sidecar metadata a cache entry records: the fingerprint plus
    the coarse workload coordinates the nearest-neighbor warm-start
    lookup measures distance over."""
    w = req.workload
    return {"fingerprint": request_fingerprint(req, strategy, day),
            "workload_digest": workload_digest(w),
            "cluster_digest": cluster_digest(req.spec),
            "strategy": strategy,
            "day": int(day),
            "model": w.cfg.name,
            "seq": int(w.seq),
            "bs_global": int(w.bs_global),
            "d_model": int(w.cfg.d_model),
            "n_layers": int(w.cfg.n_layers),
            "n_gpus": int(req.spec.n_gpus)}


def incumbent_perm(plan_dict: dict) -> Optional[np.ndarray]:
    """Extract the flat GPU permutation behind a serialized plan's best
    mapping (the warm-start seed), or ``None`` for infeasible plans or
    undecodable documents.  The permutation is shape-agnostic: SA reshapes
    it per candidate conf, so one incumbent seeds every chain of a
    neighboring search."""
    try:
        best = plan_dict.get("best")
        if best is None:
            return None
        m = best["mapping"]
        mapping = np.asarray(m["data"],
                             dtype=np.dtype(m["dtype"])) \
            .reshape(tuple(m["shape"]))
        return mapping_to_perm(mapping)
    except (KeyError, TypeError, ValueError):
        return None

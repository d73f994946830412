"""Elastic scaling: when the healthy device count changes (node failure,
capacity change), re-run the Pipette search for the new G, rebuild the
mesh with the new worker dedication, and reshard the checkpoint.

This is the paper's configurator promoted to a *runtime* fault-tolerance
mechanism, expressed through the Planner API: ``replan`` shrinks the spec
to the healthy node count, re-profiles the interconnect, validates (and if
stale, refits) the memory estimator, then runs
``Planner(PipetteStrategy(...), device=device).plan(request, bw)`` — the
same entry point that produced the initial configuration — and hands the
resulting serializable :class:`~repro_torch.core.plan.Plan` to the launch
layer / the checkpoint reshard.  The search and any estimator refit run on
``device``: ``None`` is the CUDA device and raises without one, the CPU
must be named (``device="cpu"``).

Replanning is *incremental* when an ``incumbent`` plan is supplied: the
incumbent's GPU permutation is projected onto the surviving ranks
(:func:`~repro_torch.core.dedication.project_perm`) and seeds every SA chain via
``Budget.warm_start``, and candidates are selected by ``step_time +
migration_weight * downtime`` (:mod:`repro_torch.core.migration`) instead of
step time alone — so a marginally faster plan that reshards the whole
fleet loses to a near-peer reachable by moving two ranks.  The
trace-driven churn simulator (:mod:`repro_torch.runtime.churn`) drives this
entry point once per fleet event.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .._device import DeviceLike, resolve_device
from ..core.cluster import ClusterSpec, profile_bandwidth
from ..core.dedication import mapping_to_perm, project_perm
from ..core.memory import MemoryEstimator, fit_memory_estimator
from ..core.migration import PlanDiff, diff_assignments
from ..core.plan import (Budget, ExhaustiveStrategy, Plan, Planner,
                         PlanRequest, PipetteStrategy, SearchSpace)
from ..core.search import Candidate, SearchResult
from ..core.simulator import ProfileCache, Workload
from ..core.latency import pipette_latency

# The declarative-request knobs ``replan(**search_kw)`` accepts, derived
# from the dataclasses themselves so a new SearchSpace/Budget field is
# routable the day it lands (the historical hardcoded tuples silently
# rejected ``partition``/``max_vpp``/``backend``/... for two releases).
# ``sa_seconds`` stays an explicit ``replan`` parameter (its elastic
# default differs from the Budget default), so it is carved out here.
_SPACE_KEYS = frozenset(f.name for f in dataclasses.fields(SearchSpace))
_BUDGET_KEYS = frozenset(f.name for f in dataclasses.fields(Budget)) \
    - {"sa_seconds"}
assert not (_SPACE_KEYS & _BUDGET_KEYS), \
    "SearchSpace and Budget field names must stay disjoint for the " \
    "replan() kwarg split to be unambiguous"


@dataclass
class ElasticPlan:
    """Outcome of a re-plan: the serializable Plan plus re-profile context.

    ``result`` (the full in-process :class:`SearchResult`) is kept for
    callers that inspect the complete ranking; ``plan`` is the artifact the
    launch layer consumes (``plan.save`` to persist it with the
    checkpoint).  ``plan.best`` stays the *fastest* candidate; when an
    incumbent was supplied, ``chosen`` is the candidate minimizing
    ``latency + migration_weight * downtime`` (it may differ from the
    fastest) and ``migration`` prices the switch from the incumbent to
    ``chosen``."""
    result: SearchResult
    n_gpus: int
    bw: np.ndarray
    refit_estimator: bool = False
    plan: Optional[Plan] = None
    chosen: Optional[Candidate] = None
    migration: Optional[PlanDiff] = None


def _estimator_stale(est: MemoryEstimator, spec: ClusterSpec,
                     max_cp: int = 1) -> bool:
    """True when ``est`` was fit on hardware that no longer matches
    ``spec`` — a resized node count is fine (the features extrapolate over
    GPU count by design, in both directions: ``n_gpus`` enters the feature
    vector, ``gpus_per_node`` is what the fit is conditioned on), but a
    different per-GPU memory or node width changes the ground truth the
    fit learned, so its predictions are invalid for the new cluster.  A
    3D-fit estimator asked to score a 4D re-plan (``max_cp > 1`` without
    ``with_cp``) is stale for the same reason: it cannot price cp>1
    candidates.  The partition mode and ``max_vpp`` deliberately do *not*
    stale an estimator: they change which layers each stage holds, not the
    feature layout the fit learned (vpp/partition enter the *analytical*
    term, which needs no fit).  Estimators without hardware provenance
    (legacy ``fit_gpu_mem == 0``) are trusted on that axis as before."""
    if max_cp > 1 and not est.with_cp:
        return True
    if est.fit_gpu_mem == 0.0 and est.fit_gpus_per_node == 0:  # repro: noqa DET005 -- 0.0 is the exact stored legacy-provenance sentinel, assigned literally and never computed
        return False
    return (est.fit_gpu_mem != spec.gpu_mem or
            est.fit_gpus_per_node != spec.gpus_per_node)


def _split_request_kwargs(search_kw: dict) -> Tuple[dict, dict]:
    """Route ``replan(**kw)`` extras to SearchSpace vs Budget by the
    dataclasses' own field lists; unknown keys raise ``TypeError``."""
    space_kw = {k: search_kw.pop(k) for k in sorted(_SPACE_KEYS)
                if k in search_kw}
    budget_kw = {k: search_kw.pop(k) for k in sorted(_BUDGET_KEYS)
                 if k in search_kw}
    if search_kw:
        raise TypeError(f"unknown replan() keywords: {sorted(search_kw)}")
    return space_kw, budget_kw


def _rescore_with_perm(w: Workload, new_spec: ClusterSpec, bw: np.ndarray,
                       perm: np.ndarray, space: SearchSpace,
                       template: Candidate) -> Optional[Candidate]:
    """Price ``template``'s configuration under the mapping induced by
    (the relevant prefix of) ``perm`` on the new interconnect.  Returns
    ``None`` when the conf cannot be profiled on ``new_spec``."""
    conf = template.conf
    if conf.n_gpus > len(perm):
        return None
    from ..core.dedication import perm_to_mapping
    mapping = perm_to_mapping(np.asarray(perm[:conf.n_gpus]), conf)
    try:
        prof = ProfileCache(w, new_spec, space.partition).get(conf)
    except ValueError:
        return None
    lat = pipette_latency(conf, mapping, bw, prof, new_spec)
    return Candidate(conf=conf, mapping=mapping, latency=lat,
                     mem_pred=template.mem_pred,
                     partition=template.partition,
                     schedule=template.schedule)


def _score_stay_candidate(w: Workload, new_spec: ClusterSpec,
                          bw: np.ndarray, incumbent: Plan,
                          survivors: Sequence[int],
                          space: SearchSpace) -> Optional[Candidate]:
    """The zero/low-migration fallback: the incumbent's own configuration
    and (projected) mapping, re-scored on the new interconnect.

    Only exists when the event preserved the incumbent's GPU count (all
    incumbent GPUs survive, none added) — a shrink invalidates the conf,
    and a grow would leave the new nodes idle.  Returns ``None``
    otherwise, or when the incumbent cannot be re-scored (e.g. its conf no
    longer enumerates)."""
    conf = incumbent.conf
    n_new = new_spec.n_gpus
    if conf is None or conf.n_gpus != len(survivors) or n_new != len(
            survivors):
        return None
    perm = project_perm(mapping_to_perm(incumbent.mapping),
                        survivors, n_new)
    return _rescore_with_perm(
        w, new_spec, bw, perm, space,
        Candidate(conf=conf, mapping=incumbent.mapping,
                  latency=float("nan"), mem_pred=incumbent.mem_pred,
                  partition=incumbent.partition,
                  schedule=incumbent.schedule))


def replan_on(w: Workload, new_spec: ClusterSpec, bw: np.ndarray, *,
              estimator: Optional[MemoryEstimator] = None,
              incumbent: Optional[Plan] = None,
              migration_weight: float = 0.0,
              survivors: Optional[Sequence[int]] = None,
              sa_seconds: float = 0.5, seed: int = 0,
              refit_steps: int = 2_000, mem_limit: Optional[float] = None,
              dedicate: bool = True, device: DeviceLike = None,
              **search_kw) -> ElasticPlan:
    """Re-plan on an already-mutated spec + profiled matrix.

    The core behind :func:`replan`, split out so the churn simulator can
    hand in event-stream specs (:meth:`ClusterSpec.with_node_subset`,
    :meth:`ClusterSpec.with_compute_factors`) and its own bandwidth
    submatrices instead of a fresh ``profile_bandwidth`` snapshot.

    Args:
        w: the workload being trained.
        new_spec: the post-event cluster.
        bw: ``(G, G)`` profiled bandwidth matrix for ``new_spec``.
        estimator: memory estimator; refit when stale for ``new_spec``.
        incumbent: the currently-running plan.  When given, its GPU
            permutation — projected onto ``survivors`` — warm-starts every
            SA chain, replan lineage is recorded on the new plan, and the
            returned ``chosen``/``migration`` price the switch.
        migration_weight: seconds-per-second-of-downtime weight in the
            selection objective ``latency + migration_weight * downtime``.
            ``0`` selects purely by step time (but still warm-starts).
            With step times in seconds and downtime dominated by the
            restart barrier, a weight around ``1 / expected steps between
            events`` amortizes the stall over the replan's lifetime.
        survivors: incumbent GPU ids still present, in new-fleet order
            (new GPU ``i`` is incumbent GPU ``survivors[i]`` for ``i <
            len(survivors)``; new GPUs follow).  Default: identity on the
            common prefix — the ``with_nodes`` truncation convention.
        sa_seconds / seed / refit_steps / mem_limit / dedicate / device:
            as on :func:`replan`.
        **search_kw: any :class:`SearchSpace` or :class:`Budget` field
            (routed by the dataclasses' own field lists; ``backend`` is
            ``"torch"`` or ``"numpy"``, as :class:`Budget` takes it).
    """
    device = resolve_device(device)
    space_kw, budget_kw = _split_request_kwargs(search_kw)
    space = SearchSpace(**space_kw)
    budget = Budget(sa_seconds=sa_seconds, **budget_kw)

    n_new = new_spec.n_gpus
    if survivors is None:
        n_old = incumbent.conf.n_gpus if (
            incumbent is not None and incumbent.conf is not None) else n_new
        survivors = list(range(min(n_old, n_new)))
    survivors = [int(s) for s in survivors]

    lineage = None
    if incumbent is not None and incumbent.feasible:
        projected = budget.warm_start is None
        if projected:
            perm = project_perm(mapping_to_perm(incumbent.mapping),
                                survivors, n_new)
            budget = dataclasses.replace(
                budget, warm_start=tuple(int(x) for x in perm))
        lineage = {"replan_of": incumbent.fingerprint(),
                   "warm_start_projected": projected,
                   "survivors": len(survivors)}

    refit = estimator is not None and _estimator_stale(
        estimator, new_spec, space.max_cp)
    if refit:
        estimator = fit_memory_estimator(
            [w], new_spec, fit_nodes=min(2, new_spec.n_nodes),
            steps=refit_steps, residual=estimator.residual,
            max_cp=space.max_cp, device=device)
    req = PlanRequest(workload=w, spec=new_spec, space=space, budget=budget,
                      seed=seed)
    strategy = (PipetteStrategy(estimator=estimator, mem_limit=mem_limit)
                if dedicate
                else ExhaustiveStrategy(estimator=estimator,
                                        mem_limit=mem_limit))
    plan = Planner(strategy, device=device).plan(req, bw, lineage=lineage)
    if not plan.feasible:
        raise RuntimeError(
            f"no feasible configuration for {new_spec.n_gpus} GPUs — "
            f"memory limit too tight for every (pp, tp, cp, dp, bs_micro)")

    chosen, migration = _select(w, new_spec, bw, plan, incumbent,
                                migration_weight, survivors, space)
    return ElasticPlan(plan.result, n_new, bw, refit_estimator=refit,
                       plan=plan, chosen=chosen, migration=migration)


def _select(w: Workload, new_spec: ClusterSpec, bw: np.ndarray, plan: Plan,
            incumbent: Optional[Plan], migration_weight: float,
            survivors: Sequence[int], space: SearchSpace
            ) -> Tuple[Candidate, Optional[PlanDiff]]:
    """Pick the go-live candidate: fastest when there is no incumbent,
    else the minimizer of ``latency + migration_weight * downtime`` over
    the ranked candidates, the stay-put fallback, and each ranked
    configuration re-mapped onto the incumbent's projected permutation.

    The aligned variants are the heart of incremental replanning: SA's
    dedication is near-indifferent between permutations on a uniform
    interconnect, so the ranked mappings land arbitrarily far from the
    incumbent and reshard everything.  Re-pricing every ranked conf under
    the incumbent-aligned mapping offers the selector a same-speed,
    low-migration version of each configuration: a plan 1 % slower that
    is reached by moving two ranks.  SA's mapping still wins whenever
    its latency edge exceeds the amortized migration cost (heterogeneous
    interconnects, degraded links)."""
    ranked: List[Candidate] = list(plan.ranked)
    if incumbent is None or not incumbent.feasible:
        return ranked[0], None
    stay = _score_stay_candidate(w, new_spec, bw, incumbent, survivors,
                                 space)
    if stay is not None:
        ranked.append(stay)
    if migration_weight > 0 and incumbent.conf is not None:
        proj = project_perm(mapping_to_perm(incumbent.mapping),
                            survivors, new_spec.n_gpus)
        seen_confs = set()
        for cand in list(plan.ranked):
            if cand.conf in seen_confs:
                continue
            seen_confs.add(cand.conf)
            aligned = _rescore_with_perm(w, new_spec, bw, proj, space,
                                         cand)
            if aligned is not None and not np.array_equal(
                    aligned.mapping, cand.mapping):
                ranked.append(aligned)
    b_to_a = [survivors[g] if g < len(survivors) else -1
              for g in range(new_spec.n_gpus)]
    best_i, best_key, diffs = 0, None, []
    for i, cand in enumerate(ranked):
        d = diff_assignments(
            w.cfg, incumbent.conf, incumbent.mapping, cand.conf,
            cand.mapping, partition_a=incumbent.partition,
            partition_b=cand.partition, b_to_a=b_to_a,
            n_nodes=new_spec.n_nodes, inter_bw=new_spec.inter_bw)
        diffs.append(d)
        key = (cand.latency + migration_weight * d.downtime_s,
               cand.latency, i)
        if best_key is None or key < best_key:
            best_i, best_key = i, key
    return ranked[best_i], diffs[best_i]


def replan(w: Workload, spec: ClusterSpec,
           healthy_nodes: Union[int, Sequence[int]], *,
           estimator: Optional[MemoryEstimator] = None,
           incumbent: Optional[Plan] = None,
           migration_weight: float = 0.0,
           sa_seconds: float = 0.5, seed: int = 0,
           refit_steps: int = 2_000, mem_limit: Optional[float] = None,
           dedicate: bool = True, device: DeviceLike = None,
           **search_kw) -> ElasticPlan:
    """Re-plan for a degraded/grown cluster of ``healthy_nodes`` nodes.

    Steps: resize the spec to the healthy node count and re-profile the
    (changed) interconnect; validate the memory estimator against the new
    hardware (refit on ``refit_steps`` training steps when ``gpu_mem`` or
    ``gpus_per_node`` changed — a fit from the original spec would silently
    mis-predict peaks on different GPUs); then run
    ``Planner(PipetteStrategy(), device=device).plan`` on the new GPU
    count.  The returned :class:`ElasticPlan` carries the serializable
    Plan whose mapping the runtime builds its process groups from before
    restoring the checkpoint with the new partition specs.

    Args:
        healthy_nodes: either a node *count* — ``spec.with_nodes``
            semantics, truncating (shrink) or cycling (grow) the tier
            pattern — or an explicit sequence of surviving node ids of
            ``spec`` (``spec.with_node_subset`` semantics: "node 3 of 16
            died" keeps nodes ``[0..2, 4..15]`` with their own tiers).
        incumbent / migration_weight: incremental-replan knobs, see
            :func:`replan_on`.  With a node-id sequence, the surviving
            GPU map is derived from it automatically.
        **search_kw: any :class:`SearchSpace` field (``max_cp``,
            ``max_tp``, ``max_micro``, ``fixed_micro``, ``partition``,
            ``max_vpp``) or :class:`Budget` field (``sa_iters``,
            ``n_chains``, ``sa_topk``, ``backend``, ``hierarchical``,
            ``warm_start``) — the split is derived from the dataclass
            fields themselves; anything else raises ``TypeError``.
        device: where the search and an estimator refit run; ``None`` is
            the CUDA device and raises without one, ``"cpu"`` must be
            named.
    """
    survivors = None
    if isinstance(healthy_nodes, (int, np.integer)):
        new_spec = spec.with_nodes(int(healthy_nodes))
    else:
        nodes = [int(i) for i in healthy_nodes]
        new_spec = spec.with_node_subset(nodes)
        survivors = [g for node in nodes for g in spec.node_gpus(node)]
    bw, _ = profile_bandwidth(new_spec)
    return replan_on(w, new_spec, bw, estimator=estimator,
                     incumbent=incumbent, migration_weight=migration_weight,
                     survivors=survivors, sa_seconds=sa_seconds, seed=seed,
                     refit_steps=refit_steps, mem_limit=mem_limit,
                     dedicate=dedicate, device=device, **search_kw)

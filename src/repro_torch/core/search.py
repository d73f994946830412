"""Algorithm 1 — the Pipette configurator, as a staged array pipeline.

``run_search()`` — the engine behind ``Planner(PipetteStrategy())`` and the
legacy ``configure()`` shim — runs five batched stages instead of a
per-candidate loop:

1. **enumerate** — all (pp, tp, cp, dp, bs_micro) with ``pp*tp*cp*dp = G``
   (``cp`` up to the ``max_cp`` knob; 1 keeps the paper's 3D space), plus
   the microbatch / schedule-validity filters, collected up front;
2. **memory-prune** — one
   :meth:`~repro_torch.core.memory.MemoryEstimator.predict_batch` call on the
   whole ``(N, F)`` feature matrix, pruned as a vector (one forward on the
   device instead of one dispatch per candidate);
3. **profile** — :class:`~repro_torch.core.simulator.ProfileCache` builds each
   surviving ``(pp, tp, bs_micro)`` profile once (a ``Profile`` does not
   depend on ``dp``, and its ``(pp, tp)``-only fields are shared across
   microbatch variants); pruned configs never pay profile construction;
4. **pre-score** — every survivor's default mapping is scored in one cached
   pass (:func:`~repro_torch.core.latency.default_mapping_latencies`);
5. **dedicate** — SA worker dedication on every survivor, or, with
   ``sa_topk=k``, only on the ``k`` most promising by pre-score so the SA
   budget concentrates where it matters; the rest keep their default
   mapping and pre-scored latency.

The SA stage runs on the CUDA device by default (``Budget.backend="torch"``,
:class:`~repro_torch.core.torch_engine.TorchDedicationEngine`).  The host
paths use the incremental :class:`~repro_torch.core.dedication.
DedicationEngine`; its permutation-position index tensors depend only on the
(pp, tp, cp, dp) shape, so they are built once per shape and shared across
every microbatch variant of that shape.

Every entry point here takes ``device``: ``None`` is the CUDA device and an
error without one; ``"cpu"`` must be named.  It is resolved where a tensor is
first needed (the estimator forward, the torch SA backend), so a request that
uses neither (no estimator, ``backend="numpy"`` or ``None``) needs no device.

Stages 1-4 are reified as :class:`BatchSearchContext` so *near-identical
requests* (same workload + cluster + space shape, different microbatch
caps / budgets / seeds) can share one enumeration, one
``predict_batch`` forward, one profile cache and one pre-score pass — the
plan service batches grouped requests through a single context.  Per
request, the context filters the shared enumeration by the request's own
microbatch predicates (order-preserving, so the filtered list is exactly
what a standalone enumeration would produce) and indexes the shared
per-conf arrays — every per-conf value is computed independently of its
batch neighbours, so a batched search is **bit-identical** to a standalone
``run_search`` of the same request.  ``run_search`` itself is now a
single-request context: one code path, trivially consistent."""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .._device import DeviceLike
from .cluster import ClusterSpec
from .dedication import (DedicationEngine, GroupIndex, PairCache, SAResult,
                         anneal, anneal_multistart)
from .latency import default_mapping_latencies
from .memory import MemoryEstimator, enumerate_confs, ground_truth_memory
from .partition import Partition
from .simulator import Conf, ProfileCache, Workload, default_mapping

if TYPE_CHECKING:                              # pragma: no cover
    from .plan import PlanRequest


@dataclass
class Candidate:
    """One surviving configuration: (Conf, Map, T) plus the memory estimate.

    Attributes:
        conf: parallelism configuration.
        mapping: ``(pp, tp, dp)`` (or ``(pp, tp, cp, dp)`` when
            ``conf.cp > 1``) worker -> GPU dedication.
        latency: estimated seconds/iteration (Eq. 3-6).
        mem_pred: predicted peak bytes/GPU (``nan`` without an estimator).
        partition: resolved non-uniform chunk partition (None = the legacy
            uniform split, which is also what a "dp"-mode search records
            when the DP solver degenerates to the ceil-first boundaries).
        schedule: pipeline schedule name (``conf.schedule``; recorded for
            Plan provenance).
        sa: the :class:`~repro_torch.core.dedication.SAResult` behind ``mapping``
            when this candidate was annealed (None for default-mapping
            candidates).  In-process diagnostics only — never serialized
            into a Plan; its accepted-move counters feed the warm-start
            economy metrics in :class:`Overhead`.
    """
    conf: Conf
    mapping: np.ndarray
    latency: float
    mem_pred: float
    partition: Optional[Partition] = None
    schedule: str = "1f1b"
    sa: Optional[SAResult] = field(default=None, repr=False)


@dataclass
class Overhead:
    """Typed search-overhead breakdown (the paper's Table II axis).

    The ``*_s`` fields are wall-clock phase timings of the staged pipeline;
    ``n_enumerated``/``n_candidates`` are the deterministic size counters.
    ``sa_accepted`` is the total number of accepted SA moves across every
    annealed candidate and chain; ``sa_accepted_to_best`` is the accepted
    moves the *winning* candidate's best chain needed before landing on its
    final mapping — the "search economy" a warm start buys (a seeded chain
    that starts at a good incumbent accepts fewer moves to reach an equal
    or better plan).  Both are deterministic under iteration-bound budgets
    and serialize with the plan.  ``as_dict()`` keeps the benchmarks'
    JSON/CSV output format, and ``__getitem__`` preserves the historical
    ``overhead["sa_s"]`` dict-style access so existing callers keep working
    — but unlike the stringly-typed dict, a typo in attribute access now
    fails loudly at the call site.
    """
    total_s: float = 0.0
    sa_s: float = 0.0
    mem_estimator_s: float = 0.0
    enumerate_s: float = 0.0
    profile_s: float = 0.0
    prescore_s: float = 0.0
    n_enumerated: int = 0
    n_candidates: int = 0
    sa_accepted: int = 0
    sa_accepted_to_best: int = 0

    def as_dict(self) -> dict:
        """Plain-dict view (benchmark JSON/CSV output)."""
        return dataclasses.asdict(self)

    def counts(self) -> dict:
        """Only the deterministic counters — what a serialized
        :class:`~repro_torch.core.plan.Plan` records (wall-clock timings are
        process-local measurements, excluded so the artifact is
        byte-reproducible)."""
        return {"n_enumerated": self.n_enumerated,
                "n_candidates": self.n_candidates,
                "sa_accepted": self.sa_accepted,
                "sa_accepted_to_best": self.sa_accepted_to_best}

    def __getitem__(self, key: str):
        return self.as_dict()[key]


@dataclass
class SearchResult:
    """Ranked output of a configurator search (``Planner.plan`` /
    ``configure``).

    Attributes:
        best: lowest-latency candidate (``None`` if nothing survived).
        ranked: all candidates, fastest first.
        overhead: typed timing breakdown (:class:`Overhead`).

    Example:
        >>> res = configure(w, spec, bw, sa_seconds=0.2)
        >>> res.best.conf.n_gpus == spec.n_gpus
        True
        >>> [str(c.conf) for c in res.top(3)]       # Fig. 5b style top-k
        ['pp4·tp8·dp2·mb2(n_mb=16)', ...]
    """
    best: Optional[Candidate]
    ranked: List[Candidate]
    overhead: Overhead = field(default_factory=Overhead)

    def top(self, k: int = 10) -> List[Candidate]:
        """First ``k`` candidates by estimated latency (fastest first)."""
        return self.ranked[:k]


class BatchSearchContext:
    """Stages 1-4 of Algorithm 1, run once and shared across requests.

    The context is built for one (workload, cluster, search-space *shape*)
    group with *union* microbatch caps; each member request then calls
    :meth:`search`, which filters the shared enumeration down to exactly
    the confs that request would have enumerated standalone and runs only
    stage 5 (SA dedication) per request.  Because every per-conf quantity
    (memory prediction row, profile, default-mapping pre-score) is
    computed independently of its batch neighbours, a batched search is
    bit-identical to a standalone :func:`run_search` of the same request
    — the plan service relies on this to coalesce near-identical requests
    through one ``predict_batch`` forward without changing a
    single plan byte.

    Attributes:
        n_predict_batches: how many ``predict_batch`` forwards this
            context has issued (0 without an estimator, else exactly 1) —
            observable proof of request batching for tests and benchmarks.
        build_s / enumerate_s / mem_estimator_s / profile_s / prescore_s:
            wall-clock timings of the shared stages; every member request's
            :class:`Overhead` reports these same (un-amortized) values.
    """

    def __init__(self, workload: Workload, spec: ClusterSpec,
                 bw: np.ndarray, *, partition: str = "uniform",
                 max_cp: int = 1, max_tp: int = 0, max_vpp: int = 1,
                 max_micro: int = 16, fixed_micro: Optional[int] = None,
                 estimator: Optional[MemoryEstimator] = None,
                 mem_limit: Optional[float] = None,
                 device: DeviceLike = None) -> None:
        t0 = time.perf_counter()
        self.device = device
        self.workload = workload
        self.spec = spec
        self.bw = bw
        self.partition = partition
        self.max_cp, self.max_tp, self.max_vpp = max_cp, max_tp, max_vpp
        self.max_micro, self.fixed_micro = max_micro, fixed_micro
        self.estimator = estimator
        self.mem_limit = (mem_limit if mem_limit is not None
                          else spec.mem_floor)
        self.n_predict_batches = 0
        w = workload

        # stage 1: enumerate the whole (union) search space up front
        confs = [conf for conf in enumerate_confs(spec.n_gpus, w.bs_global,
                                                  n_layers=w.cfg.n_layers,
                                                  max_cp=max_cp,
                                                  max_tp=max_tp,
                                                  seq=w.seq,
                                                  max_vpp=max_vpp)
                 if conf.bs_micro <= max_micro
                 and (fixed_micro is None or conf.bs_micro == fixed_micro)]
        self._confs = confs
        self.enumerate_s = time.perf_counter() - t0

        # partition-aware profile cache; also the resolver of each conf's
        # chunk partition (None = uniform -> every legacy bit-exact path)
        self._prof_cache = ProfileCache(w, spec, partition)

        # stage 2: batched memory pruning — one forward for all
        # confs in the union
        tm = time.perf_counter()
        if estimator is not None and confs:
            preds = estimator.predict_batch(w.cfg, confs, device=device)
            self.n_predict_batches = 1
            # The estimator was fit on the uniform-split ground truth; a
            # non-uniform partition / interleaved schedule shifts the
            # worst-stage peak, so rescale its prediction by the
            # ground-truth ratio.  Uniform plain-1F1B configs skip this
            # entirely (ratio would be exactly 1), keeping legacy
            # predictions bit-identical.
            for i, c in enumerate(confs):
                part = self._prof_cache.partition_for(c)
                if part is None and c.vpp == 1:
                    continue
                legacy = ground_truth_memory(
                    w, dataclasses.replace(c, vpp=1), spec)
                actual = ground_truth_memory(w, c, spec, partition=part)
                preds[i] *= actual / legacy
            self._keep = np.asarray(
                preds <= self.mem_limit * estimator.soft_margin, dtype=bool)
            self._mem_preds = preds
        else:
            self._keep = np.ones(len(confs), dtype=bool)
            self._mem_preds = np.full(len(confs), float("nan"))
        self.mem_estimator_s = time.perf_counter() - tm

        # stage 3: profiles only for union survivors, memoized per
        # (pp, tp, cp, bs_micro, vpp, partition)
        tp0 = time.perf_counter()
        surv = [i for i in range(len(confs)) if self._keep[i]]
        self._profiles = {i: self._prof_cache.get(confs[i]) for i in surv}
        self.profile_s = time.perf_counter() - tp0

        # stage 4: one cached pass over every union survivor's default
        # mapping; per-conf values are independent, so indexing this by a
        # request's conf subset reproduces its standalone pre-score
        ts0 = time.perf_counter()
        self._base_lat = np.full(len(confs), float("nan"))
        if surv:
            self._base_lat[surv] = default_mapping_latencies(
                [confs[i] for i in surv], [self._profiles[i] for i in surv],
                bw, spec)
        self.prescore_s = time.perf_counter() - ts0
        self.build_s = time.perf_counter() - t0

    @classmethod
    def for_requests(cls, reqs: Sequence["PlanRequest"], bw: np.ndarray, *,
                     estimator: Optional[MemoryEstimator] = None,
                     mem_limit: Optional[float] = None,
                     device: DeviceLike = None
                     ) -> "BatchSearchContext":
        """Build a context covering every request in ``reqs``.

        The requests must share workload, cluster spec, and the
        search-space *shape* knobs (``partition``/``max_cp``/``max_tp``/
        ``max_vpp``); the microbatch knobs are unioned (``max_micro`` =
        group max; ``fixed_micro`` kept only when every request pins the
        same value, else the union enumerates all microbatches and each
        request re-applies its own pin in :meth:`search`).
        """
        if not reqs:
            raise ValueError("for_requests needs at least one request")
        r0 = reqs[0]
        for r in reqs[1:]:
            if r.workload != r0.workload or r.spec != r0.spec:
                raise ValueError(
                    "batched requests must share workload and cluster spec")
            if (r.space.partition != r0.space.partition
                    or r.space.max_cp != r0.space.max_cp
                    or r.space.max_tp != r0.space.max_tp
                    or r.space.max_vpp != r0.space.max_vpp):
                raise ValueError("batched requests must share the "
                                 "search-space shape knobs (partition/"
                                 "max_cp/max_tp/max_vpp)")
        fixed = {r.space.fixed_micro for r in reqs}
        return cls(r0.workload, r0.spec, bw,
                   partition=r0.space.partition, max_cp=r0.space.max_cp,
                   max_tp=r0.space.max_tp, max_vpp=r0.space.max_vpp,
                   max_micro=max(r.space.max_micro for r in reqs),
                   fixed_micro=(fixed.pop() if len(fixed) == 1 else None),
                   estimator=estimator, mem_limit=mem_limit, device=device)

    def _check(self, req: "PlanRequest") -> None:
        """Reject a request whose standalone enumeration would not be an
        in-order subset of this context's union enumeration."""
        space = req.space
        if req.workload != self.workload or req.spec != self.spec:
            raise ValueError(
                "request workload/cluster does not match this batch context")
        if (space.partition != self.partition
                or space.max_cp != self.max_cp
                or space.max_tp != self.max_tp
                or space.max_vpp != self.max_vpp):
            raise ValueError("request search-space shape does not match "
                             "this batch context")
        if space.max_micro > self.max_micro:
            raise ValueError(
                f"request max_micro={space.max_micro} exceeds the "
                f"context's union cap {self.max_micro}")
        if (self.fixed_micro is not None
                and space.fixed_micro != self.fixed_micro):
            raise ValueError(
                f"request fixed_micro={space.fixed_micro!r} conflicts with "
                f"the context's pinned fixed_micro={self.fixed_micro}")

    def search(self, req: "PlanRequest", *,
               dedicate: bool = True) -> SearchResult:
        """Run stage 5 (SA dedication + ranking) for one member request.

        Filters the shared union enumeration by the request's own
        microbatch predicates (order-preserving — the filtered list is
        exactly what the request would have enumerated standalone), then
        indexes the shared predictions/profiles/pre-scores and anneals.
        ``budget.warm_start``, when set, must be a permutation of the
        cluster's GPU ids; it seeds every SA chain with that incumbent
        mapping (both the unified NumPy/torch backends and the legacy
        per-candidate path).
        """
        t0 = time.perf_counter()
        self._check(req)
        space, budget, seed = req.space, req.budget, req.seed
        sa_seconds, sa_iters = budget.sa_seconds, budget.sa_iters
        n_chains, sa_topk = budget.n_chains, budget.sa_topk
        spec, bw = self.spec, self.bw

        warm_perm: Optional[np.ndarray] = None
        warm = getattr(budget, "warm_start", None)
        if warm is not None:
            warm_perm = np.asarray(warm, dtype=np.int64)
            n = spec.n_gpus
            if (warm_perm.shape != (n,)
                    or not np.array_equal(np.sort(warm_perm),
                                          np.arange(n))):
                raise ValueError(
                    f"budget.warm_start must be a permutation of the {n} "
                    f"cluster GPU ids, got shape {warm_perm.shape}")

        # per-request view of the shared stages
        idx = [i for i, c in enumerate(self._confs)
               if c.bs_micro <= space.max_micro
               and (space.fixed_micro is None
                    or c.bs_micro == space.fixed_micro)]
        n_enumerated = len(idx)
        surv_idx = [i for i in idx if self._keep[i]]
        survivors = [self._confs[i] for i in surv_idx]
        profiles = [self._profiles[i] for i in surv_idx]
        base_lat = self._base_lat[surv_idx]
        mem_preds = self._mem_preds[surv_idx]

        # stage 5: SA dedication — exhaustive, or concentrated on the
        # top-k by pre-score
        sa_time = 0.0
        cands: List[Candidate] = []
        if dedicate and survivors:
            if sa_topk is None or sa_topk >= len(survivors):
                sa_set = set(range(len(survivors)))
            else:
                order = np.argsort(base_lat, kind="stable")
                sa_set = set(int(i) for i in order[:max(sa_topk, 0)])
            if budget.backend is not None:
                # unified backend-selectable core: one MovePlan executed
                # by the incremental NumPy engine or the batched torch
                # annealer (byte-identical results); candidates batched
                # per shape; warm_start is read off the budget inside
                from .annealing import dedicate_candidates
                ts = time.perf_counter()
                sa_res = dedicate_candidates(survivors, profiles,
                                             sorted(sa_set), bw, spec,
                                             budget, seed,
                                             device=self.device)
                sa_time = time.perf_counter() - ts
                for i, conf in enumerate(survivors):
                    if i in sa_res:
                        cands.append(Candidate(conf, sa_res[i].mapping,
                                               sa_res[i].latency,
                                               float(mem_preds[i]),
                                               sa=sa_res[i]))
                    else:
                        cands.append(Candidate(conf, default_mapping(conf),
                                               float(base_lat[i]),
                                               float(mem_preds[i])))
                survivors = []        # handled; skip the legacy loop
            index_cache: Dict[Tuple[int, int, int, int], GroupIndex] = {}
            pair_cache: Optional[PairCache] = None
            for i, (conf, prof) in enumerate(zip(survivors, profiles)):
                if i not in sa_set:
                    cands.append(Candidate(conf, default_mapping(conf),
                                           float(base_lat[i]),
                                           float(mem_preds[i])))
                    continue
                shape = (conf.pp, conf.tp, conf.cp, conf.dp)
                gidx = index_cache.get(shape)
                if gidx is None:
                    gidx = index_cache[shape] = GroupIndex.build(conf)
                if pair_cache is None:
                    # the O(G^2) pair matrices depend only on (bw, spec)
                    # — one build serves every annealed candidate
                    pair_cache = PairCache.build(bw, spec.gpus_per_node)
                engine = DedicationEngine(conf, bw, prof, spec, index=gidx,
                                          pairs=pair_cache)
                ts = time.perf_counter()
                if n_chains > 1:
                    res = anneal_multistart(conf, bw, prof, spec,
                                            n_chains=n_chains,
                                            time_limit_s=sa_seconds,
                                            max_iters=sa_iters, seed=seed,
                                            init_perm=warm_perm,
                                            engine=engine)
                else:
                    res = anneal(conf, bw, prof, spec,
                                 time_limit_s=sa_seconds,
                                 max_iters=sa_iters, seed=seed,
                                 init_perm=warm_perm, engine=engine)
                sa_time += time.perf_counter() - ts
                cands.append(Candidate(conf, res.mapping, res.latency,
                                       float(mem_preds[i]), sa=res))
        else:
            for i, conf in enumerate(survivors):
                cands.append(Candidate(conf, default_mapping(conf),
                                       float(base_lat[i]),
                                       float(mem_preds[i])))

        # record partition + schedule provenance on every candidate
        for c in cands:
            c.partition = self._prof_cache.partition_for(c.conf)
            c.schedule = c.conf.schedule

        cands.sort(key=lambda c: c.latency)
        sa_accepted = sum(c.sa.accepted for c in cands if c.sa is not None)  # repro: noqa DET004 -- accepted-move counters are ints; integer addition is order-independent
        best = cands[0] if cands else None
        sa_accepted_to_best = (best.sa.accepted_to_best
                               if best is not None and best.sa is not None
                               else 0)
        return SearchResult(
            best=best,
            ranked=cands,
            overhead=Overhead(
                total_s=self.build_s + (time.perf_counter() - t0),
                sa_s=sa_time, mem_estimator_s=self.mem_estimator_s,
                enumerate_s=self.enumerate_s, profile_s=self.profile_s,
                prescore_s=self.prescore_s,
                n_enumerated=n_enumerated,
                n_candidates=len(cands),
                sa_accepted=int(sa_accepted),
                sa_accepted_to_best=int(sa_accepted_to_best)))


def run_search(req: "PlanRequest", bw: np.ndarray, *,
               estimator: Optional[MemoryEstimator] = None,
               mem_limit: Optional[float] = None,
               dedicate: bool = True,
               device: DeviceLike = None) -> SearchResult:
    """Pipette (Algorithm 1) over a declarative :class:`~repro_torch.core.plan.
    PlanRequest`: enumerate -> memory-prune -> profile -> pre-score ->
    dedicate -> rank.

    This is the engine behind both :class:`~repro_torch.core.plan.PipetteStrategy`
    (``dedicate=True``) and :class:`~repro_torch.core.plan.ExhaustiveStrategy`
    (``dedicate=False``, the PPT-L ablation).  The legacy kwarg entry point
    :func:`configure` is a thin, bit-exact shim over it.  Internally this
    builds a single-request :class:`BatchSearchContext` — the same code
    path the plan service uses to batch grouped requests, so standalone
    and batched searches cannot drift apart.

    Args:
        req: declarative request — workload, cluster spec, search space
            (``max_cp``/``max_tp``/``max_micro``/``fixed_micro``), budget
            (``sa_seconds``/``sa_iters``/``n_chains``/``sa_topk``, plus
            ``warm_start`` to seed every SA chain with an incumbent
            permutation), seed.
        bw: ``(G, G)`` profiled bandwidth matrix from
            :func:`~repro_torch.core.cluster.profile_bandwidth`.
        estimator: optional MLP memory estimator; prunes configs predicted
            to exceed ``mem_limit * soft_margin`` (one batched forward for
            the whole enumeration).  Must have been fit with
            ``max_cp > 1`` (:func:`~repro_torch.core.memory.fit_memory_estimator`)
            to score a 4D search.
        mem_limit: per-GPU memory budget in bytes (default
            ``req.spec.mem_floor`` — every GPU hosts a worker, so the
            budget must respect the *tightest* device tier; identical to
            ``gpu_mem`` on homogeneous specs).
        dedicate: ``False`` gives the PPT-L ablation (latency+memory
            estimators only, identity mapping).
        device: where the estimator forward and the torch SA backend run;
            ``None`` is the CUDA device and raises without one.

    Returns:
        :class:`SearchResult` with the best candidate and the full ranking.
    """
    space = req.space
    ctx = BatchSearchContext(req.workload, req.spec, bw,
                             partition=space.partition,
                             max_cp=space.max_cp, max_tp=space.max_tp,
                             max_vpp=space.max_vpp,
                             max_micro=space.max_micro,
                             fixed_micro=space.fixed_micro,
                             estimator=estimator, mem_limit=mem_limit,
                             device=device)
    return ctx.search(req, dedicate=dedicate)


def configure(w: Workload, spec: ClusterSpec, bw: np.ndarray, *,
              estimator: Optional[MemoryEstimator] = None,
              mem_limit: Optional[float] = None,
              sa_seconds: float = 1.0, sa_iters: int = 8_000,
              n_chains: int = 1, sa_topk: Optional[int] = None,
              max_micro: int = 16, fixed_micro: Optional[int] = None,
              max_cp: int = 1, max_tp: int = 0,
              partition: str = "uniform", max_vpp: int = 1,
              seed: int = 0,
              dedicate: bool = True,
              backend: Optional[str] = "torch",
              device: DeviceLike = None) -> SearchResult:
    """Legacy kwarg entry point — a thin shim over the Planner API.

    Packs the kwarg pile into a declarative
    :class:`~repro_torch.core.plan.PlanRequest` and runs it through
    ``Planner(PipetteStrategy(...))`` (or ``ExhaustiveStrategy`` when
    ``dedicate=False``).  Bit-exact with calling the Planner directly —
    same best conf, mapping, latency, and full ranking (enforced by
    ``tests/test_planner_api.py``) — so every historical caller keeps
    working unchanged.

    Args:
        w: workload (model config, sequence length, global batch).
        spec: cluster description.
        bw: ``(G, G)`` profiled bandwidth matrix.
        estimator / mem_limit: memory-pruning inputs (see
            :func:`run_search`).
        sa_seconds / sa_iters / n_chains / sa_topk: SA budget
            (:class:`~repro_torch.core.plan.Budget`).
        max_micro / fixed_micro / max_cp / max_tp / partition / max_vpp:
            search-space knobs (:class:`~repro_torch.core.plan.SearchSpace`).
        seed: RNG seed; the whole search is deterministic given it.
        dedicate: ``False`` gives the PPT-L ablation (identity mapping).
        backend / device: SA execution engine (``Budget.backend``) and the
            device it and the estimator run on (``None`` = CUDA).

    Returns:
        The full :class:`SearchResult` (the Planner's in-process view;
        use the Planner directly to get the serializable ``Plan``).
    """
    from .plan import (Budget, ExhaustiveStrategy, Planner, PlanRequest,
                       PipetteStrategy, SearchSpace)
    req = PlanRequest(
        workload=w, spec=spec,
        space=SearchSpace(max_cp=max_cp, max_tp=max_tp, max_micro=max_micro,
                          fixed_micro=fixed_micro, partition=partition,
                          max_vpp=max_vpp),
        budget=Budget(sa_seconds=sa_seconds, sa_iters=sa_iters,
                      n_chains=n_chains, sa_topk=sa_topk, backend=backend),
        seed=seed)
    strategy = (PipetteStrategy(estimator=estimator, mem_limit=mem_limit)
                if dedicate
                else ExhaustiveStrategy(estimator=estimator,
                                        mem_limit=mem_limit))
    return Planner(strategy, device=device).plan(req, bw).result

"""The Planner API: declarative request -> pluggable strategy -> Plan.

One search pipeline (enumerate -> memory-prune -> pre-score -> dedicate,
Alg. 1) serves initial configuration, baseline comparison, and elastic
re-planning — so the public API is built around three pieces:

1. a **declarative request**: :class:`SearchSpace` (strategy-agnostic
   space knobs), :class:`Budget` (SA budget), and
   :class:`PlanRequest` (workload + cluster + space + budget + seed),
   replacing the historical 15-kwarg ``configure()`` pile;
2. a **pluggable strategy**: the :class:`Strategy` protocol, implemented
   by :class:`PipetteStrategy` (the five-stage pipeline),
   :class:`ExhaustiveStrategy` (the PPT-L ``dedicate=False`` ablation),
   and the AMP / Varuna / Megatron-LM baselines re-homed behind the same
   interface — ``Planner(strategy).plan(request, bw)`` is the one entry
   point for all of them;
3. a **serializable artifact**: :class:`Plan` — best conf + mapping +
   latency + memory prediction, the ranked top-k, the deterministic
   overhead counters, and provenance (bandwidth-matrix digest, estimator
   fit provenance, seed, strategy name) — with a byte-reproducible JSON
   round trip (:meth:`Plan.save` / :meth:`Plan.load`), in the same schema
   and bytes as the JAX package's, so either package reads the other's
   plans.

The legacy ``configure()`` remains as a thin, bit-exact shim over
``Planner(PipetteStrategy())`` (see ``search.py``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from dataclasses import dataclass, field
from typing import ClassVar, Optional, Protocol, Tuple, runtime_checkable

import numpy as np

from .._device import DeviceLike
from .baselines import amp_configure, mlm_configure, varuna_configure
from .cluster import ClusterSpec, tier_fingerprint
from .memory import MemoryEstimator
from .partition import PARTITION_MODES, Partition
from .search import Candidate, Overhead, SearchResult, run_search
from .simulator import Conf, Workload

# 2: heterogeneous-compute provenance — ``provenance.tiers`` records the
#    device-tier table digest, the table itself, and the node assignment
#    (null for homogeneous clusters).
# 3: backend-selectable SA core — ``provenance.budget`` grows ``backend``
#    (null = historical per-candidate loop, "numpy"/"torch" here —
#    "numpy"/"jax" in the JAX package — = the unified MovePlan core) and ``hierarchical`` (island search; null = auto by
#    fleet size).
# 4: non-uniform pipeline partitions + interleaved-1F1B — confs grow
#    ``vpp``, candidates grow ``partition`` (the resolved stage-boundary
#    artifact, null = uniform layering) and ``schedule`` ("1f1b" /
#    "interleaved-1f1b"), ``provenance.space`` grows ``partition`` and
#    ``max_vpp``.
# 5: planning-as-a-service — ``provenance.budget`` grows ``warm_start``
#    (the incumbent GPU permutation that seeded every SA chain; null =
#    cold start), ``provenance`` grows ``lineage`` (how the serving layer
#    produced this plan: warm-start source fingerprint + neighbor
#    distance; null = a direct cold search), and ``overhead`` grows the
#    deterministic accepted-move counters ``sa_accepted`` /
#    ``sa_accepted_to_best`` (the warm-start economy metric).  Any
#    further change to the serialized shape MUST bump this
#    (tests/test_plan_golden.py enforces it).
PLAN_SCHEMA_VERSION = 5


# ---------------------------------------------------------------------------
# the declarative request
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SearchSpace:
    """Strategy-agnostic description of the candidate space.

    Attributes:
        max_cp: open the context-parallel axis up to this degree (1 —
            the default — is the paper's 3D space).
        max_tp: cap on tensor parallelism (0 = unbounded); useful to keep
            TP groups inside a node (``spec.gpus_per_node``).
        max_micro: skip configurations with ``bs_micro`` above this.
        fixed_micro: restrict to one microbatch size (ablations).
        partition: layer-to-stage partitioning mode — ``"uniform"``
            (the historical ceil-first split) or ``"dp"`` (the balanced
            min-max dynamic program over per-layer cost vectors).
        max_vpp: open interleaved-1F1B up to this many virtual pipeline
            chunks per stage (1 — the default — is plain 1F1B only).
    """
    max_cp: int = 1
    max_tp: int = 0
    max_micro: int = 16
    fixed_micro: Optional[int] = None
    partition: str = "uniform"
    max_vpp: int = 1

    def __post_init__(self):
        if self.max_cp < 1:
            raise ValueError(f"max_cp must be >= 1, got {self.max_cp}")
        if self.max_tp < 0 or self.max_micro < 1:
            raise ValueError("max_tp must be >= 0 and max_micro >= 1")
        if self.partition not in PARTITION_MODES:
            raise ValueError(
                f"partition must be one of {PARTITION_MODES}, "
                f"got {self.partition!r}")
        if self.max_vpp < 1:
            raise ValueError(f"max_vpp must be >= 1, got {self.max_vpp}")


@dataclass(frozen=True)
class Budget:
    """SA dedication budget (per candidate, split across chains).

    Attributes:
        sa_seconds / sa_iters: wall-clock / iteration caps per candidate
            (whichever bites first; use a large ``sa_seconds`` with a small
            ``sa_iters`` for deterministic, iteration-bound runs).
        n_chains: independent SA restarts per candidate, best-of.
        sa_topk: anneal only the ``k`` best pre-scored candidates; the
            rest keep their default mapping (``None`` = anneal every
            survivor).
        backend: SA execution engine.  ``"torch"`` (default) and
            ``"numpy"`` select the unified
            :mod:`~repro_torch.core.annealing` core (precomputed
            :class:`~repro_torch.core.annealing.MovePlan`, exact chain
            budget split, optional hierarchical island search) executed as
            one batched step loop on the CUDA device or incrementally on
            the host — the two produce byte-identical plans.  ``None``
            keeps the historical per-candidate
            ``anneal``/``anneal_multistart`` host loop, bit-exact with
            its regression fixtures.  There is no device field here on
            purpose: the budget is serialized into every Plan, so where a
            search ran is an argument of the entry point
            (``Planner(strategy, device=...)``), not of the request.
        hierarchical: island-decomposed search (coarse inter-island
            arrangement + within-island refinement; unified backends
            only).  ``None`` = auto: hierarchical at >= 2048 GPUs.
        warm_start: incumbent flat GPU permutation to seed every SA chain
            with (``None`` = cold start from the coarse/identity
            assignment).  Must be a permutation of ``range(n_gpus)``; the
            plan server derives it from a cached neighbor plan's mapping
            via :func:`~repro_torch.core.dedication.mapping_to_perm`.  The seed
            only sets the *starting point* — move schedules are unchanged,
            and SA tracks best-so-far from the initial permutation, so a
            warm-started search never returns a worse plan than the
            incumbent it started from.
    """
    sa_seconds: float = 1.0
    sa_iters: int = 8_000
    n_chains: int = 1
    sa_topk: Optional[int] = None
    backend: Optional[str] = "torch"
    hierarchical: Optional[bool] = None
    warm_start: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.sa_seconds <= 0 or self.sa_iters < 1 or self.n_chains < 1:
            raise ValueError("sa_seconds/sa_iters/n_chains must be positive")
        if self.backend not in (None, "numpy", "torch"):
            raise ValueError(
                f"backend must be None, 'numpy' or 'torch', "
                f"got {self.backend!r}")
        if self.hierarchical is not None \
                and not isinstance(self.hierarchical, bool):
            raise ValueError("hierarchical must be None or a bool")
        if self.warm_start is not None:
            ws = tuple(int(x) for x in self.warm_start)
            if sorted(ws) != list(range(len(ws))):
                raise ValueError(
                    "warm_start must be a permutation of range(n), got "
                    f"{self.warm_start!r}")
            object.__setattr__(self, "warm_start", ws)


@dataclass(frozen=True)
class PlanRequest:
    """Everything a strategy needs to produce a Plan, as one value.

    Attributes:
        workload: model config + sequence length + global batch.
        spec: cluster description.
        space: candidate-space knobs (:class:`SearchSpace`).
        budget: SA budget (:class:`Budget`).
        seed: RNG seed; given it, every strategy is deterministic (under an
            iteration-bound budget).
    """
    workload: Workload
    spec: ClusterSpec
    space: SearchSpace = field(default_factory=SearchSpace)
    budget: Budget = field(default_factory=Budget)
    seed: int = 0


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------

@runtime_checkable
class Strategy(Protocol):
    """A configurator: turns a :class:`PlanRequest` + bandwidth matrix into
    a ranked :class:`~repro_torch.core.search.SearchResult`.

    ``name`` identifies the strategy in Plan provenance and CLI output.
    """
    name: str

    def search(self, req: PlanRequest,
               bw: np.ndarray) -> SearchResult: ...      # pragma: no cover


@dataclass(frozen=True)
class PipetteStrategy:
    """The paper's five-stage pipeline (Alg. 1): enumerate -> memory-prune
    -> profile -> pre-score -> SA worker dedication."""
    estimator: Optional[MemoryEstimator] = None
    mem_limit: Optional[float] = None
    device: DeviceLike = None
    name: ClassVar[str] = "pipette"

    def search(self, req: PlanRequest, bw: np.ndarray) -> SearchResult:
        return run_search(req, bw, estimator=self.estimator,
                          mem_limit=self.mem_limit, dedicate=True,
                          device=self.device)


@dataclass(frozen=True)
class ExhaustiveStrategy:
    """The PPT-L ablation: latency + memory estimators over the exhaustive
    enumeration, identity (default) mapping — no SA dedication."""
    estimator: Optional[MemoryEstimator] = None
    mem_limit: Optional[float] = None
    device: DeviceLike = None
    name: ClassVar[str] = "exhaustive"

    def search(self, req: PlanRequest, bw: np.ndarray) -> SearchResult:
        return run_search(req, bw, estimator=self.estimator,
                          mem_limit=self.mem_limit, dedicate=False,
                          device=self.device)


@dataclass(frozen=True)
class AMPStrategy:
    """AMP baseline [8]: Eq. 1 latency model on nominal bandwidths,
    memory-unaware, 3D space only (the profiled ``bw`` is ignored)."""
    name: ClassVar[str] = "amp"

    def search(self, req: PlanRequest, bw: np.ndarray) -> SearchResult:
        return amp_configure(req.workload, req.spec,
                             max_micro=req.space.max_micro)


@dataclass(frozen=True)
class VarunaStrategy:
    """Varuna baseline [12]: pipeline + data parallelism only (tp = 1),
    memory-unaware, 3D space only (the profiled ``bw`` is ignored)."""
    name: ClassVar[str] = "varuna"

    def search(self, req: PlanRequest, bw: np.ndarray) -> SearchResult:
        return varuna_configure(req.workload, req.spec,
                                max_micro=req.space.max_micro)


@dataclass(frozen=True)
class MegatronStrategy:
    """Megatron-LM manual heuristic [14]: tp = gpus-per-node, then the
    "expert" trial-runs the most promising configs on the cluster.

    The trial runs execute on ``bw_true`` when given (the simulator's
    ground-truth matrix — the paper's setting, where manual tuning runs on
    the real cluster, not the profiled snapshot); otherwise on the ``bw``
    handed to :meth:`search`.
    """
    trials: int = 6
    bw_true: Optional[np.ndarray] = None
    name: ClassVar[str] = "megatron-lm"

    def search(self, req: PlanRequest, bw: np.ndarray) -> SearchResult:
        return mlm_configure(req.workload, req.spec, self.scoring_bw(bw),
                             max_micro=req.space.max_micro,
                             trials=self.trials, seed=req.seed)

    def scoring_bw(self, bw: np.ndarray) -> np.ndarray:
        """The matrix the trial runs actually execute on — what Plan
        provenance must fingerprint (not the ignored profiled ``bw``)."""
        return self.bw_true if self.bw_true is not None else bw


#: Strategy constructors by name (CLI / provenance lookup).
STRATEGIES = {
    "pipette": PipetteStrategy,
    "exhaustive": ExhaustiveStrategy,
    "amp": AMPStrategy,
    "varuna": VarunaStrategy,
    "megatron-lm": MegatronStrategy,
}


# ---------------------------------------------------------------------------
# provenance
# ---------------------------------------------------------------------------

def bw_fingerprint(bw: np.ndarray) -> str:
    """SHA-256 digest of a bandwidth matrix (shape + float64 bytes).

    Recorded in Plan provenance so a plan can be matched against the
    interconnect snapshot it was computed for — a re-profiled cluster
    yields a different digest, signalling the plan may be stale.
    """
    a = np.ascontiguousarray(bw, np.float64)
    h = hashlib.sha256()
    h.update(repr(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def tier_provenance(spec: ClusterSpec) -> Optional[dict]:
    """Device-tier provenance of a cluster spec (``None`` when homogeneous):
    the :func:`~repro_torch.core.cluster.tier_fingerprint` digest plus the tier
    table and node assignment themselves, so a plan records exactly which
    fleet composition it priced — a re-tiered cluster (node swapped,
    host degraded) yields a different digest, signalling staleness."""
    digest = tier_fingerprint(spec)
    if digest is None:
        return None
    return {"digest": digest,
            "tiers": [{"flops": t.flops, "mem": t.mem,
                       "efficiency": t.efficiency, "name": t.name}
                      for t in spec.tiers],
            "node_tiers": [int(t) for t in spec.node_tiers]}


def estimator_provenance(est: Optional[MemoryEstimator]) -> Optional[dict]:
    """Fit provenance of a memory estimator (``None`` for memory-unaware
    strategies): which feature space it was fit on and against which
    hardware ground truth — the fields an elastic re-planner needs for
    staleness detection."""
    if est is None:
        return None
    return {"with_cp": bool(est.with_cp),
            "residual": bool(est.residual),
            "soft_margin": float(est.soft_margin),
            "workload_seq": int(est.workload_seq),
            "fit_gpu_mem": float(est.fit_gpu_mem),
            "fit_gpus_per_node": int(est.fit_gpus_per_node)}


@dataclass(frozen=True)
class Provenance:
    """Where a Plan came from — enough to audit it without re-running.

    Attributes:
        strategy: producing strategy's ``name``.
        seed: the request seed.
        bw_digest: :func:`bw_fingerprint` of the profiled matrix.
        cluster: cluster spec name; ``n_gpus`` its size at plan time.
        model / seq / bs_global: the workload.
        space / budget: the request's search-space and budget knobs.
        estimator: :func:`estimator_provenance` dict, or ``None``.
        tiers: :func:`tier_provenance` dict (device-tier table digest +
            node assignment), or ``None`` for homogeneous clusters.
        lineage: how the serving layer produced this plan, or ``None``
            for a direct cold search.  The plan server records
            ``{"warm_start_from": <fingerprint>, "distance": <float>}``
            when the search was seeded from a cached neighbor plan, and
            an elastic replan records ``{"replan_of": <incumbent
            fingerprint>, "warm_start_projected": <bool>, "survivors":
            <count>}`` — enough to audit which incumbent a warm start /
            replan descended from.  Free-form dict, serialized as-is
            (keys inside it are not schema-pinned).
    """
    strategy: str
    seed: int
    bw_digest: str
    cluster: str
    n_gpus: int
    model: str
    seq: int
    bs_global: int
    space: SearchSpace
    budget: Budget
    estimator: Optional[dict] = None
    tiers: Optional[dict] = None
    lineage: Optional[dict] = None


# ---------------------------------------------------------------------------
# the serializable Plan artifact
# ---------------------------------------------------------------------------

class PlanLoadError(ValueError):
    """A plan artifact could not be read: corrupt JSON, an unknown schema
    version, or a structurally broken document.

    One typed error for every way :meth:`Plan.load` can fail, carrying the
    offending ``path`` (``None`` when loading from an in-memory dict) so
    callers — the CLI, the plan server's cache — can report *which* file
    is bad and fall back (e.g. drop the cache entry and re-search) without
    fishing through ``json.JSONDecodeError`` / ``KeyError`` /
    ``ValueError`` separately.
    """

    def __init__(self, message: str, *, path: Optional[str] = None):
        super().__init__(message)
        self.path = path


def _num_out(x: float):
    """JSON-safe float: NaN -> None, inf -> "inf" (strict-JSON friendly)."""
    x = float(x)
    if math.isnan(x):
        return None
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    return x


def _num_in(x) -> float:
    if x is None:
        return float("nan")
    if isinstance(x, str):
        return float(x)
    return float(x)


def _budget_out(b: Budget) -> dict:
    d = dataclasses.asdict(b)
    if d["warm_start"] is not None:
        d["warm_start"] = list(d["warm_start"])    # tuple -> JSON array
    return d


def _conf_out(conf: Conf) -> dict:
    return {"pp": conf.pp, "tp": conf.tp, "cp": conf.cp, "dp": conf.dp,
            "vpp": conf.vpp, "bs_micro": conf.bs_micro,
            "bs_global": conf.bs_global}


def _conf_in(d: dict) -> Conf:
    return Conf(pp=d["pp"], tp=d["tp"], dp=d["dp"], bs_micro=d["bs_micro"],
                bs_global=d["bs_global"], cp=d.get("cp", 1),
                vpp=d.get("vpp", 1))


def _mapping_out(mapping: np.ndarray) -> dict:
    m = np.asarray(mapping)
    return {"dtype": str(m.dtype), "shape": list(m.shape),
            "data": m.reshape(-1).tolist()}


def _mapping_in(d: dict) -> np.ndarray:
    return np.asarray(d["data"], dtype=np.dtype(d["dtype"])) \
        .reshape(tuple(d["shape"]))


def _candidate_out(c: Candidate) -> dict:
    return {"conf": _conf_out(c.conf), "mapping": _mapping_out(c.mapping),
            "latency": _num_out(c.latency), "mem_pred": _num_out(c.mem_pred),
            "partition": (None if c.partition is None
                          else c.partition.to_json_dict()),
            "schedule": c.schedule}


def _candidate_in(d: dict) -> Candidate:
    part = d.get("partition")
    return Candidate(conf=_conf_in(d["conf"]),
                     mapping=_mapping_in(d["mapping"]),
                     latency=_num_in(d["latency"]),
                     mem_pred=_num_in(d["mem_pred"]),
                     partition=(None if part is None
                                else Partition.from_json_dict(part)),
                     schedule=d.get("schedule", "1f1b"))


@dataclass(frozen=True, eq=False)
class Plan:
    """A serializable training-configuration plan.

    The first-class artifact the launch/runtime/checkpoint layers consume:
    the chosen parallelism configuration and worker dedication, the latency
    and memory predictions behind the choice, the ranked top-k fallbacks,
    the deterministic search counters, and full provenance.  ``save``/
    ``load`` round-trip it through canonical JSON — byte-identical across
    runs for the same request + seed (wall-clock overhead timings are
    deliberately *not* serialized; they stay on the in-process
    :attr:`overhead`).

    Attributes:
        conf: best configuration (``None`` when nothing survived — e.g.
            every candidate was memory-pruned).
        mapping: worker -> GPU dedication of the best candidate,
            ``(pp, tp, dp)`` or ``(pp, tp, cp, dp)``.
        latency: estimated seconds/iteration of the best candidate.
        mem_pred: predicted peak bytes/GPU (NaN without an estimator).
        ranked: top-k candidates, fastest first (fallbacks: e.g. step to
            ``ranked[1]`` when the best OOMs in practice, Fig. 5b style).
        overhead: :class:`~repro_torch.core.search.Overhead`; only its
            deterministic counters are serialized.
        provenance: :class:`Provenance`.
        result: the full in-process :class:`~repro_torch.core.search.SearchResult`
            (every candidate, wall-clock timings).  Not serialized —
            ``None`` after :meth:`load`.
        partition: resolved layer-to-stage :class:`Partition` of the best
            candidate (``None`` = uniform layering — the historical split).
        schedule: pipeline schedule of the best candidate ("1f1b" or
            "interleaved-1f1b").
    """
    conf: Optional[Conf]
    mapping: Optional[np.ndarray]
    latency: float
    mem_pred: float
    ranked: Tuple[Candidate, ...]
    overhead: Overhead
    provenance: Provenance
    result: Optional[SearchResult] = field(default=None, repr=False)
    partition: Optional[Partition] = None
    schedule: str = "1f1b"

    @property
    def feasible(self) -> bool:
        """True when the search found at least one runnable candidate."""
        return self.conf is not None

    @classmethod
    def from_search(cls, res: SearchResult, req: PlanRequest,
                    bw: np.ndarray, *, strategy: str,
                    estimator: Optional[MemoryEstimator] = None,
                    keep_top: int = 10,
                    lineage: Optional[dict] = None) -> "Plan":
        """Freeze a :class:`SearchResult` into a Plan artifact."""
        w = req.workload
        prov = Provenance(strategy=strategy, seed=req.seed,
                          bw_digest=bw_fingerprint(bw),
                          cluster=req.spec.name, n_gpus=req.spec.n_gpus,
                          model=w.cfg.name, seq=w.seq,
                          bs_global=w.bs_global, space=req.space,
                          budget=req.budget,
                          estimator=estimator_provenance(estimator),
                          tiers=tier_provenance(req.spec),
                          lineage=lineage)
        best = res.best
        return cls(conf=best.conf if best else None,
                   mapping=(np.asarray(best.mapping).copy()
                            if best else None),
                   latency=best.latency if best else float("inf"),
                   mem_pred=best.mem_pred if best else float("nan"),
                   ranked=tuple(res.top(keep_top)),
                   overhead=res.overhead, provenance=prov, result=res,
                   partition=best.partition if best else None,
                   schedule=best.schedule if best else "1f1b")

    # -- JSON round trip ----------------------------------------------------

    def to_json_dict(self) -> dict:
        """Canonical JSON-ready dict (deterministic field content)."""
        prov = self.provenance
        return {
            "version": PLAN_SCHEMA_VERSION,
            "strategy": prov.strategy,
            "best": (None if self.conf is None else
                     {"conf": _conf_out(self.conf),
                      "mapping": _mapping_out(self.mapping),
                      "latency": _num_out(self.latency),
                      "mem_pred": _num_out(self.mem_pred),
                      "partition": (None if self.partition is None
                                    else self.partition.to_json_dict()),
                      "schedule": self.schedule}),
            "ranked": [_candidate_out(c) for c in self.ranked],
            "overhead": self.overhead.counts(),
            "provenance": {
                "seed": prov.seed,
                "bw_digest": prov.bw_digest,
                "cluster": prov.cluster,
                "n_gpus": prov.n_gpus,
                "model": prov.model,
                "seq": prov.seq,
                "bs_global": prov.bs_global,
                "space": dataclasses.asdict(prov.space),
                "budget": _budget_out(prov.budget),
                "estimator": prov.estimator,
                "tiers": prov.tiers,
                "lineage": prov.lineage,
            },
        }

    def to_json(self) -> str:
        """Canonical JSON text: sorted keys, fixed separators, trailing
        newline — byte-identical for identical plan content."""
        return json.dumps(self.to_json_dict(), sort_keys=True, indent=2,
                          allow_nan=False) + "\n"

    def save(self, path) -> str:
        """Write the canonical JSON artifact; returns the path written."""
        with open(path, "w") as f:
            f.write(self.to_json())
        return str(path)

    @classmethod
    def from_json_dict(cls, d: dict) -> "Plan":
        if d.get("version") != PLAN_SCHEMA_VERSION:
            raise PlanLoadError(
                f"unsupported plan schema version {d.get('version')!r} "
                f"(this build reads version {PLAN_SCHEMA_VERSION})")
        p = d["provenance"]
        prov = Provenance(strategy=d["strategy"], seed=p["seed"],
                          bw_digest=p["bw_digest"], cluster=p["cluster"],
                          n_gpus=p["n_gpus"], model=p["model"],
                          seq=p["seq"], bs_global=p["bs_global"],
                          space=SearchSpace(**p["space"]),
                          budget=Budget(**p["budget"]),
                          estimator=p["estimator"],
                          tiers=p["tiers"],
                          lineage=p["lineage"])
        best = d["best"]
        best_part = None if best is None else best.get("partition")
        return cls(
            conf=None if best is None else _conf_in(best["conf"]),
            mapping=None if best is None else _mapping_in(best["mapping"]),
            latency=(float("inf") if best is None
                     else _num_in(best["latency"])),
            mem_pred=(float("nan") if best is None
                      else _num_in(best["mem_pred"])),
            ranked=tuple(_candidate_in(c) for c in d["ranked"]),
            overhead=Overhead(**d["overhead"]),
            provenance=prov, result=None,
            partition=(None if best_part is None
                       else Partition.from_json_dict(best_part)),
            schedule=("1f1b" if best is None
                      else best.get("schedule", "1f1b")))

    @classmethod
    def load(cls, path) -> "Plan":
        """Read a Plan back from :meth:`save` output.

        Raises:
            PlanLoadError: corrupt JSON, unknown schema version, or a
                structurally broken document — one typed error carrying
                the offending ``path``, whatever went wrong underneath.
        """
        try:
            with open(path) as f:
                doc = json.load(f)
        except json.JSONDecodeError as e:
            raise PlanLoadError(
                f"plan artifact is not valid JSON: {e}",
                path=str(path)) from e
        try:
            return cls.from_json_dict(doc)
        except PlanLoadError as e:
            if e.path is None:
                e.path = str(path)
            raise
        except (KeyError, TypeError, ValueError) as e:
            raise PlanLoadError(
                f"plan artifact is structurally invalid: {e!r}",
                path=str(path)) from e

    # -- migration cost -----------------------------------------------------

    def diff(self, other: "Plan", *, cfg=None,
             survivors: Optional[Tuple[int, ...]] = None,
             n_nodes: Optional[int] = None,
             inter_bw: float = 12.5e9,
             restart_s: Optional[float] = None) -> "PlanDiff":
        """Migration cost of switching from this plan to ``other``.

        ``self`` is the incumbent, ``other`` the successor:
        ``a.diff(b)`` prices the ranks that must re-fetch their
        parameter/optimizer shards to go live on ``b`` (see
        :mod:`repro_torch.core.migration` for the model).  Both plans must be
        feasible.

        Args:
            cfg: the shared :class:`~repro_torch.models.config.ModelConfig`;
                resolved from ``provenance.model`` through the
                architecture registry when omitted (the two plans must
                then record the same model name).
            survivors: when the fleets differ (shrink/grow), successor
                GPU ``i`` (for ``i < len(survivors)``) is incumbent GPU
                ``survivors[i]``; successor GPUs beyond that are new.
                Default: identity on the common id prefix — the
                ``with_nodes`` truncation convention.
            n_nodes: healthy node count of the successor fleet (sets the
                aggregate transfer bandwidth); inferred from the GPU
                count when omitted.
            inter_bw: per-node inter-node bandwidth, bytes/s.
            restart_s: restart barrier seconds (``None`` = the model
                default, :data:`~repro_torch.core.migration.DEFAULT_RESTART_S`).
        """
        from .migration import (DEFAULT_RESTART_S, diff_assignments,
                                resolve_model)
        if not (self.feasible and other.feasible):
            raise ValueError("Plan.diff needs two feasible plans")
        if cfg is None:
            a, b = self.provenance.model, other.provenance.model
            if a != b:
                raise ValueError(
                    f"plans record different models ({a!r} vs {b!r}); "
                    f"pass cfg explicitly")
            cfg = resolve_model(a)
        b_to_a = None
        if survivors is not None:
            n_b = other.conf.n_gpus
            b_to_a = [int(survivors[g]) if g < len(survivors) else -1
                      for g in range(n_b)]
        return diff_assignments(
            cfg, self.conf, self.mapping, other.conf, other.mapping,
            partition_a=self.partition, partition_b=other.partition,
            b_to_a=b_to_a, n_nodes=n_nodes, inter_bw=inter_bw,
            restart_s=DEFAULT_RESTART_S if restart_s is None else restart_s)

    def fingerprint(self) -> str:
        """SHA-256 of the canonical JSON artifact — a content identity
        (replan lineage records it as ``replan_of``; note the plan
        *server*'s cache keys on the request fingerprint instead)."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()


# ---------------------------------------------------------------------------
# the one entry point
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Planner:
    """``Planner(strategy).plan(request, bw)`` — the single configurator
    entry point, shared by Pipette, its ablations, and every baseline.

    Example:
        >>> req = PlanRequest(w, spec, SearchSpace(max_cp=2), Budget())
        >>> plan = Planner(PipetteStrategy(estimator=est)).plan(req, bw)
        >>> plan.save("plan.json")          # consumed by launch/runtime

    ``device`` is where the strategy's tensors live: ``None`` is the CUDA
    device (an error without one), ``"cpu"`` must be named.  It overrides
    the ``device`` of a strategy that has one and is ignored by the
    host-only baselines.
    """
    strategy: Strategy
    device: DeviceLike = None

    def plan(self, req: PlanRequest, bw: np.ndarray, *,
             keep_top: int = 10, lineage: Optional[dict] = None) -> Plan:
        """Run the strategy and freeze its result into a :class:`Plan`.

        Args:
            req: declarative request.
            bw: ``(G, G)`` profiled bandwidth matrix.
            keep_top: how many ranked fallback candidates the Plan keeps
                (the full ranking stays on ``plan.result``).
            lineage: serving-layer provenance recorded on the plan (e.g.
                which cached neighbor seeded a warm start); ``None`` for
                a direct cold search.
        """
        strategy = self.strategy
        if self.device is not None and hasattr(strategy, "device"):
            strategy = dataclasses.replace(strategy, device=self.device)
        res = strategy.search(req, bw)
        # provenance must fingerprint the matrix the strategy actually
        # scored against (MegatronStrategy may substitute its bw_true)
        scoring_bw = getattr(self.strategy, "scoring_bw", None)
        return Plan.from_search(
            res, req, scoring_bw(bw) if scoring_bw is not None else bw,
            strategy=self.strategy.name,
            estimator=getattr(self.strategy, "estimator", None),
            keep_top=keep_top, lineage=lineage)

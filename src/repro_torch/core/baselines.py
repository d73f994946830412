"""Baseline configurators: AMP [8], Varuna [12], and the Megatron-LM
manual heuristic [14] — as characterised in the paper's evaluation.

All three deliberately search the 3D (pp, tp, dp) space only: none of the
prior art models context parallelism, which is exactly the comparison point
for Pipette's 4D search (``configure(max_cp > 1)``) on long-context
workloads.  They do share the schedule-validity gate (``n_mb >= pp``) —
a config 1F1B cannot fill would be rejected on any real cluster.

Behind the Planner API these functions are re-homed as strategies
(:class:`~repro_torch.core.plan.AMPStrategy`, ``VarunaStrategy``,
``MegatronStrategy``) so all four configurators run behind the single
``Planner(strategy).plan(request, bw)`` interface."""
from __future__ import annotations

import time
from typing import List

import numpy as np

from .cluster import ClusterSpec
from .latency import amp_latency, varuna_latency
from .memory import enumerate_confs, ground_truth_memory
from .search import Candidate, Overhead, SearchResult
from .simulator import Workload, build_profile, default_mapping, measure


def amp_configure(w: Workload, spec: ClusterSpec, *, max_micro: int = 16) -> SearchResult:
    """AMP: Eq. 1 latency model, nominal bandwidths, memory-unaware,
    identity GPU assignment.

    Args:
        w: workload (model config, sequence length, global batch).
        spec: cluster description (nominal bandwidths only are used).
        max_micro: skip configurations with ``bs_micro`` above this.

    Returns:
        :class:`~repro_torch.core.search.SearchResult` ranked by Eq. 1 latency
        (``mem_pred`` is ``nan`` — AMP does not model memory).
    """
    t0 = time.perf_counter()
    cands = []
    n_enum = 0
    for conf in enumerate_confs(spec.n_gpus, w.bs_global, n_layers=w.cfg.n_layers):
        n_enum += 1
        if conf.bs_micro > max_micro:
            continue
        prof = build_profile(w, spec, conf)
        lat = amp_latency(conf, default_mapping(conf), spec, prof)
        cands.append(Candidate(conf, default_mapping(conf), lat, float("nan")))
    cands.sort(key=lambda c: c.latency)
    return SearchResult(best=cands[0] if cands else None, ranked=cands,
                        overhead=Overhead(total_s=time.perf_counter() - t0,
                                          n_enumerated=n_enum,
                                          n_candidates=len(cands)))


def varuna_configure(w: Workload, spec: ClusterSpec, *, max_micro: int = 16) -> SearchResult:
    """Varuna: pipeline+data parallelism only (tp = 1), memory-unaware.

    Args:
        w: workload (model config, sequence length, global batch).
        spec: cluster description (nominal bandwidths only are used).
        max_micro: skip configurations with ``bs_micro`` above this.

    Returns:
        :class:`~repro_torch.core.search.SearchResult` ranked by the Varuna-style
        estimate (``mem_pred`` is ``nan``).
    """
    t0 = time.perf_counter()
    cands = []
    n_enum = 0
    for conf in enumerate_confs(spec.n_gpus, w.bs_global, n_layers=w.cfg.n_layers):
        n_enum += 1
        if conf.tp != 1 or conf.bs_micro > max_micro:
            continue
        prof = build_profile(w, spec, conf)
        lat = varuna_latency(conf, spec, prof)
        cands.append(Candidate(conf, default_mapping(conf), lat, float("nan")))
    cands.sort(key=lambda c: c.latency)
    return SearchResult(best=cands[0] if cands else None, ranked=cands,
                        overhead=Overhead(total_s=time.perf_counter() - t0,
                                          n_enumerated=n_enum,
                                          n_candidates=len(cands)))


def mlm_configure(w: Workload, spec: ClusterSpec, bw_true: np.ndarray, *,
                  max_micro: int = 16, trials: int = 6,
                  seed: int = 0) -> SearchResult:
    """Megatron-LM manual tuning: tp = gpus-per-node, then try promising
    (pp, mb) combinations one by one on the cluster (here: the simulator)
    until the fastest runnable one is found — i.e. actual manual labour,
    memory-checked by construction.

    Args:
        w: workload (model config, sequence length, global batch).
        spec: cluster description.
        bw_true: ground-truth bandwidth matrix the trial runs execute on.
        max_micro: skip configurations with ``bs_micro`` above this.
        trials: how many promising configs the "expert" actually runs.
        seed: simulator seed for the trial runs.

    Returns:
        :class:`~repro_torch.core.search.SearchResult` over the tried configs,
        ranked by *measured* (simulated) iteration time.
    """
    t0 = time.perf_counter()
    tp = spec.gpus_per_node
    cands: List[Candidate] = []
    n_enum = 0
    for conf in enumerate_confs(spec.n_gpus, w.bs_global, max_tp=tp,
                                n_layers=w.cfg.n_layers):
        n_enum += 1
        if conf.tp != tp or conf.bs_micro > max_micro:
            continue
        # the trial run is physical: on a tiered fleet it OOMs as soon as
        # the *smallest* GPU overflows (mem_floor == gpu_mem when
        # homogeneous); the heuristic itself stays compute-blind
        if ground_truth_memory(w, conf, spec) > spec.mem_floor:
            continue                      # a human discards the OOM run
        cands.append(Candidate(conf, default_mapping(conf), float("inf"),
                               float("nan")))
    # the expert tries the most promising handful, smallest pp first
    cands.sort(key=lambda c: (c.conf.pp, -c.conf.bs_micro))
    tried = cands[:trials]
    for c in tried:
        c.latency = measure(c.conf, c.mapping, w, spec, bw_true, seed=seed)
    tried.sort(key=lambda c: c.latency)
    return SearchResult(best=tried[0] if tried else None, ranked=tried,
                        overhead=Overhead(total_s=time.perf_counter() - t0,
                                          n_enumerated=n_enum,
                                          n_candidates=len(tried)))

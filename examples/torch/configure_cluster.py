"""The paper's headline experiment on the PyTorch package: configure
GPT-3.1B training on the simulated 128-GPU mid-range cluster and compare
Pipette (PPT-L / PPT-LF) against Megatron-LM, Varuna and AMP (Fig. 6),
all five configurators behind the one Planner API.

``--cluster mid-range-degraded`` runs the same pipeline on a partially
degraded fleet (a quarter of the hosts throttled to half speed, seeded),
and closes with compute-aware against compute-blind worker dedication of
a deep pipeline in the simulator.

    PYTHONPATH=src python examples/torch/configure_cluster.py [--cluster high-end]
    PYTHONPATH=src python examples/torch/configure_cluster.py --device cpu

Port of ``examples/configure_cluster.py``.  The memory estimator is fitted
and the SA dedication runs on the CUDA device (``--device cpu`` to run on
the host; without a device and without it the example fails).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.gpt_paper import GPT_3_1B, GPT_11_1B
from repro_torch.core import (HIGH_END, MID_RANGE, MID_RANGE_DEGRADED,
                              AMPStrategy, Budget, ClusterSpec, Conf,
                              ExhaustiveStrategy, MegatronStrategy,
                              MemoryEstimator, Planner, PlanRequest,
                              PipetteStrategy, SearchSpace, VarunaStrategy,
                              Workload, anneal_multistart, build_profile,
                              compute_slowdowns, default_mapping,
                              fit_memory_estimator, ground_truth_memory,
                              measure, profile_bandwidth,
                              true_bandwidth_matrix)

CLUSTERS = {"mid-range": MID_RANGE, "high-end": HIGH_END,
            "mid-range-degraded": MID_RANGE_DEGRADED}
#: The estimator's training steps and the request's SA iterations.
FIT_STEPS = 12_000
SA_ITERS = 20_000


def first_runnable(ranked, w: Workload, spec: ClusterSpec):
    """The first of ``ranked`` that fits the cluster's memory in the
    simulator, and how many were tried to find it."""
    for i, c in enumerate(ranked):
        if ground_truth_memory(w, c.conf, spec) <= spec.mem_floor:
            return c, i + 1
    return None, len(ranked)


def strategies(est: MemoryEstimator, spec: ClusterSpec,
               bw_true: np.ndarray) -> list:
    """``(label, strategy)`` of the five configurators."""
    return [
        # the Megatron heuristic's trial runs execute on the real cluster
        # (the ground-truth matrix), not the profiled snapshot
        ("Megatron-LM (tp=8 heuristic)", MegatronStrategy(bw_true=bw_true)),
        ("Varuna (pp-only)", VarunaStrategy()),
        ("AMP", AMPStrategy()),
        ("Pipette PPT-L", ExhaustiveStrategy(estimator=est,
                                             mem_limit=spec.mem_floor)),
        ("Pipette PPT-LF", PipetteStrategy(estimator=est,
                                           mem_limit=spec.mem_floor)),
    ]


def compare(req: PlanRequest, est: MemoryEstimator, bw_meas: np.ndarray,
            bw_true: np.ndarray, device: DeviceLike = None) -> Dict[str, Any]:
    """Every strategy of :func:`strategies` on ``req``: its plan, the
    first of its ranking that fits (memory-unaware baselines walk the
    ranking, counting the trial runs), and that candidate's iteration
    time in the simulator on the true bandwidths.

    Returns ``rows`` (``(label, conf, seconds)``), ``plans`` (label ->
    Plan), ``ppt_plan`` and ``ppt_best`` (PPT-LF's plan and the candidate
    its row measured) and ``sa_time`` (PPT-LF's planning seconds)."""
    w, spec = req.workload, req.spec
    rows, plans, ppt_plan, ppt_best, sa_time = [], {}, None, None, 0.0
    for label, strategy in strategies(est, spec, bw_true):
        t0 = time.perf_counter()
        plan = Planner(strategy, device=device).plan(req, bw_meas)
        elapsed = time.perf_counter() - t0
        plans[label] = plan
        best, trials = first_runnable(plan.result.ranked, w, spec)
        if trials > 1:
            label = f"{label} (runnable after {trials} trials)"
        rows.append((label, best.conf, measure(best.conf, best.mapping, w,
                                               spec, bw_true)))
        if strategy.name == "pipette":
            ppt_plan, ppt_best, sa_time = plan, best, elapsed
    return {"rows": rows, "plans": plans, "ppt_plan": ppt_plan,
            "ppt_best": ppt_best, "sa_time": sa_time}


def degraded_host_demo(base_w: Workload, spec: ClusterSpec,
                       bw_meas: np.ndarray, bw_true: np.ndarray, *,
                       seed: int = 0, time_limit_s: float = 10.0,
                       max_iters: int = 10_000, log=print) -> tuple:
    """Where per-GPU compute awareness pays on a degraded fleet.

    A deep pipeline over a layer count ``pp`` does not divide leaves
    light stages beside heavy ones, the one place a throttled host can
    serve without pacing the whole pipeline.  A pp=16 configuration of a
    24-layer variant is dedicated node-major (tier-blind) and
    compute-aware (slow hosts on the light stages, then SA, host NumPy),
    and both are played back in the simulator at true per-rank speed.
    Returns ``(blind_seconds, aware_seconds)``."""
    cfg24 = dataclasses.replace(base_w.cfg, name=base_w.cfg.name + "-24L",
                                n_layers=24)
    w = Workload(cfg24, base_w.seq, 32)
    conf = Conf(16, 8, 1, 2, 32)          # 8 heavy + 8 light (1-layer) stages
    prof = build_profile(w, spec, conf)
    slow = compute_slowdowns(spec)
    # the fastest GPUs serve the heavy leading stages, throttled hosts sink
    # to the light trailing ones; SA polishes the communication
    greedy = np.argsort(slow, kind="stable")
    aware = anneal_multistart(conf, bw_meas, prof, spec, n_chains=2,
                              time_limit_s=time_limit_s,
                              max_iters=max_iters, seed=seed,
                              init_perm=greedy)
    sim_aware = measure(conf, aware.mapping, w, spec, bw_true, seed=1)
    sim_blind = measure(conf, default_mapping(conf), w, spec, bw_true,
                        seed=1)
    deg = [i for i, t in enumerate(spec.node_tiers) if t == 1]
    log(f"\n[degraded] throttled nodes (half speed): {deg}")
    log(f"[degraded] dedication of {conf} ({cfg24.n_layers} layers -> "
        f"8 heavy + 8 light stages), simulated:")
    log(f"  tier-blind node-major {sim_blind * 1e3:9.1f} ms/iter")
    log(f"  compute-aware + SA    {sim_aware * 1e3:9.1f} ms/iter "
        f"({(1 - sim_aware / sim_blind) * 100:+.1f}%)")
    return sim_blind, sim_aware


def table(rows: List[tuple]) -> List[str]:
    """The Fig. 6 table's lines: method, config, iteration ms and the
    speed-up over AMP."""
    base = next(t for name, _, t in rows if name.startswith("AMP"))
    out = [f"{'method':38s} {'config':28s} {'iter ms':>9s} {'vs AMP':>7s}"]
    for name, conf, t in rows:
        out.append(f"{name:38s} {str(conf):28s} {t*1e3:9.1f} {base/t:7.2f}x")
    return out


def run(cluster: str = "mid-range", *, budget: Optional[Budget] = None,
        save_plan: Optional[str] = None,
        device: DeviceLike = None, log=print) -> Dict[str, Any]:
    """The whole example on ``cluster``: profile, fit the estimator on
    ``device``, :func:`compare` the five strategies under ``budget`` (by
    default ``sa_seconds=1.0``, ``SA_ITERS``), print the table and
    PPT-LF's dedication, save PPT-LF's plan to ``save_plan``, and on a
    tiered fleet run :func:`degraded_host_demo`.  Returns
    :func:`compare`'s dict, with ``request``, ``estimator``, ``bw_meas``,
    ``bw_true`` and ``fit_s``."""
    device = resolve_device(device)
    budget = budget or Budget(sa_seconds=1.0, sa_iters=SA_ITERS)
    spec = CLUSTERS[cluster]
    model = GPT_11_1B if cluster == "high-end" else GPT_3_1B
    w = Workload(model, 2048, 256)
    log(f"cluster: {spec.name} ({spec.n_gpus} GPUs), model {model.name}")

    bw_true = true_bandwidth_matrix(spec)
    bw_meas, cost = profile_bandwidth(spec)
    log(f"[profile] bandwidth matrix measured "
        f"(~{cost:.0f}s on the real cluster)")

    t0 = time.perf_counter()
    est = fit_memory_estimator(
        [Workload(model, 2048, bsg) for bsg in (64, 128, 256, 512)], spec,
        fit_nodes=4, steps=FIT_STEPS, residual=True, device=device)
    fit_s = time.perf_counter() - t0
    log(f"[memest] MLP fitted on <=4-node profiles in {fit_s:.0f}s")

    # one declarative request, five strategies behind one interface
    req = PlanRequest(workload=w, spec=spec, space=SearchSpace(),
                      budget=budget, seed=1)
    res = compare(req, est, bw_meas, bw_true, device)
    log("")
    for line in table(res["rows"]):
        log(line)
    ppt_plan, ppt_best = res["ppt_plan"], res["ppt_best"]
    log(f"\n[pipette] total search time {res['sa_time']:.0f}s "
        f"(SA dedication per candidate config)")
    # ppt_best is the candidate the table row measured (plan.conf unless
    # the estimator under-predicted and first_runnable stepped down the
    # ranking): print the dedication of what was reported
    log(f"[pipette] worker dedication for {ppt_best.conf} "
        "(GPU ids, stages x (tp*dp)):")
    log(str(ppt_best.mapping.reshape(ppt_best.conf.pp, -1)))
    if save_plan:
        if ppt_best.conf != ppt_plan.conf:
            # index into the full ranking first_runnable searched, not the
            # top-k the artifact keeps
            rank = [c.conf for c in ppt_plan.result.ranked] \
                .index(ppt_best.conf)
            log(f"[pipette] note: artifact best {ppt_plan.conf} was not "
                f"runnable; the measured row used fallback ranked[{rank}]")
        log(f"[pipette] plan artifact -> {ppt_plan.save(save_plan)}")

    if spec.has_tiers:
        degraded_host_demo(w, spec, bw_meas, bw_true, log=log)
    res.update(request=req, estimator=est, bw_meas=bw_meas, bw_true=bw_true,
               fit_s=fit_s)
    return res


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cluster", choices=sorted(CLUSTERS),
                    default="mid-range")
    ap.add_argument("--sa-seconds", type=float, default=1.0)
    ap.add_argument("--save-plan", default=None, metavar="PATH",
                    help="write the PPT-LF Plan JSON artifact here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' to "
                         "run on the host)")
    args = ap.parse_args(argv)
    run(args.cluster,
        budget=Budget(sa_seconds=args.sa_seconds, sa_iters=SA_ITERS),
        save_plan=args.save_plan, device=resolve_device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

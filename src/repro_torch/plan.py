"""Plan CLI: build and inspect serializable configurator Plan artifacts.

    # search a named model config on a simulated cluster, write the Plan
    python -m repro_torch.plan plan --config qwen2-7b --reduced \
        --cluster mid-range --nodes 2 --seq 128 --bs-global 64 \
        -o plan.json

    # pretty-print a saved Plan (no search, no device needed)
    python -m repro_torch.plan show plan.json

    # price the migration from one plan to another: ranks moved,
    # parameter/optimizer bytes re-fetched, estimated downtime
    python -m repro_torch.plan diff a.json b.json

    # statically verify an artifact against a cluster — no re-search, no
    # device (schema, conf arithmetic, 1F1B schedulability, mapping
    # permutation, memory floor, bandwidth/tier digests)
    python -m repro_torch.plan lint plan.json --cluster mid-range --nodes 2

The search runs on the CUDA device (``--device cuda``, the default, fails
without one; ``--device cpu`` must be asked for).  The emitted JSON is the
same artifact ``Planner.plan`` produces in process: byte-reproducible for
a fixed request + seed (use ``--sa-iters`` with the default large
``--sa-seconds`` cap for iteration-bound, deterministic SA), in the schema
the JAX package reads and writes.
"""
from __future__ import annotations

import argparse
import math
import sys

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.core import (HIGH_END, MID_RANGE, MID_RANGE_DEGRADED,
                              MIXED_A100_V100, STRATEGIES, TPU_POD, Budget,
                              ExhaustiveStrategy, MegatronStrategy, Plan,
                              Planner, PlanRequest, PipetteStrategy,
                              SearchSpace, Workload, fit_memory_estimator,
                              profile_bandwidth, true_bandwidth_matrix)

CLUSTERS = {"mid-range": MID_RANGE, "high-end": HIGH_END,
            "tpu-pod": TPU_POD,
            "mixed-a100-v100": MIXED_A100_V100,
            "mid-range-degraded": MID_RANGE_DEGRADED}


def _fmt_bytes(x: float) -> str:
    return "-" if (x is None or math.isnan(x)) else f"{x / 1e9:.2f} GB"


def _fmt_ms(x: float) -> str:
    return "-" if (x is None or math.isinf(x)) else f"{x * 1e3:.2f} ms"


def cmd_plan(args: argparse.Namespace) -> int:
    device = resolve_device(args.device)     # fails early without a card
    cfg = configs.get(args.config)
    if args.reduced:
        cfg = cfg.reduced()
    spec = CLUSTERS[args.cluster]
    if args.nodes:
        spec = spec.with_nodes(args.nodes)
    w = Workload(cfg, args.seq, args.bs_global)
    bw, cost_s = profile_bandwidth(spec)
    print(f"[profile] {spec.name}: {spec.n_gpus} GPUs "
          f"(~{cost_s:.0f}s on a real cluster)", file=sys.stderr)

    estimator = None
    if args.fit_estimator and args.strategy not in ("pipette", "exhaustive"):
        # the baselines are memory-unaware by design: fitting would burn
        # minutes and then be silently discarded by the dispatch below
        print(f"error: --fit-estimator has no effect with "
              f"--strategy {args.strategy} (memory-unaware baseline); "
              f"drop the flag or use pipette/exhaustive", file=sys.stderr)
        return 2
    if args.fit_estimator:
        estimator = fit_memory_estimator(
            [w], spec, fit_nodes=min(2, spec.n_nodes),
            steps=args.fit_estimator, residual=True, max_cp=args.max_cp,
            device=device)
        print(f"[memest] MLP fit on <=2-node profiles "
              f"({args.fit_estimator} steps)", file=sys.stderr)

    # one registry (repro_torch.core.plan.STRATEGIES) drives both the CLI
    # choices and the dispatch — only construction args differ per kind
    cls = STRATEGIES[args.strategy]
    if cls in (PipetteStrategy, ExhaustiveStrategy):
        # mem_floor == gpu_mem on homogeneous clusters; on tiered ones it
        # budgets for the tightest device tier
        strategy = cls(estimator=estimator, mem_limit=spec.mem_floor)
    elif cls is MegatronStrategy:
        # megatron-lm: trial runs happen on the ground-truth links
        strategy = cls(bw_true=true_bandwidth_matrix(spec))
    else:
        strategy = cls()

    req = PlanRequest(
        workload=w, spec=spec,
        space=SearchSpace(max_cp=args.max_cp, max_tp=args.max_tp,
                          max_micro=args.max_micro,
                          partition=args.partition, max_vpp=args.max_vpp),
        budget=Budget(sa_seconds=args.sa_seconds, sa_iters=args.sa_iters,
                      sa_topk=args.sa_topk),
        seed=args.seed)
    plan = Planner(strategy, device=device).plan(req, bw,
                                                 keep_top=args.topk)
    if not plan.feasible:
        print(f"[plan] INFEASIBLE: {strategy.name} found no runnable "
              f"configuration for {spec.n_gpus} GPUs", file=sys.stderr)
        plan.save(args.output)      # still record the (empty) outcome
        return 1
    print(f"[plan] {strategy.name}: best {plan.conf} "
          f"est {_fmt_ms(plan.latency)}/iter "
          f"mem {_fmt_bytes(plan.mem_pred)}", file=sys.stderr)
    print(plan.save(args.output))
    return 0


def cmd_show(args: argparse.Namespace) -> int:
    plan = Plan.load(args.path)
    p = plan.provenance
    print(f"plan: strategy={p.strategy} seed={p.seed}")
    print(f"workload: {p.model} seq={p.seq} bs_global={p.bs_global}")
    print(f"cluster: {p.cluster} ({p.n_gpus} GPUs) "
          f"bw sha256:{p.bw_digest[:16]}…")
    print(f"space: max_cp={p.space.max_cp} max_tp={p.space.max_tp} "
          f"max_micro={p.space.max_micro} fixed_micro={p.space.fixed_micro} "
          f"partition={p.space.partition} max_vpp={p.space.max_vpp}")
    print(f"budget: sa_seconds={p.budget.sa_seconds} "
          f"sa_iters={p.budget.sa_iters} n_chains={p.budget.n_chains} "
          f"sa_topk={p.budget.sa_topk}")
    if p.tiers is not None:
        names = [t["name"] or f"tier{i}"
                 for i, t in enumerate(p.tiers["tiers"])]
        counts = [p.tiers["node_tiers"].count(i) for i in range(len(names))]
        mix = " + ".join(f"{c}x {n}" for n, c in zip(names, counts))
        print(f"tiers: {mix} (digest sha256:{p.tiers['digest'][:16]}…)")
    if p.estimator is None:
        print("estimator: none (memory-unaware)")
    else:
        e = p.estimator
        print(f"estimator: with_cp={e['with_cp']} residual={e['residual']} "
              f"fit_gpu_mem={e['fit_gpu_mem'] / 1e9:.0f}GB "
              f"fit_gpus_per_node={e['fit_gpus_per_node']}")
    o = plan.overhead
    print(f"search: {o.n_enumerated} enumerated -> "
          f"{o.n_candidates} candidates")
    if not plan.feasible:
        print("result: INFEASIBLE — no runnable configuration")
        return 1
    print(f"\nbest: {plan.conf}  est {_fmt_ms(plan.latency)}/iter  "
          f"mem {_fmt_bytes(plan.mem_pred)}")
    if plan.partition is not None or plan.schedule != "1f1b":
        sizes = ("uniform" if plan.partition is None else
                 ",".join(str(s) for s in plan.partition.sizes))
        print(f"schedule: {plan.schedule}  chunk layers: {sizes}")
    print("mapping (stages x workers/stage):")
    print(plan.mapping.reshape(plan.conf.pp, -1))
    print(f"\n{'#':>3s} {'config':30s} {'est/iter':>10s} {'mem':>10s}")
    for i, c in enumerate(plan.ranked):
        print(f"{i + 1:3d} {str(c.conf):30s} {_fmt_ms(c.latency):>10s} "
              f"{_fmt_bytes(c.mem_pred):>10s}")
    return 0


def cmd_diff(args: argparse.Namespace) -> int:
    import json

    plan_a = Plan.load(args.a)
    plan_b = Plan.load(args.b)
    cfg = None
    if args.config:
        cfg = configs.get(args.config)
        if args.reduced:
            cfg = cfg.reduced()
    try:
        d = plan_a.diff(plan_b, cfg=cfg,
                        inter_bw=args.inter_bw * 1e9,
                        restart_s=args.restart_s)
    except (KeyError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.format == "json":
        doc = {"ranks_total": d.ranks_total,
               "ranks_moved": d.ranks_moved,
               "ranks_added": d.ranks_added,
               "ranks_removed": d.ranks_removed,
               "bytes_migrated": d.bytes_migrated,
               "downtime_s": d.downtime_s,
               "conf_changed": d.conf_changed}
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        print(f"migration {args.a} -> {args.b}:")
        print(f"  conf: {plan_a.conf} -> {plan_b.conf}"
              f"{'' if d.conf_changed else ' (unchanged)'}")
        print(f"  ranks: {d.ranks_total} total, {d.ranks_moved} moved, "
              f"{d.ranks_added} added, {d.ranks_removed} removed")
        print(f"  bytes migrated: {_fmt_bytes(d.bytes_migrated)}")
        print(f"  est downtime: {d.downtime_s:.2f} s"
              f"{' (no-op: resumes without a stall)' if d.is_noop else ''}")
    return 0


def cmd_lint(args: argparse.Namespace) -> int:
    # deliberately avoids Plan.load: the verifier diagnoses artifacts the
    # loader would refuse (unknown schema, malformed blocks)
    import json

    import numpy as np

    from repro_torch.analysis import verify_plan_file

    spec = None
    if args.cluster:
        spec = CLUSTERS[args.cluster]
        if args.nodes:
            spec = spec.with_nodes(args.nodes)
    bw = np.load(args.bw) if args.bw else None
    issues = verify_plan_file(args.path, spec=spec, bw=bw)
    errors = [i for i in issues if i.severity == "error"]
    if args.format == "json":
        print(json.dumps([{"rule": i.rule, "severity": i.severity,
                           "where": i.where, "message": i.message}
                          for i in issues], indent=2, sort_keys=True))
    else:
        for i in issues:
            print(i)
        against = spec.name if spec is not None else "recorded provenance"
        verdict = ("FAIL — plan cannot execute as recorded"
                   if errors else "OK — static checks pass")
        print(f"[lint] {args.path} vs {against}: {len(errors)} error(s), "
              f"{sum(1 for i in issues if i.severity == 'warning')} "
              f"warning(s) -> {verdict}", file=sys.stderr)
    return 1 if errors else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.plan",
        description="Build / inspect serializable configurator plans.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("plan", help="run a strategy, write a Plan JSON")
    p.add_argument("--config", required=True,
                   help="model config name (repro_torch.configs registry)")
    p.add_argument("--reduced", action="store_true",
                   help="use the tiny same-family smoke config")
    p.add_argument("--cluster", choices=sorted(CLUSTERS),
                   default="mid-range")
    p.add_argument("--nodes", type=int, default=0,
                   help="override the cluster's node count")
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--bs-global", type=int, default=256)
    p.add_argument("--strategy", default="pipette",
                   choices=sorted(STRATEGIES))
    p.add_argument("--max-cp", type=int, default=1)
    p.add_argument("--max-tp", type=int, default=0)
    p.add_argument("--max-micro", type=int, default=16)
    p.add_argument("--partition", choices=("uniform", "dp"),
                   default="uniform",
                   help="layer-to-stage split: historical uniform, or the "
                        "balanced min-max DP over per-layer costs")
    p.add_argument("--max-vpp", type=int, default=1,
                   help="open interleaved-1F1B up to this many virtual "
                        "pipeline chunks per stage (1 = plain 1F1B only)")
    p.add_argument("--sa-seconds", type=float, default=60.0,
                   help="SA wall-clock cap per candidate (default large "
                        "so --sa-iters bounds it deterministically)")
    p.add_argument("--sa-iters", type=int, default=2000)
    p.add_argument("--sa-topk", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="device for the estimator and the SA "
                        "engine (default cuda: an error without a card; "
                        "pass cpu to run on the host)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--topk", type=int, default=10,
                   help="ranked fallback candidates kept in the artifact")
    p.add_argument("--fit-estimator", type=int, default=0, metavar="STEPS",
                   help="fit the MLP memory estimator first (0 = skip; "
                        "memory-unaware search)")
    p.add_argument("-o", "--output", default="plan.json")
    p.set_defaults(fn=cmd_plan)

    s = sub.add_parser("show", help="pretty-print a saved Plan JSON")
    s.add_argument("path")
    s.set_defaults(fn=cmd_show)

    d = sub.add_parser(
        "diff", help="migration cost of switching plan A -> plan B "
                     "(ranks moved, bytes migrated, est downtime)")
    d.add_argument("a", help="incumbent Plan JSON")
    d.add_argument("b", help="successor Plan JSON")
    d.add_argument("--config", default=None,
                   help="model config name (default: resolve the plans' "
                        "recorded provenance.model from the registry)")
    d.add_argument("--reduced", action="store_true",
                   help="use the --config's reduced() smoke variant")
    d.add_argument("--inter-bw", type=float, default=12.5,
                   help="per-node inter-node bandwidth, GB/s "
                        "(default 12.5)")
    d.add_argument("--restart-s", type=float, default=None,
                   help="restart barrier seconds (default: model default)")
    d.add_argument("--format", choices=("text", "json"), default="text")
    d.set_defaults(fn=cmd_diff)

    v = sub.add_parser(
        "lint", help="statically verify a Plan JSON against a cluster "
                     "(no re-search, no device; exit 1 on executability "
                     "errors)")
    v.add_argument("path")
    v.add_argument("--cluster", choices=sorted(CLUSTERS), default=None,
                   help="check against this simulated cluster preset "
                        "(default: self-check against recorded provenance)")
    v.add_argument("--nodes", type=int, default=0,
                   help="override the preset's node count")
    v.add_argument("--bw", default=None, metavar="FILE.npy",
                   help="profiled bandwidth matrix to verify the "
                        "recorded digest against")
    v.add_argument("--format", choices=("text", "json"), default="text")
    v.set_defaults(fn=cmd_lint)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # stdout went away (e.g. `... | head`); exit quietly like a
        # well-behaved unix tool instead of tracebacking
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 0


if __name__ == "__main__":
    raise SystemExit(main())

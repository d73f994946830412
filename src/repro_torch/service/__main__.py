"""Plan-service CLI: run the daemon, submit requests, manage the cache.

    # start the server (ephemeral port, announced via the port file);
    # searches run on the CUDA device, --device cpu runs them on the host
    python -m repro_torch.service serve --cache-dir .plan-cache \
        --port-file plan-server.port

    # submit a request; the canonical plan JSON lands in plan.json and
    # the meta line (cache=miss|hit|coalesced fingerprint=...) on stdout
    python -m repro_torch.service submit --port-file plan-server.port \
        --config qwen2-7b --reduced --cluster mid-range --nodes 2 \
        --seq 128 --bs-global 64 --sa-iters 60 -o plan.json

    # inspect / manage the fleet cache
    python -m repro_torch.service cache stats --port-file plan-server.port
    python -m repro_torch.service cache ls --port-file plan-server.port
    python -m repro_torch.service cache evict <fingerprint> --port-file ...

    # stop the daemon
    python -m repro_torch.service shutdown --port-file plan-server.port
"""
from __future__ import annotations

import argparse
import sys

from repro_torch import configs
from repro_torch.core import (STRATEGIES, Budget, PlanRequest, SearchSpace,
                              Workload)
from repro_torch.plan import CLUSTERS
from repro_torch.service.client import PlanClient, ServiceError
from repro_torch.service.server import PlanServer


def _client(args: argparse.Namespace) -> PlanClient:
    return PlanClient(host=args.host, port=args.port,
                      port_file=args.port_file, timeout=args.timeout)


def cmd_serve(args: argparse.Namespace) -> int:
    server = PlanServer(host=args.host, port=args.port or 0,
                        cache_dir=args.cache_dir,
                        max_entries=args.max_entries,
                        warm_start=not args.no_warm_start,
                        warm_max_distance=args.warm_max_distance,
                        batch_window=args.batch_window,
                        port_file=args.port_file, device=args.device)
    try:
        server.run()
    except KeyboardInterrupt:
        pass
    return 0


def cmd_submit(args: argparse.Namespace) -> int:
    cfg = configs.get(args.config)
    if args.reduced:
        cfg = cfg.reduced()
    spec = CLUSTERS[args.cluster]
    if args.nodes:
        spec = spec.with_nodes(args.nodes)
    req = PlanRequest(
        workload=Workload(cfg, args.seq, args.bs_global),
        spec=spec,
        space=SearchSpace(max_cp=args.max_cp, max_tp=args.max_tp,
                          max_micro=args.max_micro,
                          fixed_micro=args.fixed_micro,
                          partition=args.partition, max_vpp=args.max_vpp),
        budget=Budget(sa_seconds=args.sa_seconds, sa_iters=args.sa_iters,
                      n_chains=args.n_chains, sa_topk=args.sa_topk,
                      backend=args.backend),
        seed=args.seed)
    try:
        resp = _client(args).submit(req, strategy=args.strategy,
                                    day=args.day)
    except ServiceError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    meta = resp["meta"]
    warm = meta.get("warm_start_from")
    print(f"cache={meta['cache']} fingerprint={meta['fingerprint']}"
          + (f" warm_start_from={warm}" if warm else ""))
    if args.output:
        with open(args.output, "w") as f:
            f.write(resp["plan"])
        print(args.output)
    else:
        sys.stdout.write(resp["plan"])
    return 0


def cmd_cache(args: argparse.Namespace) -> int:
    client = _client(args)
    if args.cache_cmd == "stats":
        stats = client.stats()
        cache = stats.pop("cache")
        for k in sorted(stats):
            print(f"{k}: {stats[k]}")
        for k in sorted(cache):
            print(f"cache.{k}: {cache[k]}")
        return 0
    if args.cache_cmd == "ls":
        entries = client.cache_ls()
        for e in entries:
            print(f"{e.get('fingerprint', '?')} "
                  f"strategy={e.get('strategy')} model={e.get('model')} "
                  f"seq={e.get('seq')} bs_global={e.get('bs_global')} "
                  f"n_gpus={e.get('n_gpus')} day={e.get('day')}"
                  + (" warm" if e.get("warm_started") else ""))
        print(f"{len(entries)} entr{'y' if len(entries) == 1 else 'ies'}",
              file=sys.stderr)
        return 0
    if args.cache_cmd == "evict":
        gone = client.cache_evict(args.fingerprint)
        print("evicted" if gone else "not found")
        return 0 if gone else 1
    raise AssertionError(args.cache_cmd)


def cmd_ping(args: argparse.Namespace) -> int:
    _client(args).ping()
    print("ok")
    return 0


def cmd_shutdown(args: argparse.Namespace) -> int:
    _client(args).shutdown()
    print("shutdown requested")
    return 0


def _add_client_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--port-file", default=None,
                   help="file the server wrote its bound port to")
    p.add_argument("--timeout", type=float, default=300.0)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.service",
        description="plan server / client (planning-as-a-service)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("serve", help="run the plan server")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=0,
                   help="0 = ephemeral (see --port-file)")
    s.add_argument("--port-file", default=None,
                   help="write the bound port here once listening")
    s.add_argument("--cache-dir", default=None,
                   help="persistent plan-cache directory")
    s.add_argument("--max-entries", type=int, default=256)
    s.add_argument("--no-warm-start", action="store_true")
    s.add_argument("--warm-max-distance", type=float, default=2.0)
    s.add_argument("--batch-window", type=float, default=0.05,
                   help="seconds to group near-identical requests "
                        "(0 disables batching)")
    s.add_argument("--device", default="cuda",
                   help="device of every search (default cuda: an error "
                        "without a card; pass cpu to run on the host)")
    s.set_defaults(fn=cmd_serve)

    s = sub.add_parser("submit", help="request a plan from the server")
    _add_client_args(s)
    s.add_argument("--config", required=True,
                   help="model config name (repro_torch.configs)")
    s.add_argument("--reduced", action="store_true")
    s.add_argument("--cluster", default="mid-range",
                   choices=sorted(CLUSTERS))
    s.add_argument("--nodes", type=int, default=0)
    s.add_argument("--seq", type=int, default=2048)
    s.add_argument("--bs-global", type=int, default=64)
    s.add_argument("--strategy", default="pipette",
                   choices=sorted(STRATEGIES))
    s.add_argument("--day", type=int, default=0)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--max-cp", type=int, default=1)
    s.add_argument("--max-tp", type=int, default=0)
    s.add_argument("--max-micro", type=int, default=16)
    s.add_argument("--fixed-micro", type=int, default=None)
    s.add_argument("--partition", default="uniform")
    s.add_argument("--max-vpp", type=int, default=1)
    s.add_argument("--sa-seconds", type=float, default=60.0)
    s.add_argument("--sa-iters", type=int, default=200)
    s.add_argument("--n-chains", type=int, default=1)
    s.add_argument("--sa-topk", type=int, default=None)
    s.add_argument("--backend", default="torch",
                   choices=["numpy", "torch"],
                   help="SA engine the server runs the request on")
    s.add_argument("-o", "--output", default=None,
                   help="write the plan JSON here (default: stdout)")
    s.set_defaults(fn=cmd_submit)

    s = sub.add_parser("cache", help="inspect / manage the plan cache")
    cache_sub = s.add_subparsers(dest="cache_cmd", required=True)
    for name in ("stats", "ls"):
        c = cache_sub.add_parser(name)
        _add_client_args(c)
        c.set_defaults(fn=cmd_cache)
    c = cache_sub.add_parser("evict")
    c.add_argument("fingerprint")
    _add_client_args(c)
    c.set_defaults(fn=cmd_cache)

    s = sub.add_parser("ping", help="liveness check")
    _add_client_args(s)
    s.set_defaults(fn=cmd_ping)

    s = sub.add_parser("shutdown", help="stop the server")
    _add_client_args(s)
    s.set_defaults(fn=cmd_shutdown)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        return 0
    except (ConnectionError, OSError) as e:
        print(f"error: cannot reach plan server: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())

"""Quickstart on the PyTorch package: configure -> train -> generate.

    PYTHONPATH=src python examples/torch/quickstart.py
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu

Port of ``examples/quickstart.py``.  Everything runs on the CUDA device
unless ``--device cpu`` is given, and fails without one: the Pipette
search (simulated-annealing dedication on the torch backend), training
(the ``rmsnorm`` and ``flash_attention`` kernels and their backward
kernels), and prefill plus greedy decode.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import torch

from repro_torch import configs
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import (MID_RANGE, Budget, Planner, PlanRequest,
                              PipetteStrategy, Workload, profile_bandwidth)
from repro_torch.data.pipeline import DataLoader, LoaderConfig, SyntheticCorpus
from repro_torch.launch.generate import grow_cache
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import ShardCtx
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import AdamW

#: The reference's request: 4 nodes of the mid-range cluster, and its SA
#: budget (whichever of the two caps bites first on the NumPy backend;
#: the torch backend is iteration-bound).
NODES = 4
BUDGET = Budget(sa_seconds=0.2, sa_iters=2000)
#: Prompt rows and length, and the greedy tokens after the prefill's.
PROMPT_ROWS, PROMPT_LEN, DECODE_STEPS = 2, 32, 5


def plan_request(cfg: ModelConfig, budget: Budget) -> tuple:
    """``(request, profiled bandwidths, profiling seconds)`` of the plan:
    ``cfg`` at 128 tokens and a global batch of 64 on ``NODES`` nodes of
    the mid-range cluster."""
    spec = MID_RANGE.with_nodes(NODES)
    bw, cost_s = profile_bandwidth(spec)
    req = PlanRequest(workload=Workload(cfg, seq=128, bs_global=64),
                      spec=spec, budget=budget)
    return req, bw, cost_s


def run(cfg: ModelConfig, params: Dict[str, Any], budget: Budget,
        steps: int = 40, device: DeviceLike = None, *,
        log=None) -> Dict[str, Any]:
    """Plan ``cfg`` on ``NODES`` nodes of the mid-range cluster, train
    ``params`` for ``steps`` AdamW steps microbatched by the plan, then
    prefill two prompts and decode ``DECODE_STEPS`` greedy tokens.

    ``params`` are updated: the returned ``params`` are the trained ones
    (the step returns new tensors; the caller's are not changed).  ``log``
    gets each line the example prints (``None``: print nothing).

    Returns:
        ``plan`` (the :class:`~repro_torch.core.plan.Plan`), ``plan_json``
        (its JSON text), ``n_micro``, ``losses`` (every step's),
        ``prompts`` ``(2, 32)`` int64, ``tokens`` (the greedy tokens of
        the first row, the prefill's first) and ``params``.
    """
    device = resolve_device(device)
    say = log or (lambda line: None)
    # 1) Pipette: pick (pp, tp, dp, bs_micro) and the worker mapping for a
    #    simulated 4-node cluster through one PlanRequest
    req, bw, cost_s = plan_request(cfg, budget)
    spec = req.spec
    plan = Planner(PipetteStrategy(), device=device).plan(req, bw)
    say(f"[pipette] profiled {spec.n_gpus} GPUs (~{cost_s:.0f}s on a real "
        f"cluster); best: {plan.conf} "
        f"est {plan.latency*1e3:.1f} ms/iter "
        f"(strategy {plan.provenance.strategy})")

    # 2) train on the synthetic corpus, microbatched by Pipette's bs_micro
    ctx = ShardCtx()
    opt = AdamW(lr=2e-3, weight_decay=0.0)
    state = opt.init(params)
    n_micro = max(1, min(4, plan.result.best.conf.n_mb))
    step = make_train_step(cfg, ctx, opt, n_micro=n_micro)
    loader = DataLoader(SyntheticCorpus(cfg.vocab_size, seed=0, noise=0.02),
                        LoaderConfig(8, 64))
    losses = []
    for s in range(steps):
        params, state, m = step(params, state, loader.batch_at(s))
        losses.append(float(m["loss"]))
        if s % 10 == 0:
            say(f"[train] step {s:3d} loss {losses[-1]:.3f}")

    # 3) serve: prefill, then greedy decode steps on a cache with room for
    #    them, updated in place
    prompts = torch.from_numpy(
        loader.batch_at(100)["tokens"][:PROMPT_ROWS, :PROMPT_LEN]).to(
        device=device, dtype=torch.int64)
    with torch.no_grad():
        last, cache = make_prefill_step(cfg, ctx)(params,
                                                  {"tokens": prompts})
        cache = grow_cache(cache, DECODE_STEPS)
        decode = make_decode_step(cfg, ctx)
        tok = torch.argmax(last, dim=-1)[:, None]
        out = [int(tok[0, 0])]
        for i in range(DECODE_STEPS):
            tok, _, cache = decode(params, cache, tok, PROMPT_LEN + i)
            out.append(int(tok[0, 0]))
    say(f"[generate] greedy continuation: {out}")
    return {"plan": plan, "plan_json": plan.to_json(), "n_micro": n_micro,
            "losses": losses, "prompts": prompts, "tokens": out,
            "params": params}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' to "
                         "run on the host)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = configs.get("qwen2-7b").reduced()
    # random weights drawn from a torch.Generator seeded with 0, on device
    params = init_params(cfg, seed=0, device=device)
    run(cfg, params, BUDGET, 40, device, log=print)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

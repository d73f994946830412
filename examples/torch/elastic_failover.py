"""Fault tolerance on the PyTorch package: train, lose a node, let
Pipette re-plan for the degraded cluster, restore the checkpoint and keep
training.

    PYTHONPATH=src python examples/torch/elastic_failover.py
    PYTHONPATH=src python examples/torch/elastic_failover.py --device cpu

Port of ``examples/elastic_failover.py``.  Training and both replans run
on the CUDA device unless ``--device cpu`` is given (and fail without
one).
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional

from repro_torch import configs
from repro_torch._device import DeviceLike, resolve_device
from repro_torch._tree import tree_map
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import MID_RANGE, Workload
from repro_torch.data.pipeline import DataLoader, LoaderConfig, SyntheticCorpus
from repro_torch.launch.steps import make_train_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import ShardCtx
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.elastic import replan

#: The reference's replan budget (its ``sa_seconds``; the torch backend
#: is iteration-bound, at ``Budget``'s default ``sa_iters``).
REPLAN = dict(sa_seconds=0.2)
CKPT_DIR = "checkpoints/elastic"


def _copy(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def run(cfg: ModelConfig, params: Dict[str, Any], *,
        replan_kw: Optional[dict] = None, ckpt_dir: str = CKPT_DIR,
        steps: int = 20, more: int = 10, device: DeviceLike = None,
        log=None) -> Dict[str, Any]:
    """Plan for 4 healthy nodes of the mid-range cluster, train ``params``
    ``steps`` steps and checkpoint, replan for 3 nodes and save the plan
    beside the checkpoint, restore, and train ``more`` steps.

    ``replan_kw`` goes to both :func:`~repro_torch.runtime.elastic.replan`
    calls (default :data:`REPLAN`); ``log`` gets each printed line.

    Returns the two :class:`~repro_torch.runtime.elastic.ElasticPlan`
    (``plan4``, ``plan3``), the plan artifact's path, the step restored
    at, the ``saved`` and ``restored`` ``(params, opt_state)`` and the
    losses of both stretches of training."""
    device = resolve_device(device)
    say = log or (lambda line: None)
    kw = dict(REPLAN if replan_kw is None else replan_kw, device=device)
    ctx = ShardCtx()
    opt = AdamW(lr=1e-3, weight_decay=0.0)
    state = opt.init(params)
    loader = DataLoader(SyntheticCorpus(cfg.vocab_size, 0, noise=0.02),
                        LoaderConfig(8, 64))
    mgr = CheckpointManager(ckpt_dir, keep=2, async_save=False)

    w = Workload(cfg, 64, 64)
    plan = replan(w, MID_RANGE, healthy_nodes=4, **kw)
    say(f"[plan] 4 nodes healthy: {plan.result.best.conf} "
        f"est {plan.result.best.latency*1e3:.1f} ms/iter")

    step = make_train_step(cfg, ctx, opt,
                           n_micro=min(4, plan.result.best.conf.n_mb))
    losses = []
    for s in range(steps):
        params, state, m = step(params, state, loader.batch_at(s))
        losses.append(float(m["loss"]))
    mgr.save(steps, (params, state))
    saved = _copy((params, state))
    say(f"[train] {steps} steps done, loss {losses[-1]:.3f}; "
        f"checkpoint saved")

    # node failure: only 3 nodes healthy now
    say("[fault] node lost! re-planning for 3 nodes...")
    plan2 = replan(w, MID_RANGE, healthy_nodes=3, **kw)
    best = plan2.result.best
    say(f"[plan] degraded cluster: {best.conf} "
        f"est {best.latency*1e3:.1f} ms/iter "
        f"(mapping over {best.conf.n_gpus} GPUs)")
    # the replan is a serializable artifact: kept with the checkpoint, so
    # the restarted job knows what it runs
    path = plan2.plan.save(os.path.join(ckpt_dir, "plan.json"))
    say(f"[plan] artifact -> {path}")

    # restore (one device here: the blocks of each rank are the whole)
    (params, state), at = mgr.restore((params, state))
    restored = _copy((params, state))
    step2 = make_train_step(cfg, ctx, opt, n_micro=min(4, best.conf.n_mb))
    more_losses = []
    for s in range(at, at + more):
        params, state, m = step2(params, state, loader.batch_at(s))
        more_losses.append(float(m["loss"]))
    say(f"[train] resumed at step {at}, continued to {at + more}, "
        f"loss {more_losses[-1]:.3f} — elastic failover complete")
    return {"plan4": plan, "plan3": plan2, "artifact": path, "at": at,
            "saved": saved, "restored": restored, "losses": losses,
            "more_losses": more_losses}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' to "
                         "run on the host)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = configs.get("qwen2-7b").reduced()
    params = init_params(cfg, seed=0, device=device)
    run(cfg, params, device=device, log=print)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

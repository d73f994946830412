"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \
        --layers 4 --steps 4 --global-batch 4 --seq-len 512

Port of the JAX package's ``launch/train.py``, on one device: the CUDA
device unless ``--device cpu`` is given (and it fails without one).
``--configure`` runs the port's Pipette planner first (simulated-annealing
dedication with ``backend="torch"`` on the same device) against the
simulated cluster, reports the chosen (pp, tp, dp, bs_micro) and worker
dedication, and hands the plan to the loop, which keeps it beside the
checkpoints as ``plan.json``; microbatch accumulation (``--n-micro``)
stands in for Pipette's ``bs_micro`` knob.  ``--smoke`` trains the reduced
config of the arch, ``--layers N`` its first N layers at full width.
Weights are random, drawn from ``--seed`` on the device.  Every family
trains on the card (dense, MoE, vlm, audio, Mamba1 and the hybrid
zamba2-7b), where each kernel on the path takes its gradient from a
backward kernel (``rmsnorm_bwd``, ``flash_attention_bwd``,
``selective_scan_fused_bwd``) and the plain-torch parts (the MoE layer,
Mamba2's SSD) from autograd; the default arch, gpt-1.1b, has head dim 96.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch

from .._device import DeviceLike, resolve_device
from .._tree import leaves
from ..models.config import ModelConfig

#: The SA budget of ``--configure`` (the reference's; the torch backend
#: is iteration-bound).  A module constant only so that ``chip_smoke.py``
#: and the tests can run ``--configure`` at a cut budget; the CLI has no
#: option for it.
CONFIGURE_BUDGET = dict(sa_seconds=0.2, sa_iters=2000)


def train(cfg: ModelConfig, *, steps: int, global_batch: int, seq_len: int,
          n_micro: int, lr: float, ckpt_dir: str, ckpt_every: int,
          resume: bool = False, metrics: Optional[str] = None,
          fail_at: Optional[int] = None, seed: int = 0,
          device: DeviceLike = None, plan: Any = None,
          save_final: bool = True) -> Dict[str, Any]:
    """Train ``cfg`` from random weights (seed ``seed``) on
    ``SyntheticCorpus`` batches through :class:`~repro_torch.runtime.
    trainer.TrainLoop` and ``make_train_step``, with AdamW on the
    reference's cosine schedule (20 warm-up steps).

    Returns the loop (its ``history`` holds each step's loss and seconds),
    the final parameters and optimizer state, the run's seconds and, on a
    CUDA device, the peak bytes allocated during it.  Raises the loop's
    ``RuntimeError`` at ``fail_at``.  ``save_final=False`` skips the
    checkpoint after the last step (``TrainLoopConfig.save_final``).
    """
    from ..data.pipeline import DataLoader, LoaderConfig, SyntheticCorpus
    from ..models.sharding import ShardCtx
    from ..models.transformer import init_params
    from ..optim.adamw import AdamW, cosine_schedule
    from ..runtime.trainer import TrainLoop, TrainLoopConfig
    from .steps import make_train_step

    device = resolve_device(device)
    params = init_params(cfg, seed=seed, device=device)
    opt = AdamW(lr=cosine_schedule(lr, 20, steps))
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, ShardCtx(), opt, n_micro=n_micro)
    loader = DataLoader(SyntheticCorpus(cfg.vocab_size, seed=seed),
                        LoaderConfig(global_batch, seq_len))
    loop = TrainLoop(
        TrainLoopConfig(total_steps=steps, ckpt_every=ckpt_every,
                        ckpt_dir=ckpt_dir, metrics_path=metrics,
                        save_final=save_final),
        step_fn, loader, fail_at_step=fail_at, plan=plan)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params, opt_state = loop.run(params, opt_state, resume=resume)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out = {"loop": loop, "params": params, "opt_state": opt_state,
           "seconds": time.perf_counter() - t0,
           "n_params": sum(p.numel() for p in leaves(params))}  # repro: noqa DET004 -- numel() is an int element count; integer sum is exact in any order
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced config (CPU-friendly)")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N layers (full width)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints/train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--configure", action="store_true",
                    help="run the Pipette search first (simulated cluster)")
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (fault-tolerance demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' to "
                         "run on the host)")
    args = ap.parse_args(argv)

    from .. import configs
    from ..core import (MID_RANGE, Budget, Planner, PlanRequest,
                        PipetteStrategy, Workload, profile_bandwidth)

    device = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)

    plan = None
    if args.configure:
        spec = MID_RANGE.with_nodes(8)
        w = Workload(cfg, args.seq_len, max(args.global_batch, 64))
        bw, cost = profile_bandwidth(spec)
        req = PlanRequest(workload=w, spec=spec,
                          budget=Budget(**CONFIGURE_BUDGET),
                          seed=args.seed)
        plan = Planner(PipetteStrategy(), device=device).plan(req, bw)
        print(f"[pipette] profiled {spec.n_gpus} GPUs in {cost:.0f}s (sim); "
              f"best config {plan.conf} est {plan.latency*1e3:.1f} ms/iter")
        print(f"[pipette] worker dedication (stage-major GPU ids):\n"
              f"{plan.mapping.reshape(plan.conf.pp, -1)}")

    print(f"[train] {cfg.name} ({cfg.n_layers} layers) on {device}: "
          f"batch {args.global_batch} x seq {args.seq_len}, "
          f"{args.n_micro} microbatches")
    res = train(cfg, steps=args.steps, global_batch=args.global_batch,
                seq_len=args.seq_len, n_micro=args.n_micro, lr=args.lr,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                resume=args.resume, metrics=args.metrics,
                fail_at=args.fail_at, seed=args.seed, device=device,
                plan=plan)
    hist = res["loop"].history
    dt = res["seconds"]
    losses = [h["loss"] for h in hist]
    print(f"[train] {res['n_params']/1e6:.1f}M params; {len(hist)} steps in "
          f"{dt:.1f}s ({dt/max(len(hist),1):.2f}s/step)"
          + (f"; loss {losses[0]:.3f} -> {losses[-1]:.3f}" if losses else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

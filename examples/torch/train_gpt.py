"""End-to-end driver on the PyTorch package: train a GPT on the synthetic
corpus for a few hundred steps with checkpointing and fault recovery.

The default is a ~20M-parameter GPT; ``--full`` trains ~110M parameters,
the "train a ~100M model" scenario.  Both are float32, so on the card the
attention runs its float32 CUDA-core kernel, forward and backward.

    PYTHONPATH=src python examples/torch/train_gpt.py --steps 200
    PYTHONPATH=src python examples/torch/train_gpt.py --steps 200 --fail-at 120
    # ^ crashes at step 120; run again with --resume to continue bitwise
    PYTHONPATH=src python examples/torch/train_gpt.py --steps 3 --device cpu

Port of ``examples/train_gpt.py``: it registers the ``gpt-demo`` config
and drives ``repro_torch.launch.train`` with the reference's arguments
(``--configure``, a checkpoint every 40 steps under
``checkpoints/gpt-demo``), on the CUDA device unless ``--device cpu`` is
given (and it fails without one).
"""
from __future__ import annotations

import argparse
from typing import Optional

from repro_torch import configs
from repro_torch.launch import train as train_cli
from repro_torch.models.config import ModelConfig

#: (layers, width, heads) of the default and the ``--full`` model.
SIZES = {"demo": dict(n_layers=6, d_model=384, n_heads=6),
         "full": dict(n_layers=12, d_model=768, n_heads=12)}
CKPT_EVERY = 40


def gpt_demo(full: bool = False) -> ModelConfig:
    """The ``gpt-demo`` config at the default or the ``--full`` size."""
    size = SIZES["full" if full else "demo"]
    return ModelConfig(name="gpt-demo", family="dense",
                       n_kv_heads=size["n_heads"], d_ff=4 * size["d_model"],
                       vocab_size=4096, dtype="float32", remat=False, **size)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true",
                    help="~110M params instead of ~20M")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' to "
                         "run on the host)")
    args = ap.parse_args(argv)
    gpt = gpt_demo(args.full)
    configs.PAPER_GPTS[gpt.name] = gpt      # register for the CLI

    argv = ["--arch", "gpt-demo", "--steps", str(args.steps),
            "--global-batch", "8", "--seq-len", "256", "--n-micro", "2",
            "--ckpt-dir", "checkpoints/gpt-demo",
            "--ckpt-every", str(CKPT_EVERY), "--configure",
            "--metrics", "checkpoints/gpt-demo-metrics.jsonl"]
    if args.fail_at is not None:
        argv += ["--fail-at", str(args.fail_at)]
    if args.resume:
        argv += ["--resume"]
    if args.device is not None:
        argv += ["--device", args.device]
    return train_cli.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())

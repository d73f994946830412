"""Recompute the roofline terms of saved dry-run cells from their raw
counts, with no new run.

Port of the JAX package's ``launch/reanalyze.py``, which re-parses each
cell's saved HLO with an improved cost model.  The port's dry run has no
HLO: a cell keeps its raw counts (``flops_per_dev``,
``hbm_bytes_per_dev``, ``collective_bytes_per_dev``,
``collective_bytes_native``, ``model_flops``, ``n_devices``, a
pipeline cell's per stage), and this recomputes ``t_compute``,
``t_memory``, ``t_collective``, ``t_collective_native``, ``bottleneck``,
``useful_flops_ratio``, ``fits_h100_80g`` and a pipeline cell's slowest
stage from them under ``launch/dryrun.py``'s constants
(``dryrun.analyze``).  Running it twice changes nothing.

    PYTHONPATH=src python -m repro_torch.launch.reanalyze [--out build/dryrun]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from .dryrun import analyze


def reanalyze(out_dir: Path) -> int:
    """Rewrite every cell of ``out_dir`` that ran (skips are left as they
    are) with its terms recomputed; returns how many."""
    n = 0
    for path in sorted(Path(out_dir).glob("*.json")):
        d = json.loads(path.read_text())
        if "skipped" in d:
            continue
        d.update(analyze(d))
        path.write_text(json.dumps(d, indent=2))
        n += 1
    return n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)
    n = reanalyze(Path(args.out))
    print(f"re-analyzed {n} artifacts")


if __name__ == "__main__":
    main()

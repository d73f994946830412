"""The determinism-linter CLI: ``python -m repro_torch.analysis [paths...]``.

    # lint the library (CI gate: exit 1 on any unsuppressed finding)
    python -m repro_torch.analysis src/

    # machine-readable audit trail, suppressed findings included
    python -m repro_torch.analysis src/ --format json

    # one rule only, against an explicit config
    python -m repro_torch.analysis src/ --select DET002 --config pyproject.toml

Exit codes: 0 clean, 1 unsuppressed findings, 2 usage error.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from .config import find_pyproject, load_config
from .diagnostics import render_json, render_text
from .linter import lint_paths
from .rules import RULES


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Determinism linter: enforce the invariants behind "
                    "the repo's bit-exactness guarantees.")
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files and/or directories to lint")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--select", action="append", metavar="RULE",
                    help="only run these rule ids (repeatable)")
    ap.add_argument("--ignore", action="append", metavar="RULE",
                    help="skip these rule ids (repeatable)")
    ap.add_argument("--config", type=Path, default=None,
                    help="explicit pyproject.toml (default: nearest one "
                         "above the first path)")
    ap.add_argument("--no-config", action="store_true",
                    help="built-in defaults only; ignore pyproject.toml")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="include suppressed findings in text output "
                         "(JSON always includes them)")
    ap.add_argument("--relative-to", type=Path, default=None,
                    help="report paths relative to this root")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule registry and exit")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.list_rules:
        for r in RULES.values():
            print(f"{r.id}  {r.name:26s} {r.summary}")
        return 0
    if not args.paths:
        print("error: no paths given (or use --list-rules)",
              file=sys.stderr)
        return 2
    for p in args.paths:
        if not p.exists():
            print(f"error: no such path: {p}", file=sys.stderr)
            return 2

    if args.no_config:
        cfg_path = None
    elif args.config is not None:
        if not args.config.is_file():
            print(f"error: config not found: {args.config}",
                  file=sys.stderr)
            return 2
        cfg_path = args.config
    else:
        cfg_path = find_pyproject(args.paths[0])
    config = load_config(cfg_path)

    unknown = [r for r in (args.select or []) + (args.ignore or [])
               if r not in RULES]
    if unknown:
        print(f"error: unknown rule id(s): {', '.join(unknown)} "
              f"(see --list-rules)", file=sys.stderr)
        return 2
    disable = set(config.disable) | set(args.ignore or [])
    if args.select:
        disable |= set(RULES) - set(args.select)
    if disable != set(config.disable):
        import dataclasses
        config = dataclasses.replace(config, disable=frozenset(disable))

    diags = lint_paths(args.paths, config,
                       relative_to=args.relative_to)
    open_diags = [d for d in diags if not d.suppressed]
    if args.format == "json":
        sys.stdout.write(render_json(diags))
    else:
        for line in render_text(diags,
                                show_suppressed=args.show_suppressed):
            print(line)
        n_sup = sum(1 for d in diags if d.suppressed)
        print(f"[repro_torch.analysis] {len(open_diags)} finding(s), "
              f"{n_sup} suppressed with reasons "
              f"(config: {config.source})", file=sys.stderr)
    return 1 if open_diags else 0


if __name__ == "__main__":                         # pragma: no cover
    raise SystemExit(main())

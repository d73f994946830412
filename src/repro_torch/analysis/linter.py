"""Linter driver: walk files, parse, run rules, apply suppressions."""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List, Optional

from .config import AnalysisConfig
from .diagnostics import Diagnostic
from .rules import DeterminismVisitor
from .suppress import apply_suppressions, scan_suppressions


def lint_source(source: str, path: str,
                config: Optional[AnalysisConfig] = None) -> List[Diagnostic]:
    """Lint one module given as text (the unit the tests drive)."""
    config = config or AnalysisConfig()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Diagnostic(path=path, line=e.lineno or 1,
                           col=(e.offset or 1) - 1, rule="SYN001",
                           message=f"file does not parse: {e.msg}",
                           end_line=e.lineno or 1)]
    diags = DeterminismVisitor(path, config).run(tree)
    supps, malformed = scan_suppressions(source, path)
    diags = apply_suppressions(diags, supps, path)
    return diags + malformed


def lint_file(path: Path,
              config: Optional[AnalysisConfig] = None,
              display_path: Optional[str] = None) -> List[Diagnostic]:
    """Lint one file; ``display_path`` overrides the path recorded on
    diagnostics (the CLI passes a normalized relative path)."""
    text = Path(path).read_text(encoding="utf-8")
    return lint_source(text, display_path or str(path), config)


def iter_python_files(paths: Iterable[Path]) -> List[Path]:
    """Expand files/directories into a sorted list of ``.py`` files."""
    out = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        else:
            out.append(p)
    return out


def lint_paths(paths: Iterable[Path],
               config: Optional[AnalysisConfig] = None,
               relative_to: Optional[Path] = None) -> List[Diagnostic]:
    """Lint every ``.py`` file under ``paths`` (recursing directories).

    Args:
        paths: files and/or directories.
        config: resolved :class:`AnalysisConfig` (defaults when None).
        relative_to: when given, diagnostics carry ``/``-separated paths
            relative to this root — stable output for golden fixtures.
    """
    config = config or AnalysisConfig()
    diags: List[Diagnostic] = []
    for f in iter_python_files(paths):
        display = f.as_posix()
        if relative_to is not None:
            try:
                display = f.resolve().relative_to(
                    Path(relative_to).resolve()).as_posix()
            except ValueError:
                pass
        if config.is_excluded(display):
            continue
        diags.extend(lint_file(f, config, display_path=display))
    return sorted(diags)

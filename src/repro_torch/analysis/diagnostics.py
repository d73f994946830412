"""Diagnostic records and the two output renderers (text / JSON).

A :class:`Diagnostic` is one finding of one rule at one source location.
Suppressed findings are *kept* (with ``suppressed=True`` and the
suppression's reason) rather than dropped: the JSON output is a complete
audit trail — every exception to a determinism invariant is visible next
to its justification, which is what the golden-diagnostics test pins.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from typing import List, Sequence


@dataclass(frozen=True, order=True)
class Diagnostic:
    """One rule finding at one source location.

    Attributes:
        path: file the finding is in (as passed to the linter; the CLI
            normalizes to ``/``-separated relative paths for stable output).
        line / col: 1-based line and 0-based column of the offending node.
        rule: rule id (``DET001`` ... ``SUP002``).
        message: human-readable description with the resolved symbol.
        end_line: last physical line of the offending statement —
            suppression comments anywhere in ``[line, end_line]`` apply.
        suppressed: True when a valid reasoned ``# repro: noqa`` matched.
        reason: the suppression's stated reason (empty when unsuppressed).
    """
    path: str
    line: int
    col: int
    rule: str
    message: str
    end_line: int = 0
    suppressed: bool = field(default=False, compare=False)
    reason: str = field(default="", compare=False)

    def suppress(self, reason: str) -> "Diagnostic":
        return replace(self, suppressed=True, reason=reason)


def render_text(diags: Sequence[Diagnostic], *,
                show_suppressed: bool = False) -> List[str]:
    """flake8-style one-line-per-finding text output, sorted by location."""
    lines = []
    for d in sorted(diags):
        if d.suppressed and not show_suppressed:
            continue
        tag = f" [suppressed: {d.reason}]" if d.suppressed else ""
        lines.append(f"{d.path}:{d.line}:{d.col + 1}: {d.rule} "
                     f"{d.message}{tag}")
    return lines


def render_json(diags: Sequence[Diagnostic]) -> str:
    """Canonical JSON: sorted findings, sorted keys, trailing newline —
    byte-stable for identical findings (the golden-diagnostics fixture
    relies on this)."""
    out = [{"path": d.path, "line": d.line, "col": d.col, "rule": d.rule,
            "message": d.message, "suppressed": d.suppressed,
            "reason": d.reason}
           for d in sorted(diags)]
    return json.dumps(out, sort_keys=True, indent=2) + "\n"

"""Reasoned inline suppressions: ``# repro: noqa DET002 -- why``.

The policy is deliberately stricter than flake8's bare ``# noqa``:

* a suppression must name the rule(s) it silences (no blanket waivers),
* it must carry a non-empty reason after ``--`` (the *why* is reviewed,
  not just the *what*), and
* it must actually match a finding — stale suppressions rot into silent
  blanket waivers, so an unused one is itself a violation (``SUP002``).

Malformed suppressions (missing codes, missing reason) are ``SUP001``
violations rather than being ignored: a typo'd noqa that silently fails
open is worse than no noqa at all.
"""
from __future__ import annotations

import io
import re
import tokenize
from dataclasses import dataclass, field
from typing import List, Tuple

from .diagnostics import Diagnostic

#: Matches the suppression marker anywhere in a comment.
_NOQA_RE = re.compile(r"#\s*repro:\s*noqa\b(?P<rest>[^\n]*)")
#: codes, then `` -- reason``; codes are comma/space separated rule ids.
_REST_RE = re.compile(
    r"^\s*(?P<codes>[A-Z]{3}\d{3}(?:\s*,\s*[A-Z]{3}\d{3})*)"
    r"\s*--\s*(?P<reason>\S.*)$")


@dataclass
class Suppression:
    """One parsed ``# repro: noqa`` comment."""
    line: int
    codes: Tuple[str, ...]
    reason: str
    used: bool = field(default=False, compare=False)


def scan_suppressions(source: str,
                      path: str) -> Tuple[List[Suppression],
                                          List[Diagnostic]]:
    """Extract suppressions from source text.

    Only real ``#`` comments count (the source is tokenized, so a noqa
    *example* inside a docstring or string literal is inert).  Returns
    ``(valid_suppressions, malformed_diagnostics)`` — malformed markers
    become ``SUP001`` findings at their own location.
    """
    supps: List[Suppression] = []
    bad: List[Diagnostic] = []
    comments = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                comments.append((tok.start[0], tok.start[1], tok.string))
    except (tokenize.TokenError, IndentationError):
        # unparsable files already carry a SYN001 from the linter driver
        return supps, bad
    for lineno, col, text in comments:
        m = _NOQA_RE.search(text)
        if m is None:
            continue
        rest = _REST_RE.match(m.group("rest"))
        if rest is None:
            bad.append(Diagnostic(
                path=path, line=lineno, col=col + m.start(), rule="SUP001",
                message="malformed suppression: expected "
                        "'# repro: noqa <RULE[,RULE...]> -- <reason>' "
                        "(rule codes and a non-empty reason are both "
                        "required)", end_line=lineno))
            continue
        codes = tuple(c.strip() for c in rest.group("codes").split(","))
        supps.append(Suppression(line=lineno, codes=codes,
                                 reason=rest.group("reason").strip()))
    return supps, bad


def apply_suppressions(diags: List[Diagnostic], supps: List[Suppression],
                       path: str) -> List[Diagnostic]:
    """Match suppressions to findings; flag unused ones as ``SUP002``.

    A suppression on physical line L silences a finding whose statement
    spans ``[line, end_line]`` containing L — so the comment can sit at
    the end of any line of a multi-line call.
    """
    out: List[Diagnostic] = []
    for d in diags:
        hit = None
        for s in supps:
            if d.rule in s.codes and \
                    d.line <= s.line <= max(d.end_line, d.line):
                hit = s
                break
        if hit is not None:
            hit.used = True
            out.append(d.suppress(hit.reason))
        else:
            out.append(d)
    for s in supps:
        if not s.used:
            out.append(Diagnostic(
                path=path, line=s.line, col=0, rule="SUP002",
                message=f"unused suppression for "
                        f"{', '.join(s.codes)}: no matching finding on "
                        f"this statement (stale noqa — remove it)",
                end_line=s.line))
    return out

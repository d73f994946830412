"""Static analysis for the reproduction: a determinism linter + plan verifier.

The repo's correctness story rests on bit-exactness — golden Plan
fixtures, hex-float regression suites, chain-for-chain NumPy/JAX parity —
but those suites only catch a determinism break *after* it lands.  This
package enforces the invariants that make bit-exactness possible, before
any search runs:

1. the **determinism linter** (``python -m repro_torch.analysis``): an AST-based
   checker with a rule registry (:mod:`~repro_torch.analysis.rules` — unseeded
   RNG, wall-clock reads, order-dependent float accumulation, float
   equality, unordered-container iteration, host effects inside jitted
   functions), per-rule configuration in ``pyproject.toml``
   (``[tool.repro.analysis]``) and *reasoned* inline suppressions
   (``# repro: noqa DET002 -- why this one is safe``);
2. the **static plan verifier** (:mod:`~repro_torch.analysis.plan_verifier`,
   surfaced as ``python -m repro_torch.plan lint``): checks a serialized
   :class:`~repro_torch.core.plan.Plan` against a
   :class:`~repro_torch.core.cluster.ClusterSpec` without re-running the search
   — Pipette's critique of prior configurators is that they recommend
   plans that cannot execute, and a cached or hand-edited artifact can
   drift into exactly that state.
"""
from .config import AnalysisConfig, load_config
from .diagnostics import Diagnostic, render_json, render_text
from .linter import lint_file, lint_paths
from .plan_verifier import PlanIssue, verify_plan_dict, verify_plan_file
from .rules import RULES, Rule

__all__ = [
    "AnalysisConfig", "Diagnostic", "PlanIssue", "RULES", "Rule",
    "lint_file", "lint_paths", "load_config", "render_json", "render_text",
    "verify_plan_dict", "verify_plan_file",
]

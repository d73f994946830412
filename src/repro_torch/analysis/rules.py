"""The determinism rule registry and its AST checkers.

Every rule is a :class:`Rule` in :data:`RULES`; the
:class:`DeterminismVisitor` walks one module's AST with an import-alias
resolver (so ``np.random.rand`` and ``from numpy import random as r;
r.rand`` both resolve to ``numpy.random.rand``) and emits
:class:`~repro_torch.analysis.diagnostics.Diagnostic` findings.

Rule ids (stable — suppression comments reference them):

=======  ==========================================================
DET001   unseeded or process-global RNG (legacy ``np.random.*``,
         stdlib ``random`` module functions, ``default_rng()`` with
         no seed, a ``torch`` sampler called without ``generator=``)
DET002   wall-clock read outside the allowlisted overhead timers
DET003   ``np.sum`` / ``torch.sum`` / ``ndarray.sum`` / ``Tensor.sum``
         in a scoring module where ``np_pairwise_sum`` is the required
         reduction (scoped via ``det003-paths``)
DET004   builtin ``sum()`` over potentially-float values
         (left-fold, order-dependent; use ``math.fsum`` or
         ``np_pairwise_sum``)
DET005   ``==`` / ``!=`` against a float literal on computed values
DET006   iteration over a set expression feeding order-sensitive
         accumulation
DET007   host-side effect (print / wall clock / global RNG / IO)
         inside a jitted function (``jax.jit`` and its kin, or
         ``torch.compile`` / ``torch.jit.script`` / ``torch.jit.trace``)
SYN001   file does not parse (reported by the linter driver)
SUP001   malformed suppression comment (see ``suppress.py``)
SUP002   unused suppression comment (see ``suppress.py``)
=======  ==========================================================

Known limitations (documented, deliberate): resolution is lexical, so a
set/RNG/clock reached through a *variable* (``s = set(xs); for x in s``)
or re-exported helper is not seen, and DET004's integer-sum escape only
recognizes ``len(...)`` elements.  The rules are a cheap gate in front of
the expensive bit-exactness suites, not a soundness proof — the same
split as AMP's validity pruning before real evaluation.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional

from .config import AnalysisConfig
from .diagnostics import Diagnostic


@dataclass(frozen=True)
class Rule:
    """One registry entry: id, short name, and the one-line summary that
    the CLI's ``--list-rules`` and the docs table show."""
    id: str
    name: str
    summary: str


RULES: Dict[str, Rule] = {r.id: r for r in [
    Rule("DET001", "unseeded-rng",
         "unseeded or process-global RNG (legacy np.random.*, stdlib "
         "random.*, default_rng() without a seed, torch.randn & co. "
         "without generator=)"),
    Rule("DET002", "wall-clock-read",
         "wall-clock read (time.time, datetime.now, ...) outside the "
         "allowlisted monotonic overhead timers"),
    Rule("DET003", "non-pairwise-reduction",
         "np.sum/torch.sum/ndarray.sum/Tensor.sum in a scoring module "
         "where np_pairwise_sum is the required "
         "(association-order-pinned) reduction"),
    Rule("DET004", "order-dependent-sum",
         "builtin sum() over potentially-float values — a left fold "
         "whose rounding depends on operand order (use math.fsum)"),
    Rule("DET005", "float-equality",
         "== / != against a float literal; computed floats differ in "
         "the last ulp across backends"),
    Rule("DET006", "unordered-iteration",
         "iterating a set expression into order-sensitive accumulation "
         "(set order varies with PYTHONHASHSEED)"),
    Rule("DET007", "host-effect-in-jit",
         "host-side effect (print, wall clock, global RNG, IO) inside "
         "a jitted function — runs at trace time, not step time"),
    Rule("SYN001", "syntax-error", "file does not parse"),
    Rule("SUP001", "malformed-suppression",
         "suppression comment missing rule codes or a reason"),
    Rule("SUP002", "unused-suppression",
         "suppression comment that matches no finding"),
]}

#: Legacy process-global numpy RNG entry points (DET001).
_NP_LEGACY_RNG = frozenset({
    "seed", "rand", "randn", "randint", "random", "random_sample",
    "ranf", "sample", "choice", "shuffle", "permutation", "uniform",
    "normal", "standard_normal", "binomial", "poisson", "exponential",
    "get_state", "set_state",
})
#: Stdlib ``random`` module-level functions (process-global Mersenne state).
_STDLIB_RNG = frozenset({
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "betavariate",
    "seed", "getrandbits", "randbytes", "triangular",
})
#: ``torch`` samplers that draw from the process-global generator unless
#: they are handed one (DET001): the port seeds a ``torch.Generator`` and
#: passes it explicitly.
_TORCH_RNG = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial",
})
#: Consumers for which set-iteration order cannot matter (DET006).
_ORDER_FREE_CONSUMERS = frozenset({
    "min", "max", "any", "all", "len", "sorted", "set", "frozenset",
    "math.fsum",  # fsum is exact: result independent of operand order
})
#: Decorator spellings that mark a function as jitted (DET007): the
#: reference's JAX transforms, and the ``torch`` compilers, which trace
#: a body once and run the graph without its host effects after that.
_JIT_NAMES = frozenset({"jax.jit", "jax.pmap", "jax.pjit",
                        "jax.experimental.pjit.pjit",
                        "torch.compile", "torch.jit.script",
                        "torch.jit.trace"})
#: Host-effect calls banned inside jitted bodies (beyond wall clock/RNG).
_JIT_HOST_EFFECTS = frozenset({"print", "input", "open", "breakpoint"})


class _ImportResolver:
    """Lexical alias map: resolves an expression node to a dotted name.

    ``import numpy as np`` makes ``np.random.rand`` resolve to
    ``numpy.random.rand``; ``from time import time as now`` makes
    ``now`` resolve to ``time.time``.  Names assigned in the module are
    dropped from the map (a local ``sum = ...`` shadows the builtin).
    """

    def __init__(self):
        self.aliases: Dict[str, str] = {}
        self.shadowed: set = set()

    def add_import(self, node: ast.Import) -> None:
        for a in node.names:
            self.aliases[a.asname or a.name.split(".")[0]] = \
                a.name if a.asname else a.name.split(".")[0]

    def add_import_from(self, node: ast.ImportFrom) -> None:
        mod = ("." * node.level) + (node.module or "")
        for a in node.names:
            if a.name == "*":
                continue
            self.aliases[a.asname or a.name] = f"{mod}.{a.name}"

    def shadow(self, name: str) -> None:
        self.shadowed.add(name)
        self.aliases.pop(name, None)

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted name of ``node`` with import aliases expanded, or None
        for non-name expressions (calls, subscripts, literals)."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = node.id
        if base in self.shadowed:
            # a rebound local: no alias expansion, and a bare name (e.g. a
            # local called ``sum``) no longer refers to the builtin
            return ".".join([base, *reversed(parts)]) if parts else None
        root = self.aliases.get(base, base)
        return ".".join([root, *reversed(parts)])


def _is_float_literal(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, float)


def _is_len_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "len")


def _is_set_expr(node: ast.AST, resolver: _ImportResolver) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        return resolver.resolve(node.func) in ("set", "frozenset")
    return False


def _int_elements_only(call: ast.Call) -> bool:
    """True when every summed element is an obvious integer — the one
    escape DET004 recognizes is ``sum(len(x) for x in ...)`` (and sums of
    integer literals); everything else needs a reasoned suppression."""
    if not call.args:
        return True
    arg = call.args[0]
    if isinstance(arg, (ast.GeneratorExp, ast.ListComp)):
        return _is_len_call(arg.elt) or (
            isinstance(arg.elt, ast.Constant)
            and isinstance(arg.elt.value, int))
    if isinstance(arg, (ast.List, ast.Tuple)):
        return all(_is_len_call(e) or
                   (isinstance(e, ast.Constant) and isinstance(e.value, int))
                   for e in arg.elts)
    return False


class DeterminismVisitor(ast.NodeVisitor):
    """Single-pass visitor running every enabled DET rule over one module."""

    def __init__(self, path: str, config: AnalysisConfig):
        self.path = path
        self.config = config
        self.resolver = _ImportResolver()
        self.diags: List[Diagnostic] = []
        self._jit_depth = 0          # > 0 while inside a jitted function
        self._parents: Dict[int, ast.AST] = {}

    # -- plumbing ----------------------------------------------------------

    def run(self, tree: ast.Module) -> List[Diagnostic]:
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[id(child)] = parent
        self.visit(tree)
        return self.diags

    def _emit(self, rule_id: str, node: ast.AST, message: str) -> None:
        if not self.config.rule_enabled(rule_id):
            return
        self.diags.append(Diagnostic(
            path=self.path, line=node.lineno, col=node.col_offset,
            rule=rule_id, message=message,
            end_line=getattr(node, "end_lineno", node.lineno)))

    def _parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(id(node))

    # -- imports and shadowing --------------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        self.resolver.add_import(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        self.resolver.add_import_from(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                self.resolver.shadow(tgt.id)
        self.generic_visit(node)

    # -- jit context (DET007) ---------------------------------------------

    def _is_jit_decorator(self, dec: ast.AST) -> bool:
        name = self.resolver.resolve(dec)
        if name in _JIT_NAMES or (name or "").split(".")[-1] == "jit":
            return True
        # @partial(jax.jit, ...) / @functools.partial(jit, ...)
        if isinstance(dec, ast.Call):
            fn = self.resolver.resolve(dec.func)
            if fn in ("functools.partial", "partial") and dec.args:
                return self._is_jit_decorator(dec.args[0])
            return self._is_jit_decorator(dec.func)
        return False

    def _visit_function(self, node) -> None:
        for a in [*node.args.args, *node.args.kwonlyargs,
                  *node.args.posonlyargs]:
            self.resolver.shadow(a.arg)
        jitted = any(self._is_jit_decorator(d) for d in node.decorator_list)
        self._jit_depth += 1 if jitted else 0
        self.generic_visit(node)
        self._jit_depth -= 1 if jitted else 0

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    # -- call-site rules ---------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        name = self.resolver.resolve(node.func)
        if name is not None:
            self._check_rng(node, name)
            self._check_wall_clock(node, name)
            self._check_array_sum(node, name)
            self._check_builtin_sum(node, name)
            if self._jit_depth > 0 and name in _JIT_HOST_EFFECTS:
                self._emit("DET007", node,
                           f"host-side effect '{name}()' inside a jitted "
                           f"function: executes at trace time only, and "
                           f"breaks purity of the compiled computation")
        self.generic_visit(node)

    def _check_rng(self, node: ast.Call, name: str) -> None:
        if name.startswith("numpy.random.") and \
                name.split(".")[-1] in _NP_LEGACY_RNG:
            self._emit("DET001", node,
                       f"process-global legacy RNG '{name}': draws depend "
                       f"on hidden module state; use a seeded "
                       f"np.random.default_rng(seed) passed explicitly")
        elif name.startswith("random.") and \
                name.split(".")[-1] in _STDLIB_RNG:
            self._emit("DET001", node,
                       f"process-global stdlib RNG '{name}': use a seeded "
                       f"np.random.default_rng(seed) or random.Random(seed)")
        elif name in ("numpy.random.default_rng", "random.Random") \
                and not node.args and not node.keywords:
            self._emit("DET001", node,
                       f"'{name}()' without a seed draws entropy from the "
                       f"OS; pass an explicit seed")
        elif name.startswith("torch.") and name.count(".") == 1 \
                and name.split(".")[-1] in _TORCH_RNG \
                and not any(k.arg == "generator" for k in node.keywords):
            self._emit("DET001", node,
                       f"'{name}()' without generator= draws from the "
                       f"process-global torch generator; pass a seeded "
                       f"torch.Generator explicitly")
        if self._jit_depth > 0 and (name.startswith("numpy.random.")
                                    or name.startswith("random.")
                                    or (name.startswith("torch.")
                                        and name.split(".")[-1]
                                        in _TORCH_RNG)):
            self._emit("DET007", node,
                       f"host RNG '{name}' inside a jitted function: "
                       f"evaluated once at trace time, then baked into "
                       f"the compiled graph as a constant")

    def _check_wall_clock(self, node: ast.Call, name: str) -> None:
        if name in self.config.wall_clock_ban:
            det7 = self._jit_depth > 0
            self._emit("DET007" if det7 else "DET002", node,
                       f"wall-clock read '{name}' "
                       + ("inside a jitted function"
                          if det7 else
                          "outside the allowlisted overhead timers: "
                          "wall time must never reach a scored or "
                          "serialized value (inject timestamps; use "
                          "time.perf_counter for overhead measurement)"))

    def _check_array_sum(self, node: ast.Call, name: str) -> None:
        if not self.config.det003_applies(self.path):
            return
        is_np = name in ("numpy.sum", "jax.numpy.sum", "torch.sum")
        is_method = (isinstance(node.func, ast.Attribute)
                     and node.func.attr == "sum" and not is_np)
        if not (is_np or is_method):
            return
        # ``int(x.sum())`` is self-documenting: an integer reduction is
        # exact, so association order cannot change the value
        parent = self._parent(node)
        if isinstance(parent, ast.Call) \
                and self.resolver.resolve(parent.func) == "int":
            return
        self._emit("DET003", node,
                   "array sum in a scoring module: reductions on this "
                   "path must replay NumPy's pairwise association "
                   "order exactly (np_pairwise_sum) or carry a reason "
                   "why order cannot matter here")

    def _check_builtin_sum(self, node: ast.Call, name: str) -> None:
        if name != "sum" or _int_elements_only(node):
            return
        self._emit("DET004", node,
                   "builtin sum() is a left fold — float rounding depends "
                   "on operand order; use math.fsum (order-independent) "
                   "or np_pairwise_sum, or suppress with a reason if the "
                   "operands are provably integers")

    # -- comparison / iteration rules -------------------------------------

    def visit_Compare(self, node: ast.Compare) -> None:
        if any(isinstance(op, (ast.Eq, ast.NotEq)) for op in node.ops) and \
                any(_is_float_literal(c) for c in
                    [node.left, *node.comparators]):
            self._emit("DET005", node,
                       "exact ==/!= against a float literal: computed "
                       "floats differ in the last ulp across backends and "
                       "reduction orders; compare with a tolerance, or "
                       "suppress with a reason if the value is an exact "
                       "sentinel (never computed)")
        self.generic_visit(node)

    def _comprehension_consumer_ok(self, node: ast.AST) -> bool:
        parent = self._parent(node)
        if isinstance(parent, ast.Call) and len(parent.args) >= 1 \
                and parent.args[0] is node:
            return self.resolver.resolve(parent.func) \
                in _ORDER_FREE_CONSUMERS
        # feeding a set/dict comprehension result stays unordered anyway
        return isinstance(parent, (ast.SetComp, ast.DictComp))

    def _check_comp_iters(self, node) -> None:
        for gen in node.generators:
            if _is_set_expr(gen.iter, self.resolver) and \
                    not self._comprehension_consumer_ok(node):
                self._emit("DET006", node,
                           "comprehension over a set expression feeding "
                           "an order-sensitive consumer: set order varies "
                           "with PYTHONHASHSEED; iterate sorted(...) "
                           "instead")
        self.generic_visit(node)

    visit_GeneratorExp = _check_comp_iters
    visit_ListComp = _check_comp_iters

    def visit_SetComp(self, node: ast.SetComp) -> None:
        self.generic_visit(node)                 # result is unordered; fine

    def visit_For(self, node: ast.For) -> None:
        if _is_set_expr(node.iter, self.resolver):
            self._emit("DET006", node,
                       "for-loop over a set expression: iteration order "
                       "varies with PYTHONHASHSEED, so any order-sensitive "
                       "body (float accumulation, list building, dict "
                       "insertion) is non-deterministic; iterate "
                       "sorted(...) instead")
        self.generic_visit(node)

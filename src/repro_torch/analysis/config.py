"""Per-rule linter configuration from ``pyproject.toml``.

Read from ``[tool.repro.analysis]``:

.. code-block:: toml

    [tool.repro.analysis]
    disable = ["DET006"]               # rule ids switched off entirely
    exclude = ["**/generated/*.py"]    # files the linter skips
    # DET003 (pairwise-summation) only applies to these scoring modules —
    # everywhere else ndarray sums are ordinary numerics, not something a
    # replica must replay association-order-exactly.
    det003-paths = ["**/core/latency.py"]
    # DET002 wall-clock tuning: extend or shrink the banned set.
    wall-clock-ban = ["arrow.utcnow"]
    wall-clock-allow = ["time.localtime"]

The port's own scoring modules are not named in the repo's
``pyproject.toml`` (its table is the JAX package's), so
:data:`PORT_DET003_PATHS` is appended to ``det003-paths`` whenever a
config file is loaded; with no file (``--no-config``) the defaults stay
empty, as in the reference.

TOML parsing uses :mod:`tomllib` (3.11+) with a ``tomli`` fallback for
3.10; with neither available, explicit ``--config`` fails loudly while
``--no-config`` / built-in defaults keep the linter usable.
"""
from __future__ import annotations

import fnmatch
from dataclasses import dataclass
from pathlib import Path
from typing import FrozenSet, Optional, Tuple

#: Wall-clock reads banned by DET002.  Monotonic timers
#: (``perf_counter`` / ``monotonic`` / ``process_time``) are deliberately
#: absent: they are the *allowlisted overhead timers* — meaningless across
#: processes, so nothing bit-reproducible can be derived from them.
DEFAULT_WALL_CLOCK_BAN = frozenset({
    "time.time", "time.time_ns", "time.ctime", "time.asctime",
    "time.localtime", "time.gmtime", "time.strftime",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
})


#: The port's scoring modules whose reductions must replay NumPy's
#: pairwise order (DET003), added to every loaded config: the SA engine's
#: batched scorer and the group-reduce kernels' plain versions.
PORT_DET003_PATHS = ("**/core/torch_engine.py", "**/kernels/group_reduce.py")


@dataclass(frozen=True)
class AnalysisConfig:
    """Resolved linter configuration (defaults when no file is found)."""
    disable: FrozenSet[str] = frozenset()
    exclude: Tuple[str, ...] = ()
    det003_paths: Tuple[str, ...] = ()
    wall_clock_ban: FrozenSet[str] = DEFAULT_WALL_CLOCK_BAN
    source: str = "<defaults>"

    def rule_enabled(self, rule_id: str) -> bool:
        return rule_id not in self.disable

    def is_excluded(self, path: str) -> bool:
        return _any_glob(path, self.exclude)

    def det003_applies(self, path: str) -> bool:
        """DET003 is scoped: active only for configured scoring modules."""
        return _any_glob(path, self.det003_paths)


def _any_glob(path: str, globs: Tuple[str, ...]) -> bool:
    norm = Path(path).as_posix()
    return any(fnmatch.fnmatch(norm, g) or fnmatch.fnmatch(Path(norm).name, g)
               for g in globs)


def _load_toml(path: Path) -> dict:
    try:
        import tomllib
    except ImportError:                                   # Python 3.10
        try:
            import tomli as tomllib
        except ImportError as e:
            raise RuntimeError(
                f"cannot read {path}: no TOML parser available "
                f"(need Python >= 3.11 or the tomli package); "
                f"run with --no-config to use built-in defaults") from e
    with open(path, "rb") as f:
        return tomllib.load(f)


def find_pyproject(start: Path) -> Optional[Path]:
    """Walk up from ``start`` to the nearest ``pyproject.toml``."""
    cur = start.resolve()
    if cur.is_file():
        cur = cur.parent
    for d in (cur, *cur.parents):
        cand = d / "pyproject.toml"
        if cand.is_file():
            return cand
    return None


def load_config(path: Optional[Path]) -> AnalysisConfig:
    """Load ``[tool.repro.analysis]`` from ``path`` (defaults if None or
    the table is absent), with :data:`PORT_DET003_PATHS` appended to
    ``det003-paths`` whenever a file is read."""
    if path is None:
        return AnalysisConfig()
    data = _load_toml(Path(path))
    table = data.get("tool", {}).get("repro", {}).get("analysis", {})
    ban = set(DEFAULT_WALL_CLOCK_BAN)
    ban |= set(table.get("wall-clock-ban", ()))
    ban -= set(table.get("wall-clock-allow", ()))
    return AnalysisConfig(
        disable=frozenset(table.get("disable", ())),
        exclude=tuple(table.get("exclude", ())),
        det003_paths=tuple(table.get("det003-paths", ()))
        + PORT_DET003_PATHS,
        wall_clock_ban=frozenset(ban),
        source=str(path))

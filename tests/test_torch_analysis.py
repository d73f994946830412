"""The determinism linter of the PyTorch package (``repro_torch.analysis``).

The cases of the JAX package's ``tests/test_analysis.py`` on the port's
copy, over the reference's fixtures (read only): one fixture file per
rule, the golden JSON diagnostics, suppression handling, config scoping
and exclusion, escape hatches and the CLI.  Beside them, the torch reading
of the rules, on fixtures written into ``tmp_path``: DET003 on
``torch.sum`` and ``Tensor.sum`` in the port's scoring modules (added to
``det003-paths`` by every loaded config), DET007 inside ``torch.compile``
and ``torch.jit.script``, DET001 on a ``torch`` sampler without
``generator=``; and the gate: ``src/repro_torch`` lints clean under the
repo's ``pyproject.toml`` with the port's linter, through the CLI too.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import (
    RULES,
    lint_file,
    lint_paths,
    load_config,
    render_json,
    render_text,
)
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.config import PORT_DET003_PATHS, AnalysisConfig
from repro_torch.analysis.linter import lint_source

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
FIXTURES = TESTS / "data" / "analysis_fixtures"


@pytest.fixture(scope="module")
def fixture_config():
    return load_config(FIXTURES / "fixture_pyproject.toml")


def _open_rules(diags):
    return sorted(d.rule for d in diags if not d.suppressed)


# ---------------------------------------------------------------- registry

def test_rule_registry_is_complete():
    expected = {f"DET{i:03d}" for i in range(1, 8)}
    expected |= {"SYN001", "SUP001", "SUP002"}
    assert set(RULES) == expected
    for rule_id, rule in RULES.items():
        assert rule.id == rule_id
        assert rule.name and rule.summary


# ------------------------------------------------- one violation per rule

@pytest.mark.parametrize("rule_id, fname", [
    ("DET001", "det001.py"),
    ("DET002", "det002.py"),
    ("DET003", "det003.py"),
    ("DET004", "det004.py"),
    ("DET005", "det005.py"),
    ("DET006", "det006.py"),
    ("DET007", "det007.py"),
])
def test_fixture_flags_exactly_its_rule(rule_id, fname, fixture_config):
    diags = lint_file(FIXTURES / fname, fixture_config)
    assert _open_rules(diags) == [rule_id]


def test_syntax_error_is_a_diagnostic_not_a_crash():
    diags = lint_source("def broken(:\n    pass\n", "broken.py")
    assert _open_rules(diags) == ["SYN001"]


# ------------------------------------------------------- golden JSON output

def test_golden_json_diagnostics(fixture_config):
    diags = lint_paths([FIXTURES], fixture_config, relative_to=FIXTURES)
    got = render_json(diags)
    expected = (FIXTURES / "expected.json").read_text(encoding="utf-8")
    assert got == expected
    # and it really is machine-readable
    records = json.loads(got)
    assert all(set(r) >= {"path", "line", "col", "rule", "message",
                          "suppressed", "reason"} for r in records)


def test_excluded_file_is_skipped(fixture_config):
    diags = lint_paths([FIXTURES], fixture_config, relative_to=FIXTURES)
    assert not any(d.path == "excluded.py" for d in diags)
    # same file, default config (no exclusion) -> DET001 fires
    diags = lint_file(FIXTURES / "excluded.py", AnalysisConfig())
    assert _open_rules(diags) == ["DET001"]


# ------------------------------------------------------------- suppressions

def test_reasoned_suppression_silences_and_records_reason(fixture_config):
    diags = lint_file(FIXTURES / "suppressed.py", fixture_config)
    assert _open_rules(diags) == []
    sup = [d for d in diags if d.suppressed]
    assert len(sup) == 1
    assert sup[0].rule == "DET002"
    assert sup[0].reason == "fixture exercising reasoned suppressions"


def test_malformed_and_unused_suppressions_are_findings(fixture_config):
    diags = lint_file(FIXTURES / "bad_suppress.py", fixture_config)
    # the reason-less noqa does NOT suppress, and is itself flagged;
    # the noqa with no matching finding is flagged as stale
    assert _open_rules(diags) == ["DET002", "SUP001", "SUP002"]


def test_suppression_must_name_the_right_rule():
    src = ("import time\n"
           "t = time.time()  # repro: noqa DET001 -- wrong rule named\n")
    diags = lint_source(src, "mod.py")
    # DET002 stays open, and the DET001 noqa is unused
    assert _open_rules(diags) == ["DET002", "SUP002"]


def test_noqa_in_docstring_or_string_is_ignored():
    src = '"""docs mention # repro: noqa DET001 -- example"""\nx = 1\n'
    assert lint_source(src, "mod.py") == []


# ------------------------------------------------------------ escape hatches

def test_det004_integer_escapes():
    assert _open_rules(lint_source(
        "xs = [[1], [2, 3]]\nn = sum(len(x) for x in xs)\n", "m.py")) == []
    assert _open_rules(lint_source(
        "n = sum(1 for _ in range(5))\n", "m.py")) == []
    assert _open_rules(lint_source(
        "xs = [0.5, 0.25]\ns = sum(x for x in xs)\n", "m.py")) == ["DET004"]


def test_det003_scoping_and_int_escape():
    cfg = AnalysisConfig(det003_paths=("scored.py",))
    src = "def f(a):\n    return float(a.sum())\n"
    assert _open_rules(lint_source(src, "scored.py", cfg)) == ["DET003"]
    assert _open_rules(lint_source(src, "elsewhere.py", cfg)) == []
    # integer reductions are exact in any association order
    src_int = "def f(mask):\n    return int(mask.sum())\n"
    assert _open_rules(lint_source(src_int, "scored.py", cfg)) == []


def test_det002_allows_monotonic_timers():
    src = ("import time\n"
           "t0 = time.perf_counter()\n"
           "t1 = time.monotonic()\n")
    assert lint_source(src, "m.py") == []


def test_det006_order_free_consumers_are_fine():
    assert _open_rules(lint_source(
        "xs = [3, 1]\nm = max(set(xs))\n", "m.py")) == []
    assert _open_rules(lint_source(
        "xs = [3, 1]\nys = sorted(set(xs))\n", "m.py")) == []


def test_import_alias_resolution():
    src = ("from time import time as now\n"
           "def f():\n"
           "    return now()\n")
    assert _open_rules(lint_source(src, "m.py")) == ["DET002"]
    # a local shadowing the name kills the match
    shadowed = ("def f(time):\n"
                "    time = 0.0\n"
                "    return time\n")
    assert lint_source(shadowed, "m.py") == []


def test_rule_disable_via_config():
    cfg = AnalysisConfig(disable=frozenset({"DET005"}))
    assert lint_source("def f(x):\n    return x == 1.0\n", "m.py", cfg) == []


# --------------------------------------------------------------------- CLI

def test_cli_exit_codes(capsys):
    assert cli_main([str(FIXTURES / "det001.py"), "--no-config"]) == 1
    capsys.readouterr()
    assert cli_main([str(FIXTURES / "suppressed.py"), "--no-config"]) == 0
    capsys.readouterr()
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "DET001" in out and "SUP002" in out
    assert cli_main([]) == 2                       # no paths
    assert cli_main(["/no/such/file.py"]) == 2
    assert cli_main([str(FIXTURES / "det001.py"),
                     "--select", "NOPE999"]) == 2


def test_cli_select_narrows_rules(capsys):
    rc = cli_main([str(FIXTURES / "det001.py"), "--no-config",
                   "--select", "DET005"])
    assert rc == 0
    capsys.readouterr()


def test_cli_json_output(capsys):
    rc = cli_main([str(FIXTURES), "--format", "json",
                   "--config", str(FIXTURES / "fixture_pyproject.toml"),
                   "--relative-to", str(FIXTURES)])
    assert rc == 1
    records = json.loads(capsys.readouterr().out)
    assert any(r["rule"] == "DET001" and r["path"] == "det001.py"
               for r in records)
    # JSON mode always includes suppressed findings, reasons attached
    assert any(r["suppressed"] and r["reason"] for r in records)


def test_render_text_shape(fixture_config):
    diags = lint_file(FIXTURES / "det001.py", fixture_config,
                      display_path="det001.py")
    lines = render_text(diags)
    assert lines == [
        "det001.py:6:12: DET001 process-global legacy RNG "
        "'numpy.random.rand': draws depend on hidden module state; use a "
        "seeded np.random.default_rng(seed) passed explicitly"]


# ------------------------------------------------------ the torch reading

TORCH_SUM = """import torch


def stage_total(c_x, mask):
    a = torch.sum(c_x)
    b = c_x.sum(dim=0)
    n = int(mask.sum())
    return a, b, n
"""


@pytest.mark.parametrize("path, want", [
    ("src/repro_torch/core/torch_engine.py", ["DET003", "DET003"]),
    ("src/repro_torch/kernels/group_reduce.py", ["DET003", "DET003"]),
    ("src/repro_torch/core/mlp.py", []),
])
def test_det003_reads_torch_sum_and_tensor_sum_in_port_scoring_modules(
        tmp_path, path, want):
    """``torch.sum`` resolves beside ``numpy.sum``, ``Tensor.sum`` is a
    method sum; both fire where the port's scoring modules live, the
    integer escape holds, and elsewhere nothing fires."""
    f = tmp_path / path
    f.parent.mkdir(parents=True)
    f.write_text(TORCH_SUM, encoding="utf-8")
    cfg = load_config(REPO / "pyproject.toml")
    diags = lint_paths([tmp_path / "src"], cfg, relative_to=tmp_path)
    assert _open_rules(diags) == want
    assert [d.line for d in diags] == [5, 6][:len(want)]


def test_port_det003_paths_join_every_loaded_config_only():
    cfg = load_config(FIXTURES / "fixture_pyproject.toml")
    assert cfg.det003_paths == ("det003.py",) + PORT_DET003_PATHS
    assert load_config(None).det003_paths == ()
    assert set(PORT_DET003_PATHS) == {"**/core/torch_engine.py",
                                      "**/kernels/group_reduce.py"}


@pytest.mark.parametrize("decorator", [
    "@torch.compile", "@torch.compile(fullgraph=True)", "@torch.jit.script",
    "@partial(torch.compile, mode='max-autotune')", "@compile",
])
def test_det007_host_effect_inside_torch_compiled_function(decorator):
    src = ("from functools import partial\n"
           "import torch\n"
           "from torch import compile\n\n\n"
           f"{decorator}\n"
           "def step(x):\n"
           "    print('tracing', x)\n"
           "    return x * 2\n")
    assert _open_rules(lint_source(src, "m.py")) == ["DET007"]
    plain = src.replace(decorator + "\n", "")
    assert _open_rules(lint_source(plain, "m.py")) == []


def test_det007_torch_jit_trace_through_partial():
    src = ("import functools\n"
           "import torch\n\n\n"
           "@functools.partial(torch.jit.trace, example_inputs=(1,))\n"
           "def step(x):\n"
           "    return open('log').read()\n")
    assert _open_rules(lint_source(src, "m.py")) == ["DET007"]


@pytest.mark.parametrize("call, want", [
    ("torch.randn(3)", ["DET001"]),
    ("torch.rand(3, 4)", ["DET001"]),
    ("torch.randint(0, 9, (3,))", ["DET001"]),
    ("torch.randperm(8)", ["DET001"]),
    ("torch.normal(0.0, 1.0, (3,))", ["DET001"]),
    ("torch.bernoulli(p)", ["DET001"]),
    ("torch.multinomial(p, 2)", ["DET001"]),
    ("torch.randn(3, generator=g)", []),
    ("torch.randperm(8, generator=g, device='cpu')", []),
    ("torch.zeros(3)", []),
])
def test_det001_torch_sampler_without_a_generator(call, want):
    src = ("import torch\n\n\n"
           "def draw(p, g):\n"
           f"    return {call}\n")
    assert _open_rules(lint_source(src, "m.py")) == want


def test_det001_resolves_torch_aliases():
    src = ("import torch as T\n"
           "from torch import randn\n\n\n"
           "def draw():\n"
           "    return T.rand(2), randn(2)\n")
    assert _open_rules(lint_source(src, "m.py")) == ["DET001", "DET001"]


# --------------------------------------------- the acceptance-criteria gate

def test_port_tree_lints_clean_under_both_readings():
    """``src/repro_torch`` lints clean with the port's linter and the
    repo's ``pyproject.toml`` (the port's scoring modules under DET003),
    and every suppression there carries a reason."""
    cfg = load_config(REPO / "pyproject.toml")
    diags = lint_paths([REPO / "src" / "repro_torch"], cfg, relative_to=REPO)
    open_diags = [d for d in diags if not d.suppressed]
    assert open_diags == [], render_text(open_diags)
    for d in diags:
        if d.suppressed:
            assert d.reason.strip(), f"reason-less suppression: {d}"


def test_python_m_repro_torch_analysis_exits_0_on_the_port():
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "src/repro_torch"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[repro_torch.analysis] 0 finding(s)" in proc.stderr
    assert "pyproject.toml" in proc.stderr

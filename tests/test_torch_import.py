"""The PyTorch package stands alone: it imports with ``jax`` and the JAX
package both blocked, and no source line of it (or of ``chip_smoke.py``
and the examples under ``examples/torch``) imports either."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")

BLOCKED = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\s|\.|,|$)"
    r"|from\s+repro(\s|\.))")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for top in (os.path.join(SRC, "repro_torch"),
                os.path.join(ROOT, "examples", "torch")):
        for d, _, files in os.walk(top):
            out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_package_imports_with_jax_and_reference_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.core, repro_torch.plan\n"
        "import repro_torch.convert, repro_torch.kernels.group_reduce\n"
        "import repro_torch.kernels._build, repro_torch.kernels.rmsnorm\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.selective_scan\n"
        "import repro_torch.models.layers, repro_torch.models.attention\n"
        "import repro_torch.models.mamba, repro_torch.models.sharding\n"
        "import repro_torch.models.transformer, repro_torch.models.model\n"
        "import repro_torch.launch.steps, repro_torch.launch.generate\n"
        "import repro_torch.analysis, repro_torch.analysis.cli\n"
        "import repro_torch.analysis.plan_verifier\n"
        "import repro_torch.runtime.elastic, repro_torch.runtime.churn\n"
        "import repro_torch.service, repro_torch.service.server\n"
        "import repro_torch.service.client, repro_torch.service.wire\n"
        "import repro_torch.service.cache, repro_torch.service.__main__\n"
        "import repro_torch.optim.adamw, repro_torch.optim.compression\n"
        "import repro_torch.checkpoint.manager, repro_torch.data.pipeline\n"
        "import repro_torch.runtime.trainer, repro_torch.launch.train\n"
        "import repro_torch.launch.mesh, repro_torch.launch.collectives\n"
        "import repro_torch.launch.pipeline, repro_torch.launch.pp_step\n"
        "import repro_torch.launch.serve\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('repro.') or "
        "m.startswith('triton')]\n"
        "assert bad == ['jax'], bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_no_source_line_imports_jax_or_the_reference_package():
    files = _port_sources()
    assert len(files) > 35
    assert sum("examples" in f for f in files) == 4, files
    bad = []
    for path in files:
        with open(path) as f:
            for no, line in enumerate(f, 1):
                if BLOCKED.match(line):
                    bad.append(f"{os.path.relpath(path, ROOT)}:{no}: "
                               f"{line.strip()}")
    assert not bad, bad


@pytest.mark.parametrize("line,blocked", [
    ("import jax", True), ("from jax import numpy", True),
    ("    import jax.numpy as jnp", True), ("import repro", True),
    ("from repro.core import x", True), ("from repro import configs", True),
    ("import repro_torch", False), ("from repro_torch.core import x", False),
    ("import jaxtyping", False), ("# import jax", False),
])
def test_the_import_pattern_itself(line, blocked):
    assert bool(BLOCKED.match(line)) == blocked


def test_cli_show_and_diff_run_without_a_device(tmp_path):
    """``show``, ``diff`` and ``lint`` read artifacts only; ``plan``
    without a card must fail rather than fall back to the CPU."""
    golden = os.path.join(ROOT, "tests", "data", "golden_plan_v5.json")
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    run = lambda *a: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "repro_torch.plan", *a], env=env,
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    show = run("show", golden)
    assert show.returncode == 0 and "best:" in show.stdout
    # the golden plan's model is not a registry name: name one to price it
    diff = run("diff", golden, golden, "--format", "json", "--config",
               "qwen2-7b")
    assert diff.returncode == 0 and '"ranks_moved": 0' in diff.stdout
    lint = run("lint", golden)
    assert lint.returncode == 0 and "OK" in lint.stderr, lint.stderr
    plan = run("plan", "--config", "qwen2-7b", "--reduced", "--nodes", "2",
               "--seq", "128", "--bs-global", "64", "--sa-iters", "20")
    assert plan.returncode != 0 and "CUDA" in plan.stderr
    ok = run("plan", "--config", "qwen2-7b", "--reduced", "--nodes", "2",
             "--seq", "128", "--bs-global", "64", "--sa-iters", "20",
             "--device", "cpu", "-o", "p.json")
    assert ok.returncode == 0, ok.stderr
    assert (tmp_path / "p.json").exists()

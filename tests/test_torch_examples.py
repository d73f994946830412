"""The examples of the PyTorch package (``examples/torch/``) against the
JAX package on the CPU, and the deprecated ``launch/serve.py`` shim.

Every example runs here with ``device="cpu"`` (or ``--device cpu``) at a
small size and under iteration-bound SA budgets (``sa_iters`` set, the
wall-clock cap out of reach), on inputs both packages draw from the same
seeds: the reference's weights come across through
``convert.params_from_reference``, the synthetic corpus is the same
NumPy sequence in both.

- quickstart: the plan byte-equal (apart from the recorded backend) to
  the reference ``Planner(PipetteStrategy())`` plan on its NumPy backend;
  each step's loss within ``LOSS_TOL`` (``tests/test_torch_train.py``'s
  1e-4 of ``1 + |loss|``, which ``tests/test_torch_train_steps.py`` holds
  the same step to) of the reference's ``make_train_step``; the greedy
  tokens equal the reference's ``prefill`` and ``decode_step`` on the
  trained parameters, or within ``LOGIT_TOL`` (2e-3 of ``1 + |l|``, the
  float32 logits' tolerance of ``tests/test_torch_models.py``) of its
  largest logit (a near-tie, ``tests/test_torch_models.py``'s rule).
- elastic_failover: both replans byte-equal to ``repro.runtime.elastic.
  replan``; the restored parameters and AdamW state bit-equal to the
  saved.
- train_gpt (a small ``gpt-demo``): a ``--fail-at`` run resumed with
  ``--resume`` ends on the straight run's checkpoint bit for bit; the
  ``--configure`` plan byte-equal to the reference's.
- configure_cluster: the five strategies' ranked lists and measured
  iteration times equal the reference strategies' and ``measure``'s;
  ``degraded_host_demo``'s two simulated times equal the reference's.
- Each example raises without a CUDA device unless told ``cpu``.
"""
import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import (MID_RANGE as R_MID_RANGE,
                        MID_RANGE_DEGRADED as R_MID_RANGE_DEGRADED)
from repro.core import (AMPStrategy as RAMP, Budget as RBudget,
                        ExhaustiveStrategy as RExhaustive,
                        MegatronStrategy as RMegatron, Planner as RPlanner,
                        PlanRequest as RPlanRequest,
                        PipetteStrategy as RPipette,
                        VarunaStrategy as RVaruna, Workload as RWorkload)
from repro.core import (anneal_multistart as r_anneal_multistart,
                        build_profile as r_build_profile,
                        compute_slowdowns as r_compute_slowdowns,
                        default_mapping as r_default_mapping,
                        fit_memory_estimator as r_fit_memory_estimator,
                        ground_truth_memory as r_ground_truth_memory,
                        measure as r_measure,
                        profile_bandwidth as r_profile_bandwidth,
                        true_bandwidth_matrix as r_true_bandwidth_matrix)
from repro.core.simulator import Conf as RConf
from repro.data.pipeline import DataLoader as RLoader
from repro.data.pipeline import LoaderConfig as RLoaderConfig
from repro.data.pipeline import SyntheticCorpus as RCorpus
from repro.launch.steps import make_train_step as r_make_train_step
from repro.models import model as RM
from repro.models.config import ModelConfig as RModelConfig
from repro.models.sharding import ShardCtx as RShardCtx
from repro.optim.adamw import AdamW as RAdamW
from repro.runtime.elastic import replan as r_replan
from repro_torch import configs
from repro_torch._tree import leaves
from repro_torch.convert import estimator_from_reference, params_from_reference
from repro_torch.core import (MID_RANGE, MID_RANGE_DEGRADED, Budget,
                              PlanRequest, SearchSpace, Workload,
                              profile_bandwidth, true_bandwidth_matrix)
from repro_torch.launch import train as train_cli
from test_torch_train import LOSS_TOL

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
EXAMPLES = ("quickstart", "train_gpt", "elastic_failover",
            "configure_cluster")
LOGIT_TOL = 2e-3
#: SA iterations a candidate on the 8 best pre-scored candidates, the
#: wall-clock cap out of reach
SA = dict(sa_seconds=600.0, sa_iters=50, sa_topk=8)
QS_STEPS = 4
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs several workers side by side; keep each example to
    two intra-op threads instead of one per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _example(name):
    """``examples/torch/<name>.py`` as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}",
        os.path.join(ROOT, "examples", "torch", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _strip_backend(text: str) -> str:
    d = json.loads(text)
    d["provenance"]["budget"].pop("backend")
    return json.dumps(d, sort_keys=True)


def _ref_params(rcfg):
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    return rp, params_from_reference(jax.tree.map(np.asarray, rp), CPU)


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _bit_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def test_quickstart_matches_reference():
    qs = _example("quickstart")
    rcfg = ref_configs.get("qwen2-7b").reduced()
    cfg = configs.get("qwen2-7b").reduced()
    rp, params = _ref_params(rcfg)
    res = qs.run(cfg, params, Budget(**SA), QS_STEPS, CPU)

    # the plan: the reference's Planner on its NumPy backend
    spec = R_MID_RANGE.with_nodes(qs.NODES)
    bw, _ = r_profile_bandwidth(spec)
    want = RPlanner(RPipette()).plan(RPlanRequest(
        workload=RWorkload(rcfg, 128, 64), spec=spec,
        budget=RBudget(backend="numpy", **SA)), bw)
    assert _strip_backend(res["plan_json"]) == _strip_backend(want.to_json())

    # the training steps: the reference's make_train_step, same n_micro
    n_micro = max(1, min(4, want.result.best.conf.n_mb))
    assert res["n_micro"] == n_micro
    ropt = RAdamW(lr=2e-3, weight_decay=0.0)
    rstate = ropt.init(rp)
    rstep = jax.jit(r_make_train_step(rcfg, RShardCtx(), ropt,
                                      n_micro=n_micro))
    loader = RLoader(RCorpus(rcfg.vocab_size, seed=0, noise=0.02),
                     RLoaderConfig(8, 64))
    for s in range(QS_STEPS):
        rp, rstate, m = rstep(rp, rstate, loader.batch_at(s))
        want_loss = float(m["loss"])
        assert abs(res["losses"][s] - want_loss) <= \
            LOSS_TOL * (1 + abs(want_loss)), (s, res["losses"][s], want_loss)

    # the greedy tokens: the reference's prefill and decode steps on the
    # port's trained parameters, fed the port's tokens
    trained = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()),
                           res["params"])
    prompts = jnp.asarray(res["prompts"].numpy().astype(np.int32))
    last, cache = RM.prefill(trained, rcfg, RShardCtx(), prompts)
    cache = {k: (jnp.pad(v, [(0, 0), (0, 0), (0, qs.DECODE_STEPS)]
                         + [(0, 0)] * (v.ndim - 3))
                 if k in ("k", "v") else v) for k, v in cache.items()}
    toks = res["tokens"]
    assert len(toks) == qs.DECODE_STEPS + 1
    step = jax.jit(lambda p, c, t, pos: RM.decode_step(
        p, rcfg, RShardCtx(), t, c, pos))
    logits = [np.asarray(last)]
    for i in range(qs.DECODE_STEPS):
        # the first row's token (the rows do not meet in attention)
        tok = jnp.full((prompts.shape[0], 1), toks[i], jnp.int32)
        lg, cache = step(trained, cache, tok, jnp.int32(qs.PROMPT_LEN + i))
        logits.append(np.asarray(lg))
    for i, (lg, tok) in enumerate(zip(logits, toks)):
        row = lg[0]
        top = row.max()
        assert tok == int(np.argmax(row)) or \
            top - row[tok] <= LOGIT_TOL * (1 + abs(top)), (i, tok, top,
                                                          row[tok])


# ---------------------------------------------------------------------------
# elastic_failover
# ---------------------------------------------------------------------------

def test_elastic_failover_replans_match_reference_and_restore_bitwise(
        tmp_path):
    ef = _example("elastic_failover")
    rcfg = ref_configs.get("qwen2-7b").reduced()
    cfg = configs.get("qwen2-7b").reduced()
    _, params = _ref_params(rcfg)
    res = ef.run(cfg, params, replan_kw=SA, ckpt_dir=str(tmp_path),
                 steps=3, more=2, device=CPU)
    w = RWorkload(rcfg, 64, 64)
    for nodes, key in ((4, "plan4"), (3, "plan3")):
        want = r_replan(w, R_MID_RANGE, healthy_nodes=nodes,
                        backend="numpy", **SA)
        assert _strip_backend(res[key].plan.to_json()) \
            == _strip_backend(want.plan.to_json()), nodes
    assert res["at"] == 3
    _bit_equal(res["saved"], res["restored"])
    assert os.path.exists(res["artifact"])
    assert len(res["more_losses"]) == 2


# ---------------------------------------------------------------------------
# train_gpt
# ---------------------------------------------------------------------------

TINY = dict(n_layers=2, d_model=64, n_heads=2)


def test_train_gpt_resume_is_bitwise_and_plan_matches_reference(
        tmp_path, monkeypatch):
    """A small ``gpt-demo`` (2 layers of width 64, checkpoints every 2
    steps): a straight run of 5 steps, and a run that fails at step 3 and
    resumes from its step-2 checkpoint, end on the same checkpoint (the
    parameters and AdamW's state) bit for bit."""
    tg = _example("train_gpt")
    monkeypatch.setitem(tg.SIZES, "demo", TINY)
    monkeypatch.setattr(tg, "CKPT_EVERY", 2)
    monkeypatch.setattr(train_cli, "CONFIGURE_BUDGET", SA)
    monkeypatch.setattr(configs, "PAPER_GPTS", dict(configs.PAPER_GPTS))
    base = ["--steps", "5", "--device", "cpu"]
    for d in ("straight", "resumed"):
        (tmp_path / d).mkdir()
    monkeypatch.chdir(tmp_path / "straight")
    assert tg.main(base) == 0
    monkeypatch.chdir(tmp_path / "resumed")
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        tg.main(base + ["--fail-at", "3"])
    assert tg.main(base + ["--resume"]) == 0
    ck = {d: tmp_path / d / "checkpoints" / "gpt-demo"
          for d in ("straight", "resumed")}
    with np.load(ck["straight"] / "step_5" / "arrays.npz") as a, \
            np.load(ck["resumed"] / "step_5" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes(), k

    # --configure: the reference Planner on its NumPy backend
    rcfg = RModelConfig(name="gpt-demo", family="dense", n_kv_heads=2,
                        d_ff=256, vocab_size=4096, dtype="float32",
                        remat=False, **TINY)
    assert dataclasses.asdict(tg.gpt_demo()) == dataclasses.asdict(rcfg)
    spec = R_MID_RANGE.with_nodes(8)
    bw, _ = r_profile_bandwidth(spec)
    want = RPlanner(RPipette()).plan(RPlanRequest(
        workload=RWorkload(rcfg, 256, 64), spec=spec,
        budget=RBudget(backend="numpy", **SA), seed=0), bw)
    got = (ck["straight"] / "plan.json").read_text()
    assert _strip_backend(got) == _strip_backend(want.to_json())


# ---------------------------------------------------------------------------
# configure_cluster
# ---------------------------------------------------------------------------

def _ranked(plan):
    return [(dataclasses.asdict(c.conf), np.asarray(c.mapping).tolist(),
             c.latency) for c in plan.result.ranked]


def test_configure_cluster_strategies_match_reference():
    """The strategy loop on two nodes of the mid-range cluster with
    reduced gpt-3.1b and the reference's estimator (300 steps on both
    nodes), carried across: each strategy's ranking and the iteration
    time measured for its first runnable candidate equal the
    reference's."""
    cc = _example("configure_cluster")
    rcfg = ref_configs.get("gpt-3.1b").reduced()
    cfg = configs.get("gpt-3.1b").reduced()
    rspec, spec = R_MID_RANGE.with_nodes(2), MID_RANGE.with_nodes(2)
    rw, w = RWorkload(rcfg, 2048, 256), Workload(cfg, 2048, 256)
    est_r = r_fit_memory_estimator(
        [RWorkload(rcfg, 2048, b) for b in (64, 128, 256, 512)], rspec,
        fit_nodes=2, steps=300, residual=True)
    fields = {f.name: getattr(est_r, f.name)
              for f in dataclasses.fields(est_r)
              if f.name not in ("params", "x_mean", "x_std", "y_mean",
                                "y_std")}
    est = estimator_from_reference(
        [{k: np.asarray(v) for k, v in lay.items()} for lay in est_r.params],
        est_r.x_mean, est_r.x_std, est_r.y_mean, est_r.y_std, **fields)
    bw_true, bw_meas = true_bandwidth_matrix(spec), profile_bandwidth(spec)[0]
    np.testing.assert_array_equal(bw_true, r_true_bandwidth_matrix(rspec))
    req = PlanRequest(workload=w, spec=spec, space=SearchSpace(),
                      budget=Budget(**SA), seed=1)
    got = cc.compare(req, est, bw_meas, bw_true, CPU)

    rreq = RPlanRequest(workload=rw, spec=rspec,
                        budget=RBudget(backend="numpy", **SA), seed=1)
    ref = [RMegatron(bw_true=bw_true), RVaruna(), RAMP(),
           RExhaustive(estimator=est_r, mem_limit=rspec.mem_floor),
           RPipette(estimator=est_r, mem_limit=rspec.mem_floor)]
    assert [lbl for lbl, _ in cc.strategies(est, spec, bw_true)] == \
        list(got["plans"])
    for (label, plan), strategy, row in zip(got["plans"].items(), ref,
                                            got["rows"]):
        want = RPlanner(strategy).plan(rreq, bw_meas)
        assert _ranked(plan) == _ranked(want), label
        trials = next(i + 1 for i, c in enumerate(want.result.ranked)
                      if r_ground_truth_memory(rw, c.conf, rspec)
                      <= rspec.mem_floor)
        best = want.result.ranked[trials - 1]
        assert row[0].startswith(label) and (trials > 1) == (
            "trials" in row[0])
        assert row[1] == plan.result.ranked[trials - 1].conf
        assert row[2] == r_measure(best.conf, best.mapping, rw, rspec,
                                   bw_true), label


def test_degraded_host_demo_matches_reference():
    """The compute-aware dedication of the degraded fleet's deep pipeline
    (reduced gpt-3.1b at 24 layers) with 200 SA iterations that bind (the
    clock's cap out of reach): the blind and the aware simulated times
    equal the reference's, computed by its own functions."""
    cc = _example("configure_cluster")
    rcfg = ref_configs.get("gpt-3.1b").reduced()
    cfg = configs.get("gpt-3.1b").reduced()
    spec, rspec = MID_RANGE_DEGRADED, R_MID_RANGE_DEGRADED
    bw_meas, bw_true = profile_bandwidth(spec)[0], true_bandwidth_matrix(spec)
    blind, aware = cc.degraded_host_demo(
        Workload(cfg, 2048, 256), spec, bw_meas, bw_true, time_limit_s=600.0,
        max_iters=200, log=lambda line: None)

    w24 = RWorkload(dataclasses.replace(rcfg, name=rcfg.name + "-24L",
                                        n_layers=24), 2048, 32)
    conf = RConf(16, 8, 1, 2, 32)
    sa = r_anneal_multistart(
        conf, bw_meas, r_build_profile(w24, rspec, conf), rspec, n_chains=2,
        time_limit_s=600.0, max_iters=200, seed=0,
        init_perm=np.argsort(r_compute_slowdowns(rspec), kind="stable"))
    assert sa.iters == 200
    assert aware == r_measure(conf, sa.mapping, w24, rspec, bw_true, seed=1)
    assert blind == r_measure(conf, r_default_mapping(conf), w24, rspec,
                              bw_true, seed=1)
    assert aware < blind


# ---------------------------------------------------------------------------
# the device rule, the shim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", EXAMPLES)
def test_example_needs_a_device_unless_told_cpu(name, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(configs, "PAPER_GPTS", dict(configs.PAPER_GPTS))
    with pytest.raises(RuntimeError, match="CUDA device"):
        _example(name).main([])


def test_serve_shim_is_the_generate_cli():
    from repro_torch.launch import generate, serve
    assert serve.main is generate.main

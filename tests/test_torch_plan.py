"""The slice as a whole: the port's ``Planner.plan`` on its torch backend
against the JAX package's on its NumPy backend.

Without an estimator the serialized Plans must be byte-identical once the
one field that names the executor (``provenance.budget.backend``) is
dropped.  With an estimator (fitted by the reference, carried across) the
memory predictions pass through float32 matrix products that the two
frameworks sum in different orders, and ``mem_pred`` is serialized — so
bytes cannot be promised there; the test holds the survivor set, the best
configuration, its mapping and latency (hex) equal, and ``mem_pred`` to
the forward's tolerance.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core import cluster as r_cluster
from repro.core import memory as r_memory
from repro.core import plan as r_plan
from repro.core import search as r_search
from repro.core import simulator as r_sim
from repro.models.config import ModelConfig as RModelConfig
from repro_torch.convert import estimator_from_reference
from repro_torch.core import cluster as t_cluster
from repro_torch.core import plan as t_plan
from repro_torch.core import search as t_search
from repro_torch.core import simulator as t_sim
from repro_torch.models.config import ModelConfig as TModelConfig

GPT_KW = dict(name="g12", family="dense", n_layers=12, d_model=1024,
              n_heads=16, n_kv_heads=16, d_ff=4096, vocab_size=32000)
GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "golden_plan_v5.json")


def _mixed(mod):
    return mod.mixed_fleet_spec("det-mixed-16x1", 16,
                                (mod.A100_TIER, mod.V100_TIER), (0.5, 0.5),
                                gpus_per_node=1, seed=31)


def _req(pmod, smod, cfg_cls, spec, backend, hierarchical=None, n_chains=2):
    return pmod.PlanRequest(
        workload=smod.Workload(cfg_cls(**GPT_KW), 2048, 32), spec=spec,
        space=pmod.SearchSpace(max_micro=2),
        budget=pmod.Budget(sa_seconds=60.0, sa_iters=40, n_chains=n_chains,
                           sa_topk=2, backend=backend,
                           hierarchical=hierarchical),
        seed=11)


def _strip_backend(text, expect):
    d = json.loads(text)
    assert d["provenance"]["budget"].pop("backend") == expect
    return json.dumps(d, sort_keys=True, indent=2)


#: The four requests of the reference's backend-determinism suite.
REQUESTS = {
    "uniform": ("uniform", {}),
    "mixed": ("mixed", {}),
    "hierarchical": ("mixed", {"hierarchical": True}),
    "three-chains": ("mixed", {"n_chains": 3}),
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_torch_plan_bytes_equal_reference_numpy_plan(name):
    kind, kw = REQUESTS[name]
    r_spec = r_cluster.MID_RANGE if kind == "uniform" else _mixed(r_cluster)
    t_spec = t_cluster.MID_RANGE if kind == "uniform" else _mixed(t_cluster)
    bw, _ = r_cluster.profile_bandwidth(r_spec)
    assert np.array_equal(bw, t_cluster.profile_bandwidth(t_spec)[0])
    want = r_plan.Planner(r_plan.PipetteStrategy()).plan(
        _req(r_plan, r_sim, RModelConfig, r_spec, "numpy", **kw),
        bw).to_json()
    got_plan = t_plan.Planner(t_plan.PipetteStrategy(), device="cpu").plan(
        _req(t_plan, t_sim, TModelConfig, t_spec, "torch", **kw), bw)
    got = got_plan.to_json()
    assert want != got                   # the backend field does differ...
    assert _strip_backend(want, "numpy") == _strip_backend(got, "torch")
    assert got_plan.overhead.sa_accepted > 0
    # the port's own host engine writes the same bytes too
    host = t_plan.Planner(t_plan.PipetteStrategy()).plan(
        _req(t_plan, t_sim, TModelConfig, t_spec, "numpy", **kw),
        bw).to_json()
    assert host == want


def test_legacy_backend_none_equals_reference_legacy_plan():
    r_spec, t_spec = _mixed(r_cluster), _mixed(t_cluster)
    bw, _ = r_cluster.profile_bandwidth(r_spec)
    want = r_plan.Planner(r_plan.PipetteStrategy()).plan(
        _req(r_plan, r_sim, RModelConfig, r_spec, None), bw).to_json()
    got = t_plan.Planner(t_plan.PipetteStrategy()).plan(
        _req(t_plan, t_sim, TModelConfig, t_spec, None), bw).to_json()
    assert got == want


def test_plan_with_carried_across_estimator():
    r_spec = r_cluster.MID_RANGE.with_nodes(4)
    t_spec = t_cluster.MID_RANGE.with_nodes(4)
    kw = dict(name="gpt-1.1b", family="dense", n_layers=24, d_model=1920,
              n_heads=20, n_kv_heads=20, d_ff=7680, vocab_size=51200)
    r_w = r_sim.Workload(RModelConfig(**kw), 2048, 128)
    t_w = t_sim.Workload(TModelConfig(**kw), 2048, 128)
    est = r_memory.fit_memory_estimator([r_w], r_spec, fit_nodes=2,
                                        steps=300, residual=True)
    fields = {f.name: getattr(est, f.name) for f in dataclasses.fields(est)
              if f.name not in ("params", "x_mean", "x_std", "y_mean",
                                "y_std")}
    twin = estimator_from_reference(
        [{k: np.asarray(v) for k, v in l.items()} for l in est.params],
        est.x_mean, est.x_std, est.y_mean, est.y_std, **fields)
    bw, _ = r_cluster.profile_bandwidth(r_spec)
    budget = dict(sa_seconds=60.0, sa_iters=60, n_chains=2, sa_topk=3)
    want = r_plan.Planner(r_plan.PipetteStrategy(estimator=est)).plan(
        r_plan.PlanRequest(r_w, r_spec,
                           budget=r_plan.Budget(backend="numpy", **budget),
                           seed=2), bw)
    got = t_plan.Planner(t_plan.PipetteStrategy(estimator=twin),
                         device="cpu").plan(
        t_plan.PlanRequest(t_w, t_spec,
                           budget=t_plan.Budget(backend="torch", **budget),
                           seed=2), bw)
    assert got.feasible and want.feasible
    # the estimator really pruned, and pruned the same set
    assert 0 < want.overhead.n_candidates < want.overhead.n_enumerated
    assert got.overhead.counts() == want.overhead.counts()
    assert [str(c.conf) for c in got.result.ranked] == \
        [str(c.conf) for c in want.result.ranked]
    assert str(got.conf) == str(want.conf)
    assert np.array_equal(got.mapping, want.mapping)
    assert float(got.latency).hex() == float(want.latency).hex()
    for a, b in zip(got.result.ranked, want.result.ranked):
        assert float(a.latency).hex() == float(b.latency).hex()
        # serialized, but float32-forward dependent: a tolerance, not bytes
        assert a.mem_pred == pytest.approx(b.mem_pred, rel=2e-5)
    assert got.to_json_dict()["provenance"]["estimator"] == \
        want.to_json_dict()["provenance"]["estimator"]


def test_golden_v5_plan_round_trips_byte_for_byte(tmp_path):
    with open(GOLDEN) as f:
        text = f.read()
    plan = t_plan.Plan.load(GOLDEN)
    assert plan.to_json() == text
    out = tmp_path / "again.json"
    plan.save(out)
    assert out.read_text() == text
    ref = r_plan.Plan.load(GOLDEN)
    assert plan.fingerprint() == ref.fingerprint()
    assert str(plan.conf) == str(ref.conf)
    assert t_plan.PLAN_SCHEMA_VERSION == r_plan.PLAN_SCHEMA_VERSION == 5
    # and the migration-cost view of a plan against itself is a no-op
    assert plan.diff(plan, cfg=TModelConfig(**GPT_KW)).is_noop


def test_reference_written_plan_loads_and_diffs_in_the_port(tmp_path):
    r_spec, t_spec = _mixed(r_cluster), _mixed(t_cluster)
    bw, _ = r_cluster.profile_bandwidth(r_spec)
    paths = []
    for seed_chains in (2, 3):
        p = tmp_path / f"ref{seed_chains}.json"
        r_plan.Planner(r_plan.PipetteStrategy()).plan(
            _req(r_plan, r_sim, RModelConfig, r_spec, "numpy",
                 n_chains=seed_chains), bw).save(p)
        paths.append(p)
    a, b = (t_plan.Plan.load(p) for p in paths)
    assert a.to_json() == paths[0].read_text()
    cfg_r, cfg_t = RModelConfig(**GPT_KW), TModelConfig(**GPT_KW)
    want = r_plan.Plan.load(paths[0]).diff(r_plan.Plan.load(paths[1]),
                                           cfg=cfg_r)
    got = a.diff(b, cfg=cfg_t)
    assert (got.ranks_moved, got.bytes_migrated, got.downtime_s) == \
        (want.ranks_moved, want.bytes_migrated, want.downtime_s)


def test_budget_backend_set_and_default():
    assert t_plan.Budget().backend == "torch"
    assert t_plan.Budget(backend=None).backend is None
    assert t_plan.Budget(backend="numpy").backend == "numpy"
    with pytest.raises(ValueError, match="backend"):
        t_plan.Budget(backend="jax")
    # no device field: the budget is serialized into every plan
    assert [f.name for f in dataclasses.fields(t_plan.Budget)] == \
        [f.name for f in dataclasses.fields(r_plan.Budget)]


def test_default_device_is_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    t_spec = _mixed(t_cluster)
    bw, _ = t_cluster.profile_bandwidth(t_spec)
    req = _req(t_plan, t_sim, TModelConfig, t_spec, "torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_plan.Planner(t_plan.PipetteStrategy()).plan(req, bw)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_search.run_search(req, bw)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_search.configure(req.workload, t_spec, bw, sa_iters=10)
    # the strategy's own device and the Planner's override both reach it
    a = t_plan.Planner(t_plan.PipetteStrategy(device="cpu")).plan(req, bw)
    b = t_plan.Planner(t_plan.PipetteStrategy(), device="cpu").plan(req, bw)
    assert a.to_json() == b.to_json()


def test_configure_shim_matches_reference_shim():
    r_spec, t_spec = _mixed(r_cluster), _mixed(t_cluster)
    bw, _ = r_cluster.profile_bandwidth(r_spec)
    kw = dict(sa_seconds=60.0, sa_iters=30, sa_topk=2, max_micro=2, seed=4)
    want = r_search.configure(r_sim.Workload(RModelConfig(**GPT_KW), 2048,
                                             32), r_spec, bw, **kw)
    got = t_search.configure(t_sim.Workload(TModelConfig(**GPT_KW), 2048,
                                            32), t_spec, bw, backend=None,
                             **kw)
    assert [float(c.latency).hex() for c in got.ranked] == \
        [float(c.latency).hex() for c in want.ranked]
    assert np.array_equal(got.best.mapping, want.best.mapping)


def test_baseline_strategies_agree():
    r_spec, t_spec = _mixed(r_cluster), _mixed(t_cluster)
    bw, _ = r_cluster.profile_bandwidth(r_spec)
    for name in ("amp", "varuna", "megatron-lm", "exhaustive"):
        want = r_plan.Planner(r_plan.STRATEGIES[name]()).plan(
            _req(r_plan, r_sim, RModelConfig, r_spec, None), bw).to_json()
        got = t_plan.Planner(t_plan.STRATEGIES[name]()).plan(
            _req(t_plan, t_sim, TModelConfig, t_spec, None), bw).to_json()
        assert got == want, name

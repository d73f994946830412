"""Elastic replanning of the PyTorch package (``runtime/elastic.py``).

The cases of the JAX package's ``tests/test_runtime.py`` elastic part, on
the port: ``replan`` after a node is lost, degraded or added, estimator
staleness and refit, the request-knob routing, node-subset survivors and
incremental (incumbent-seeded) replanning.  Every call names
``device="cpu"``; the SA engine is the port's default ``backend="torch"``
unless a case routes another.  One case holds a torch replan byte-equal
to the JAX package's NumPy replan of the same request, and one shows that
``device=None`` raises without a CUDA device.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import MID_RANGE as R_MID_RANGE
from repro.core import Workload as RWorkload
from repro.models.config import ModelConfig as RModelConfig
from repro.runtime.elastic import replan as r_replan
from repro_torch.core import (MID_RANGE, MIXED_A100_V100, Workload,
                              fit_memory_estimator)
from repro_torch.core.plan import Budget, SearchSpace
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.elastic import replan, replan_on

CFG_KW = dict(name="g", family="dense", n_layers=16, d_model=1024,
              n_heads=16, n_kv_heads=16, d_ff=4096, vocab_size=32000)
CPU = "cpu"


def _tiny_workload():
    return Workload(ModelConfig(**CFG_KW), 1024, 64)


def test_elastic_replan_degraded_cluster():
    w = _tiny_workload()
    plan = replan(w, MID_RANGE.with_nodes(4), healthy_nodes=3,
                  sa_seconds=0.1, sa_iters=200, device=CPU)
    best = plan.result.best
    assert best.conf.n_gpus == 3 * 8
    m = best.mapping.reshape(-1)
    assert sorted(m.tolist()) == list(range(24))


def test_elastic_replan_16_to_12_nodes_keeps_matching_estimator():
    """A 16 -> 12 node shrink keeps gpu_mem and gpus_per_node, so the
    estimator fit on the original spec stays valid and is not refit."""
    w = _tiny_workload()
    spec = MID_RANGE.with_nodes(16)
    est = fit_memory_estimator([w], spec, fit_nodes=2, steps=1500,
                               residual=True, device=CPU)
    assert est.fit_gpu_mem == spec.gpu_mem
    plan = replan(w, spec, healthy_nodes=12, estimator=est,
                  sa_seconds=0.05, sa_iters=60, sa_topk=2, device=CPU)
    assert not plan.refit_estimator
    assert plan.n_gpus == 12 * 8
    assert plan.result.best.conf.n_gpus == 96


def test_elastic_replan_refits_estimator_on_changed_hardware():
    """Replacement nodes with a different per-GPU memory invalidate the
    old fit: replan refits, on the device it was given."""
    w = _tiny_workload()
    spec = MID_RANGE.with_nodes(4)
    est = fit_memory_estimator([w], spec, fit_nodes=1, steps=600,
                               residual=True, device=CPU)
    shrunk = dataclasses.replace(spec, gpu_mem=spec.gpu_mem / 2)
    plan = replan(w, shrunk, healthy_nodes=3, estimator=est,
                  sa_seconds=0.05, sa_iters=60, sa_topk=2, refit_steps=600,
                  device=CPU)
    assert plan.refit_estimator
    assert plan.result.best is not None
    assert plan.result.best.conf.n_gpus == 24


def test_elastic_replan_refits_3d_estimator_for_4d_search():
    """A 3D-fit estimator cannot score cp>1 candidates; replan(max_cp>1)
    refits (cp-aware) instead of failing in predict_batch."""
    w = _tiny_workload()
    spec = MID_RANGE.with_nodes(4)
    est = fit_memory_estimator([w], spec, fit_nodes=1, steps=600,
                               residual=True, device=CPU)
    assert not est.with_cp
    plan = replan(w, spec, healthy_nodes=3, estimator=est,
                  sa_seconds=0.05, sa_iters=60, sa_topk=2, refit_steps=600,
                  max_cp=2, device=CPU)
    assert plan.refit_estimator
    assert plan.result.best is not None
    assert any(c.conf.cp > 1 for c in plan.result.ranked)


@pytest.mark.parametrize("kw", [
    {"partition": "dp"},
    {"max_vpp": 2},
    {"backend": "numpy"},
    {"backend": "torch"},
    {"hierarchical": False},
    {"warm_start": tuple(range(24))},
], ids=lambda kw: f"{next(iter(kw))}-{next(iter(kw.values()))}"[:24])
def test_replan_routes_every_new_request_knob(kw):
    """The replan() kwarg split is derived from the SearchSpace/Budget
    dataclass fields, so every request knob routes to its dataclass."""
    ep = replan(_tiny_workload(), MID_RANGE.with_nodes(4), healthy_nodes=3,
                sa_seconds=0.5, sa_iters=60, sa_topk=1, device=CPU, **kw)
    assert ep.plan.feasible
    space_fields = {f.name for f in dataclasses.fields(SearchSpace)}
    for k, v in kw.items():
        dest = (ep.plan.provenance.space if k in space_fields
                else ep.plan.provenance.budget)
        assert getattr(dest, k) == v, k


def test_replan_backend_torch_with_vpp_end_to_end():
    """The torch SA backend and an interleaved-1F1B space through an
    elastic replan."""
    ep = replan(_tiny_workload(), MID_RANGE.with_nodes(4), healthy_nodes=3,
                sa_seconds=1.0, sa_iters=60, sa_topk=1, backend="torch",
                max_vpp=2, device=CPU)
    assert ep.plan.feasible
    assert ep.plan.provenance.budget.backend == "torch"
    assert ep.plan.provenance.space.max_vpp == 2
    assert any(c.conf.vpp > 1 for c in ep.result.ranked)


def test_replan_unknown_kwarg_still_raises():
    with pytest.raises(TypeError, match="unknown replan"):
        replan(_tiny_workload(), MID_RANGE.with_nodes(4), healthy_nodes=3,
               sa_seconds=0.05, device=CPU, definitely_not_a_knob=1)


def test_with_nodes_grow_extends_tier_pattern():
    """The grow path of a tiered spec cycles the tier pattern, and works
    end to end through replan."""
    spec = MIXED_A100_V100
    pat = spec.node_tiers
    grown = spec.with_nodes(spec.n_nodes + 4)
    assert grown.n_nodes == spec.n_nodes + 4
    assert len(grown.node_tiers) == grown.n_nodes
    reps = -(-grown.n_nodes // len(pat))
    assert grown.node_tiers == (pat * reps)[:grown.n_nodes]
    small = spec.with_nodes(2)
    ep = replan(_tiny_workload(), small, healthy_nodes=3, sa_seconds=0.5,
                sa_iters=40, sa_topk=1, device=CPU)
    assert ep.n_gpus == 3 * small.gpus_per_node


def test_replan_node_subset_keeps_surviving_tiers():
    """"node 1 of 4 died" keeps nodes 0, 2, 3 with their own tiers."""
    spec = MIXED_A100_V100.with_nodes(4)
    ep = replan(_tiny_workload(), spec, healthy_nodes=[0, 2, 3],
                sa_seconds=0.5, sa_iters=40, sa_topk=1, device=CPU)
    assert ep.n_gpus == 3 * spec.gpus_per_node
    tiers = ep.plan.provenance.tiers
    assert tiers is not None
    assert tuple(tiers["node_tiers"]) == tuple(
        spec.node_tiers[i] for i in (0, 2, 3))


def test_partition_and_vpp_do_not_stale_estimator():
    """Partition mode and vpp change which layers a stage holds, not the
    feature layout the memory fit learned: the estimator is kept."""
    w = _tiny_workload()
    spec = MID_RANGE.with_nodes(4)
    est = fit_memory_estimator([w], spec, fit_nodes=2, steps=1500,
                               residual=True, device=CPU)
    ep = replan(w, spec, healthy_nodes=3, estimator=est, sa_seconds=0.5,
                sa_iters=40, sa_topk=1, partition="dp", max_vpp=2,
                device=CPU)
    assert not ep.refit_estimator
    assert ep.plan.feasible


def test_grown_spec_does_not_stale_estimator():
    """Growing the node count keeps gpu_mem/gpus_per_node: no refit on a
    node join."""
    w = _tiny_workload()
    spec = MID_RANGE.with_nodes(2)
    est = fit_memory_estimator([w], spec, fit_nodes=2, steps=1500,
                               residual=True, device=CPU)
    ep = replan(w, spec, healthy_nodes=3, estimator=est, sa_seconds=0.5,
                sa_iters=40, sa_topk=1, device=CPU)
    assert not ep.refit_estimator
    assert ep.n_gpus == 24


def test_incremental_replan_records_lineage_and_migration():
    """An incumbent-seeded replan warm-starts from the projected incumbent
    permutation, records replan lineage, and prices the migration of the
    chosen candidate; the warm replan is never slower than the cold one
    (SA keeps its best-so-far from the seed)."""
    w = _tiny_workload()
    spec = MID_RANGE.with_nodes(3)
    first = replan(w, spec, healthy_nodes=3, sa_seconds=0.5, sa_iters=60,
                   sa_topk=1, device=CPU)
    second = replan(w, spec, healthy_nodes=3, incumbent=first.plan,
                    migration_weight=1e-4, sa_seconds=0.5, sa_iters=60,
                    sa_topk=1, device=CPU)
    lin = second.plan.provenance.lineage
    assert lin is not None
    assert lin["replan_of"] == first.plan.fingerprint()
    assert lin["warm_start_projected"] is True
    assert lin["survivors"] == 24
    ws = second.plan.provenance.budget.warm_start
    assert ws is not None and sorted(ws) == list(range(24))
    assert second.chosen is not None
    assert second.migration is not None
    assert second.migration.ranks_total == 24


def _strip_backend(plan, incumbent=None):
    """The Plan's JSON without the field that names the executor; the
    lineage's ``replan_of`` (the incumbent's fingerprint, which hashes
    that field too) is checked against the incumbent and dropped."""
    d = json.loads(plan.to_json())
    d["provenance"]["budget"].pop("backend")
    if incumbent is not None:
        assert d["provenance"]["lineage"].pop("replan_of") \
            == incumbent.fingerprint()
    return json.dumps(d, sort_keys=True)


def test_torch_replan_is_byte_equal_to_the_reference_numpy_replan():
    """The same incumbent-seeded replan after one node of four is lost:
    the port on its torch backend and the JAX package on its NumPy backend
    make the same Plan, byte for byte once the backend field is dropped,
    and choose the same candidate at the same migration price."""
    kw = dict(healthy_nodes=[0, 2, 3], sa_seconds=60.0, sa_iters=60,
              sa_topk=2)
    w_r = RWorkload(RModelConfig(**CFG_KW), 1024, 64)
    inc_r = r_replan(w_r, R_MID_RANGE.with_nodes(4), healthy_nodes=4,
                     sa_seconds=60.0, sa_iters=60, sa_topk=2,
                     backend="numpy").plan
    got_r = r_replan(w_r, R_MID_RANGE.with_nodes(4), incumbent=inc_r,
                     migration_weight=1e-4, backend="numpy", **kw)
    w = _tiny_workload()
    inc = replan(w, MID_RANGE.with_nodes(4), healthy_nodes=4,
                 sa_seconds=60.0, sa_iters=60, sa_topk=2, device=CPU).plan
    got = replan(w, MID_RANGE.with_nodes(4), incumbent=inc,
                 migration_weight=1e-4, device=CPU, **kw)
    assert _strip_backend(inc) == _strip_backend(inc_r)
    assert _strip_backend(got.plan, inc) == _strip_backend(got_r.plan, inc_r)
    assert dataclasses.asdict(got.chosen.conf) \
        == dataclasses.asdict(got_r.chosen.conf)
    np.testing.assert_array_equal(got.chosen.mapping, got_r.chosen.mapping)
    assert dataclasses.asdict(got.migration) \
        == dataclasses.asdict(got_r.migration)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is "
                    "present; the no-device error cannot show")
def test_replan_needs_a_device_or_the_cpu_named():
    w = _tiny_workload()
    spec = MID_RANGE.with_nodes(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        replan(w, spec, healthy_nodes=2, sa_iters=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        replan_on(w, spec, np.ones((16, 16)), backend="numpy",
                  sa_iters=10)
    assert Budget().backend == "torch"

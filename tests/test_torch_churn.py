"""Continuous replanning under churn, on the PyTorch package
(``runtime/churn.py`` over ``runtime/elastic.py``).

The cases of the JAX package's ``tests/test_churn.py`` on the port: trace
determinism, the migration-cost model (``Plan.diff`` /
``diff_assignments``), warm-start projection, fleet state folding and the
warm-vs-cold replay gate, the last with the policies' default
``backend="torch"`` on ``device="cpu"``.  Beside them: the replay on the
torch backend gives the report the NumPy backend gives and the report the
JAX package gives, the trace is the JAX package's byte for byte, the
replay CLI runs, and ``device=None`` raises without a CUDA device.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import MID_RANGE as R_MID_RANGE
from repro.core import Workload as RWorkload
from repro.runtime import churn as r_churn
from repro_torch import configs
from repro_torch.core import (MID_RANGE, MIXED_A100_V100, Conf, Workload,
                              default_mapping, diff_assignments,
                              project_perm, rank_state_bytes, state_keys)
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.churn import (COLD_POLICY, WARM_POLICY, ChurnEvent,
                                       ChurnTrace, FleetState,
                                       generate_trace, main,
                                       simulate_churn)


def _cfg():
    return ModelConfig(name="g", family="dense", n_layers=16, d_model=1024,
                       n_heads=16, n_kv_heads=16, d_ff=4096,
                       vocab_size=32000)


# ---------------------------------------------------------------------------
# trace generation + determinism
# ---------------------------------------------------------------------------

def test_trace_same_seed_is_byte_identical():
    spec = MID_RANGE.with_nodes(8)
    a = generate_trace(spec, horizon_s=3600, seed=11)
    b = generate_trace(spec, horizon_s=3600, seed=11)
    assert a == b
    assert a.to_json() == b.to_json()
    assert generate_trace(spec, horizon_s=3600, seed=12).to_json() \
        != a.to_json()


def test_trace_json_round_trip_is_exact(tmp_path):
    spec = MID_RANGE.with_nodes(6)
    tr = generate_trace(spec, horizon_s=1800, seed=5)
    assert len(tr.events) > 0
    back = ChurnTrace.from_json_dict(json.loads(tr.to_json()))
    assert back == tr
    assert back.to_json() == tr.to_json()
    p = tmp_path / "trace.json"
    tr.save(p)
    assert ChurnTrace.load(p) == tr


def test_trace_respects_min_nodes_floor():
    spec = MID_RANGE.with_nodes(4)
    tr = generate_trace(spec, horizon_s=20000, seed=0, min_nodes=3,
                        preempt_interval_s=200.0)
    state = FleetState(spec)
    for ev in tr.events:
        state.apply(ev)
        assert len(state.nodes) >= 3


def test_trace_events_sorted_and_validated():
    spec = MID_RANGE.with_nodes(4)
    tr = generate_trace(spec, horizon_s=5000, seed=2)
    ts = [e.t for e in tr.events]
    assert ts == sorted(ts)
    assert all(e.kind in ("preempt", "return", "degrade_link", "straggler")
               for e in tr.events)
    with pytest.raises(ValueError, match="kind"):
        ChurnEvent(1.0, "meteor", 0)


# ---------------------------------------------------------------------------
# migration-cost model
# ---------------------------------------------------------------------------

def test_diff_self_is_exact_noop():
    cfg = _cfg()
    conf = Conf(pp=4, tp=2, dp=2, bs_micro=1, bs_global=64)
    m = default_mapping(conf)
    d = diff_assignments(cfg, conf, m, conf, m)
    assert d.is_noop
    assert (d.ranks_moved, d.ranks_added, d.ranks_removed) == (0, 0, 0)
    assert d.bytes_migrated == 0.0
    assert d.downtime_s == 0.0
    assert not d.conf_changed


def test_diff_dp_and_cp_moves_are_free_stage_moves_are_not():
    """dp/cp replicate parameters, so swapping GPUs inside one
    (stage, tp) slot fetches nothing; swapping across stages re-fetches
    both shards."""
    cfg = _cfg()
    conf = Conf(pp=4, tp=2, dp=2, bs_micro=1, bs_global=64)
    m = default_mapping(conf)
    dp_swap = m.copy()
    dp_swap[0, 0, 0], dp_swap[0, 0, 1] = m[0, 0, 1], m[0, 0, 0]
    d = diff_assignments(cfg, conf, m, conf, dp_swap)
    assert d.is_noop and d.bytes_migrated == 0.0

    stage_swap = m.copy()
    stage_swap[0, 0, 0], stage_swap[1, 0, 0] = m[1, 0, 0], m[0, 0, 0]
    d = diff_assignments(cfg, conf, m, conf, stage_swap)
    assert d.ranks_moved == 2
    shard = rank_state_bytes(cfg, conf)
    assert d.bytes_migrated == pytest.approx(float(shard[0] + shard[1]))
    assert d.downtime_s > 0


def test_diff_is_symmetric_on_a_fixed_fleet():
    """Same conf, same GPU set: migrating A -> B moves exactly the ranks
    that B -> A moves, and fetches the same bytes (shard sizes match
    per-slot)."""
    cfg = _cfg()
    conf = Conf(pp=2, tp=2, dp=4, bs_micro=1, bs_global=64)
    rng = np.random.default_rng(7)
    a = default_mapping(conf)
    b = a.reshape(-1)[rng.permutation(conf.n_gpus)].reshape(a.shape)
    d_ab = diff_assignments(cfg, conf, a, conf, b)
    d_ba = diff_assignments(cfg, conf, b, conf, a)
    assert d_ab.ranks_moved == d_ba.ranks_moved
    assert d_ab.bytes_migrated == pytest.approx(d_ba.bytes_migrated)
    assert d_ab.ranks_added == d_ba.ranks_added == 0


def test_diff_shrink_counts_removed_and_grow_counts_added():
    cfg = _cfg()
    big = Conf(pp=4, tp=2, dp=2, bs_micro=1, bs_global=64)    # 16 GPUs
    small = Conf(pp=2, tp=2, dp=2, bs_micro=1, bs_global=64)  # 8 GPUs
    d = diff_assignments(cfg, big, default_mapping(big),
                         small, default_mapping(small))
    assert d.ranks_total == 8
    assert d.ranks_removed == 8
    assert d.conf_changed
    d = diff_assignments(cfg, small, default_mapping(small),
                         big, default_mapping(big))
    assert d.ranks_total == 16
    assert d.ranks_added == 8


def test_state_keys_identify_replicated_shards():
    cfg = _cfg()
    conf = Conf(pp=2, tp=2, dp=2, bs_micro=1, bs_global=64)
    keys = state_keys(cfg, conf, default_mapping(conf))
    assert len(keys) == conf.n_gpus
    # dp peers of one (stage, tp) slot share a key; tp peers do not
    m4 = default_mapping(conf).reshape(conf.pp, conf.tp, conf.dp)
    assert keys[int(m4[0, 0, 0])] == keys[int(m4[0, 0, 1])]
    assert keys[int(m4[0, 0, 0])] != keys[int(m4[0, 1, 0])]
    assert keys[int(m4[0, 0, 0])] != keys[int(m4[1, 0, 0])]


def test_plan_diff_round_trips_through_save_load(tmp_path):
    """Artifact-level diff: two saved plans, loaded back, price the same
    migration as their in-memory originals — and diff(self) is a no-op."""
    from repro_torch.core import (Budget, Planner, PlanRequest,
                                  PipetteStrategy, SearchSpace,
                                  profile_bandwidth)

    cfg = _cfg()
    w = Workload(cfg, 1024, 64)
    spec = MID_RANGE.with_nodes(2)
    bw, _ = profile_bandwidth(spec)
    mk = lambda seed: Planner(PipetteStrategy(), device="cpu").plan(
        PlanRequest(workload=w, spec=spec, space=SearchSpace(max_tp=2),
                    budget=Budget(sa_seconds=60.0, sa_iters=60), seed=seed),
        bw)
    pa, pb = mk(0), mk(3)
    pa.save(tmp_path / "a.json")
    pb.save(tmp_path / "b.json")
    from repro_torch.core.plan import Plan
    la, lb = Plan.load(tmp_path / "a.json"), Plan.load(tmp_path / "b.json")
    d_mem = pa.diff(pb, cfg=cfg)
    d_disk = la.diff(lb, cfg=cfg)
    assert d_mem == d_disk
    assert la.diff(la, cfg=cfg).is_noop


def test_project_perm_keeps_survivor_order_and_appends_fresh():
    perm = np.array([3, 1, 7, 5, 0, 6, 2, 4])
    # survivors: old ids 1, 5, 7, 0 -> new ids 0, 1, 2, 3; two new GPUs
    out = project_perm(perm, [1, 5, 7, 0], 6)
    # relative incumbent order of survivors: 1 (pos 1), 7 (pos 2),
    # 5 (pos 3), 0 (pos 4) -> new ids 0, 2, 1, 3, then fresh 4, 5
    assert out.tolist() == [0, 2, 1, 3, 4, 5]
    assert sorted(out.tolist()) == list(range(6))
    # full survival is a pure renumbering
    same = project_perm(perm, list(range(8)), 8)
    assert same.tolist() == perm.tolist()
    with pytest.raises(ValueError, match="duplicate"):
        project_perm(perm, [1, 1], 4)
    with pytest.raises(ValueError, match="smaller"):
        project_perm(perm, [0, 1, 2], 2)


# ---------------------------------------------------------------------------
# fleet state folding
# ---------------------------------------------------------------------------

def test_fleet_state_subset_keeps_tiers_and_join_order():
    spec = MIXED_A100_V100.with_nodes(6)
    state = FleetState(spec)
    state.apply(ChurnEvent(1.0, "preempt", 2))
    state.apply(ChurnEvent(2.0, "preempt", 0))
    state.apply(ChurnEvent(3.0, "return", 2))
    assert state.nodes == [1, 3, 4, 5, 2]        # survivors, then returner
    eff = state.effective_spec()
    assert eff.n_nodes == 5
    assert eff.node_tiers == tuple(spec.node_tiers[i]
                                   for i in (1, 3, 4, 5, 2))


def test_fleet_state_straggler_and_link_factors():
    spec = MID_RANGE.with_nodes(4)
    bw = np.full((spec.n_gpus, spec.n_gpus), 100.0)
    state = FleetState(spec)
    state.apply(ChurnEvent(1.0, "straggler", 1, factor=0.5))
    eff = state.effective_spec()
    assert eff.tiers  # straggler forces a tiered spec
    slow = eff.tiers[eff.node_tiers[1]]
    fast = eff.tiers[eff.node_tiers[0]]
    assert slow.flops == pytest.approx(fast.flops * 0.5)
    # recovery restores the scalar (untier-ed) spec
    state.apply(ChurnEvent(2.0, "straggler", 1, factor=1.0))
    assert not state.effective_spec().tiers

    state.apply(ChurnEvent(3.0, "degrade_link", 0, peer=2, factor=0.25))
    sub = state.effective_bw(bw)
    gpn = spec.gpus_per_node
    assert sub[0, 2 * gpn] == pytest.approx(25.0)
    assert sub[2 * gpn, 0] == pytest.approx(25.0)
    assert sub[0, gpn] == pytest.approx(100.0)
    state.apply(ChurnEvent(4.0, "degrade_link", 0, peer=2, factor=1.0))
    assert state.effective_bw(bw)[0, 2 * gpn] == pytest.approx(100.0)


def test_fleet_state_gpu_ids_follow_node_order():
    spec = MID_RANGE.with_nodes(3)
    state = FleetState(spec)
    state.apply(ChurnEvent(1.0, "preempt", 0))
    state.apply(ChurnEvent(2.0, "return", 0))
    gpn = spec.gpus_per_node
    assert state.gpu_ids() == (
        list(range(gpn, 3 * gpn)) + list(range(gpn)))


# ---------------------------------------------------------------------------
# the replay: quality gate, backends, the reference
# ---------------------------------------------------------------------------

def _policies(**kw):
    """The two policies at an iteration-bound budget (the wall-clock cap
    set out of reach), so that every backend runs the same moves: 40
    iterations a candidate, where the reference's gate takes 150 under a
    0.1 s cap, to keep the 30 replans of a replay to seconds on the
    host."""
    return [dataclasses.replace(p, sa_iters=40, sa_seconds=60.0, **kw)
            for p in (WARM_POLICY, COLD_POLICY)]


@pytest.fixture(scope="module")
def gate_reports():
    spec = MID_RANGE.with_nodes(4)
    w = Workload(configs.get("gpt-1.1b").reduced(), 2048, 64)
    trace = generate_trace(spec, horizon_s=1200, seed=3, min_nodes=2,
                           preempt_interval_s=400.0,
                           degrade_interval_s=500.0,
                           straggler_interval_s=500.0)
    return spec, w, trace, [simulate_churn(w, spec, trace, p)
                            for p in _policies(device="cpu")]


def test_warm_incremental_beats_cold_on_seeded_trace(gate_reports):
    """On a seeded preempt/return trace, warm incremental replanning
    (projected warm start + migration-aware selection) sustains more
    throughput than from-scratch replanning, with no more downtime, and
    both policies' PlanDiff accounting matches the independent
    resident-state ledger exactly.  The policies run on the torch
    backend, their default."""
    spec, w, trace, (rw, rc) = gate_reports
    assert WARM_POLICY.backend == COLD_POLICY.backend == "torch"
    assert any(e.kind == "preempt" for e in trace.events)
    assert rw.replans == rc.replans == len(trace.events)
    assert rw.samples > rc.samples
    assert rw.downtime_s <= rc.downtime_s
    for rep in (rw, rc):
        assert rep.bytes_migrated == pytest.approx(rep.resident_bytes)
        assert rep.ranks_moved == rep.resident_moved


def test_torch_replay_reports_equal_numpy_and_reference(gate_reports):
    """The same replay on the NumPy backend, and in the JAX package on
    its NumPy backend: the reports' JSON is equal to the torch
    backend's, and so is the trace."""
    spec, w, trace, torch_reports = gate_reports
    np_reports = [simulate_churn(w, spec, trace, p)
                  for p in _policies(backend="numpy", device="cpu")]
    r_spec = R_MID_RANGE.with_nodes(4)
    from repro import configs as r_configs
    r_w = RWorkload(r_configs.get("gpt-1.1b").reduced(), 2048, 64)
    r_trace = r_churn.generate_trace(r_spec, horizon_s=1200, seed=3,
                                     min_nodes=2, preempt_interval_s=400.0,
                                     degrade_interval_s=500.0,
                                     straggler_interval_s=500.0)
    assert r_trace.to_json() == trace.to_json()
    r_reports = [r_churn.simulate_churn(
        r_w, r_spec, r_trace,
        dataclasses.replace(p, sa_iters=40, sa_seconds=60.0,
                            backend="numpy"))
        for p in (r_churn.WARM_POLICY, r_churn.COLD_POLICY)]
    for t, n, r in zip(torch_reports, np_reports, r_reports):
        doc = json.dumps(t.to_json_dict(), sort_keys=True)
        assert doc == json.dumps(n.to_json_dict(), sort_keys=True)
        assert doc == json.dumps(r.to_json_dict(), sort_keys=True)


def test_replay_cli_writes_a_report(tmp_path, capsys):
    out = tmp_path / "report.json"
    trace = tmp_path / "trace.json"
    assert main(["--nodes", "3", "--horizon", "600", "--seed", "1",
                 "--sa-iters", "40", "--policies", "warm",
                 "--trace-out", str(trace), "--out", str(out),
                 "--device", "cpu"]) == 0
    assert "report ->" in capsys.readouterr().out
    doc = json.loads(out.read_text())
    assert set(doc) == {"warm"} and doc["warm"]["replans"] >= 0
    assert ChurnTrace.load(trace).n_nodes == 3


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is "
                    "present; the no-device error cannot show")
def test_churn_needs_a_device_or_the_cpu_named():
    spec = MID_RANGE.with_nodes(3)
    w = Workload(_cfg(), 1024, 64)
    trace = generate_trace(spec, horizon_s=600, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_churn(w, spec, trace, dataclasses.replace(
            COLD_POLICY, backend="numpy", sa_iters=10))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--nodes", "2", "--horizon", "60"])

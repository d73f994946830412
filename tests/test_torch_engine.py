"""Torch scorer equivalence: bit parity with the reference NumPy engine.

The torch engine's contract is *bit*-equality with the JAX package's
:class:`repro.core.dedication.DedicationEngine` (the engine its jitted
counterpart equals by contract), not a tolerance: float64 throughout,
matching reduction order, and a replica of NumPy's pairwise summation for
the tiered per-stage sum.  Checked on homogeneous, tiered, ``cp > 1``,
non-uniform-partition and ``vpp = 2`` profiles, for single scores, batched
scores and whole annealing chains.  Profiles, confs and specs are built by
each package from the same numbers; permutations and the bandwidth matrix
are NumPy arrays shared by both.
"""
import numpy as np
import pytest
import torch

from repro.configs.gpt_paper import GPT_3_1B as R_GPT
from repro.configs.zamba2_7b import CONFIG as R_ZAMBA
from repro.core import annealing as r_annealing
from repro.core import cluster as r_cluster
from repro.core import dedication as r_dedication
from repro.core import memory as r_memory
from repro.core import partition as r_partition
from repro.core import simulator as r_sim
from repro_torch.configs.gpt_paper import GPT_3_1B as T_GPT
from repro_torch.configs.zamba2_7b import CONFIG as T_ZAMBA
from repro_torch.core import annealing as t_annealing
from repro_torch.core import cluster as t_cluster
from repro_torch.core import dedication as t_dedication
from repro_torch.core import partition as t_partition
from repro_torch.core import simulator as t_sim
from repro_torch.core.torch_engine import (TorchDedicationEngine,
                                           _apply_move, np_pairwise_sum)


def _specs(kind):
    """(reference spec, port spec) of one cluster kind, cut to a few
    nodes so a full score is cheap."""
    if kind == "uniform":
        return (r_cluster.MID_RANGE.with_nodes(2),
                t_cluster.MID_RANGE.with_nodes(2))
    if kind == "mixed":
        return (r_cluster.MIXED_A100_V100.with_nodes(4),
                t_cluster.MIXED_A100_V100.with_nodes(4))
    assert kind == "degraded"
    return (r_cluster.MID_RANGE_DEGRADED.with_nodes(4),
            t_cluster.MID_RANGE_DEGRADED.with_nodes(4))


def _conf_args(spec, k=3, max_cp=2):
    """A few 4D shapes exercising every term (pp>1, tp>1; cp>1 first), as
    constructor arguments both packages accept."""
    out = [c for c in r_memory.enumerate_confs(
        spec.n_gpus, 256, n_layers=R_GPT.n_layers, max_cp=max_cp, seq=2048)
        if c.pp > 1 and c.tp > 1]
    out.sort(key=lambda c: (c.cp == 1, c.pp, c.tp))
    return [dict(pp=c.pp, tp=c.tp, dp=c.dp, bs_micro=c.bs_micro,
                 bs_global=c.bs_global, cp=c.cp) for c in out[:k]]


def _pair(kind, conf_kw):
    """Reference engine and torch engine for one conf on one cluster."""
    r_spec, t_spec = _specs(kind)
    bw, _ = r_cluster.profile_bandwidth(r_spec)
    r_conf, t_conf = r_sim.Conf(**conf_kw), t_sim.Conf(**conf_kw)
    r_prof = r_sim.build_profile(r_sim.Workload(R_GPT, 2048, 256), r_spec,
                                 r_conf)
    t_prof = t_sim.build_profile(t_sim.Workload(T_GPT, 2048, 256), t_spec,
                                 t_conf)
    return (r_dedication.DedicationEngine(r_conf, bw, r_prof, r_spec),
            TorchDedicationEngine([t_conf], [t_prof], bw, t_spec,
                                  device="cpu"), r_spec.n_gpus)


# ---------------------------------------------------------------------------
# the NumPy pairwise-sum replica
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 8, 9, 127, 128, 129, 300])
def test_np_pairwise_sum_on_tensor_bit_exact_vs_np_sum(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)) * rng.uniform(1e-3, 1e3)
    got = np_pairwise_sum(torch.from_numpy(x), n).numpy()
    for r in range(3):
        assert float(got[r]).hex() == float(np.sum(x[r])).hex()
    assert float(np_pairwise_sum(x[0], n)).hex() == float(np.sum(x[0])).hex()


def test_apply_move_matches_reference_host_moves():
    rng = np.random.default_rng(0)
    n = 12
    perm = rng.permutation(n)
    rows, want = [], []
    for kind in (0, 1, 2):
        for _ in range(6):
            pa, pb = rng.choice(n, size=2, replace=False)
            rows.append((kind, pa, pb))
            want.append(r_annealing._move_numpy(perm, kind, int(pa),
                                                int(pb))[0])
    k, a, b = (torch.tensor(c) for c in zip(*rows))
    got = _apply_move(torch.from_numpy(perm).expand(len(rows), n),
                      torch.arange(n), k, a, b).numpy()
    assert (got == np.stack(want)).all()


# ---------------------------------------------------------------------------
# full-score equivalence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["uniform", "mixed", "degraded"])
def test_score_hex_equal_to_reference_engine(kind):
    """Homogeneous, tiered and degraded-host fleets; the conf list leads
    with ``cp > 1`` shapes, so ring-attention groups are covered."""
    r_spec, _ = _specs(kind)
    rng = np.random.default_rng(5)
    kws = _conf_args(r_spec)
    assert any(kw["cp"] > 1 for kw in kws)
    for kw in kws:
        eng, teng, n = _pair(kind, kw)
        assert teng.tiered == (kind != "uniform")
        for _ in range(4):
            perm = rng.permutation(n)
            assert float(teng.score(perm)).hex() == \
                float(eng.score(perm)).hex(), kw


def test_score_hex_equal_without_cp():
    r_spec, _ = _specs("mixed")
    kw = _conf_args(r_spec, k=1, max_cp=1)[0]
    assert kw["cp"] == 1
    eng, teng, n = _pair("mixed", kw)
    perm = np.random.default_rng(6).permutation(n)
    assert float(teng.score(perm)).hex() == float(eng.score(perm)).hex()


@pytest.mark.parametrize("vpp", [1, 2, 3])
def test_score_hex_equal_nonuniform_partition_and_vpp(vpp):
    """``partition="dp"`` stage boundaries and interleaved-1F1B chunks on a
    homogeneous fleet (the non-tiered per-stage branch); ``vpp = 3`` makes
    the divide by ``vpp`` inexact, which a reciprocal-multiply would
    miss by an ulp."""
    pp = 4
    r_spec = r_cluster.ClusterSpec(name="t", n_nodes=4, gpus_per_node=8)
    t_spec = t_cluster.ClusterSpec(name="t", n_nodes=4, gpus_per_node=8)
    bw = r_cluster.true_bandwidth_matrix(r_spec)
    kw = dict(pp=pp, tp=4, dp=2, bs_micro=2, bs_global=96, vpp=vpp)
    r_conf, t_conf = r_sim.Conf(**kw), t_sim.Conf(**kw)
    r_part = r_partition.make_partition(R_ZAMBA, pp * vpp, 2048, "dp")
    t_part = t_partition.make_partition(T_ZAMBA, pp * vpp, 2048, "dp")
    assert r_part.boundaries == t_part.boundaries
    r_prof = r_sim.build_profile(r_sim.Workload(R_ZAMBA, 2048, 96), r_spec,
                                 r_conf, partition=r_part)
    t_prof = t_sim.build_profile(t_sim.Workload(T_ZAMBA, 2048, 96), t_spec,
                                 t_conf, partition=t_part)
    eng = r_dedication.DedicationEngine(r_conf, bw, r_prof, r_spec)
    teng = TorchDedicationEngine([t_conf], [t_prof], bw, t_spec,
                                 device="cpu")
    assert teng.nonuniform and not teng.tiered
    rng = np.random.default_rng(0)
    for _ in range(4):
        perm = rng.permutation(r_spec.n_gpus)
        assert float(teng.score(perm)).hex() == float(eng.score(perm)).hex()


def test_compute_blind_engine_matches():
    r_spec, t_spec = _specs("mixed")
    bw, _ = r_cluster.profile_bandwidth(r_spec)
    kw = _conf_args(r_spec, 1)[0]
    r_conf, t_conf = r_sim.Conf(**kw), t_sim.Conf(**kw)
    r_prof = r_sim.build_profile(r_sim.Workload(R_GPT, 2048, 256), r_spec,
                                 r_conf)
    t_prof = t_sim.build_profile(t_sim.Workload(T_GPT, 2048, 256), t_spec,
                                 t_conf)
    eng = r_dedication.DedicationEngine(r_conf, bw, r_prof, r_spec,
                                        compute_aware=False)
    teng = TorchDedicationEngine([t_conf], [t_prof], bw, t_spec,
                                 compute_aware=False, device="cpu")
    perm = np.random.default_rng(2).permutation(r_spec.n_gpus)
    assert float(teng.score(perm)).hex() == float(eng.score(perm)).hex()


def _shape_group(kind):
    """Every microbatch variant of one (pp, tp, cp, dp) shape: reference
    engines one per candidate, one shared torch engine."""
    r_spec, t_spec = _specs(kind)
    bw, _ = r_cluster.profile_bandwidth(r_spec)
    confs = [c for c in r_memory.enumerate_confs(
        r_spec.n_gpus, 256, n_layers=R_GPT.n_layers, max_cp=2, seq=2048)
        if (c.pp, c.tp, c.cp) == (2, 2, 2) and c.bs_micro <= 4]
    assert len(confs) >= 2
    kws = [dict(pp=c.pp, tp=c.tp, dp=c.dp, bs_micro=c.bs_micro,
                bs_global=c.bs_global, cp=c.cp) for c in confs]
    r_cache = r_sim.ProfileCache(r_sim.Workload(R_GPT, 2048, 256), r_spec)
    t_cache = t_sim.ProfileCache(t_sim.Workload(T_GPT, 2048, 256), t_spec)
    r_confs = [r_sim.Conf(**kw) for kw in kws]
    t_confs = [t_sim.Conf(**kw) for kw in kws]
    engs = [r_dedication.DedicationEngine(c, bw, r_cache.get(c), r_spec)
            for c in r_confs]
    teng = TorchDedicationEngine(t_confs, [t_cache.get(c) for c in t_confs],
                                 bw, t_spec, device="cpu")
    return engs, teng, r_spec, t_spec, bw


def test_score_batch_matches_scalar_scores():
    engs, teng, r_spec, _, _ = _shape_group("mixed")
    rng = np.random.default_rng(3)
    perms = np.stack([rng.permutation(r_spec.n_gpus) for _ in range(5)])
    for ci, eng in enumerate(engs):
        batch = teng.score_batch(perms, ci)
        assert batch.shape == (5,) and batch.dtype == np.float64
        for r, perm in enumerate(perms):
            assert float(batch[r]).hex() == float(eng.score(perm)).hex()
            assert float(batch[r]).hex() == \
                float(teng.score(perm, ci)).hex()


def test_shared_pairs_and_device_pairs_do_not_change_scores():
    r_spec, t_spec = _specs("mixed")
    bw, _ = r_cluster.profile_bandwidth(r_spec)
    kw = _conf_args(r_spec, 1)[0]
    t_conf = t_sim.Conf(**kw)
    t_prof = t_sim.build_profile(t_sim.Workload(T_GPT, 2048, 256), t_spec,
                                 t_conf)
    pairs = t_dedication.PairCache.build(bw, t_spec.gpus_per_node)
    own = TorchDedicationEngine([t_conf], [t_prof], bw, t_spec, device="cpu")
    shared = TorchDedicationEngine([t_conf], [t_prof], bw, t_spec,
                                   pairs=pairs,
                                   device_pairs=own.device_pairs,
                                   device="cpu")
    assert shared.device_pairs is own.device_pairs
    for v in own.device_pairs.values():
        assert v is None or v.dtype == torch.float64
    perm = np.random.default_rng(4).permutation(r_spec.n_gpus)
    assert float(own.score(perm)).hex() == float(shared.score(perm)).hex()


def test_engine_refuses_mixed_shapes_and_missing_device():
    _, t_spec = _specs("uniform")
    bw, _ = t_cluster.profile_bandwidth(t_spec)
    a = t_sim.Conf(2, 2, 4, 1, 256)
    b = t_sim.Conf(4, 2, 2, 1, 256)
    w = t_sim.Workload(T_GPT, 2048, 256)
    profs = [t_sim.build_profile(w, t_spec, c) for c in (a, b)]
    with pytest.raises(ValueError, match="same-shape"):
        TorchDedicationEngine([a, b], profs, bw, t_spec, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchDedicationEngine([a], profs[:1], bw, t_spec)


# ---------------------------------------------------------------------------
# whole chains: torch anneal vs the reference host execution of a MovePlan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,sa_iters,n_chains", [
    ("mixed", 60, 3), ("uniform", 45, 2), ("mixed", 2, 4)],
    ids=["mixed-3chains", "uniform-2chains", "zero-budget-chains"])
def test_anneal_chain_for_chain_vs_reference_host_chains(kind, sa_iters,
                                                         n_chains):
    """One MovePlan (drawn by the reference), executed by the reference's
    ``_run_chain_numpy`` per candidate and chain and by one torch
    ``anneal`` call: bests, best permutations, accepted and
    accepted-to-best counters all equal.  ``n_chains > sa_iters`` leaves
    chains with a zero budget, which must report the init score."""
    engs, teng, r_spec, _, _ = _shape_group(kind)
    n = r_spec.n_gpus
    r_plan = r_annealing.make_move_plan([n], sa_iters, n_chains, seed=13)
    t_plan = t_annealing.make_move_plan([n], sa_iters, n_chains, seed=13)
    for f in ("chain_iters", "kind", "isl", "oa", "ob", "thresh", "valid",
              "probe_kind", "probe_isl", "probe_oa", "probe_ob"):
        assert np.array_equal(getattr(r_plan, f), getattr(t_plan, f)), f
    if n_chains > sa_iters:
        assert (r_plan.chain_iters == 0).any()
    offsets = np.zeros(1, dtype=np.int64)
    rng = np.random.default_rng(8)
    inits = np.stack([rng.permutation(n) for _ in engs])
    abs_pos = [t_annealing._abs_positions(t_plan, offsets) for _ in engs]
    bests, bperms, finals, accs, accbs = teng.anneal(
        inits, np.stack([a[0] for a in abs_pos]),
        np.stack([a[1] for a in abs_pos]), t_plan.kind, t_plan.thresh,
        t_plan.valid, np.stack([a[2] for a in abs_pos]),
        np.stack([a[3] for a in abs_pos]), t_plan.probe_kind, alpha=0.999)
    assert bests.shape == finals.shape == (len(engs), n_chains)
    assert bperms.shape == (len(engs), n_chains, n)
    assert bperms.dtype == accs.dtype == accbs.dtype == np.int64
    moved = 0
    for ci, eng in enumerate(engs):
        for k in range(n_chains):
            b, p, _, ac, ab = r_annealing._run_chain_numpy(
                eng, inits[ci], offsets, r_plan, k, 0.999)
            assert float(bests[ci, k]).hex() == float(b).hex(), (ci, k)
            assert np.array_equal(bperms[ci, k], p), (ci, k)
            assert int(accs[ci, k]) == ac and int(accbs[ci, k]) == ab
            assert finals[ci, k] >= bests[ci, k]
            moved += ac
    if sa_iters > n_chains:
        assert moved > 0                 # the chains really did anneal

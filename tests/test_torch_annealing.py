"""The port's unified SA routine on its torch backend against the JAX
package's on its NumPy backend.

Both ``dedicate_candidates`` get the same survivors, profiles, bandwidth
matrix, budget and seed (each built by its own package from the same
numbers); the per-candidate ``SAResult`` must be equal field by field —
mapping, latency (hex), per-chain latencies, accepted and
accepted-to-best counters — flat and hierarchical, cold and warm-started.
"""
import numpy as np
import pytest

from repro.core import annealing as r_annealing
from repro.core import cluster as r_cluster
from repro.core import memory as r_memory
from repro.core import plan as r_plan
from repro.core import simulator as r_sim
from repro.models.config import ModelConfig as RModelConfig
from repro_torch.core import annealing as t_annealing
from repro_torch.core import cluster as t_cluster
from repro_torch.core import plan as t_plan
from repro_torch.core import simulator as t_sim
from repro_torch.models.config import ModelConfig as TModelConfig

GPT_KW = dict(name="g12", family="dense", n_layers=12, d_model=1024,
              n_heads=16, n_kv_heads=16, d_ff=4096, vocab_size=32000)


def _mixed(mod):
    return mod.mixed_fleet_spec("ann-mixed-8x2", 8,
                                (mod.A100_TIER, mod.V100_TIER), (0.5, 0.5),
                                gpus_per_node=2, seed=31)


def _setup(kind):
    if kind == "mixed":
        r_spec, t_spec = _mixed(r_cluster), _mixed(t_cluster)
    else:
        r_spec = r_cluster.MID_RANGE.with_nodes(2)
        t_spec = t_cluster.MID_RANGE.with_nodes(2)
    bw, _ = r_cluster.profile_bandwidth(r_spec)
    r_w = r_sim.Workload(RModelConfig(**GPT_KW), 2048, 32)
    t_w = t_sim.Workload(TModelConfig(**GPT_KW), 2048, 32)
    confs = [c for c in r_memory.enumerate_confs(
        r_spec.n_gpus, 32, n_layers=12, max_cp=2, seq=2048)
        if c.bs_micro <= 2]
    kws = [dict(pp=c.pp, tp=c.tp, dp=c.dp, bs_micro=c.bs_micro,
                bs_global=c.bs_global, cp=c.cp) for c in confs]
    r_confs = [r_sim.Conf(**kw) for kw in kws]
    t_confs = [t_sim.Conf(**kw) for kw in kws]
    r_cache, t_cache = r_sim.ProfileCache(r_w, r_spec), \
        t_sim.ProfileCache(t_w, t_spec)
    r_profs = [r_cache.get(c) for c in r_confs]
    t_profs = [t_cache.get(c) for c in t_confs]
    # a spread of shapes, two of them sharing one shape (microbatch
    # variants batched into one engine)
    idx = sorted(set(range(0, len(confs), max(1, len(confs) // 6))) | {0, 1})
    return (r_spec, r_confs, r_profs), (t_spec, t_confs, t_profs), bw, idx


def _assert_same(res_r, res_t, idx):
    assert sorted(res_r) == sorted(res_t) == sorted(idx)
    for i in idx:
        a, b = res_r[i], res_t[i]
        assert np.array_equal(a.mapping, b.mapping), i
        assert np.array_equal(a.perm, b.perm), i
        assert float(a.latency).hex() == float(b.latency).hex(), i
        assert a.chain_latencies is not None
        assert [float(x).hex() for x in a.chain_latencies] == \
            [float(x).hex() for x in b.chain_latencies], i
        assert (a.accepted, a.accepted_to_best, a.iters) == \
            (b.accepted, b.accepted_to_best, b.iters), i
        assert [(t, float(v).hex()) for t, v in a.trace] == \
            [(t, float(v).hex()) for t, v in b.trace], i


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("hier", [False, True], ids=["flat", "hier"])
@pytest.mark.parametrize("kind", ["uniform", "mixed"])
def test_torch_backend_equals_reference_numpy_backend(kind, hier, warm):
    (r_spec, r_confs, r_profs), (t_spec, t_confs, t_profs), bw, idx = \
        _setup(kind)
    n = r_spec.n_gpus
    ws = None
    if warm:
        ws = tuple(int(x) for x in np.random.default_rng(4).permutation(n))
    kw = dict(sa_seconds=600.0, sa_iters=60, n_chains=3, hierarchical=hier,
              warm_start=ws)
    res_r = r_annealing.dedicate_candidates(
        r_confs, r_profs, idx, bw, r_spec,
        r_plan.Budget(backend="numpy", **kw), seed=11)
    res_t = t_annealing.dedicate_candidates(
        t_confs, t_profs, idx, bw, t_spec,
        t_plan.Budget(backend="torch", **kw), seed=11, device="cpu")
    _assert_same(res_r, res_t, idx)
    assert sum(r.accepted for r in res_t.values()) > 0


def test_port_numpy_backend_equals_its_torch_backend():
    """The port's own host engine is the third leg: what ``chip_smoke.py``
    compares the card against."""
    _, (t_spec, t_confs, t_profs), bw, idx = _setup("mixed")
    kw = dict(sa_seconds=600.0, sa_iters=40, n_chains=2, hierarchical=True)
    res_n = t_annealing.dedicate_candidates(
        t_confs, t_profs, idx, bw, t_spec,
        t_plan.Budget(backend="numpy", **kw), seed=3)
    res_t = t_annealing.dedicate_candidates(
        t_confs, t_profs, idx, bw, t_spec,
        t_plan.Budget(backend="torch", **kw), seed=3, device="cpu")
    _assert_same(res_n, res_t, idx)


def test_compute_blind_ablation_agrees():
    (r_spec, r_confs, r_profs), (t_spec, t_confs, t_profs), bw, idx = \
        _setup("mixed")
    kw = dict(sa_seconds=600.0, sa_iters=30, n_chains=2)
    res_r = r_annealing.dedicate_candidates(
        r_confs, r_profs, idx[:3], bw, r_spec,
        r_plan.Budget(backend="numpy", **kw), seed=5, compute_aware=False)
    res_t = t_annealing.dedicate_candidates(
        t_confs, t_profs, idx[:3], bw, t_spec,
        t_plan.Budget(backend="torch", **kw), seed=5, compute_aware=False,
        device="cpu")
    _assert_same(res_r, res_t, idx[:3])


def test_move_plans_and_islands_are_the_same_draws():
    r_spec, t_spec = _mixed(r_cluster), _mixed(t_cluster)
    for hier in (False, True):
        ri = r_annealing.build_islands(r_spec, hierarchical=hier,
                                       max_island_gpus=4)
        ti = t_annealing.build_islands(t_spec, hierarchical=hier,
                                       max_island_gpus=4)
        assert len(ri) == len(ti)
        assert all(np.array_equal(a, b) for a, b in zip(ri, ti))
        assert r_annealing.coarse_orderings(ri, r_spec) == \
            t_annealing.coarse_orderings(ti, t_spec)
        sizes = [len(i) for i in ri]
        rp = r_annealing.make_move_plan(sizes, 50, 3, seed=2)
        tp = t_annealing.make_move_plan(sizes, 50, 3, seed=2)
        for f in ("chain_iters", "kind", "isl", "oa", "ob", "thresh",
                  "valid", "probe_kind", "probe_isl", "probe_oa",
                  "probe_ob"):
            assert np.array_equal(getattr(rp, f), getattr(tp, f)), f


def test_dedicate_candidates_rejects_the_jax_backend_and_legacy_none():
    _, (t_spec, t_confs, t_profs), bw, idx = _setup("uniform")

    class FakeBudget:
        backend = "jax"
        hierarchical = None
        sa_iters, n_chains, sa_seconds, warm_start = 10, 1, 1.0, None

    with pytest.raises(ValueError, match="numpy|torch"):
        t_annealing.dedicate_candidates(t_confs, t_profs, idx[:1], bw,
                                        t_spec, FakeBudget(), seed=0,
                                        device="cpu")

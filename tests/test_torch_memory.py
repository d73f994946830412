"""The port's memory estimator (MLP forward, fit, pruning API) against the
JAX package's.

Weights cannot be compared between a JAX fit and a torch fit (the two draw
different random bits from one seed), so the forward is pinned by carrying
a *reference-fitted* estimator across with ``convert.estimator_from_
reference`` and comparing predictions, the optimizer by running both
``train_mlp`` from the same initial parameters, and a torch fit by the
accuracy gate of the reference's own estimator test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cluster as r_cluster
from repro.core import memory as r_memory
from repro.core import mlp as r_mlp
from repro.core import simulator as r_sim
from repro.models.config import ModelConfig as RModelConfig
from repro_torch.convert import estimator_from_reference
from repro_torch.core import cluster as t_cluster
from repro_torch.core import memory as t_memory
from repro_torch.core import mlp as t_mlp
from repro_torch.core import simulator as t_sim
from repro_torch.models.config import ModelConfig as TModelConfig

GPT_KW = dict(name="gpt-1.1b", family="dense", n_layers=24, d_model=1920,
              n_heads=20, n_kv_heads=20, d_ff=7680, vocab_size=51200)
R_SPEC, T_SPEC = (r_cluster.MID_RANGE.with_nodes(4),
                  t_cluster.MID_RANGE.with_nodes(4))
R_W = r_sim.Workload(RModelConfig(**GPT_KW), 2048, 128)
T_W = t_sim.Workload(TModelConfig(**GPT_KW), 2048, 128)

#: float32 matrix products sum in another order, and ``tanh`` rounds
#: differently, in XLA and ATen: the MLP outputs differ by a few float32
#: ulps, and the prediction is ``exp`` of that output.
RTOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs several workers side by side; keep each fit to two
    intra-op threads instead of one per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def carry_across(est):
    """Reference estimator -> port estimator, through plain NumPy."""
    fields = {f.name: getattr(est, f.name) for f in dataclasses.fields(est)
              if f.name not in ("params", "x_mean", "x_std", "y_mean",
                                "y_std")}
    params = [{k: np.asarray(v) for k, v in layer.items()}
              for layer in est.params]
    return estimator_from_reference(params, est.x_mean, est.x_std,
                                    est.y_mean, est.y_std, **fields)


@pytest.fixture(scope="module")
def pool():
    """The 240-configuration sample of the reference's batched-predict
    test, as (reference confs, port confs)."""
    full = [c for g in (8, 16, 24, 32, 48, 64) for bsg in (64, 128, 256)
            for c in r_memory.enumerate_confs(g, bsg, n_layers=24)
            if c.bs_micro <= 16]
    rng = np.random.default_rng(0)
    r_confs = [full[i] for i in rng.choice(len(full), size=240,
                                           replace=False)]
    t_confs = [t_sim.Conf(c.pp, c.tp, c.dp, c.bs_micro, c.bs_global)
               for c in r_confs]
    return r_confs, t_confs


@pytest.fixture(scope="module")
def fitted():
    """Reference estimators fitted once per module, each with its
    carried-across twin.  ``fit_nodes=1`` leaves the GPU-count feature
    constant in the fit, so most of the pool extrapolates to ``inf``;
    ``fit_nodes=2`` keeps most of it finite."""
    out = {}
    for fit_nodes in (1, 2):
        est = r_memory.fit_memory_estimator([R_W], R_SPEC,
                                            fit_nodes=fit_nodes, steps=300,
                                            residual=True)
        out[fit_nodes] = (est, carry_across(est))
    return out


@pytest.mark.parametrize("fit_nodes", [1, 2])
def test_carried_across_estimator_predicts_the_same(fitted, pool, fit_nodes):
    est, twin = fitted[fit_nodes]
    r_confs, t_confs = pool
    with np.errstate(over="ignore"):       # extrapolation may saturate exp
        want = est.predict_batch(R_W.cfg, r_confs)
        got = twin.predict_batch(T_W.cfg, t_confs, device="cpu")
    assert got.shape == (240,) and got.dtype == np.float64
    finite = np.isfinite(want)
    assert np.array_equal(finite, np.isfinite(got))
    assert finite.sum() >= (100 if fit_nodes == 2 else 1)
    np.testing.assert_allclose(got[finite], want[finite], rtol=RTOL)


def test_predict_is_bitwise_a_row_of_predict_batch(fitted, pool):
    _, twin = fitted[2]
    _, t_confs = pool
    with np.errstate(over="ignore"):
        batch = twin.predict_batch(T_W.cfg, t_confs, device="cpu")
        scalar = np.array([twin.predict(T_W.cfg, c, device="cpu")
                           for c in t_confs[:60]])
    assert batch[:60].tobytes() == scalar.tobytes()


def test_carried_fields_and_param_types(fitted):
    est, twin = fitted[2]
    assert twin.residual is True and twin.with_cp is False
    assert (twin.soft_margin, twin.workload_seq, twin.fit_gpu_mem,
            twin.fit_gpus_per_node) == (est.soft_margin, est.workload_seq,
                                        est.fit_gpu_mem,
                                        est.fit_gpus_per_node)
    assert len(twin.params) == 5
    for layer in twin.params:
        assert layer["w"].dtype == layer["b"].dtype == torch.float32
    with pytest.raises(ValueError, match="MLP"):
        estimator_from_reference([{"w": np.zeros((3, 2)),
                                   "b": np.zeros(3)}], 0, 1, 0.0, 1.0)


def test_3d_estimator_refuses_cp_gt_1_and_device_none_raises(fitted):
    _, twin = fitted[2]
    conf = t_sim.Conf(2, 2, 2, 1, 128, cp=2)
    with pytest.raises(ValueError, match="cp>1"):
        twin.predict_batch(T_W.cfg, [conf], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            twin.predict_batch(T_W.cfg, [t_sim.Conf(2, 2, 2, 1, 128)])
        with pytest.raises(RuntimeError, match="CUDA"):
            t_memory.fit_memory_estimator([T_W], T_SPEC, fit_nodes=1,
                                          steps=1)


def test_features_and_ground_truth_agree(pool):
    r_confs, t_confs = pool
    assert np.array_equal(
        r_memory._features_batch(R_W.cfg, r_confs),
        t_memory._features_batch(T_W.cfg, t_confs))
    for rc, tc in list(zip(r_confs, t_confs))[:40]:
        assert r_memory.ground_truth_memory(R_W, rc, R_SPEC) == \
            t_memory.ground_truth_memory(T_W, tc, T_SPEC)
        assert r_memory.analytical_estimate(R_W, rc) == \
            t_memory.analytical_estimate(T_W, tc)


def test_mlp_forward_matches_reference_forward_on_shared_weights():
    rng = np.random.default_rng(1)
    sizes = [10, 64, 64, 1]
    params = [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / a))
               .astype(np.float32),
               "b": (rng.standard_normal(b) * 0.1).astype(np.float32)}
              for a, b in zip(sizes[:-1], sizes[1:])]
    x = rng.standard_normal((33, 10)).astype(np.float32)
    want = np.asarray(r_mlp.mlp_forward(
        [{k: jnp.asarray(v) for k, v in l.items()} for l in params],
        jnp.asarray(x)))
    got = t_mlp.mlp_forward(
        [{k: torch.from_numpy(v) for k, v in l.items()} for l in params],
        torch.from_numpy(x)).numpy()
    # tanh-GELU on both sides: an erf GELU would differ by ~1e-3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    padded = t_mlp.pad_batch_rows(x)
    assert padded.shape == (64, 10) and (padded[33:] == 0).all()
    assert np.array_equal(padded, r_mlp.pad_batch_rows(x))


@pytest.mark.parametrize("steps", [1, 150])
def test_train_mlp_tracks_reference_from_the_same_initial_parameters(steps):
    """Same data, same initial weights (drawn by the reference, carried
    across), same number of steps: the final loss agrees within 5%.  One
    step pins the bias correction and the first learning rate; 150 steps
    pin the cosine schedule (a constant-rate or default-Adam loop lands
    elsewhere)."""
    x, y, _ = r_memory.profile_memory_dataset([R_W], R_SPEC, fit_nodes=1)
    xn = ((x - x.mean(0)) / (x.std(0) + 1e-9)).astype(np.float32)
    yn = ((y - y.mean()) / (y.std() + 1e-9)).astype(np.float32)
    sizes = [x.shape[1], 48, 48, 1]
    init = r_mlp.init_mlp(jax.random.PRNGKey(3), sizes)
    init_np = [{k: np.asarray(v) for k, v in l.items()} for l in init]

    r_out = r_mlp.train_mlp(init, jnp.asarray(xn), jnp.asarray(yn),
                            steps=steps)
    want = float(jnp.mean((r_mlp.mlp_forward(r_out, jnp.asarray(xn))[:, 0]
                           - jnp.asarray(yn)) ** 2))
    t_init = [{k: torch.from_numpy(v.copy()) for k, v in l.items()}
              for l in init_np]
    xt, yt = torch.from_numpy(xn), torch.from_numpy(yn)
    start = float(t_mlp.mse_loss(t_init, xt, yt))
    t_out = t_mlp.train_mlp(t_init, xt, yt, steps=steps)
    got = float(t_mlp.mse_loss(t_out, xt, yt))
    assert got == pytest.approx(want, rel=0.05)
    assert got < start
    # the inputs are left as they were
    assert all(np.array_equal(a[k].numpy(), b[k])
               for a, b in zip(t_init, init_np) for k in a)
    if steps == 1:
        # first Adam step moves every weight by lr * schedule(1), sign(g)
        dw = (t_out[0]["w"] - t_init[0]["w"]).abs()
        lr1 = 1e-3 * (0.02 + 0.98 * 0.5 * (1 + np.cos(np.pi)))
        # (rel=1e-2: the difference of two float32 weights near 1.0
        # carries an ulp of about 6e-8 on a 2e-5 step)
        assert float(dw.max()) == pytest.approx(lr1, rel=1e-2)
        np.testing.assert_allclose(t_out[0]["w"].numpy(),
                                   np.asarray(r_out[0]["w"]), atol=2e-7,
                                   rtol=0)


def test_init_mlp_is_he_normal_and_seeded():
    gen = torch.Generator().manual_seed(7)
    p = t_mlp.init_mlp(gen, [400, 300, 1])
    again = t_mlp.init_mlp(torch.Generator().manual_seed(7), [400, 300, 1])
    assert all(torch.equal(a[k], b[k]) for a, b in zip(p, again) for k in a)
    assert p[0]["w"].shape == (400, 300) and p[0]["w"].dtype == torch.float32
    assert float(p[0]["w"].std()) == pytest.approx(np.sqrt(2 / 400), rel=0.03)
    assert float(p[0]["b"].abs().max()) == 0.0


def test_torch_fit_passes_the_reference_accuracy_gate():
    """The extrapolation gate of the reference's estimator test (train on
    <= 2 nodes, validate at 8 nodes: MLP MAPE < 0.6 x analytical and
    < 50%).  Run at 1500 steps instead of that test's 6000 to keep this
    file quick on the CPU; fewer steps only make the gate harder."""
    def gpt(n_layers, d, h, name):
        return TModelConfig(name=f"{name}-{n_layers}-{d}", family="dense",
                            n_layers=n_layers, d_model=d, n_heads=h,
                            n_kv_heads=h, d_ff=4 * d, vocab_size=51200)
    spec = t_cluster.MID_RANGE
    models = [gpt(12, 768, 12, "a"), gpt(16, 1024, 16, "b"),
              gpt(20, 1280, 20, "c")]
    ws = [t_sim.Workload(m, 1024, bsg) for m in models
          for bsg in (16, 32, 64, 128)]
    est = t_memory.fit_memory_estimator(ws, spec, fit_nodes=2, steps=1500,
                                        residual=True, device="cpu")
    assert all(t.device.type == "cpu" for l in est.params
               for t in l.values())
    w = t_sim.Workload(models[0], 1024, 64)
    confs = [c for c in t_memory.enumerate_confs(64, 64, n_layers=12)
             if c.bs_micro <= 8]
    preds = est.predict_batch(w.cfg, confs, device="cpu")
    trues = [t_memory.ground_truth_memory(w, c, spec) for c in confs]
    anas = [t_memory.analytical_estimate(w, c) for c in confs]
    m_mlp, m_ana = t_memory.mape(preds, trues), t_memory.mape(anas, trues)
    assert m_mlp < 0.6 * m_ana, (m_mlp, m_ana)
    assert m_mlp < 50.0, m_mlp
    # soft margin: the fits() API of the reference's second estimator test
    limit = est.predict(w.cfg, confs[0], device="cpu")
    assert not est.fits(w.cfg, confs[0], limit * 0.5, device="cpu")
    assert est.fits(w.cfg, confs[0], limit * 2.0, device="cpu")

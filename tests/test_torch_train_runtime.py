"""Checkpointing, the data pipeline, the training loop's fault tolerance,
the straggler watchdog, AdamW and PowerSGD of the PyTorch package.

The cases of the JAX package's ``tests/test_runtime.py`` for these modules
(its elastic part is ``tests/test_torch_elastic.py``), run on the port,
then the port held to the reference on shared inputs: a checkpoint
directory the reference wrote restores into the port (parameters and
``AdamWState``, bfloat16 leaves bit for bit) and one the port wrote
restores into the reference; AdamW updates and the cosine schedule;
PowerSGD's approximation and error given the same random factors; and the
leaf order of a parameter tree.  Everything runs on the CPU.
"""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint.manager import CheckpointManager as RefCheckpoints
from repro.models import model as RM
from repro.optim import adamw as ref_adamw
from repro.optim.compression import PowerSGD as RefPowerSGD
from repro_torch import _tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import opt_state_from_reference, params_from_reference
from repro_torch.data.pipeline import DataLoader, LoaderConfig, SyntheticCorpus
from repro_torch.optim.adamw import AdamW, AdamWState, cosine_schedule
from repro_torch.optim.compression import PowerSGD
from repro_torch.runtime.trainer import (StragglerWatchdog, TrainLoop,
                                         TrainLoopConfig)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def _tree_of(seed):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "nested": {"b": torch.randn((3,), generator=g),
                       "c": torch.ones((2, 2), dtype=torch.bfloat16)}}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    t = _tree_of(0)
    mgr.save(10, t)
    restored, step = mgr.restore(t)
    assert step == 10
    for a, b in zip(_tree.leaves(t), _tree.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_async_save_snapshots_host_tensors_updated_in_place(tmp_path):
    """An asynchronous save writes the values a tensor had when ``save``
    returned, though the caller then updates it in place (as AdamW does
    its moments): a host tensor is copied, not shared with the writer."""
    mgr = CheckpointManager(tmp_path, keep=2, async_save=True)
    t = {"m": torch.ones((1 << 22,)), "v": torch.full((1 << 22,), 2.0)}
    want = {k: v.clone() for k, v in t.items()}
    mgr.save(1, t)
    for v in t.values():
        v.mul_(3.0)                       # before the writer has finished
    mgr.wait()
    restored, step = mgr.restore(want)
    assert step == 1
    for k in want:
        assert torch.equal(restored[k], want[k]), k


def test_checkpoint_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    t = _tree_of(1)
    for s in (1, 2, 3, 4):
        mgr.save(s, t)
    assert sorted(mgr.steps()) == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_detects_topology_mismatch(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, {"a": torch.ones((2,))})
    with pytest.raises(ValueError):
        mgr.restore({"a": torch.ones((2,)), "b": torch.ones((2,))})


def test_checkpoint_manifest_is_byte_reproducible(tmp_path):
    for d in ("x", "y"):
        mgr = CheckpointManager(tmp_path / d, async_save=True)
        mgr.save(3, _tree_of(2), timestamp=12.5)
        mgr.wait()
    a = (tmp_path / "x" / "step_3" / "meta.json").read_bytes()
    assert a == (tmp_path / "y" / "step_3" / "meta.json").read_bytes()
    assert json.loads(a)["time"] == 12.5
    assert (tmp_path / "x" / "LATEST").read_text() == "step_3"


def _reference_state(arch="qwen2-7b"):
    rcfg = ref_configs.get(arch).reduced(dtype="bfloat16")
    rp = RM.init_params(rcfg, jax.random.PRNGKey(4))
    opt = ref_adamw.AdamW(lr=1e-3)
    state = opt.init(rp)
    g = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, jnp.float32), rp)
    rp, state = opt.update(g, state, rp)         # step 1, nonzero m and v
    return rp, state


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A directory the reference's manager wrote (bfloat16 parameters and
    an ``AdamWState``) restores into the port's structure, leaf for leaf
    and bit for bit."""
    rp, rstate = _reference_state()
    RefCheckpoints(tmp_path, async_save=False).save(7, (rp, rstate))
    like_p = params_from_reference(jax.tree.map(np.asarray, rp),
                                   device="cpu")
    like_s = opt_state_from_reference(0, jax.tree.map(np.asarray, rstate.m),
                                      jax.tree.map(np.asarray, rstate.v),
                                      device="cpu")
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() == 7
    (params, state), step = mgr.restore((like_p, like_s))
    assert step == 7 and isinstance(state, AdamWState)
    assert int(state.step) == 1 and state.step.dtype == torch.int32
    assert params["tok_embed"].dtype == torch.bfloat16
    for got, want in zip(_tree.leaves((params, state)),
                         jax.tree.leaves((rp, rstate))):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        if want.dtype == ml_dtypes.bfloat16:
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    rp, rstate = _reference_state()
    params = params_from_reference(jax.tree.map(np.asarray, rp),
                                   device="cpu")
    state = opt_state_from_reference(np.asarray(rstate.step),
                                     jax.tree.map(np.asarray, rstate.m),
                                     jax.tree.map(np.asarray, rstate.v),
                                     device="cpu")
    CheckpointManager(tmp_path, async_save=False).save(2, (params, state))
    (p2, s2), step = RefCheckpoints(tmp_path).restore((rp, rstate))
    assert step == 2
    for a, b in zip(jax.tree.leaves((p2, s2)), jax.tree.leaves((rp, rstate))):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_leaf_order_is_jax_tree_flatten_order():
    rp, rstate = _reference_state("falcon-mamba-7b")
    port = params_from_reference(jax.tree.map(np.asarray, rp), device="cpu")
    mine = [tuple(t.shape) for t in _tree.leaves(port)]
    assert mine == [np.shape(x) for x in jax.tree.leaves(rp)]
    flat, treedef = _tree.flatten(port)
    back = _tree.unflatten(treedef, flat)
    assert all(a is b for a, b in zip(_tree.leaves(back), flat))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_data_deterministic_and_sharded():
    corpus = SyntheticCorpus(vocab_size=97, seed=3)
    full = DataLoader(corpus, LoaderConfig(8, 32))
    r0 = DataLoader(corpus, LoaderConfig(8, 32, dp_rank=0, dp_size=2))
    r1 = DataLoader(corpus, LoaderConfig(8, 32, dp_rank=1, dp_size=2))
    b_full = full.batch_at(5)
    b0, b1 = r0.batch_at(5), r1.batch_at(5)
    np.testing.assert_array_equal(
        np.concatenate([b0["tokens"], b1["tokens"]]), b_full["tokens"])
    np.testing.assert_array_equal(full.batch_at(5)["tokens"],
                                  b_full["tokens"])  # reproducible
    assert b_full["labels"][0, 0] == b_full["tokens"][0, 1]  # shifted


def test_data_prefetch_iterator():
    corpus = SyntheticCorpus(vocab_size=31, seed=0)
    dl = DataLoader(corpus, LoaderConfig(2, 8))
    batches = list(dl.iterate(start_step=3, stop_step=6))
    assert len(batches) == 3
    np.testing.assert_array_equal(batches[0]["tokens"],
                                  dl.batch_at(3)["tokens"])


# ---------------------------------------------------------------------------
# fault tolerance / straggler
# ---------------------------------------------------------------------------

def _toy_step_fn():
    opt = AdamW(lr=0.05, weight_decay=0.0)

    def step(params, opt_state, batch):
        x = torch.from_numpy(batch["tokens"]).float() / 10.0
        y = torch.from_numpy(batch["labels"]).float() / 10.0
        w = params["w"].detach().requires_grad_()
        loss = torch.mean((x @ w - y) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        params, opt_state = opt.update({"w": g}, opt_state, params)
        return params, opt_state, {"loss": loss.detach()}

    return opt, step


def test_trainloop_failure_recovery_bitwise(tmp_path):
    """Crash at step 7, restart, final params equal the no-crash run."""
    corpus = SyntheticCorpus(vocab_size=9, seed=1)
    loader = DataLoader(corpus, LoaderConfig(4, 8))

    def fresh():
        opt, step = _toy_step_fn()
        params = {"w": torch.zeros((8, 8))}
        return step, params, opt.init(params)

    cfg = TrainLoopConfig(total_steps=12, ckpt_every=5,
                          ckpt_dir=str(tmp_path / "a"))
    step_fn, params, opt_state = fresh()
    loop = TrainLoop(cfg, step_fn, loader)
    p_ref, _ = loop.run(params, opt_state, resume=False)

    cfg2 = TrainLoopConfig(total_steps=12, ckpt_every=5,
                           ckpt_dir=str(tmp_path / "b"))
    step_fn, params, opt_state = fresh()
    crash = TrainLoop(cfg2, step_fn, loader, fail_at_step=7)
    with pytest.raises(RuntimeError, match="injected failure"):
        crash.run(params, opt_state, resume=False)
    # restart: auto-resume from step 5 checkpoint
    step_fn, params, opt_state = fresh()
    resume = TrainLoop(cfg2, step_fn, loader)
    p_rec, _ = resume.run(params, opt_state, resume=True)
    assert torch.equal(p_ref["w"], p_rec["w"])
    assert [h["loss"] for h in resume.history] == \
        [h["loss"] for h in loop.history[5:]]


@pytest.mark.parametrize("save_final", [True, False])
def test_trainloop_final_save_is_the_references_unless_turned_off(
        tmp_path, save_final):
    """The loop saves after its last step whatever ``ckpt_every`` says, as
    the reference's does; ``save_final=False`` keeps only the
    ``ckpt_every`` saves (a run whose last checkpoint nothing reads)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    _, step = _toy_step_fn()
    params = {"w": torch.zeros((8, 8))}
    loop = TrainLoop(TrainLoopConfig(total_steps=5, ckpt_every=2,
                                     ckpt_dir=str(tmp_path),
                                     save_final=save_final),
                     step, DataLoader(SyntheticCorpus(9, 1),
                                      LoaderConfig(2, 8)))
    loop.run(params, AdamW(lr=0.05).init(params), resume=False)
    assert CheckpointManager(str(tmp_path)).latest_step() == \
        (5 if save_final else 4)


def test_trainloop_keeps_the_plan_beside_its_checkpoints(tmp_path):
    from repro_torch.core.plan import Plan
    golden = Plan.load("tests/data/golden_plan_v5.json")
    _, step = _toy_step_fn()
    params = {"w": torch.zeros((8, 8))}
    loop = TrainLoop(TrainLoopConfig(total_steps=1, ckpt_every=1,
                                     ckpt_dir=str(tmp_path)),
                     step, DataLoader(SyntheticCorpus(9, 1),
                                      LoaderConfig(2, 8)), plan=golden)
    loop.run(params, AdamW(lr=0.05).init(params), resume=False)
    assert Plan.load(loop.plan_path()).to_json() == golden.to_json()


def test_straggler_watchdog_fires():
    fired = []
    wd = StragglerWatchdog(threshold=1.5, warmup_steps=3,
                           on_straggler=lambda s, dt, e: fired.append(s))
    for s in range(10):
        wd.observe(s, 0.1)
    assert not fired
    wd.observe(10, 0.5)
    assert fired == [10]
    # EWMA is not polluted by the straggler observation
    assert wd.observe(11, 0.1) is False


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_adamw_converges_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.ones((4,)) * 5}
    state = opt.init(params)
    for _ in range(120):
        params, state = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 0.15


def test_cosine_schedule_shape():
    lr = cosine_schedule(1e-3, warmup=10, total=100)
    assert float(lr(torch.tensor(0))) == 0.0
    assert float(lr(torch.tensor(10))) == pytest.approx(1e-3, rel=1e-5)
    assert float(lr(torch.tensor(100))) == pytest.approx(1e-4, rel=1e-3)


def test_cosine_schedule_is_the_references_bit_for_bit():
    mine = cosine_schedule(3e-4, warmup=20, total=100)
    ref = ref_adamw.cosine_schedule(3e-4, warmup=20, total=100)
    for s in (0, 1, 7, 19, 20, 21, 55, 99, 100, 130):
        got = mine(torch.tensor(s, dtype=torch.int32))
        want = ref(jnp.asarray(s, jnp.int32))
        assert got.dtype == torch.float32
        assert np.float32(got.item()) == np.asarray(want), s


@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clipped", "no_clip"])
def test_adamw_update_matches_reference(clip):
    """Three updates from the same parameters (float32 and bfloat16
    leaves) and gradients: parameters and moments within float32 rounding
    (the grad-clip norm is summed in the same leaf order; the sums inside
    each leaf run in another order)."""
    rng = np.random.default_rng(0)
    tree = {"b": rng.standard_normal((5, 7)).astype(np.float32),
            "a": {"z": rng.standard_normal((3,)).astype(np.float32),
                  "y": rng.standard_normal((4, 4)).astype(ml_dtypes.bfloat16)}}
    grads = [jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 3)
                          .astype(np.float32), tree) for _ in range(3)]
    ropt = ref_adamw.AdamW(lr=ref_adamw.cosine_schedule(1e-2, 1, 3),
                           grad_clip=clip)
    opt = AdamW(lr=cosine_schedule(1e-2, 1, 3), grad_clip=clip)
    rp = jax.tree.map(jnp.asarray, tree)
    rstate = ropt.init(rp)
    params = params_from_reference(tree, device="cpu")
    state = opt.init(params)
    for g in grads:
        rp, rstate = ropt.update(jax.tree.map(jnp.asarray, g), rstate, rp)
        params, state = opt.update(params_from_reference(g, device="cpu"),
                                   state, params)
    assert int(state.step) == 3
    for got, want in zip(_tree.leaves((params, state.m, state.v)),
                         jax.tree.leaves((rp, rstate.m, rstate.v))):
        assert got.dtype == {np.dtype(np.float32): torch.float32}.get(
            np.asarray(want).dtype, torch.bfloat16)
        np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_powersgd_error_feedback_reduces_error():
    """With error feedback, the accumulated compression bias over repeated
    identical gradients vanishes (the sum of applied updates approaches the
    true gradient direction)."""
    comp = PowerSGD(rank=2, min_compress_size=16)
    g_true = {"w": torch.randn((32, 48),
                               generator=torch.Generator().manual_seed(0))}
    errors = comp.init_error(g_true)
    applied = torch.zeros((32, 48))
    n = 30
    for i in range(n):
        approx, errors = comp.roundtrip(
            g_true, errors, torch.Generator().manual_seed(i))
        applied = applied + approx["w"]
    rel = float(torch.linalg.norm(applied / n - g_true["w"]) /
                torch.linalg.norm(g_true["w"]))
    one_shot, _ = comp.roundtrip(g_true, comp.init_error(g_true),
                                 torch.Generator().manual_seed(99))
    rel_one = float(torch.linalg.norm(one_shot["w"] - g_true["w"]) /
                    torch.linalg.norm(g_true["w"]))
    assert rel < rel_one * 0.6


def test_powersgd_compression_ratio():
    comp = PowerSGD(rank=2, min_compress_size=16)
    params = {"w": torch.zeros((64, 64)), "small": torch.zeros((3,))}
    assert comp.compression_ratio(params) > 10
    ref = RefPowerSGD(rank=2, min_compress_size=16)
    assert comp.compression_ratio(params) == ref.compression_ratio(
        {"w": jnp.zeros((64, 64)), "small": jnp.zeros((3,))})


def test_powersgd_matches_reference_given_the_same_factors():
    """Two rounds of error feedback on a tree with a compressed matrix, a
    compressed 3-D leaf and a small raw one: with the reference's own
    random factors (drawn from its split keys) handed to the port, the
    approximations and the new errors agree to float32 rounding."""
    rng = np.random.default_rng(1)
    grads = {"m": rng.standard_normal((16, 24)).astype(np.float32),
             "t": rng.standard_normal((4, 6, 8)).astype(np.float32),
             "s": rng.standard_normal((5,)).astype(np.float32)}
    ref, mine = (RefPowerSGD(rank=3, min_compress_size=32),
                 PowerSGD(rank=3, min_compress_size=32))
    rerr = ref.init_error(jax.tree.map(jnp.asarray, grads))
    err = mine.init_error(params_from_reference(grads, device="cpu"))
    for rnd in range(2):
        key = jax.random.PRNGKey(rnd)
        flat = jax.tree.leaves(grads)
        keys = jax.random.split(key, len(flat))
        qs = []
        for g, k in zip(flat, keys):
            if g.ndim < 2 or g.size < 32:
                qs.append(None)
                continue
            cols = g.size // g.shape[0]
            r = min(3, g.shape[0], cols)
            qs.append(torch.from_numpy(np.array(
                jax.random.normal(k, (cols, r), jnp.float32))))
        rapprox, rerr = ref.roundtrip(jax.tree.map(jnp.asarray, grads),
                                      rerr, key)
        approx, err = mine.roundtrip(params_from_reference(grads,
                                                           device="cpu"),
                                     err, q=qs)
        for got, want in zip(_tree.leaves((approx, err)),
                             jax.tree.leaves((rapprox, rerr))):
            np.testing.assert_allclose(_f32(got), np.asarray(want),
                                       rtol=1e-4, atol=1e-5)


def test_powersgd_needs_a_generator_or_factors():
    with pytest.raises(ValueError, match="generator"):
        PowerSGD(min_compress_size=4).compress({"w": torch.ones(4, 4)},
                                               {"w": torch.zeros(4, 4)})

"""The training path of the PyTorch package against the JAX package's:
whole steps.

The reference's ``test_arch_smoke_train_step`` on the MoE, vlm and audio
families (loss and every leaf's gradient); five ``make_train_step`` steps
(AdamW on the cosine schedule, ``n_micro``
1 and 2) of ``reduced()`` qwen2-7b, falcon-mamba-7b and zamba2-7b, in
float32, from the reference's weights and its initial optimizer state
(``opt_state_from_reference``), on the same NumPy batches; then the
reference's system tests of training (``tests/test_system.py``), case by
case, and the ``train`` CLI with its resumes.  The loss and the gradients
are in ``tests/test_torch_train.py``, whose configs and helpers these
tests share.  Everything runs on the CPU (``device="cpu"``).

Tolerances.  The losses as there (1e-4); parameters within the
reference's own tolerance for its accumulation test (``rtol 2e-3, atol
2e-5``, ``tests/test_system.py:60``) with ``atol`` raised to 2e-4.  Adam
normalises each update to about ``lr`` whatever the gradient's size, so
an element whose near-zero gradient differs in sign between the packages
moves by up to ``2 lr`` a step: after five steps the largest parameter
difference is 8.6e-5 at lr 1e-4 and 2.7e-3 at lr 1e-3 (falcon-mamba-7b,
two layers).
"""
import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataLoader as RefLoader
from repro.data.pipeline import LoaderConfig as RefLoaderConfig
from repro.data.pipeline import SyntheticCorpus as RefCorpus
from repro.models import model as RM
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.optim import adamw as ref_adamw
from repro_torch import configs
from repro_torch._tree import leaves
from repro_torch.convert import opt_state_from_reference
from repro_torch.data.pipeline import DataLoader, LoaderConfig, SyntheticCorpus
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import AdamW, cosine_schedule
from test_torch_train import (ARCHS, CTX, LOSS_TOL, RCTX, STEP_OVERRIDES,
                              _cfgs, _check_grads, _f32, _named,
                              _ref_params)

STEP_RTOL, STEP_ATOL = 2e-3, 2e-4
STEP_LR = 1e-4


# ---------------------------------------------------------------------------
# the new families' smoke step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "kimi-k2-1t-a32b",
                                  "llava-next-mistral-7b", "musicgen-large"])
def test_arch_smoke_train_step_matches_reference(arch):
    """The reference's ``test_arch_smoke_train_step`` on the port's new
    families (a batch of 2 x 24 tokens; llava's image embeddings ahead of
    them, labels over both), held to the reference: the loss, every
    leaf's gradient against ``jax.value_and_grad``, and the logits'
    shape."""
    rcfg, cfg = _cfgs(arch)
    rp, params = _ref_params(rcfg)
    b, s = 2, 24
    n_img = cfg.n_img_tokens if cfg.frontend == "vlm" else 0
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32), "labels": rng.integers(0, cfg.vocab_size,
                                          (b, s + n_img)).astype(np.int32)}
    if n_img:
        batch["img_embeds"] = (rng.standard_normal((b, n_img, cfg.d_model))
                               / np.sqrt(cfg.d_model)).astype(np.float32)
    (rloss, _), rgrads = jax.value_and_grad(RM.loss_fn, has_aux=True)(
        rp, rcfg, RCTX, batch)
    p, flat = steps._leaves_for_grad(params)
    tb = steps._to_device(batch, torch.device("cpu"))
    loss, _ = M.loss_fn(p, cfg, CTX, tb)
    assert bool(torch.isfinite(loss))
    assert abs(float(loss) - float(rloss)) <= LOSS_TOL * (1 + float(rloss))
    grads = torch.autograd.grad(loss, flat)
    _check_grads(list(zip(_named(p), grads)),
                 jax.tree.map(np.asarray, rgrads))
    logits = M.forward_logits(params, cfg, CTX, tb["tokens"],
                              tb.get("img_embeds"))
    assert tuple(logits.shape) == (b, s + n_img, cfg.padded_vocab)


# ---------------------------------------------------------------------------
# five steps against the reference's make_train_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_steps_track_reference(arch, n_micro):
    rcfg, cfg = _cfgs(arch, **STEP_OVERRIDES.get(arch, {"n_layers": 2}))
    rp, params = _ref_params(rcfg, seed=1)
    ropt = ref_adamw.AdamW(lr=ref_adamw.cosine_schedule(STEP_LR, 2, 5))
    opt = AdamW(lr=cosine_schedule(STEP_LR, 2, 5))
    rstate = ropt.init(rp)
    state = opt_state_from_reference(
        np.asarray(rstate.step), jax.tree.map(np.asarray, rstate.m),
        jax.tree.map(np.asarray, rstate.v), device="cpu")
    rstep = jax.jit(ref_make_train_step(rcfg, RCTX, ropt, n_micro=n_micro))
    step = make_train_step(cfg, CTX, opt, n_micro=n_micro)
    loader = DataLoader(SyntheticCorpus(cfg.vocab_size, seed=2),
                        LoaderConfig(4, 16))
    for s in range(5):
        batch = loader.batch_at(s)
        rp, rstate, rm = rstep(rp, rstate, batch)
        params, state, m = step(params, state, batch)
        assert abs(float(m["loss"]) - float(rm["loss"])) <= \
            LOSS_TOL * (1 + abs(float(rm["loss"]))), s
    assert int(state.step) == int(rstate.step) == 5
    for got, want in zip(leaves(params), jax.tree.leaves(rp)):
        np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32),
                                   rtol=STEP_RTOL, atol=STEP_ATOL)
    for got, want in zip(leaves(state.m), jax.tree.leaves(rstate.m)):
        np.testing.assert_allclose(_f32(got), np.asarray(want), rtol=2e-2,
                                   atol=1e-5)


def test_train_step_is_deterministic():
    """Two runs of a step from the same state give the same bits."""
    _, cfg = _cfgs("qwen2-7b", n_layers=2)
    opt = AdamW(lr=1e-3)
    batch = DataLoader(SyntheticCorpus(cfg.vocab_size, 0),
                       LoaderConfig(4, 16)).batch_at(0)
    outs = []
    for _ in range(2):
        params = init_params(cfg, seed=0, device="cpu")
        step = make_train_step(cfg, CTX, opt, n_micro=2)
        p2, _, m = step(params, opt.init(params), batch)
        outs.append((p2, float(m["loss"])))
    assert outs[0][1] == outs[1][1]
    for a, b in zip(leaves(outs[0][0]), leaves(outs[1][0])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the reference's system tests of training (tests/test_system.py)
# ---------------------------------------------------------------------------

def test_tiny_training_loss_decreases():
    """A tiny dense model must learn the synthetic Markov stream."""
    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                      vocab_size=64, dtype="float32", remat=False)
    params = init_params(cfg, seed=0, device="cpu")
    opt = AdamW(lr=3e-3, weight_decay=0.0)
    opt_state = opt.init(params)
    step = make_train_step(cfg, CTX, opt, n_micro=2)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0, noise=0.02)
    loader = DataLoader(corpus, LoaderConfig(8, 32))
    losses = []
    for s in range(60):
        params, opt_state, m = step(params, opt_state, loader.batch_at(s))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:5]) - 0.5, \
        (losses[:5], losses[-10:])


def test_microbatch_accumulation_equivalence():
    """n_micro=1 vs n_micro=4 accumulate to (numerically) the same update."""
    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=32,
                      n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
                      vocab_size=32, dtype="float32", remat=False)
    opt = AdamW(lr=1e-3, weight_decay=0.0)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=1)
    batch = DataLoader(corpus, LoaderConfig(8, 16)).batch_at(0)
    outs = []
    for n_micro in (1, 4):
        params = init_params(cfg, seed=0, device="cpu")
        state = opt.init(params)
        step = make_train_step(cfg, CTX, opt, n_micro=n_micro)
        p2, _, m = step(params, state, batch)
        outs.append((p2, float(m["loss"])))
    assert outs[0][1] == pytest.approx(outs[1][1], rel=1e-4)
    for a, b in zip(leaves(outs[0][0]), leaves(outs[1][0])):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=2e-3, atol=2e-5)


def test_configure_then_train_integration():
    """Pipette picks a config on the simulated cluster (the port's planner,
    SA with the torch backend on the host); training consumes its bs_micro
    as the accumulation length."""
    from repro_torch.core import MID_RANGE, Workload, configure, \
        profile_bandwidth
    cfg = configs.get("qwen2-7b").reduced()
    spec = MID_RANGE.with_nodes(2)
    w = Workload(cfg, 64, 64)
    bw, _ = profile_bandwidth(spec)
    res = configure(w, spec, bw, sa_seconds=0.05, sa_iters=400,
                    device="cpu")
    assert res.best is not None
    n_micro = max(1, min(4, res.best.conf.n_mb))
    params = init_params(cfg, seed=0, device="cpu")
    opt = AdamW(lr=1e-3)
    step = make_train_step(cfg, CTX, opt, n_micro=n_micro)
    loader = DataLoader(SyntheticCorpus(cfg.vocab_size, 0),
                        LoaderConfig(8, 64))
    _, _, m = step(params, opt.init(params), loader.batch_at(0))
    assert np.isfinite(float(m["loss"]))


def test_data_pipeline_is_the_references():
    """The copy serves the reference's batches, bit for bit."""
    mine = DataLoader(SyntheticCorpus(97, seed=3), LoaderConfig(6, 24))
    ref = RefLoader(RefCorpus(97, seed=3), RefLoaderConfig(6, 24))
    for s in (0, 5):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(mine.batch_at(s)[k],
                                          ref.batch_at(s)[k])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_train_cli_smoke_on_the_host(tmp_path, capsys):
    rc = train_cli.main(["--arch", "qwen2-7b", "--smoke", "--steps", "3",
                         "--device", "cpu", "--global-batch", "4",
                         "--seq-len", "32", "--ckpt-every", "2",
                         "--ckpt-dir", str(tmp_path / "ck"),
                         "--metrics", str(tmp_path / "m.jsonl")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[train] qwen2-7b-smoke (4 layers) on cpu" in out
    assert "3 steps in" in out
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
        ["LATEST", "step_2", "step_3"]


def test_train_cli_layers_cut_and_resume(tmp_path):
    """``--layers`` keeps the first layers; ``--fail-at`` then ``--resume``
    finishes the run from its checkpoint with the uninterrupted run's
    losses."""
    common = ["--arch", "falcon-mamba-7b", "--smoke", "--layers", "2",
              "--steps", "4", "--device", "cpu", "--global-batch", "2",
              "--seq-len", "16", "--ckpt-every", "2"]
    cfg = configs.get("falcon-mamba-7b").reduced(n_layers=2)
    full = train_cli.train(cfg, steps=4, global_batch=2, seq_len=16,
                           n_micro=2, lr=3e-4, ckpt_dir=str(tmp_path / "a"),
                           ckpt_every=2, device="cpu")
    with pytest.raises(RuntimeError, match="injected failure"):
        train_cli.main(common + ["--ckpt-dir", str(tmp_path / "b"),
                                 "--fail-at", "3"])
    resumed = train_cli.train(cfg, steps=4, global_batch=2, seq_len=16,
                              n_micro=2, lr=3e-4,
                              ckpt_dir=str(tmp_path / "b"), ckpt_every=2,
                              resume=True, device="cpu")
    hist = resumed["loop"].history
    assert [h["step"] for h in hist] == [2, 3]
    assert [h["loss"] for h in hist] == \
        [h["loss"] for h in full["loop"].history[2:]]
    for a, b in zip(leaves(full["params"]), leaves(resumed["params"])):
        assert torch.equal(a, b)


def test_hybrid_train_resume_is_bitwise(tmp_path):
    """Reduced zamba2-7b through ``TrainLoop``: a run that fails at step 3
    and resumes from its step-2 checkpoint (the nested ``shared`` block
    and its AdamW moments among the leaves) gives the uninterrupted run's
    losses and parameters bit for bit."""
    cfg = configs.get("zamba2-7b").reduced(n_layers=3, remat=True)
    kw = dict(steps=4, global_batch=2, seq_len=16, n_micro=2, lr=3e-4,
              ckpt_every=2, device="cpu")
    full = train_cli.train(cfg, ckpt_dir=str(tmp_path / "a"), **kw)
    with pytest.raises(RuntimeError, match="injected failure"):
        train_cli.train(cfg, ckpt_dir=str(tmp_path / "b"), fail_at=3, **kw)
    resumed = train_cli.train(cfg, ckpt_dir=str(tmp_path / "b"),
                              resume=True, **kw)
    hist = resumed["loop"].history
    assert [h["step"] for h in hist] == [2, 3]
    assert [h["loss"] for h in hist] == \
        [h["loss"] for h in full["loop"].history[2:]]
    assert sorted(resumed["params"]["shared"]) == \
        sorted(full["params"]["shared"])
    for a, b in zip(leaves(full["params"]), leaves(resumed["params"])):
        assert torch.equal(a, b)
    for a, b in zip(leaves(full["opt_state"]), leaves(resumed["opt_state"])):
        assert torch.equal(a, b)


def test_train_cli_needs_a_device_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--arch", "qwen2-7b", "--smoke", "--steps", "1"])

"""The training path of the PyTorch package against the JAX package's.

``loss_fn``, the per-leaf gradients (``jax.value_and_grad`` of the
reference's ``loss_fn``), and five ``make_train_step`` steps (AdamW on the
cosine schedule, ``n_micro`` 1 and 2) of ``reduced()`` qwen2-7b (dense,
GQA, QKV bias), falcon-mamba-7b (Mamba1) and zamba2-7b (hybrid: six
Mamba2 layers, the weight-tied block after layers 2 and 5, so its gradient
sums two applications), in float32, from the
reference's weights (``params_from_reference``) and its initial optimizer
state (``opt_state_from_reference``), on the same NumPy batches.  Then the
reference's system tests of training (``tests/test_system.py``), case by
case, and the ``train`` CLI.  Everything runs on the CPU (``device="cpu"``),
where the kernels' plain versions stand in for them and autograd
differentiates them.

Tolerances.  The loss: 1e-4 (both round the final state to bfloat16
before the head, ``model.py:51`` of the reference, and sum in another
order).  Gradients: each leaf's relative Frobenius error at most 1e-3 and
every element within 2e-3 of the leaf's largest magnitude — the head's
input gradient goes back through that bfloat16 cast on both sides, so an
element near a rounding boundary may land one bfloat16 step (2^-8) away.
Five steps, at a peak learning rate of 1e-4: losses as above, parameters
within the reference's own tolerance for its accumulation test (``rtol
2e-3, atol 2e-5``, ``tests/test_system.py:60``) with ``atol`` raised to
2e-4.  Adam normalises each update to about ``lr`` whatever the gradient's
size, so an element whose near-zero gradient differs in sign between the
packages moves by up to ``2 lr`` a step: after five steps the largest
parameter difference is 8.6e-5 at lr 1e-4 and 2.7e-3 at lr 1e-3
(falcon-mamba-7b, two layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.pipeline import DataLoader as RefLoader
from repro.data.pipeline import LoaderConfig as RefLoaderConfig
from repro.data.pipeline import SyntheticCorpus as RefCorpus
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import model as RM
from repro.models.sharding import ShardCtx as RefShardCtx
from repro.optim import adamw as ref_adamw
from repro_torch import configs
from repro_torch._tree import leaves
from repro_torch.convert import opt_state_from_reference, params_from_reference
from repro_torch.data.pipeline import DataLoader, LoaderConfig, SyntheticCorpus
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import ShardCtx
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import AdamW, cosine_schedule

RCTX, CTX = RefShardCtx(), ShardCtx()
ARCHS = ["qwen2-7b", "falcon-mamba-7b", "zamba2-7b"]
#: ``reduced()`` overrides of the five-step tests: two layers, and for the
#: hybrid the shared block after each of them (period 1), so that its
#: gradient still sums two applications.
STEP_OVERRIDES = {"zamba2-7b": {"n_layers": 2, "hybrid_attn_period": 1}}
LOSS_TOL = 1e-4
GRAD_FRO_TOL, GRAD_MAX_TOL = 1e-3, 2e-3
STEP_RTOL, STEP_ATOL = 2e-3, 2e-4
STEP_LR = 1e-4


def _cfgs(arch, **kw):
    return (ref_configs.get(arch).reduced(**kw),
            configs.get(arch).reduced(**kw))


def _batch(vocab, b=2, s=16, seed=0, masked=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    if masked:
        labels[0, :3] = -1                       # masked positions
    return {"tokens": toks, "labels": labels}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _ref_params(rcfg, seed=0):
    rp = RM.init_params(rcfg, jax.random.PRNGKey(seed))
    return rp, params_from_reference(jax.tree.map(np.asarray, rp),
                                     device="cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(arch):
    rcfg, cfg = _cfgs(arch)
    rp, params = _ref_params(rcfg)
    batch = _batch(cfg.vocab_size)
    want, raux = RM.loss_fn(rp, rcfg, RCTX, batch)
    got, aux = M.loss_fn(params, cfg, CTX, _torch_batch(batch))
    assert abs(float(got) - float(want)) <= LOSS_TOL * (1 + abs(float(want)))
    assert float(aux["tokens"]) == float(raux["tokens"]) == 29.0


def test_loss_fn_gather_is_the_one_hot_einsum_bit_for_bit():
    """The reference picks the label's logit with a one-hot einsum; the
    port gathers it.  The einsum adds only exact zeros, so on the same
    logits the two are the same bits."""
    rng = np.random.default_rng(3)
    lf = rng.standard_normal((3, 7, 256)).astype(np.float32) * 4
    lf[..., 250:] = -1e30                        # phantom rows
    labels = rng.integers(0, 250, (3, 7))
    onehot = jax.nn.one_hot(labels, 256, dtype=jnp.float32)
    want = np.asarray(jnp.einsum("bsv,bsv->bs", lf, onehot))
    got = torch.gather(torch.from_numpy(lf), -1,
                       torch.from_numpy(labels)[..., None])[..., 0]
    np.testing.assert_array_equal(got.numpy(), want)


def _paths(tree, prefix=()):
    """The key paths of ``tree``'s leaves, in ``_tree.leaves`` order."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _paths(tree[k], prefix + (k,))]
    return [prefix]


def _named(p):
    """``(path, layer)`` of each leaf ``steps._leaves_for_grad`` returns, in
    its order: the top-level entries' key paths (a hybrid's ``shared``
    block nested), then each layer's keys."""
    named = [(q, None) for q in _paths({k: v for k, v in p.items()
                                        if k != "layers"})]
    named += [((k,), i) for i in range(len(p["layers"]))
              for k in sorted(p["layers"][i])]
    return named


def _port_grads(params, cfg, batch):
    p, flat = steps._leaves_for_grad(params)
    loss, _ = M.loss_fn(p, cfg, CTX, _torch_batch(batch))
    grads = torch.autograd.grad(loss, flat)
    return loss.detach(), list(zip(_named(p), grads))


def _check_grads(port, ref):
    for (path, layer), g in port:
        node = ref if layer is None else ref["layers"]
        for k in path:
            node = node[k]
        key = "/".join(path)
        want = np.asarray(node if layer is None else node[layer], np.float32)
        got = _f32(g)
        assert got.shape == want.shape, key
        scale = float(np.abs(want).max())
        fro = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert fro <= GRAD_FRO_TOL, (key, layer, fro)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=GRAD_MAX_TOL * scale,
                                   err_msg=f"{key} layer {layer}")


@pytest.mark.parametrize("arch,remat", [("qwen2-7b", False),
                                        ("qwen2-7b", True),
                                        ("falcon-mamba-7b", False),
                                        ("falcon-mamba-7b", True),
                                        ("zamba2-7b", False),
                                        ("zamba2-7b", True)])
def test_gradients_match_value_and_grad(arch, remat):
    """Every leaf's gradient against ``jax.value_and_grad`` of the
    reference's ``loss_fn``; with ``remat`` each layer runs under the
    checkpoint on both sides (a hybrid's shared block outside it, on both
    sides: its leaves, nested under ``shared``, sum two applications)."""
    rcfg, cfg = _cfgs(arch, remat=remat)
    rp, params = _ref_params(rcfg)
    batch = _batch(cfg.vocab_size)
    (rloss, _), rgrads = jax.value_and_grad(RM.loss_fn, has_aux=True)(
        rp, rcfg, RCTX, batch)
    loss, grads = _port_grads(params, cfg, batch)
    assert abs(float(loss) - float(rloss)) <= LOSS_TOL * (1 + float(rloss))
    _check_grads(grads, jax.tree.map(np.asarray, rgrads))


#: The shipped head dims the attention kernel did not take before:
#: gpt-1.1b's 96 (``launch/train.py``'s default arch), kimi-k2's and
#: zamba2's 112, gpt-11.1b's 136.
@pytest.mark.parametrize("head_dim", [96, 112, 136])
def test_gpt_at_the_shipped_head_dims_matches_reference(head_dim):
    """Reduced gpt-1.1b at each head dim: ``forward_logits`` (2e-3),
    ``loss_fn`` and every leaf's gradient against the reference's
    ``chunked_attention`` model."""
    rcfg, cfg = _cfgs("gpt-1.1b", head_dim=head_dim)
    rp, params = _ref_params(rcfg)
    batch = _batch(cfg.vocab_size)
    got = M.forward_logits(params, cfg, CTX, _torch_batch(batch)["tokens"])
    want = RM.forward_logits(rp, rcfg, RCTX, batch["tokens"])
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-3, atol=2e-3)
    (rloss, _), rgrads = jax.value_and_grad(RM.loss_fn, has_aux=True)(
        rp, rcfg, RCTX, batch)
    loss, grads = _port_grads(params, cfg, batch)
    assert abs(float(loss) - float(rloss)) <= LOSS_TOL * (1 + float(rloss))
    _check_grads(grads, jax.tree.map(np.asarray, rgrads))


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


def test_stacked_leaves_get_one_layer_gradients():
    """The step differentiates per-layer leaves that share the stacked
    parameters' storage: each gradient has one layer's shape, and the
    stacked tensors are not themselves in the graph."""
    _, cfg = _cfgs("qwen2-7b")
    params = init_params(cfg, seed=0, device="cpu")
    p, flat = steps._leaves_for_grad(params)
    assert len(p["layers"]) == cfg.n_layers
    wq = params["layers"]["wq"]
    assert p["layers"][1]["wq"].data_ptr() == wq[1].data_ptr()
    loss, _ = M.loss_fn(p, cfg, CTX, _torch_batch(_batch(cfg.vocab_size)))
    grads = torch.autograd.grad(loss, flat)
    assert all(g.shape == t.shape for g, t in zip(grads, flat))
    assert not wq.requires_grad and wq.grad is None


def test_leaves_for_grad_flattens_nested_subtrees():
    """A nested subtree beside ``layers`` (the hybrid's ``shared`` block, a
    dict of tensors) becomes leaves of its own, in ``_tree.leaves`` order
    (keys sorted, recursively) — the order the accumulators, AdamW and the
    checkpoint walk — each a leaf that requires a gradient and shares its
    parameter's storage."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)

    params = {"tok_embed": r(8, 4), "final_norm": r(4),
              "shared": {"wq": r(4, 2), "ln1": r(4),
                         "inner": {"b": r(3), "a": r(2)}},
              "layers": {"w": r(2, 4, 4), "ln1": r(2, 4)}}
    p, flat = steps._leaves_for_grad(params)
    top = leaves({k: v for k, v in params.items() if k != "layers"})
    assert len(flat) == len(top) + 2 * 2
    for got, want in zip(flat, top + [params["layers"][k][i]
                                      for i in range(2)
                                      for k in ("ln1", "w")]):
        assert got.is_leaf and got.requires_grad
        assert got.data_ptr() == want.data_ptr() and got.shape == want.shape
    assert p["shared"]["inner"]["a"] is flat[1]        # final_norm, then a
    assert [q for q, _ in _named(p)][:6] == [
        ("final_norm",), ("shared", "inner", "a"), ("shared", "inner", "b"),
        ("shared", "ln1"), ("shared", "wq"), ("tok_embed",)]


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_over_a_nested_shared_block(n_micro):
    """A train step of reduced zamba2-7b, whose ``params["shared"]`` is a
    dict of nine tensors: every shared leaf gets an update, the loss is
    finite, and two runs give the same bits."""
    _, cfg = _cfgs("zamba2-7b", n_layers=2, hybrid_attn_period=1)
    opt = AdamW(lr=1e-3)
    batch = DataLoader(SyntheticCorpus(cfg.vocab_size, 0),
                       LoaderConfig(4, 16)).batch_at(0)
    outs = []
    for _ in range(2):
        params = init_params(cfg, seed=0, device="cpu")
        assert sorted(params["shared"]) == ["down", "gate", "ln1", "ln2",
                                            "up", "wk", "wo", "wq", "wv"]
        step = make_train_step(cfg, CTX, opt, n_micro=n_micro)
        new, state, m = step(params, opt.init(params), batch)
        assert np.isfinite(float(m["loss"]))
        for k, v in new["shared"].items():
            assert not torch.equal(v, params["shared"][k]), k
            assert float(state.m["shared"][k].abs().max()) > 0, k
        outs.append((new, float(m["loss"])))
    assert outs[0][1] == outs[1][1]
    for a, b in zip(leaves(outs[0][0]), leaves(outs[1][0])):
        assert torch.equal(a, b)


def test_remat_is_used_only_under_a_gradient(monkeypatch):
    """``run_stack`` checkpoints each layer when the config asks for remat
    and a gradient is taken, and never on the inference paths."""
    _, cfg = _cfgs("qwen2-7b", remat=True)
    params = init_params(cfg, seed=0, device="cpu")
    calls = []
    from repro_torch.models import transformer as tf
    real = tf.checkpoint

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)

    monkeypatch.setattr(tf, "checkpoint", spy)
    toks = torch.from_numpy(_batch(cfg.vocab_size)["tokens"]).long()
    M.forward_logits(params, cfg, CTX, toks)
    M.prefill(params, cfg, CTX, toks)
    assert calls == []
    p, flat = steps._leaves_for_grad(params)
    M.forward_logits(p, cfg, CTX, toks).sum().backward()
    assert len(calls) == cfg.n_layers
    assert all(k["use_reentrant"] is False for k in calls)
    with torch.no_grad():
        M.forward_logits(p, cfg, CTX, toks)
    assert len(calls) == cfg.n_layers


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

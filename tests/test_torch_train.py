"""The training path of the PyTorch package against the JAX package's:
the loss and the gradients.

``loss_fn`` and the per-leaf gradients (``jax.value_and_grad`` of the
reference's ``loss_fn``) of ``reduced()`` qwen2-7b (dense, GQA, QKV
bias), falcon-mamba-7b (Mamba1) and zamba2-7b (hybrid: six Mamba2 layers,
the weight-tied block after layers 2 and 5, so its gradient sums two
applications) and gpt-1.1b at the shipped head dims, in float32, from
the reference's weights (``params_from_reference``), on the same NumPy
batches; then the train step's parameter leaves and remat.  The MoE, vlm
and audio families' smoke steps, the steps against the reference's
``make_train_step``, its system tests of training and the ``train`` CLI
are in ``tests/test_torch_train_steps.py``.  Everything runs on the CPU
(``device="cpu"``), where the kernels' plain versions stand in for them
and autograd differentiates them.

Tolerances.  The loss: 1e-4 (both round the final state to bfloat16
before the head, ``model.py:51`` of the reference, and sum in another
order).  Gradients: each leaf's relative Frobenius error at most 1e-3 and
every element within 2e-3 of the leaf's largest magnitude — the head's
input gradient goes back through that bfloat16 cast on both sides, so an
element near a rounding boundary may land one bfloat16 step (2^-8) away.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import model as RM
from repro.models.sharding import ShardCtx as RefShardCtx
from repro_torch import configs
from repro_torch._tree import leaves
from repro_torch.convert import params_from_reference
from repro_torch.data.pipeline import DataLoader, LoaderConfig, SyntheticCorpus
from repro_torch.launch import steps
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.models.sharding import ShardCtx
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import AdamW

RCTX, CTX = RefShardCtx(), ShardCtx()
ARCHS = ["qwen2-7b", "falcon-mamba-7b", "zamba2-7b"]
#: ``reduced()`` overrides of the five-step tests: two layers, and for the
#: hybrid the shared block after each of them (period 1), so that its
#: gradient still sums two applications.
STEP_OVERRIDES = {"zamba2-7b": {"n_layers": 2, "hybrid_attn_period": 1}}
LOSS_TOL = 1e-4
GRAD_FRO_TOL, GRAD_MAX_TOL = 1e-3, 2e-3


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

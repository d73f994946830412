"""The frontend stubs and the vlm input path of the PyTorch package against
the JAX package's.

``vlm_patch_embeddings`` and ``audio_tokens`` keep the reference's shapes,
types and scale (their draws differ from ``jax.random``'s, so those are
compared as distributions); ``embed_inputs``, ``forward_logits``,
``loss_fn`` and ``prefill`` of reduced llava-next-mistral-7b take the same
NumPy image embeddings as the reference and match it; the ``generate``
CLI builds the reference's vlm prompt (``max(prompt_len - n_img, 8)``
text tokens after the image) and decodes after it.  Everything runs on
the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import frontends as ref_frontends
from repro.models import model as RM
from repro.models.sharding import ShardCtx as RefShardCtx
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.launch import generate as gen_cli
from repro_torch.models import frontends
from repro_torch.models import model as M
from repro_torch.models.sharding import ShardCtx

KEY = jax.random.PRNGKey(0)
RCTX, CTX = RefShardCtx(), ShardCtx()
ARCH = "llava-next-mistral-7b"


def _gen(seed):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_vlm_patch_embeddings_keep_the_references_shape_type_and_scale(
        dtype):
    b, n, d = 3, 2880, 256
    got = frontends.vlm_patch_embeddings(_gen(0), b, n, d, dtype)
    want = ref_frontends.vlm_patch_embeddings(
        KEY, b, n, d, dtype=jnp.dtype(str(dtype).split(".")[-1]))
    assert tuple(got.shape) == want.shape == (b, n, d)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    # N(0, 1) / sqrt(d): both standard deviations within 1% of 1/16
    for x in (got.float().numpy(), np.asarray(want, np.float32)):
        assert abs(float(x.std()) * np.sqrt(d) - 1) < 0.01
        assert abs(float(x.mean())) * np.sqrt(d) < 0.01
    again = frontends.vlm_patch_embeddings(_gen(0), b, n, d, dtype)
    assert torch.equal(got, again)
    assert not torch.equal(got, frontends.vlm_patch_embeddings(
        _gen(1), b, n, d, dtype))


def test_audio_tokens_keep_the_references_shape_type_and_range():
    got = frontends.audio_tokens(_gen(0), 4, 512)
    want = ref_frontends.audio_tokens(KEY, 4, 512)
    assert tuple(got.shape) == want.shape == (4, 512)
    assert got.dtype == torch.int32 and want.dtype == jnp.int32
    # 2048 uniform draws over 2048 values: about 2048 (1 - 1/e) = 1295
    # distinct ones
    for x in (got.numpy(), np.asarray(want)):
        assert x.min() >= 0 and x.max() < 2048 and len(np.unique(x)) > 1200
    small = frontends.audio_tokens(_gen(0), 2, 64, vocab=7)
    assert int(small.max()) < 7
    assert torch.equal(got, frontends.audio_tokens(_gen(0), 4, 512))


def _pair():
    cfg_r = ref_configs.get(ARCH).reduced()
    cfg = configs.get(ARCH).reduced()
    params_r = RM.init_params(cfg_r, KEY)
    params = params_from_reference(jax.tree.map(np.asarray, params_r),
                                   device="cpu")
    rng = np.random.default_rng(0)
    img = (rng.standard_normal((2, cfg.n_img_tokens, cfg.d_model))
           / np.sqrt(cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    return cfg_r, cfg, params_r, params, img, toks


def test_embed_inputs_put_the_image_ahead_of_the_text():
    cfg_r, cfg, params_r, params, img, toks = _pair()
    x, pos = M.embed_inputs(params, cfg, torch.from_numpy(toks).long(),
                            torch.from_numpy(img))
    x_r, pos_r = RM.embed_inputs(params_r, cfg_r, toks, img)
    assert tuple(x.shape) == x_r.shape == (2, cfg.n_img_tokens + 12,
                                           cfg.d_model)
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_r))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_r))
    # bfloat16 embeddings cast the image to their type, as the reference
    bf = {"tok_embed": params["tok_embed"].bfloat16()}
    xb, _ = M.embed_inputs(bf, cfg, torch.from_numpy(toks).long(),
                           torch.from_numpy(img))
    assert xb.dtype == torch.bfloat16
    assert torch.equal(xb[:, :cfg.n_img_tokens],
                       torch.from_numpy(img).bfloat16())


def test_vlm_logits_loss_and_prefill_match_reference():
    cfg_r, cfg, params_r, params, img, toks = _pair()
    t, it = torch.from_numpy(toks).long(), torch.from_numpy(img)
    got = M.forward_logits(params, cfg, CTX, t, it)
    want = RM.forward_logits(params_r, cfg_r, RCTX, toks, img)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)
    labels = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, cfg.n_img_tokens + 12)).astype(np.int32)
    labels[:, :cfg.n_img_tokens] = -1             # no loss on the image
    loss, aux = M.loss_fn(params, cfg, CTX, {
        "tokens": t, "labels": torch.from_numpy(labels).long(),
        "img_embeds": it})
    loss_r, aux_r = RM.loss_fn(params_r, cfg_r, RCTX, {
        "tokens": toks, "labels": labels, "img_embeds": img})
    assert abs(float(loss) - float(loss_r)) <= 1e-4 * (1 + float(loss_r))
    assert float(aux["tokens"]) == float(aux_r["tokens"]) == 24.0
    last, cache = M.prefill(params, cfg, CTX, t, it)
    last_r, cache_r = RM.prefill(params_r, cfg_r, RCTX, toks, img)
    np.testing.assert_allclose(last.numpy(), np.asarray(last_r), rtol=2e-3,
                               atol=2e-3)
    assert cache.keys() == cache_r.keys()
    for k in cache_r:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(cache_r[k]),
                                   rtol=1e-4, atol=1e-4)


def test_vlm_decode_after_the_image_reproduces_forward_logits():
    """A decode step at position ``n_img + s_text`` gives the full
    forward's logits there (the image stays in the cache's first rows)."""
    cfg_r, cfg, params_r, params, img, toks = _pair()
    t, it = torch.from_numpy(toks).long(), torch.from_numpy(img)
    full = M.forward_logits(params, cfg, CTX, t, it)
    _, cache = M.prefill(params, cfg, CTX, t[:, :-1], it)
    pos = cfg.n_img_tokens + t.shape[1] - 1
    logits, _ = M.decode_step(params, cfg, CTX, t[:, -1:],
                              gen_cli.grow_cache(cache, 1), pos)
    np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("prompt_len,s_text", [(10, 8), (40, 24)])
def test_generate_builds_the_references_vlm_prompt(prompt_len, s_text):
    """``n_img`` = 16 in the reduced config: the text is ``max(prompt_len -
    16, 8)`` tokens after the image, and decode starts after both."""
    cfg = configs.get(ARCH).reduced()
    res = gen_cli.generate(cfg, batch=2, prompt_len=prompt_len, gen=3,
                           seed=2, device="cpu")
    assert tuple(res["prompts"].shape) == (2, s_text)
    assert tuple(res["img_embeds"].shape) == (2, 16, cfg.d_model)
    assert res["img_embeds"].dtype == torch.bfloat16
    assert res["prompt_len"] == s_text + 16
    assert tuple(res["tokens"].shape) == (2, 3)


def test_generate_cli_runs_the_vlm_and_audio_archs_on_the_cpu(capsys):
    for arch, plen in ((ARCH, 24), ("musicgen-large", 10)):
        rc = gen_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "10", "--gen",
                           "3"])
        out = capsys.readouterr().out
        assert rc == 0
        assert f"prefill 2x{plen} in" in out and "decoded 2 steps" in out

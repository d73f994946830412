"""The model stack of the PyTorch package against the JAX package's.

Layers and blocks (``rms_norm``, ``apply_rope``, ``decode_attention``,
``causal_conv1d(_step)``, ``selective_scan_step``, ``mamba1_block``) are
held to their ``repro.models`` counterparts on the same NumPy inputs.  The
whole generation path runs on ``reduced()`` qwen2-7b (dense, GQA, QKV
bias), gemma3-12b (sliding-window ring caches beside a global layer),
falcon-mamba-7b (Mamba1), granite-moe-3b-a800m and kimi-k2-1t-a32b (MoE;
kimi also at its head dim of 112, and granite with the config's other
dispatch and combine forms, which decode ignores as the reference's does),
musicgen-large (audio) and zamba2-7b (hybrid: six Mamba2 layers and the
weight-tied attention block after layers 2 and 5): the reference's weights
go through
``params_from_reference``, then ``run_stack``, ``forward_logits``,
``prefill`` and eight greedy ``decode_step``s are compared (the vlm family
in ``tests/test_torch_frontends.py``).  Tolerances:
1e-4 on the residual stream (float32, sums in another order), 2e-3 on
logits (the bfloat16 cast before the head, ``model.py:51`` of the
reference), greedy tokens equal; falcon-mamba-7b and zamba2-7b also in
bfloat16 (see their tests).  Everything runs on the CPU
(``device="cpu"``), where the kernels' plain versions stand in for them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch.steps import make_decode_step as ref_make_decode_step
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import mamba as ref_mamba
from repro.models import model as RM
from repro.models import transformer as ref_tf
from repro.models.sharding import ShardCtx as RefShardCtx
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.launch import generate as gen_cli
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import mamba
from repro_torch.models import model as M
from repro_torch.models import transformer as tf
from repro_torch.models.sharding import ShardCtx

KEY = jax.random.PRNGKey(0)
RCTX, CTX = RefShardCtx(), ShardCtx()
#: (arch, reduced() overrides, prompt length): gemma3 keeps six layers so
#: that one global layer sits beside five sliding-window ones; kimi-k2
#: also runs at its own head dim (112), granite also with the gather
#: dispatch and the einsum combine.
ARCHS = [("qwen2-7b", {}, 16), ("gemma3-12b", {"n_layers": 6}, 32),
         ("falcon-mamba-7b", {}, 16), ("granite-moe-3b-a800m", {}, 16),
         ("kimi-k2-1t-a32b", {}, 16), ("kimi-k2-1t-a32b", {"head_dim": 112}, 16),
         ("granite-moe-3b-a800m", {"moe_gather_dispatch": True,
                                   "moe_combine_f32_materialize": False}, 16),
         ("musicgen-large", {}, 16), ("zamba2-7b", {}, 16)]


def _arch_id(arch, overrides):
    if "head_dim" in overrides:
        return f"{arch}-hd{overrides['head_dim']}"
    if "moe_gather_dispatch" in overrides:
        return f"{arch}-gather-einsum"
    return arch


ARCH_IDS = [_arch_id(a, o) for a, o, _ in ARCHS]
N_DECODE = 8
#: Logit tolerance of the greedy-decode comparison by family.  Both
#: packages round the final state to bfloat16 before the head; where the
#: two float32 streams straddle a bfloat16 boundary, one element of the
#: head's input rounds one step the other way and a logit moves by up to
#: 2^-8 |x_i W_ij|.  An MoE layer sums its k expert rows in another order
#: than XLA, which leaves the stream far enough off (1e-6) that this shows
#: (4.3e-3 on reduced granite-moe-3b-a800m's fourth decode step, every
#: other logit within 1.2e-6): MoE takes 8e-3, one such step of the
#: largest |x_i W_ij| of the reduced configs.  The hybrid's Mamba2 SSD
#: sums in another order than XLA's too (its float32 caches 3e-5 from the
#: reference's), and its logits land up to 2.2e-3 away (reduced zamba2-7b's
#: forward): it takes the same 8e-3.  The caches stay at 1e-4.
DECODE_LOGIT_TOL = {"moe": 8e-3, "hybrid": 8e-3}


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# layers and blocks
# ---------------------------------------------------------------------------

def test_rms_norm_matches_reference():
    rng = _rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 2
    w = rng.standard_normal(64).astype(np.float32)
    _close(layers.rms_norm(_t(x), _t(w), 1e-6),
           ref_layers.rms_norm(x, w, 1e-6), 1e-5)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_reference(theta):
    rng = _rng(2)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    _close(layers.apply_rope(_t(x), _t(pos), theta),
           ref_layers.apply_rope(x, pos, theta), 1e-5)
    _close(layers.rope_freqs(32, theta), ref_layers.rope_freqs(32, theta),
           1e-7)


@pytest.mark.parametrize("pos,window", [(0, 0), (9, 0), (15, 0), (12, 4)])
def test_decode_attention_matches_reference(pos, window):
    rng = _rng(3 + pos)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
    _close(attn.decode_attention(_t(q), _t(k), _t(v), pos, window=window),
           ref_attn.decode_attention(q, k, v, jnp.int32(pos), window=window),
           1e-5)


@pytest.mark.parametrize("causal,window,q_offset",
                         [(True, 0, 0), (True, 5, 0), (False, 0, 0),
                          (True, 0, 3)])
def test_reference_attention_matches_reference(causal, window, q_offset):
    rng = _rng(4)
    q = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    _close(attn.reference_attention(_t(q), _t(k), _t(v), **kw),
           ref_attn.reference_attention(q, k, v, **kw), 1e-5)


def test_causal_conv1d_and_step_match_reference():
    rng = _rng(5)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    _close(mamba.causal_conv1d(_t(x), _t(w), _t(b)),
           ref_mamba.causal_conv1d(x, w, b), 1e-5)
    cache = rng.standard_normal((2, 3, 24)).astype(np.float32)
    y, c = mamba.causal_conv1d_step(_t(x[:, 0]), _t(cache), _t(w), _t(b))
    yr, cr = ref_mamba.causal_conv1d_step(x[:, 0], cache, w, b)
    _close(y, yr, 1e-5)
    _close(c, cr, 0)


def test_selective_scan_step_matches_reference():
    rng = _rng(6)
    x = rng.standard_normal((2, 16)).astype(np.float32)
    dt = np.abs(rng.standard_normal((2, 16))).astype(np.float32) * 0.1
    bb = rng.standard_normal((2, 4)).astype(np.float32)
    cc = rng.standard_normal((2, 4)).astype(np.float32)
    a = -np.exp(rng.standard_normal((16, 4))).astype(np.float32)
    h = rng.standard_normal((2, 16, 4)).astype(np.float32)
    got = mamba.selective_scan_step(*map(_t, (x, dt, bb, cc, a, h)))
    want = ref_mamba.selective_scan_step(x, dt, bb, cc, a, h)
    for g, w_ in zip(got, want):
        _close(g, w_, 1e-5)


def test_softplus_is_logaddexp_like_jax():
    x = np.array([-30, -3, 0, 0.5, 19, 21, 40], np.float32)
    _close(mamba.softplus(_t(x)), jax.nn.softplus(x), 1e-6)


@pytest.fixture(scope="module")
def mamba_layer():
    cfg = ref_configs.get("falcon-mamba-7b").reduced()
    p = jax.tree.map(lambda a: np.asarray(a[0]),
                     ref_tf.init_params(cfg, KEY)["layers"])
    # a non-zero dt_bias and conv bias
    rng = _rng(7)
    p["dt_bias"] = rng.standard_normal(p["dt_bias"].shape).astype(np.float32)
    p["conv_b"] = rng.standard_normal(p["conv_b"].shape).astype(np.float32)
    return cfg, p, params_from_reference(p, device="cpu")


def test_mamba1_block_matches_reference(mamba_layer):
    cfg, p, pt = mamba_layer
    x = _rng(8).standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    y, (h, tail) = mamba.mamba1_block(_t(x), pt, cfg)
    yr, (hr, tailr) = ref_mamba.mamba1_block(x, p, cfg)
    _close(y, yr, 1e-4)
    _close(h, hr, 1e-4)
    _close(tail, tailr, 0)
    # one more token through the single-step path, from those caches
    x1 = _rng(9).standard_normal((2, cfg.d_model)).astype(np.float32)
    y1, (h1, c1) = mamba.mamba1_block(_t(x1), pt, cfg, h0=h, conv0=tail,
                                      single_step=True)
    y1r, (h1r, c1r) = ref_mamba.mamba1_block(x1, p, cfg, h0=hr, conv0=tailr,
                                             single_step=True)
    _close(y1, y1r, 1e-4)
    _close(h1, h1r, 1e-4)
    _close(c1, c1r, 1e-5)


def _mamba1_block_aten(x, p, cfg, h0=None, conv0=None, single_step=False):
    """``mamba1_block`` as it ran before the fused scan: ATen's softplus,
    the plain scan or one-step update, D skip, gate and cast."""
    from repro_torch.kernels.selective_scan import selective_scan_ref
    n = cfg.ssm_state
    A = -torch.exp(p["A_log"].to(torch.float32))
    xi, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    if single_step:
        xi, conv_cache = mamba.causal_conv1d_step(xi, conv0, p["conv_w"],
                                                  p["conv_b"])
    else:
        conv_cache = xi[:, -(cfg.ssm_conv - 1):, :].clone()
        xi = mamba.causal_conv1d(xi, p["conv_w"], p["conv_b"])
    xi = layers.silu(xi)
    dt, B_, C_ = torch.split(xi @ p["x_proj"], [cfg.dt_rank, n, n], dim=-1)
    dt = mamba.softplus(dt @ p["dt_w"] + p["dt_bias"].to(dt.dtype))
    if single_step:
        y, h = mamba.selective_scan_step(xi, dt, B_, C_, A, h0)
    else:
        y, h = selective_scan_ref(xi, dt, B_, C_, A, h0)
    y = y + p["D"].to(torch.float32) * xi.to(torch.float32)
    y = y * layers.silu(z.to(torch.float32))
    return y.to(x.dtype) @ p["out_proj"], (h, conv_cache)


def test_mamba1_block_takes_the_fused_scan_and_keeps_its_bits(mamba_layer,
                                                              monkeypatch):
    """Both branches call ``selective_scan_fused`` once (``step`` on the
    decode branch); on the CPU the block returns what the ATen sequence
    it replaced returns, bit for bit, and ``h_out`` receives the state."""
    cfg, _, pt = mamba_layer
    calls = []
    fused = mamba.selective_scan_fused

    def spy(*args, step=False):
        calls.append(step)
        return fused(*args, step=step)

    monkeypatch.setattr(mamba, "selective_scan_fused", spy)
    x = _t(_rng(10).standard_normal((2, 12, cfg.d_model)).astype(np.float32))
    y, (h, tail) = mamba.mamba1_block(x, pt, cfg)
    y_a, (h_a, tail_a) = _mamba1_block_aten(x, pt, cfg)
    x1 = _t(_rng(11).standard_normal((2, cfg.d_model)).astype(np.float32))
    state = h.clone()
    y1, (h1, c1) = mamba.mamba1_block(x1, pt, cfg, h0=state, conv0=tail,
                                      single_step=True, h_out=state)
    y1_a, (h1_a, c1_a) = _mamba1_block_aten(x1, pt, cfg, h0=h_a,
                                            conv0=tail_a, single_step=True)
    assert calls == [False, True] and h1 is state
    for got, want in ((y, y_a), (h, h_a), (tail, tail_a), (y1, y1_a),
                      (h1, h1_a), (c1, c1_a)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_decode_step_writes_the_ssm_state_in_place():
    """A Mamba layer's decode step writes its new state over the cache row
    it read: the same tensor and storage come back, with new values."""
    cfg = configs.get("falcon-mamba-7b").reduced()
    params = tf.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_rng(12).integers(0, cfg.vocab_size, (2, 9)))
    _, cache = M.prefill(params, cfg, CTX, toks[:, :8])
    cache = gen_cli.grow_cache(cache, 1)
    ssm, before = cache["ssm"], cache["ssm"].clone()
    ptr = ssm.data_ptr()
    _, cache = M.decode_step(params, cfg, CTX, toks[:, 8:], cache, 8)
    assert cache["ssm"] is ssm and ssm.data_ptr() == ptr
    assert not torch.equal(ssm, before)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma3-12b",
                                  "falcon-mamba-7b", "granite-moe-3b-a800m",
                                  "kimi-k2-1t-a32b", "llava-next-mistral-7b",
                                  "musicgen-large", "zamba2-7b"])
def test_init_params_has_the_reference_keys_shapes_and_types(arch):
    cfg = configs.get(arch).reduced(vocab_size=500)
    mine = tf.init_params(cfg, seed=0, device="cpu")
    theirs = ref_tf.init_params(ref_configs.get(arch).reduced(
        vocab_size=500), KEY)
    flat_m = {"/".join(map(str, k)): v for k, v in
              jax.tree_util.tree_flatten_with_path(mine)[0]}
    flat_r = {"/".join(map(str, k)): v for k, v in
              jax.tree_util.tree_flatten_with_path(theirs)[0]}
    assert flat_m.keys() == flat_r.keys()
    for k in flat_r:
        assert tuple(flat_m[k].shape) == flat_r[k].shape, k
        assert str(flat_m[k].dtype).split(".")[-1] == \
            str(flat_r[k].dtype), k
    assert not mine["tok_embed"][500:].any()
    assert not mine["lm_head"][:, 500:].any()
    assert mine["tok_embed"][:500].std() > 0


def test_params_from_reference_keeps_bfloat16_bits():
    a = np.asarray(jnp.linspace(-3, 3, 11, dtype=jnp.bfloat16))
    t = params_from_reference({"w": {"x": a}}, device="cpu")["w"]["x"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16))


def test_unported_families_raise_naming_the_roadmap_item(monkeypatch):
    """Every family of the JAX package is ported: ``NOT_PORTED`` is empty
    and every arch of ``configs.ARCHS`` builds at ``reduced()`` (the
    hybrid zamba2-7b included, with its ``shared`` block).  The refusal
    itself stays for a family that a later config may add: one listed in
    ``NOT_PORTED`` raises, naming its ROADMAP item."""
    assert tf.NOT_PORTED == {}
    for arch in configs.ARCHS:
        cfg = configs.get(arch).reduced()
        tf.check_family(cfg)
        params = tf.init_params(cfg, device="cpu")
        assert ("shared" in params) == (cfg.family == "hybrid"), arch
    monkeypatch.setitem(tf.NOT_PORTED, "hybrid", "ROADMAP Queue A 99")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A 99"):
        tf.init_params(configs.get("zamba2-7b").reduced(), device="cpu")


# ---------------------------------------------------------------------------
# the generation path, end to end
# ---------------------------------------------------------------------------

def _both(arch, overrides):
    cfg_r = ref_configs.get(arch).reduced(**overrides)
    cfg = configs.get(arch).reduced(**overrides)
    params_r = ref_tf.init_params(cfg_r, KEY)
    params = params_from_reference(jax.tree.map(np.asarray, params_r),
                                   device="cpu")
    return cfg_r, cfg, params_r, params


@pytest.fixture(scope="module", params=ARCHS, ids=ARCH_IDS)
def model_pair(request):
    arch, overrides, s = request.param
    cfg_r, cfg, params_r, params = _both(arch, overrides)
    toks = np.asarray(jax.random.randint(KEY, (2, s + N_DECODE), 0,
                                         cfg.vocab_size, jnp.int32))
    return cfg_r, cfg, params_r, params, toks, s


def test_run_stack_matches_reference(model_pair):
    cfg_r, cfg, params_r, params, toks, s = model_pair
    x_r, pos_r = RM.embed_inputs(params_r, cfg_r, toks[:, :s])
    x, pos = M.embed_inputs(params, cfg, _t(toks[:, :s]).long())
    _close(x, x_r, 0)
    out, _ = tf.run_stack(x, params, cfg, CTX, pos)
    out_r, _ = ref_tf.run_stack(x_r, params_r, cfg_r, RCTX, pos_r)
    _close(out, out_r, 1e-4)


def test_forward_logits_match_reference(model_pair):
    cfg_r, cfg, params_r, params, toks, s = model_pair
    got = M.forward_logits(params, cfg, CTX, _t(toks[:, :s]).long())
    want = RM.forward_logits(params_r, cfg_r, RCTX, toks[:, :s])
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want, DECODE_LOGIT_TOL.get(cfg.family, 2e-3))


def test_prefill_then_greedy_decode_match_reference(model_pair):
    cfg_r, cfg, params_r, params, toks, s = model_pair
    last, cache = M.prefill(params, cfg, CTX, _t(toks[:, :s]).long())
    last_r, cache_r = RM.prefill(params_r, cfg_r, RCTX, toks[:, :s])
    tol = DECODE_LOGIT_TOL.get(cfg.family, 2e-3)
    _close(last, last_r, tol)
    assert cache.keys() == cache_r.keys()
    for k in cache_r:
        assert tuple(cache[k].shape) == cache_r[k].shape, k
        _close(cache[k], cache_r[k], 1e-4)

    cache = gen_cli.grow_cache(cache, N_DECODE)
    cache_r = {k: (jnp.pad(v, [(0, 0), (0, 0), (0, N_DECODE), (0, 0),
                               (0, 0)]) if k in ("k", "v") else v)
               for k, v in cache_r.items()}
    step_r = jax.jit(ref_make_decode_step(cfg_r, RCTX))
    step = make_decode_step(cfg, CTX)
    tok_r = jnp.argmax(last_r, -1).astype(jnp.int32)[:, None]
    tok = torch.argmax(last, -1)[:, None]
    for i in range(N_DECODE):
        assert tok.tolist() == np.asarray(tok_r).tolist(), i
        tok, logits, cache = step(params, cache, tok, s + i)
        tok_r, logits_r, cache_r = step_r(params_r, cache_r, tok_r,
                                          jnp.int32(s + i))
        _close(logits, logits_r, tol)
    assert tok.tolist() == np.asarray(tok_r).tolist()
    for k in cache_r:
        _close(cache[k], cache_r[k], 1e-4)


def test_decode_step_reproduces_forward_logits_at_the_next_position(
        model_pair):
    """decode at position s must give forward_logits[:, s] — the
    reference's own prefill/decode consistency check, on the port."""
    cfg_r, cfg, params_r, params, toks, s = model_pair
    t = _t(toks[:, :s + 1]).long()
    full = M.forward_logits(params, cfg, CTX, t)
    _, cache = M.prefill(params, cfg, CTX, t[:, :s])
    logits, _ = M.decode_step(params, cfg, CTX, t[:, s:s + 1],
                              gen_cli.grow_cache(cache, 1), s)
    _close(logits, full[:, s], 2e-3)


def _op_by_op_logits(params_r, cfg_r, toks):
    """The reference's Mamba1 forward with its layer functions called one
    by one, outside a compiled scan: each op rounds to the activation
    type as its jaxpr says."""
    x, _ = RM.embed_inputs(params_r, cfg_r, toks)
    for i in range(cfg_r.n_layers):
        lp = jax.tree.map(lambda a: a[i], params_r["layers"])
        y, _ = ref_mamba.mamba1_block(
            ref_layers.rms_norm(x, lp["ln1"], cfg_r.norm_eps), lp, cfg_r)
        x = x + y
    x = ref_layers.rms_norm(x, params_r["final_norm"], cfg_r.norm_eps)
    return RM._project_logits(x, params_r, cfg_r)


def test_falcon_mamba_bfloat16_matches_reference_logits_and_tokens():
    """Reduced falcon-mamba-7b with bfloat16 weights and activations.

    The port's logits are bit-equal to the reference's layers called op
    by op: its softplus and silu round each op to bfloat16 as JAX's do.
    The reference's own ``forward_logits`` runs the layers in a compiled
    scan, where XLA keeps some products in float32 (its compiled and
    op-by-op logits differ by up to 7.0e-2 of ``1 + |l|``), so the port is
    held to it at 8e-2 of ``1 + |l|``: prefill, then eight greedy decode
    steps, each fed the reference's token.  The port's token equals the
    reference's at every step, except where the reference's logit at the
    port's token is within that tolerance of its largest (a near-tie
    bfloat16 logits cannot order; seen twice in eight steps)."""
    cfg_r, cfg, params_r, params = _both("falcon-mamba-7b",
                                         {"dtype": "bfloat16"})
    s, tol = 16, 8e-2
    toks = np.asarray(jax.random.randint(KEY, (2, s + N_DECODE), 0,
                                         cfg.vocab_size, jnp.int32))
    got = M.forward_logits(params, cfg, CTX, _t(toks[:, :s]).long())
    assert got.dtype == torch.bfloat16
    _close(got, _op_by_op_logits(params_r, cfg_r, toks[:, :s]), 0)
    _close(got, RM.forward_logits(params_r, cfg_r, RCTX, toks[:, :s]), tol)

    last, cache = M.prefill(params, cfg, CTX, _t(toks[:, :s]).long())
    last_r, cache_r = RM.prefill(params_r, cfg_r, RCTX, toks[:, :s])
    _close(last, last_r, tol)
    cache = gen_cli.grow_cache(cache, N_DECODE)
    step_r = jax.jit(ref_make_decode_step(cfg_r, RCTX))
    step = make_decode_step(cfg, CTX)
    tok_r = jnp.argmax(last_r, -1).astype(jnp.int32)[:, None]
    assert torch.argmax(last, -1).tolist() == np.asarray(tok_r)[:, 0].tolist()
    exact = 0
    for i in range(N_DECODE):
        tok, logits, cache = step(params, cache, _t(tok_r).long(), s + i)
        tok_r, logits_r, cache_r = step_r(params_r, cache_r, tok_r,
                                          jnp.int32(s + i))
        _close(logits, logits_r, tol)
        lr = _np(logits_r)
        for b, (mine, theirs) in enumerate(zip(tok[:, 0].tolist(),
                                               np.asarray(tok_r)[:, 0])):
            exact += mine == theirs
            top = lr[b].max()
            assert mine == theirs or lr[b, mine] >= top - tol * (1 + top), i
    assert exact >= 2 * N_DECODE - 2
    for k in cache_r:
        _close(cache[k], cache_r[k], tol)


def _hybrid_op_by_op_logits(params_r, cfg_r, toks):
    """The reference's hybrid forward with its layer functions called one
    by one, outside a compiled scan: each Mamba2 layer, and the shared
    block after each layer in ``shared_at``."""
    x, pos = RM.embed_inputs(params_r, cfg_r, toks)
    _, meta = ref_tf.layer_plan(cfg_r)
    for i in range(cfg_r.n_layers):
        lp = jax.tree.map(lambda a: a[i], params_r["layers"])
        y, _ = ref_mamba.mamba2_block(
            ref_layers.rms_norm(x, lp["ln1"], cfg_r.norm_eps), lp, cfg_r)
        x = x + y
        if i in meta["shared_at"]:
            x = ref_tf.shared_attn_apply(x, params_r["shared"], cfg_r, RCTX,
                                         pos, cfg_r.rope_theta)
    x = ref_layers.rms_norm(x, params_r["final_norm"], cfg_r.norm_eps)
    return RM._project_logits(x, params_r, cfg_r)


def test_zamba2_bfloat16_matches_reference_logits_and_tokens():
    """Reduced zamba2-7b with bfloat16 weights and activations, at
    falcon-mamba-7b's bfloat16 tolerance of 8e-2 of ``1 + |l|``.

    Here the reference's compiled ``forward_logits`` equals its layers
    called op by op, bit for bit.  The port is not bit-equal to either:
    each Mamba2 block rounds its float32 SSD output to bfloat16 before the
    output projection, and the SSD's float32 sums (the cumulative sum, the
    contractions) run in another order than XLA's, so an element at a
    rounding boundary lands one bfloat16 step away (0.07 % of one reduced
    block's outputs; ``tests/test_torch_mamba2.py`` holds each block to
    one step).  Over six layers and two shared-block applications the
    logits stay within the tolerance (measured 5.5e-2 of ``1 + |l|``).
    Then prefill and eight greedy decode steps, each fed the reference's
    token and the reference's cache (a decode step's state goes on
    drifting by a bfloat16 step a layer: fed its own cache, the port's
    eighth step is 9.4e-2 away), with the cache rows each step writes held
    to the reference's: the port's token equals the reference's at every
    step, except where the reference's logit at the port's token is within
    the tolerance of its largest (a near-tie bfloat16 logits cannot
    order)."""
    cfg_r, cfg, params_r, params = _both("zamba2-7b", {"dtype": "bfloat16"})
    assert params["shared"]["wq"].dtype == torch.bfloat16
    s, tol = 16, 8e-2
    toks = np.asarray(jax.random.randint(KEY, (2, s + N_DECODE), 0,
                                         cfg.vocab_size, jnp.int32))

    def within(got, want):
        got, want = _np(got), _np(want)
        assert np.all(np.abs(got - want) <= tol * (1 + np.abs(want)))

    got = M.forward_logits(params, cfg, CTX, _t(toks[:, :s]).long())
    assert got.dtype == torch.bfloat16
    op = _hybrid_op_by_op_logits(params_r, cfg_r, toks[:, :s])
    within(got, op)
    within(got, RM.forward_logits(params_r, cfg_r, RCTX, toks[:, :s]))

    last, cache = M.prefill(params, cfg, CTX, _t(toks[:, :s]).long())
    last_r, cache_r = RM.prefill(params_r, cfg_r, RCTX, toks[:, :s])
    within(last, last_r)
    for k in cache_r:
        within(cache[k], cache_r[k])
    cache_r = {k: (jnp.pad(v, [(0, 0), (0, 0), (0, N_DECODE), (0, 0),
                               (0, 0)]) if k in ("k", "v") else v)
               for k, v in cache_r.items()}
    step_r = jax.jit(ref_make_decode_step(cfg_r, RCTX))
    step = make_decode_step(cfg, CTX)
    tok_r = jnp.argmax(last_r, -1).astype(jnp.int32)[:, None]
    exact = 0
    for i in range(N_DECODE):
        cache = params_from_reference(jax.tree.map(np.asarray, cache_r),
                                      device="cpu")
        tok, logits, cache = step(params, cache, _t(tok_r).long(), s + i)
        tok_r, logits_r, cache_r = step_r(params_r, cache_r, tok_r,
                                          jnp.int32(s + i))
        within(logits, logits_r)
        for k in ("ssm", "conv"):
            within(cache[k], cache_r[k])
        for k in ("k", "v"):
            within(cache[k][:, :, s + i], cache_r[k][:, :, s + i])
        lr = _np(logits_r)
        for b, (mine, theirs) in enumerate(zip(tok[:, 0].tolist(),
                                               np.asarray(tok_r)[:, 0])):
            exact += mine == theirs
            top = lr[b].max()
            assert mine == theirs or lr[b, mine] >= top - tol * (1 + top), i
    assert exact >= 2 * N_DECODE - 2


def _op_by_op_forward(params_r, cfg_r, toks):
    """The reference's attention-family forward with its layer body called
    once a layer, outside the compiled scan (each op rounds as its jaxpr
    says): all logits and each layer's ``(k, v)``, stacked."""
    x, pos = RM.embed_inputs(params_r, cfg_r, toks)
    body = ref_tf._layer_body(cfg_r, RCTX, True)
    plan, _ = ref_tf.layer_plan(cfg_r)
    ks, vs = [], []
    for i, e in enumerate(plan):
        lp = jax.tree.map(lambda a: a[i], params_r["layers"])
        x, (k, v) = body(x, lp, e["window"], e["theta"], pos)
        ks.append(k)
        vs.append(v)
    x = ref_layers.rms_norm(x, params_r["final_norm"], cfg_r.norm_eps)
    return RM._project_logits(x, params_r, cfg_r), jnp.stack(ks), \
        jnp.stack(vs)


def _op_by_op_decode(params_r, cfg_r, tok, ck, cv, pos):
    """One decode step of the reference's layers called one by one (full
    caches ``ck, cv`` ``(L, b, S, KV, hd)``): ``(logits, ck, cv)``."""
    x = params_r["tok_embed"][tok]
    plan, _ = ref_tf.layer_plan(cfg_r)
    for i, e in enumerate(plan):
        lp = jax.tree.map(lambda a: a[i], params_r["layers"])
        x, cki, cvi = RM._decode_layer_body(
            x, lp, ck[i], cv[i], cfg_r, RCTX, jnp.int32(pos), kind=e["kind"],
            cache_kind="full", window=0, theta=e["theta"])
        ck, cv = ck.at[i].set(cki), cv.at[i].set(cvi)
    x = ref_layers.rms_norm(x, params_r["final_norm"], cfg_r.norm_eps)
    return RM._project_logits(x, params_r, cfg_r)[:, 0], ck, cv


def test_granite_moe_bfloat16_matches_reference_logits_and_tokens():
    """Reduced granite-moe-3b-a800m with bfloat16 weights and activations
    (the router float32 in both), at falcon-mamba-7b's bfloat16 tolerance
    of 8e-2 of ``1 + |l|``.

    The port is held to the reference's layers called op by op: the
    logits, then eight greedy decode steps, each fed the reference's token
    and the reference's cache (a router near-tie lets one bfloat16 step
    send a token to another expert, so each step starts from the same
    state), the port's token equal to the reference's except at a
    near-tie within the tolerance, and the port's cache rows written as
    the reference's.  (Given the same inputs, each attention and MoE block of
    the port is within one bfloat16 step of the reference's.)  The
    reference's compiled ``forward_logits`` keeps some products in float32
    and so routes a token or two to another expert than its own op-by-op
    layers do (a gate near-tie; up to 0.79 on a logit after it): the port
    is held to it at the tolerance on every token where the reference
    agrees with itself, and those are most of them."""
    cfg_r, cfg, params_r, params = _both("granite-moe-3b-a800m",
                                         {"dtype": "bfloat16"})
    assert params["layers"]["router"].dtype == torch.float32
    assert params["layers"]["e_gate"].dtype == torch.bfloat16
    s, tol = 16, 8e-2
    toks = np.asarray(jax.random.randint(KEY, (2, s + N_DECODE), 0,
                                         cfg.vocab_size, jnp.int32))
    got = _np(M.forward_logits(params, cfg, CTX, _t(toks[:, :s]).long()))
    op, ck, cv = _op_by_op_forward(params_r, cfg_r, toks[:, :s])
    op = _np(op)
    assert np.all(np.abs(got - op) <= tol * (1 + np.abs(op)))
    compiled = _np(RM.forward_logits(params_r, cfg_r, RCTX, toks[:, :s]))
    self_ok = (np.abs(compiled - op) <= tol * (1 + np.abs(op))).all(-1)
    assert self_ok.mean() >= 0.75
    assert np.all((np.abs(got - compiled) <= tol * (1 + np.abs(compiled)))
                  .all(-1)[self_ok])

    last, cache = M.prefill(params, cfg, CTX, _t(toks[:, :s]).long())
    np.testing.assert_allclose(_np(last), op[:, -1], rtol=tol, atol=tol)
    pad = [(0, 0), (0, 0), (0, N_DECODE), (0, 0), (0, 0)]
    ck, cv = jnp.pad(ck, pad), jnp.pad(cv, pad)
    step = make_decode_step(cfg, CTX)
    tok_r = jnp.argmax(jnp.asarray(op[:, -1]), -1).astype(jnp.int32)[:, None]
    exact = 0
    for i in range(N_DECODE):
        cache = params_from_reference({"k": np.asarray(ck),
                                       "v": np.asarray(cv)}, device="cpu")
        tok, logits, cache = step(params, cache, _t(tok_r).long(), s + i)
        logits_r, ck, cv = _op_by_op_decode(params_r, cfg_r, tok_r, ck, cv,
                                            s + i)
        _close(logits, logits_r, tol)
        for key, want in (("k", ck), ("v", cv)):
            _close(cache[key][:, :, s + i], want[:, :, s + i], tol)
        lr = _np(logits_r)
        tok_r = jnp.argmax(logits_r, -1).astype(jnp.int32)[:, None]
        for b, (mine, theirs) in enumerate(zip(tok[:, 0].tolist(),
                                               np.asarray(tok_r)[:, 0])):
            exact += mine == theirs
            top = lr[b].max()
            assert mine == theirs or lr[b, mine] >= top - tol * (1 + top), i
    assert exact >= 2 * N_DECODE - 2


def test_padded_vocabulary_rows_are_masked_like_the_reference():
    cfg_r, cfg, params_r, params = _both("qwen2-7b", {"vocab_size": 500,
                                                      "n_layers": 2})
    toks = np.arange(10, dtype=np.int32).reshape(2, 5)
    got = M.forward_logits(params, cfg, CTX, _t(toks).long())
    want = RM.forward_logits(params_r, cfg_r, RCTX, toks)
    assert got.shape[-1] == 512
    assert (got[..., 500:] <= -1e29).all()
    _close(got[..., :500], np.asarray(want)[..., :500], 2e-3)


def test_bfloat16_head_keeps_the_reference_promotion():
    """bfloat16 weights: the head's product stays bfloat16; a float32 head
    (``reduced()``) promotes it to float32, as jnp does."""
    cfg = configs.get("qwen2-7b").reduced(n_layers=1)
    params = tf.init_params(cfg, device="cpu")
    x = torch.randn(2, 1, cfg.d_model)
    assert M._project_logits(x, params, cfg).dtype == torch.float32
    bf = {"tok_embed": params["tok_embed"].bfloat16(),
          "lm_head": params["lm_head"].bfloat16()}
    assert M._project_logits(x, bf, cfg).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma3-12b",
                                  "falcon-mamba-7b", "granite-moe-3b-a800m",
                                  "kimi-k2-1t-a32b", "zamba2-7b"])
def test_generate_cli_smoke_on_the_cpu(arch, capsys):
    rc = gen_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "10", "--gen", "4"])
    out = capsys.readouterr().out
    assert rc == 0
    plen = 16 if arch == "gemma3-12b" else 10      # rounded to the window
    assert f"prefill 2x{plen} in" in out and "decoded 3 steps" in out
    assert "ms/tok" in out and "[generate] sample:" in out


def test_generate_returns_tokens_and_timings_on_the_cpu():
    cfg = configs.get("falcon-mamba-7b").reduced()
    res = gen_cli.generate(cfg, batch=3, prompt_len=5, gen=4, seed=1,
                           device="cpu")
    assert tuple(res["tokens"].shape) == (3, 4)
    assert tuple(res["prompts"].shape) == (3, 5)
    assert res["tokens"].max() < cfg.vocab_size
    assert res["prefill_s"] > 0 and res["decode_steps"] == 3
    assert res["peak_bytes"] is None
    again = gen_cli.generate(cfg, batch=3, prompt_len=5, gen=4, seed=1,
                             device="cpu")
    assert torch.equal(res["tokens"], again["tokens"])


def test_generate_cli_refuses_unported_families_and_a_missing_card(
        monkeypatch, capsys):
    """The hybrid zamba2-7b, the last family to be ported, now runs (exit
    0); a family listed in ``NOT_PORTED`` still exits 2 naming its ROADMAP
    item; without a card the default device raises."""
    for arch in ("zamba2-7b",):
        assert gen_cli.main(["--arch", arch, "--smoke", "--device",
                             "cpu"]) == 0
    assert "[generate] zamba2-7b-smoke" in capsys.readouterr().out
    monkeypatch.setitem(tf.NOT_PORTED, "hybrid", "ROADMAP Queue A 99")
    with pytest.raises(SystemExit) as e:
        gen_cli.main(["--arch", "zamba2-7b", "--smoke", "--device", "cpu"])
    assert e.value.code == 2
    assert "ROADMAP Queue A 99" in capsys.readouterr().err
    monkeypatch.undo()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        gen_cli.main(["--smoke", "--batch", "1", "--prompt-len", "4",
                      "--gen", "2"])


@pytest.mark.parametrize("arch,overrides", [(a, o) for a, o, _ in ARCHS],
                         ids=ARCH_IDS)
def test_init_cache_matches_reference_shapes(arch, overrides):
    cfg = configs.get(arch).reduced(**overrides)
    mine = M.init_cache(cfg, 3, 40, device="cpu")
    theirs = RM.init_cache(ref_configs.get(arch).reduced(**overrides), 3, 40)
    assert mine.keys() == theirs.keys()
    for k in theirs:
        assert tuple(mine[k].shape) == theirs[k].shape, k
        assert str(mine[k].dtype).split(".")[-1] == str(theirs[k].dtype), k
        assert not mine[k].any()


@pytest.mark.parametrize("arch,overrides,s", ARCHS, ids=ARCH_IDS)
def test_norms_take_the_pending_residual_in_one_call(arch, overrides, s,
                                                     monkeypatch):
    """With ``norms = 1 + k * L`` (k = 2 with attention, 1 Mamba1) a
    prefill makes one plain norm over the sequence, ``norms - 2`` residual
    ones over the sequence and one plain norm of the last row; a decode
    step one plain and ``norms - 1`` residual ones — the split the card's
    launch counts show.  A hybrid adds each Mamba2 layer's gated norm (a
    plain one over the layer's ``d_inner``-wide output) after its ``ln1``,
    and the shared block's two residual norms after each layer it
    follows."""
    cfg = configs.get(arch).reduced(**overrides)
    params = tf.init_params(cfg, seed=0, device="cpu")
    calls = []
    rmsnorm, add_rmsnorm = layers.rmsnorm, layers.add_rmsnorm

    def plain(x, w, eps):
        calls.append(("plain", x.shape[1]))
        return rmsnorm(x, w, eps)

    def fused(x, r, w, eps):
        calls.append(("add", x.shape[1]))
        return add_rmsnorm(x, r, w, eps)

    monkeypatch.setattr(layers, "rmsnorm", plain)
    monkeypatch.setattr(layers, "add_rmsnorm", fused)
    norms = 1 + (2 if cfg.family in tf.ATTENTION_FAMILIES else 1) \
        * cfg.n_layers
    toks = torch.from_numpy(_rng(4).integers(0, cfg.vocab_size, (2, s + 1)))
    last, cache = M.prefill(params, cfg, CTX, toks[:, :s])
    if cfg.family == "hybrid":
        _, meta = tf.layer_plan(cfg)

        def stack(rows, gated):
            out = []
            for i in range(cfg.n_layers):
                out += [("plain" if i == 0 else "add", rows),
                        ("plain", gated)]
                out += [("add", rows)] * 2 * (i in meta["shared_at"])
            return out

        assert calls == stack(s, s) + [("plain", 1)]
        calls.clear()
        M.decode_step(params, cfg, CTX, toks[:, s:],
                      gen_cli.grow_cache(cache, 1), s)
        # a decode step's gated norm takes (b, d_inner)
        assert calls == stack(1, cfg.d_inner) + [("add", 1)]
        return
    assert calls == [("plain", s)] + [("add", s)] * (norms - 2) \
        + [("plain", 1)]
    calls.clear()
    M.decode_step(params, cfg, CTX, toks[:, s:], gen_cli.grow_cache(cache, 1),
                  s)
    assert calls == [("plain", 1)] + [("add", 1)] * (norms - 1)

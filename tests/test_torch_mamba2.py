"""Mamba2 of the PyTorch package against the JAX package's.

``ssd_scan`` (the chunked dual form), ``ssd_step`` and both branches of
``mamba2_block`` are held to their ``repro.models.mamba`` counterparts on
the same NumPy inputs, made from a seed; ``ssd_scan`` also to the naive
recurrence of ``ssd_step`` (the port of the reference's
``tests/test_kernels.py::test_ssd_matches_naive_recurrence``, at its 2e-4),
with an initial state and at a length that the default chunk of 128 does
not divide.  Everything runs on the CPU (``device="cpu"``), where the gated
norm takes the ``rmsnorm`` kernel's plain version.

Tolerances.  float32: 2e-4 against the naive recurrence (the reference's
own), 2e-5 against the reference's ``ssd_scan`` (the inclusive cumulative
sum and the three-operand contraction sum in another order than XLA's;
measured ≤ 3e-6), 1e-4 on a block's output and its conv cache (the
projections sum in another order too).
bfloat16: a block rounds its float32 SSD output to bfloat16 before the
output projection, so an element that sits at a rounding boundary lands
one bfloat16 step (2^-8 relative) from the reference's; the block and its
conv cache are held to one step of their largest magnitude, the state to
1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import mamba as ref_mamba
from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.models import mamba

KEY = jax.random.PRNGKey(0)
#: (b, S, H, P, N, chunk): the reference test's shape at chunk 8; one
#: chunk; 200 positions at the default chunk (200 = 2 x 100, so the chunk
#: is 100); 512 at the default (chunk 128, as zamba2's prefill).
SSD_CASES = [(1, 32, 2, 8, 4, 8), (2, 16, 3, 4, 8, 16),
             (1, 200, 2, 4, 4, 128), (1, 512, 2, 4, 8, 128)]
SSD_IDS = ["ref-case", "one-chunk", "S200", "S512"]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _ssd_inputs(b, s, h, p, n, seed):
    """The reference test's distributions: ``x`` ~ N(0, 0.25), ``dt`` a
    softplus times 0.2, ``A = -exp(0.3 N(0, 1))``."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = (np.logaddexp(rng.standard_normal((b, s, h)), 0) * 0.2).astype(
        np.float32)
    bb = rng.standard_normal((b, s, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, n)).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    return x, dt, bb, cc, a


def _naive(x, dt, bb, cc, a, state):
    ys = []
    for t in range(x.shape[1]):
        y, state = mamba.ssd_step(x[:, t], dt[:, t], bb[:, t], cc[:, t], a,
                                  state)
        ys.append(y)
    return torch.stack(ys, 1), state


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("case", SSD_CASES, ids=SSD_IDS)
def test_ssd_matches_naive_recurrence(case, with_h0):
    """The chunked dual form against the per-step recurrence, at the
    reference test's 2e-4 (its shape and distributions in the first
    case)."""
    b, s, h, p, n, chunk = case
    x, dt, bb, cc, a = map(_t, _ssd_inputs(b, s, h, p, n, seed=s + h))
    h0 = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (b, h, p, n)).astype(np.float32)) if with_h0 else None
    y, hf = mamba.ssd_scan(x, dt, bb, cc, a, h0=h0, chunk=chunk)
    start = h0 if with_h0 else torch.zeros((b, h, p, n))
    y_ref, state = _naive(x, dt, bb, cc, a, start)
    assert y.dtype == hf.dtype == torch.float32
    _close(y, y_ref, 2e-4)
    _close(hf, state, 2e-4)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("case", SSD_CASES, ids=SSD_IDS)
def test_ssd_scan_matches_reference(case, with_h0):
    b, s, h, p, n, chunk = case
    arrays = _ssd_inputs(b, s, h, p, n, seed=3 * s + h)
    h0 = np.random.default_rng(6).standard_normal((b, h, p, n)).astype(
        np.float32) if with_h0 else None
    y, hf = mamba.ssd_scan(*map(_t, arrays),
                           h0=None if h0 is None else _t(h0), chunk=chunk)
    y_r, hf_r = ref_mamba.ssd_scan(*arrays, h0=h0, chunk=chunk)
    _close(y, y_r, 2e-5)
    _close(hf, hf_r, 2e-5)


def test_pick_chunk_is_the_references():
    """One chunk rule for the SSD and the chunked attention, the
    reference's in both of its modules."""
    from repro.models import attention as ref_attn
    from repro_torch.models.layers import pick_chunk
    for s, target in [(512, 128), (200, 128), (97, 128), (64, 16), (7, 3)]:
        assert pick_chunk(s, target) == ref_mamba._pick_chunk(s, target) \
            == ref_attn._pick_chunk(s, target)


def test_ssd_scan_gradient_is_finite_and_matches_jax_vjp():
    """The mask sits inside the exponent: with a decay large enough that
    ``exp(l_i - l_j)`` of a masked pair (j > i) would overflow, the
    gradient stays finite, and equals ``jax.vjp`` of the reference's
    ``ssd_scan`` (each input's relative Frobenius error at most 1e-4)."""
    b, s, h, p, n = 1, 32, 2, 4, 4
    x, dt, bb, cc, a = _ssd_inputs(b, s, h, p, n, seed=11)
    a = a * 60.0                        # exp(+|l|) of a masked pair: inf
    rng = np.random.default_rng(12)
    gy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    gh = rng.standard_normal((b, h, p, n)).astype(np.float32)
    ins = [_t(v).requires_grad_() for v in (x, dt, bb, cc, a)]
    y, hf = mamba.ssd_scan(*ins, chunk=8)
    grads = torch.autograd.grad((y, hf), ins, (_t(gy), _t(gh)))
    _, vjp = jax.vjp(lambda *v: ref_mamba.ssd_scan(*v, chunk=8),
                     x, dt, bb, cc, a)
    want = vjp((gy, gh))
    for g, w in zip(grads, want):
        g, w = _np(g), np.asarray(w)
        assert np.isfinite(g).all()
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w)


@pytest.mark.parametrize("in_place", [False, True])
def test_ssd_step_matches_reference(in_place):
    """One decode step; with ``h_out`` the state it was given is updated in
    place and returned."""
    rng = np.random.default_rng(8)
    b, h, p, n = 2, 3, 4, 8
    x = rng.standard_normal((b, h, p)).astype(np.float32)
    dt = np.abs(rng.standard_normal((b, h))).astype(np.float32) * 0.1
    bb = rng.standard_normal((b, n)).astype(np.float32)
    cc = rng.standard_normal((b, n)).astype(np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32)
    state = _t(st)
    y, s_new = mamba.ssd_step(*map(_t, (x, dt, bb, cc, a)), state,
                              h_out=state if in_place else None)
    y_r, s_r = ref_mamba.ssd_step(x, dt, bb, cc, a, st)
    _close(y, y_r, 1e-5)
    _close(s_new, s_r, 1e-5)
    assert (s_new is state) == in_place


def _layer(dtype):
    """Layer 0 of reduced zamba2-7b's reference weights, with a non-zero
    ``dt_bias`` and conv bias."""
    cfg = ref_configs.get("zamba2-7b").reduced(dtype=dtype)
    p = jax.tree.map(lambda v: np.asarray(v[0]),
                     ref_tf.init_params(cfg, KEY)["layers"])
    rng = np.random.default_rng(7)
    p["dt_bias"] = rng.standard_normal(p["dt_bias"].shape).astype(np.float32)
    p["conv_b"] = np.asarray(jnp.asarray(
        rng.standard_normal(p["conv_b"].shape), p["conv_b"].dtype))
    # jnp arrays for the reference: a NumPy bfloat16 ``@`` is not XLA's
    return configs.get("zamba2-7b").reduced(dtype=dtype), \
        jax.tree.map(jnp.asarray, p), params_from_reference(p, device="cpu")


def _activations(shape, dtype, seed):
    a = np.asarray(jnp.asarray(np.random.default_rng(seed).standard_normal(
        shape), jnp.dtype(dtype)))
    return jnp.asarray(a), params_from_reference({"a": a}, device="cpu")["a"]


def _step_tol(want, dtype):
    """One bfloat16 step of the largest output magnitude (float32: 1e-4)."""
    if dtype == "float32":
        return dict(rtol=1e-4, atol=1e-4)
    return dict(rtol=0, atol=2.0 ** -8 * float(np.abs(_np(want)).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_block_matches_reference(dtype):
    """Both branches: a 12-token sequence, then one decode step from the
    caches it left, the state written into ``h_out`` in place."""
    cfg, p, pt = _layer(dtype)
    x, xt = _activations((2, 12, cfg.d_model), dtype, 9)
    y, (h, tail) = mamba.mamba2_block(xt, pt, cfg)
    y_r, (h_r, tail_r) = ref_mamba.mamba2_block(x, p, cfg)
    assert y.dtype == xt.dtype and h.dtype == torch.float32
    assert tuple(h.shape) == (2, cfg.n_ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state)
    assert tuple(tail.shape) == (2, cfg.ssm_conv - 1,
                                 cfg.d_inner + 2 * cfg.ssm_state)
    np.testing.assert_allclose(_np(y), _np(y_r), **_step_tol(y_r, dtype))
    _close(h, h_r, 1e-4)
    np.testing.assert_allclose(_np(tail), _np(tail_r),
                               **_step_tol(tail_r, dtype))
    x1, x1t = _activations((2, cfg.d_model), dtype, 10)
    state = h.clone()
    y1, (h1, c1) = mamba.mamba2_block(x1t, pt, cfg, h0=state, conv0=tail,
                                      single_step=True, h_out=state)
    y1_r, (h1_r, c1_r) = ref_mamba.mamba2_block(
        x1, p, cfg, h0=h_r, conv0=tail_r, single_step=True)
    assert h1 is state
    np.testing.assert_allclose(_np(y1), _np(y1_r), **_step_tol(y1_r, dtype))
    _close(h1, h1_r, 1e-4)
    np.testing.assert_allclose(_np(c1), _np(c1_r), **_step_tol(c1_r, dtype))


def test_mamba2_gated_norm_takes_the_rmsnorm_kernel(monkeypatch):
    """The gated norm is one call of the ``rmsnorm`` wrapper on a float32
    input with the config's weight type (bfloat16 here): the type pair
    the card's kernel runs as type code 2."""
    from repro_torch.models import layers
    cfg, _, pt = _layer("bfloat16")
    calls = []
    real = layers.rmsnorm

    def spy(x, w, eps):
        calls.append((tuple(x.shape), x.dtype, w.dtype))
        return real(x, w, eps)

    monkeypatch.setattr(layers, "rmsnorm", spy)
    _, xt = _activations((2, 5, cfg.d_model), "bfloat16", 3)
    mamba.mamba2_block(xt, pt, cfg)
    assert calls == [((2, 5, cfg.d_inner), torch.float32, torch.bfloat16)]

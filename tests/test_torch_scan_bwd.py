"""The gradient of the fused Mamba1 scan: ``SelectiveScanFusedFn`` and its
plain backward, on the CPU.

On the card the Function's backward is the CUDA kernel
``selective_scan_fused_bwd`` (``csrc/selective_scan.cu``, checked there
by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``); on the CPU both of
its sides are plain, so ``.apply`` runs here: the fused forward's plain
version, then ``selective_scan_fused_bwd_ref`` — an explicit float32
reverse recurrence that recomputes each chunk's states from the state at
its boundary, as the kernel does.  Its nine gradients (``x``, ``dt_raw``,
``dt_bias``, ``B``, ``C``, ``A_log``, ``D``, ``z``, ``h0``) are held to
torch autograd of ``selective_scan_fused_ref``, to ``jax.vjp`` of the
reference model's own Mamba1 sequence (``jax.nn.softplus(dt + dt_bias)``,
``A = -exp(A_log)``, ``repro.models.mamba.selective_scan``, the ``D``
skip and the gate, as ``src/repro/models/mamba.py`` writes them) and, in
bfloat16, to a float64 evaluation of the same function.  Sequence lengths
are not multiples of the chunk (16), ``N`` takes 1, 5 and 16, and the
cases run with and without ``h0`` and a gradient of the final state.

Tolerances, each relative to the gradient's largest magnitude:

- float32, against autograd and against JAX: 1e-5 (the same float32
  arithmetic in another order; JAX's chunked associative scan forms its
  states as products of decays, a few ulps from the sequential
  recurrence; largest seen 3.9e-7 and 3.7e-7).
- bfloat16: each side against the float64 evaluation, which takes the
  forward's bfloat16 values of ``dt_raw + dt_bias`` and of the softplus
  and differentiates through them exactly, as autograd and the kernel
  do.  The Function: 1e-2 (its float32 gradients rounded once to
  bfloat16, half a step, 2**-9; largest seen 3.5e-3).  Autograd and
  ``jax.vjp`` of the bfloat16 sequence round intermediate gradients to
  bfloat16 and sum ``ddt_bias`` over ``b·S`` terms in bfloat16, so they
  are the less accurate side: 3e-2 (largest seen 6.7e-3 for autograd,
  1.5e-2 for JAX).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as ref_mamba
from repro.models.layers import silu as ref_silu
from repro_torch import configs
from repro_torch.kernels import selective_scan as ss
from repro_torch.launch import steps
from repro_torch.models import mamba as port_mamba
from repro_torch.models import model as M
from repro_torch.models.sharding import ShardCtx
from repro_torch.models.transformer import init_params

NAMES = ("x", "dt", "dt_bias", "B", "C", "A_log", "D", "z", "h0")
#: (b, S, D, N): S not a multiple of the chunk, N at 1, 5 and 16, D odd.
CASES = [(2, 37, 24, 5), (1, 20, 9, 16), (2, 33, 16, 1)]
F32_TOL = 1e-5
BF16_FN_TOL, BF16_LOW_TOL = 1e-2, 3e-2


def _inputs(case, seed, with_h0):
    """NumPy float32 inputs of one call: x, dt_raw, B, C, z (of the
    working type once rounded), dt_bias, A_log, D, h0 (float32), and the
    cotangents of ``out`` and of the final state."""
    b, s, d, n = case
    rng = np.random.default_rng(seed)
    f = np.float32
    io = {"x": rng.standard_normal((b, s, d)).astype(f) * 0.5,
          "dt": rng.standard_normal((b, s, d)).astype(f) * 0.5 - 1.0,
          "B": rng.standard_normal((b, s, n)).astype(f),
          "C": rng.standard_normal((b, s, n)).astype(f),
          "z": rng.standard_normal((b, s, d)).astype(f)}
    params = {"dt_bias": rng.standard_normal(d).astype(f) * 0.5,
              "A_log": (np.log(np.arange(1, n + 1, dtype=f))[None, :]
                        + rng.standard_normal((d, n)).astype(f) * 0.1),
              "D": rng.standard_normal(d).astype(f),
              "h0": rng.standard_normal((b, d, n)).astype(f)
              if with_h0 else None}
    cot = (rng.standard_normal((b, s, d)).astype(f),
           rng.standard_normal((b, d, n)).astype(f))
    return io, params, cot


def _torch_args(io, params, dtype):
    def t(a, dt):
        return None if a is None else torch.from_numpy(a.copy()).to(dt)
    return [t(io["x"], dtype), t(io["dt"], dtype),
            t(params["dt_bias"], torch.float32), t(io["B"], dtype),
            t(io["C"], dtype), t(params["A_log"], torch.float32),
            t(params["D"], torch.float32), t(io["z"], dtype),
            t(params["h0"], torch.float32)]


def _function_grads(args, dout, dh_final):
    """The nine gradients through ``SelectiveScanFusedFn.apply``."""
    leaves = [a.detach().requires_grad_() if a is not None else None
              for a in args]
    out, h = ss.SelectiveScanFusedFn.apply(*leaves)
    outs, cots = [out], [dout]
    if dh_final is not None:
        outs.append(h)
        cots.append(dh_final)
    present = [a for a in leaves if a is not None]
    got = dict(zip([n for n, a in zip(NAMES, leaves) if a is not None],
                   torch.autograd.grad(outs, present, cots)))
    return got, out, h


def _autograd_grads(args, dout, dh_final):
    leaves = [a.detach().requires_grad_() if a is not None else None
              for a in args]
    out, h = ss.selective_scan_fused_ref(*leaves)
    outs, cots = [out], [dout]
    if dh_final is not None:
        outs.append(h)
        cots.append(dh_final)
    present = [a for a in leaves if a is not None]
    return dict(zip([n for n, a in zip(NAMES, leaves) if a is not None],
                    torch.autograd.grad(outs, present, cots)))


def _jax_grads(io, params, cot, bf16, with_dhf):
    """``jax.vjp`` of the reference model's Mamba1 sequence, from the bias
    add to the cast (``src/repro/models/mamba.py``)."""
    dt_io = jnp.bfloat16 if bf16 else jnp.float32

    def seq(x, dt, dt_bias, B, C, A_log, D, z, h0):
        A = -jnp.exp(A_log.astype(jnp.float32))
        dt = jax.nn.softplus(dt + dt_bias.astype(dt.dtype))
        y, h = ref_mamba.selective_scan(x, dt, B, C, A, h0=h0, chunk=16)
        y = y + D.astype(jnp.float32) * x.astype(jnp.float32)
        y = y * ref_silu(z.astype(jnp.float32))
        return y.astype(x.dtype), h

    prim = [jnp.asarray(io["x"]).astype(dt_io),
            jnp.asarray(io["dt"]).astype(dt_io),
            jnp.asarray(params["dt_bias"]), jnp.asarray(io["B"]).astype(dt_io),
            jnp.asarray(io["C"]).astype(dt_io), jnp.asarray(params["A_log"]),
            jnp.asarray(params["D"]), jnp.asarray(io["z"]).astype(dt_io)]
    with_h0 = params["h0"] is not None
    if with_h0:
        prim.append(jnp.asarray(params["h0"]))
        fn = seq
    else:
        def fn(*a):
            return seq(*a, None)
    (out, h), vjp = jax.vjp(fn, *prim)
    dh = jnp.asarray(cot[1]) if with_dhf else jnp.zeros_like(h)
    grads = vjp((jnp.asarray(cot[0]).astype(out.dtype), dh))
    return {n: np.asarray(g.astype(jnp.float32))
            for n, g in zip(NAMES, grads)}


def _f64_grads(args, dout, dh_final, io_dtype):
    """The same function evaluated in float64 by autograd: the forward's
    values of ``dt_raw + dt_bias`` and of the softplus (``ss.softplus`` in
    ``io_dtype``, which rounds as JAX's does), with the exact derivatives
    of the sum and of the softplus."""
    def as_value(t, value):
        return t + (value.double() - t).detach()

    leaves = [a.detach().double().requires_grad_() if a is not None
              else None for a in args]
    x, dt, bias, B, C, A_log, D, z, h0 = leaves
    s_io = args[1] + args[2].to(io_dtype)
    s = as_value(dt + bias, s_io)
    dtv = as_value(torch.logaddexp(s, torch.zeros_like(s)),
                   ss.softplus(s_io))
    A = -torch.exp(A_log)
    b, n_s, d = x.shape
    h = torch.zeros(b, d, A.shape[1], dtype=torch.float64) \
        if h0 is None else h0
    ys = []
    for t in range(n_s):
        h = torch.exp(dtv[:, t, :, None] * A) * h \
            + (dtv[:, t] * x[:, t])[..., None] * B[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    y = torch.stack(ys, 1) + D * x
    out = y * (z * torch.sigmoid(z))
    outs, cots = [out], [dout.double()]
    if dh_final is not None:
        outs.append(h)
        cots.append(dh_final.double())
    present = [a for a in leaves if a is not None]
    return dict(zip([nm for nm, a in zip(NAMES, leaves) if a is not None],
                    torch.autograd.grad(outs, present, cots)))


def _rel(got, want) -> float:
    g = np.asarray(got.detach().double() if isinstance(got, torch.Tensor)
                   else got, dtype=np.float64)
    w = np.asarray(want.detach().double() if isinstance(want, torch.Tensor)
                   else want, dtype=np.float64)
    assert g.shape == w.shape
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _check(got: dict, want: dict, tol: float, what: str) -> None:
    assert set(got) == set(want), (what, set(got), set(want))
    for name in got:
        err = _rel(got[name], want[name])
        assert err <= tol, (what, name, err)


STARTS = [(False, False), (True, True), (True, False), (False, True)]


@pytest.mark.parametrize("with_h0,with_dhf", STARTS,
                         ids=["zero", "h0+dh", "h0", "dh"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_function_matches_autograd_of_the_plain_forward_f32(case, with_h0,
                                                            with_dhf):
    io, params, cot = _inputs(case, sum(case), with_h0)
    args = _torch_args(io, params, torch.float32)
    dout = torch.from_numpy(cot[0])
    dhf = torch.from_numpy(cot[1]) if with_dhf else None
    got, out, h = _function_grads(args, dout, dhf)
    want_out, want_h = ss.selective_scan_fused_ref(*args)
    assert torch.equal(out, want_out) and torch.equal(h, want_h)
    assert len(got) == 8 + with_h0
    _check(got, _autograd_grads(args, dout, dhf), F32_TOL,
           "autograd")


@pytest.mark.parametrize("with_h0,with_dhf", STARTS[:3],
                         ids=["zero", "h0+dh", "h0"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_function_matches_jax_vjp_of_the_reference_sequence_f32(
        case, with_h0, with_dhf):
    io, params, cot = _inputs(case, sum(case) + 1, with_h0)
    args = _torch_args(io, params, torch.float32)
    dhf = torch.from_numpy(cot[1]) if with_dhf else None
    got, _, _ = _function_grads(args, torch.from_numpy(cot[0]), dhf)
    want = _jax_grads(io, params, cot, False, with_dhf)
    if not with_h0:
        want.pop("h0", None)
    _check(got, want, F32_TOL, "jax.vjp")


@pytest.mark.parametrize("with_h0,with_dhf", STARTS[:2],
                         ids=["zero", "h0+dh"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_bf16_gradients_against_a_float64_evaluation(case, with_h0,
                                                     with_dhf):
    """The Function within 1e-2 of the float64 evaluation; autograd of the
    bfloat16 plain forward and ``jax.vjp`` of the bfloat16 reference
    sequence, the less accurate sides, within 3e-2 of it."""
    io, params, cot = _inputs(case, sum(case) + 2, with_h0)
    args = _torch_args(io, params, torch.bfloat16)
    dout = torch.from_numpy(cot[0]).to(torch.bfloat16)
    dhf = torch.from_numpy(cot[1]) if with_dhf else None
    want = _f64_grads(args, dout, dhf, torch.bfloat16)
    got, out, _ = _function_grads(args, dout, dhf)
    assert out.dtype == torch.bfloat16
    for name in ("x", "dt", "B", "C", "z"):
        assert got[name].dtype == torch.bfloat16, name
    _check(got, want, BF16_FN_TOL, "Function vs float64")
    _check(_autograd_grads(args, dout, dhf), want, BF16_LOW_TOL,
           "bf16 autograd vs float64")
    jax_g = _jax_grads(io, params, (cot[0], cot[1]), True, with_dhf)
    if not with_h0:
        jax_g.pop("h0", None)
    _check(jax_g, want, BF16_LOW_TOL, "bf16 jax.vjp vs float64")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_backward_is_the_same_for_every_chunk(dtype):
    """The states recomputed from chunk boundaries are the forward's own
    (the same operations in the same order), so the chunk changes no bit:
    one step a chunk, a ragged chunk, the kernel's 16, one chunk for all."""
    io, params, cot = _inputs((2, 37, 12, 5), 5, True)
    args = _torch_args(io, params, dtype)
    dout = torch.from_numpy(cot[0]).to(dtype)
    dhf = torch.from_numpy(cot[1])
    want = ss.selective_scan_fused_bwd_ref(*args, dout, dhf)
    for chunk in (1, 5, ss.BWD_CHUNK, 40):
        got = ss.selective_scan_fused_bwd_ref(*args, dout, dhf, chunk=chunk)
        for g, w in zip(got, want):
            assert torch.equal(g, w), chunk


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_forward_keeps_the_boundaries_of_the_backward_walk(dtype, with_h0):
    """The plain forward's chunk boundaries (``bounds=True``: the state
    entering every ``BWD_CHUNK`` steps, which the forward kernel keeps for
    the backward kernel) are the plain backward's own forward walk, bit
    for bit, at a ragged S; the forward's outputs do not change."""
    io, params, _ = _inputs((2, 37, 12, 5), 11, with_h0)
    args = _torch_args(io, params, dtype)
    out, h, bounds = ss.selective_scan_fused_ref(*args, bounds=True)
    want_out, want_h = ss.selective_scan_fused_ref(*args)
    assert torch.equal(out, want_out) and torch.equal(h, want_h)
    assert bounds.shape == (2, 3, 12, 5) and bounds.dtype == torch.float32
    x, dt, dt_bias, B, C, A_log, D, z, h0 = args
    walk = ss._walk_bounds(x, dt, dt_bias, B, A_log, h0, ss.BWD_CHUNK)
    assert torch.equal(bounds, walk)
    assert torch.equal(bounds[:, 0], h0 if with_h0 else torch.zeros_like(
        bounds[:, 0]))
    with pytest.raises(ValueError, match="bounds"):
        ss.selective_scan_fused_ref(*args[:-1], None, torch.empty_like(h),
                                    bounds=True)


@pytest.mark.parametrize("start", ["zero", "h0+dh", "dh"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_backward_from_the_forward_boundaries_is_bit_equal(dtype,
                                                                  start):
    """``selective_scan_fused_bwd_ref(..., bounds=...)`` with the plain
    forward's boundaries gives the bits it gives when it walks forward to
    find them itself; boundaries of the wrong shape are refused."""
    io, params, cot = _inputs((2, 37, 12, 5), 12, "h0" in start)
    args = _torch_args(io, params, dtype)
    dout = torch.from_numpy(cot[0]).to(dtype)
    dhf = torch.from_numpy(cot[1]) if "dh" in start else None
    bounds = ss.selective_scan_fused_ref(*args, bounds=True)[2]
    want = ss.selective_scan_fused_bwd_ref(*args, dout, dhf)
    got = ss.selective_scan_fused_bwd_ref(*args, dout, dhf, bounds=bounds)
    for name, g, w in zip(NAMES, got, want):
        assert (g is None and w is None) or torch.equal(g, w), name
    with pytest.raises(ValueError, match="bounds"):
        ss.selective_scan_fused_bwd_ref(*args, dout, dhf,
                                        bounds=bounds[:, :2])


class _OnCard(torch.Tensor):
    """A host tensor that says it lies on the card, so that the wrappers'
    CUDA branches run here as far as their launch (recorded, not made)."""

    @property
    def is_cuda(self):
        return True


class _Ctx:
    """What ``SelectiveScanFusedFn.forward`` and ``backward`` use of
    autograd's context."""

    def set_materialize_grads(self, value):
        pass

    def save_for_backward(self, *tensors):
        self.saved_tensors = tensors


def test_the_function_hands_both_kernels_the_boundary_buffer(monkeypatch):
    """The Function's forward launches the fused kernel with a boundary
    buffer, ``(b, ceil(S / 16), D, N)`` float32, counted under its own
    shape key, and saves it; its backward hands the backward kernel that
    buffer and a workspace of ``_bwd_work_floats`` elements (the partials
    only).  A generation call — over a sequence or a decode step — hands
    the forward kernel no buffer."""
    calls = []
    monkeypatch.setattr(ss, "launch",
                        lambda name, index, *a: calls.append((name, a)))
    monkeypatch.setattr(ss.selective_scan, "launches", 0)
    monkeypatch.setattr(ss.selective_scan, "bwd_launches", 0)
    monkeypatch.setattr(ss.selective_scan, "shapes", type(
        ss.selective_scan.shapes)())
    b, s, d, n = 2, 37, 45, 5
    io, params, cot = _inputs((b, s, d, n), 13, True)
    args = [None if t is None else torch.Tensor._make_subclass(_OnCard, t)
            for t in _torch_args(io, params, torch.bfloat16)]
    ctx = _Ctx()
    ss.SelectiveScanFusedFn.forward(ctx, *args)
    bounds = ctx.saved_tensors[-1]
    assert bounds.shape == (b, 3, d, n) and bounds.dtype == torch.float32
    assert bounds.is_contiguous()
    [(name, a)] = calls
    assert name == "selective_scan_fused_fwd"
    assert a[11] == bounds.data_ptr()     # x, dt, B, C, z, A_log, dt_bias,
    #                                       D, h0, out, h_out, bound
    dout = torch.Tensor._make_subclass(
        _OnCard, torch.from_numpy(cot[0]).to(torch.bfloat16))
    grads = ss.SelectiveScanFusedFn.backward(ctx, dout, None)
    assert len(grads) == 9 and grads[-1].shape == (b, d, n)
    name, a = calls[-1]
    assert name == "selective_scan_fused_bwd"
    assert a[11] == bounds.data_ptr()     # ..., dout, dh_final, bound
    assert a[22] == ss._bwd_work_floats(b, s, d, n)
    assert dict(ss.selective_scan.shapes) == {
        ("fused_bound", (b, s, d), n, torch.bfloat16): 1,
        ("fused_bwd", (b, s, d), n, torch.bfloat16): 1}
    calls.clear()
    x, dt, dt_bias, B, C, A_log, D, z, h0 = args
    with torch.no_grad():
        ss.selective_scan_fused(x, dt, dt_bias, B, C, A_log, D, z, h0)
        ss.selective_scan_fused(x[:, :1], dt[:, :1], dt_bias, B[:, :1],
                                C[:, :1], A_log, D, z[:, :1], h0, h0,
                                step=True)
    assert [(c[0], c[1][11]) for c in calls] == [
        ("selective_scan_fused_fwd", None)] * 2
    with pytest.raises(ValueError, match="bounds"):
        ss._bwd_cuda(*args, dout, None, bounds[:, :2])


def test_bwd_workspace_holds_the_partials_only():
    """The backward kernel's workspace: the per-block ``dB, dC`` partials
    ``(2, b, ceil(D / 32), S, N)``, the per-sequence ``dA_log`` partials
    ``(b, D, N)`` and ``ddt_bias, dD`` partials ``(2, b, D)``; the chunk
    boundaries are the forward's buffer, not the workspace's."""
    for b, s, d, n in ((2, 37, 45, 5), (2, 512, 8192, 16), (1, 1, 1, 1)):
        blocks = -(-d // ss.BWD_CHANNELS)
        assert ss._bwd_work_floats(b, s, d, n) == \
            2 * b * blocks * s * n + b * d * n + 2 * b * d


def test_function_takes_a_gradient_of_either_output_alone():
    """The final state's gradient may be absent (training drops the state)
    and so may the output's; neither is materialised as zeros by autograd
    and both give what autograd of the plain forward gives."""
    io, params, cot = _inputs((1, 18, 8, 4), 9, True)
    args = _torch_args(io, params, torch.float32)
    leaves = [a.detach().requires_grad_() for a in args]
    ref_leaves = [a.detach().requires_grad_() for a in args]
    out, h = ss.SelectiveScanFusedFn.apply(*leaves)
    ro, rh = ss.selective_scan_fused_ref(*ref_leaves)
    for mine, ref in ((h.sum(), rh.sum()), ((out.float() ** 2).sum(),
                                             (ro.float() ** 2).sum())):
        g = torch.autograd.grad(mine, leaves, retain_graph=True)
        w = torch.autograd.grad(ref, ref_leaves, retain_graph=True,
                                allow_unused=True)
        for name, a, b in zip(NAMES, g, w):
            b = torch.zeros_like(a) if b is None else b
            assert _rel(a, b) <= F32_TOL or \
                float((a - b).abs().max()) == 0.0, name


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_falcon_loss_gradients_through_the_function(monkeypatch, remat):
    """The slice as a whole on the host: reduced falcon-mamba-7b's loss
    with every layer's scan through ``SelectiveScanFusedFn`` (as on the
    card) gives each parameter the gradient that autograd of the plain
    path gives (which ``tests/test_torch_train.py`` holds to
    ``jax.value_and_grad``), with and without remat."""
    cfg = configs.get("falcon-mamba-7b").reduced(n_layers=2, remat=remat)
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 21)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def grads():
        p, flat = steps._leaves_for_grad(params)
        loss, _ = M.loss_fn(p, cfg, ShardCtx(), batch)
        return float(loss.detach()), torch.autograd.grad(loss, flat)

    want_loss, want = grads()
    calls = []

    def through_function(x, dt, dt_bias, B, C, A_log, D, z, h0=None,
                         h_out=None, *, step=False):
        assert h_out is None and not step
        calls.append(x.shape)
        return ss.SelectiveScanFusedFn.apply(x, dt, dt_bias, B, C, A_log, D,
                                             z, h0)

    monkeypatch.setattr(port_mamba, "selective_scan_fused", through_function)
    loss, got = grads()
    assert len(calls) == cfg.n_layers * (2 if remat else 1)
    assert loss == want_loss
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= F32_TOL

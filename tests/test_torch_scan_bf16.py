"""The Mamba1 scan with the bfloat16 working type (``scan_dtype =
"bfloat16"``) on the CPU: the plain versions of its forward and backward
kernels, ``SelectiveScanFusedBf16Fn``, the wrapper's launches and its
meta branch.

The reference (``repro.models.mamba.selective_scan(work_dtype=bfloat16)``)
folds each chunk's ``(a, u)`` with ``jax.lax.associative_scan`` in
bfloat16.  The kernels replay that tree in place (``_tree_scan``: the
up-sweep, then the down-sweep), which is held bit for bit to the port's
recursive ``associative_scan`` (itself bit-equal to JAX's), and the
backward runs its transpose in bfloat16 (``_tree_transpose``).
Tolerances, each relative to the largest magnitude of the leaf:

- the explicit plain backward against torch autograd of the plain
  forward: 1e-4 on float32 inputs (the same bfloat16 roundings of the
  tree, float32 sums in another order; largest seen 4.1e-7); on bfloat16
  inputs against autograd of the forward on their float32 values, 1e-2
  (the gradients rounded once to bfloat16, and the forward's softplus
  rounded to bfloat16 moves ``a`` and ``u``; largest seen 7.1e-3);
- against ``jax.vjp`` of the reference's sequence, float32 inputs:
  ``BF16_GRAD_RTOL`` = 1e-2 (JAX's transpose of its associative scan
  sums the tree's cotangents in bfloat16 in its own order; largest seen
  2.7e-3, on ``dt``).

torch runs on two threads here (the driver's workers share the host).
"""
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as ref_mamba
from repro.models.layers import silu as ref_silu
from repro_torch import configs
from repro_torch.kernels import _meta
from repro_torch.kernels import selective_scan as ss
from repro_torch.models import mamba as port_mamba
from repro_torch.models.transformer import init_params

torch.set_num_threads(2)

NAMES = ("x", "dt", "dt_bias", "B", "C", "A_log", "D", "z", "h0")
#: (b, S, D, N): chunks of 80 (two), 7 (one, odd), 65 (two, odd), 128
#: (two) — ``tests/test_torch_model_kernels.py``'s ``CHUNKED_CASES``.
CHUNKED_CASES = [(2, 160, 32, 16), (1, 7, 8, 4), (2, 130, 16, 8),
                 (1, 256, 24, 16)]
F32_AUTOGRAD_TOL, BF16_GRAD_RTOL = 1e-4, 1e-2
#: The reduced block with the bfloat16 prefix against the reference's
#: (``tests/test_torch_model_kernels.py``'s ``SCAN_BF16_BLOCK_TOL``).
SCAN_BF16_BLOCK_TOL = 2e-3


def _inputs(case, seed, io=torch.float32, with_h0=True):
    """NumPy float32 inputs of one fused call in the model's ranges (x
    after silu-like scale, dt before the bias, A_log near log(1..N)) and
    the cotangents of ``out`` and of the final state; torch tensors of
    ``io`` (x, dt, B, C, z) and float32 (the rest)."""
    b, s, d, n = case
    rng = np.random.default_rng(seed)
    f = np.float32
    arrays = [rng.standard_normal((b, s, d)).astype(f) * 0.5,           # x
              rng.standard_normal((b, s, d)).astype(f) * 0.5 - 1.0,     # dt
              rng.standard_normal(d).astype(f) * 0.5,                # dt_bias
              rng.standard_normal((b, s, n)).astype(f),                 # B
              rng.standard_normal((b, s, n)).astype(f),                 # C
              (np.log(np.arange(1, n + 1, dtype=f))[None, :]
               + rng.standard_normal((d, n)).astype(f) * 0.1),       # A_log
              rng.standard_normal(d).astype(f),                         # D
              rng.standard_normal((b, s, d)).astype(f),                 # z
              rng.standard_normal((b, d, n)).astype(f) if with_h0
              else None]                                                # h0
    cot = (rng.standard_normal((b, s, d)).astype(f),
           rng.standard_normal((b, d, n)).astype(f))
    types = (io, io, torch.float32, io, io, torch.float32, torch.float32,
             io, torch.float32)
    args = [None if a is None else torch.from_numpy(a.copy()).to(t)
            for a, t in zip(arrays, types)]
    return arrays, args, (torch.from_numpy(cot[0]).to(io),
                          torch.from_numpy(cot[1]))


def _rel(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)


# ---------------------------------------------------------------------------
# the tree the kernels replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", [1, 2, 3, 5, 7, 8, 13, 64, 65, 100, 128])
def test_tree_scan_is_associative_scan_bit_for_bit(q):
    """The kernels' in-place tree (up-sweep, then down-sweep) gives the
    bits of the recursive ``associative_scan`` at even, odd and
    power-of-two lengths, and of ``jax.lax.associative_scan``."""
    rng = np.random.default_rng(q)
    a = rng.uniform(0.5, 1.0, (2, q, 3)).astype(np.float32)
    u = rng.standard_normal((2, q, 3)).astype(np.float32)
    ta, tu = (torch.from_numpy(t).bfloat16() for t in (a, u))
    ra, ru = ss.associative_scan(ta, tu, dim=1)
    ka, ku = ta.clone(), tu.clone()
    ss._tree_scan(ka, ku)
    assert torch.equal(ka, ra) and torch.equal(ku, ru)

    def combine(left, right):
        return left[0] * right[0], left[1] * right[0] + right[1]

    with jax.disable_jit():
        ja, ju = jax.lax.associative_scan(
            combine, (jnp.asarray(a, jnp.bfloat16),
                      jnp.asarray(u, jnp.bfloat16)), axis=1)
    for got, want in ((ka, ja), (ku, ju)):
        assert torch.equal(got.float(),
                           torch.from_numpy(np.asarray(want, np.float32)))


@pytest.mark.parametrize("q", [2, 7, 65, 128])
def test_tree_transpose_is_the_scans_vjp(q):
    """In float64 (no rounding) the transposed tree is the vector-Jacobian
    product of the tree: against autograd of ``_tree_scan``."""
    rng = np.random.default_rng(q + 1)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, q, 3)))
    u = torch.from_numpy(rng.standard_normal((2, q, 3)))
    ga, gu = (torch.from_numpy(rng.standard_normal((2, q, 3)))
              for _ in range(2))
    al, ul = a.clone().requires_grad_(), u.clone().requires_grad_()
    fa, fu = al * 1, ul * 1
    ss._tree_scan(fa, fu)
    want = torch.autograd.grad((fa, fu), (al, ul), (ga, gu))
    wa, wu = a.clone(), u.clone()
    ua, uu = ss._tree_scan(wa, wu)
    da, du = ga.clone(), gu.clone()
    ss._tree_transpose(da, du, wa, wu, ua, uu, a)
    torch.testing.assert_close(da, want[0], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(du, want[1], rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# the plain forward with its chunk boundaries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CHUNKED_CASES, ids=str)
def test_fused_bf16_plain_keeps_the_reference_chunk_states(case):
    """``selective_scan_fused_bf16_ref``: ``out`` and the state of the
    wrapper's plain sequence, bit for bit, and the state entering chunk
    ``k`` within 1e-6 of the reference's state after the first ``k q``
    steps (its ``selective_scan(work_dtype=bfloat16)`` with the same
    chunk)."""
    arrays, args, _ = _inputs(case, 3)
    out, h, bounds = ss.selective_scan_fused_bf16_ref(*args)
    with torch.no_grad():
        want_out, want_h = ss.selective_scan_fused(*args,
                                                   work_dtype=torch.bfloat16)
    assert torch.equal(out, want_out) and torch.equal(h, want_h)
    b, s, d, n = case
    q = ss._pick_chunk(s, ss.SCAN_CHUNK)
    assert bounds.shape == (b, s // q, d, n)
    x, dt, bias, B, C, A_log = (jnp.asarray(a) for a in arrays[:6])
    dtp = jax.nn.softplus(dt + bias)
    A = -jnp.exp(A_log)
    h0 = jnp.asarray(arrays[8])
    np.testing.assert_array_equal(bounds[:, 0].numpy(), arrays[8])
    for k in range(1, s // q):
        _, hk = ref_mamba.selective_scan(
            x[:, :k * q], dtp[:, :k * q], B[:, :k * q], C[:, :k * q], A,
            h0=h0, chunk=q, work_dtype=jnp.bfloat16)
        np.testing.assert_allclose(bounds[:, k].numpy(), np.asarray(hk),
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the explicit backward
# ---------------------------------------------------------------------------

def _jax_sequence(x, dt, bias, B, C, A_log, D, z, h0):
    """The reference model's Mamba1 sequence from the bias add to the cast
    with the bfloat16 working type, on its own functions."""
    A = -jnp.exp(A_log.astype(jnp.float32))
    dt = jax.nn.softplus(dt + bias.astype(dt.dtype))
    y, h = ref_mamba.selective_scan(x, dt, B, C, A, h0=h0,
                                    work_dtype=jnp.bfloat16)
    y = y + D.astype(jnp.float32) * x.astype(jnp.float32)
    y = y * ref_silu(z.astype(jnp.float32))
    return y.astype(x.dtype), h


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CHUNKED_CASES, ids=str)
def test_plain_bwd_matches_autograd_of_the_plain_forward(case, io):
    """The nine gradients of ``selective_scan_fused_bf16_bwd_ref`` (with
    ``h0`` and a gradient of the final state) against torch autograd of
    the wrapper's plain sequence — on bfloat16 inputs, of the sequence on
    their float32 values (autograd through the bfloat16 softplus rounds
    its gradient op by op and cancels: 4.9e-2 off); given the forward's
    boundaries or finding them itself, the same bits."""
    _, args, (dout, dhf) = _inputs(case, 5, io)
    leaves = [t.float().clone().requires_grad_() for t in args]
    out, h = ss.selective_scan_fused_ref(
        *leaves, scan=functools.partial(ss.selective_scan_chunked_ref,
                                        work_dtype=torch.bfloat16))
    want = torch.autograd.grad((out, h), leaves, (dout.float(), dhf))
    got = ss.selective_scan_fused_bf16_bwd_ref(*args, dout, dhf)
    bounds = ss.selective_scan_fused_bf16_ref(*args)[2]
    again = ss.selective_scan_fused_bf16_bwd_ref(*args, dout, dhf,
                                                 bounds=bounds)
    tol = F32_AUTOGRAD_TOL if io == torch.float32 else BF16_GRAD_RTOL
    for name, g, a, w in zip(NAMES, got, again, want):
        assert g.dtype == args[NAMES.index(name)].dtype, name
        assert g.shape == w.shape, name
        assert torch.equal(g, a), name
        assert _rel(g, w) <= tol, (name, _rel(g, w))


@pytest.mark.parametrize("case", CHUNKED_CASES, ids=str)
def test_plain_bwd_matches_jax_vjp_of_the_reference(case):
    """All nine gradients and ``dh0`` against ``jax.vjp`` of the
    reference's sequence with the bfloat16 working type, each within
    ``BF16_GRAD_RTOL`` of its leaf's largest."""
    arrays, args, (dout, dhf) = _inputs(case, 7)
    primals = [jnp.asarray(a) for a in arrays]
    _, vjp = jax.vjp(_jax_sequence, *primals)
    want = vjp((jnp.asarray(dout.numpy()), jnp.asarray(dhf.numpy())))
    got = ss.selective_scan_fused_bf16_bwd_ref(*args, dout, dhf)
    for name, g, w in zip(NAMES, got, want):
        w = torch.from_numpy(np.array(w, np.float32))
        assert _rel(g, w) <= BF16_GRAD_RTOL, (name, _rel(g, w))


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_function_on_the_cpu_is_the_plain_versions(io):
    """``SelectiveScanFusedBf16Fn`` on the CPU: its outputs are the plain
    forward's and its gradients the plain backward's, bit for bit, with
    and without ``h0`` and a gradient of the final state."""
    for with_h0 in (False, True):
        _, args, (dout, dhf) = _inputs((2, 130, 16, 8), 9, io, with_h0)
        leaves = [None if t is None else t.clone().requires_grad_()
                  for t in args]
        out, h = ss.SelectiveScanFusedBf16Fn.apply(*leaves)
        want_out, want_h, bounds = ss.selective_scan_fused_bf16_ref(*args)
        assert torch.equal(out, want_out) and torch.equal(h, want_h)
        cots = (dout, dhf) if with_h0 else (dout, None)
        torch.autograd.backward([out, h] if with_h0 else [out],
                                list(cots) if with_h0 else [dout])
        want = ss.selective_scan_fused_bf16_bwd_ref(*args, *cots,
                                                    bounds=bounds)
        for name, leaf, w in zip(NAMES, leaves, want):
            if leaf is None:
                assert w is None
                continue
            assert torch.equal(leaf.grad, w), name


def test_reduced_falcon_block_through_the_function_matches_the_reference():
    """Reduced falcon-mamba-7b's first layer with ``scan_dtype =
    "bfloat16"``, its scan through ``SelectiveScanFusedBf16Fn`` (as the
    card runs it under a gradient), against ``repro.models.mamba.
    mamba1_block``: output and final state within
    ``SCAN_BF16_BLOCK_TOL``; the input's gradient of a seeded projection
    within ``BF16_GRAD_RTOL`` of ``jax.grad``'s."""
    from repro import configs as ref_configs
    from repro.models import model as ref_model
    rcfg = ref_configs.get("falcon-mamba-7b").reduced().replace(
        scan_dtype="bfloat16")
    tcfg = configs.get("falcon-mamba-7b").reduced().replace(
        scan_dtype="bfloat16")
    full = ref_model.init_params(rcfg, jax.random.PRNGKey(0))
    p = {k: np.array(v[0], np.float32) for k, v in full["layers"].items()}
    rng = np.random.default_rng(4)
    p["dt_bias"] = rng.standard_normal(p["dt_bias"].shape).astype(np.float32)
    x = rng.standard_normal((2, 160, rcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 160, rcfg.d_model)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}

    def ref_loss(xj):
        y, (h, _) = ref_mamba.mamba1_block(xj, jp, rcfg)
        return jnp.sum(y * w), (y, h)

    (_, (y_r, h_r)), gx_r = jax.value_and_grad(ref_loss, has_aux=True)(
        jnp.asarray(x))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    calls = []

    def through_function(*a, work_dtype=torch.float32, **kw):
        assert work_dtype is torch.bfloat16 and not kw.get("step")
        calls.append(1)
        return ss.SelectiveScanFusedBf16Fn.apply(*a[:9])

    orig = port_mamba.selective_scan_fused
    port_mamba.selective_scan_fused = through_function
    try:
        y, (h, _) = port_mamba.mamba1_block(xt, tp, tcfg)
    finally:
        port_mamba.selective_scan_fused = orig
    assert calls == [1]
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_r), rtol=0,
                               atol=SCAN_BF16_BLOCK_TOL)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(h_r), rtol=0,
                               atol=SCAN_BF16_BLOCK_TOL)
    assert _rel(xt.grad, torch.from_numpy(np.array(gx_r))) <= BF16_GRAD_RTOL


# ---------------------------------------------------------------------------
# the wrapper's launches (the library stubbed) and its meta branch
# ---------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card (for the wrapper's
    dispatch; the launches are recorded, not made)."""

    @property
    def is_cuda(self):
        return True


class _Ctx:
    def set_materialize_grads(self, value):
        pass

    def save_for_backward(self, *tensors):
        self.saved_tensors = tensors


def test_the_card_branch_launches_the_bf16_instances(monkeypatch):
    """On the card the wrapper launches ``selective_scan_fused_bf16_fwd``
    with the reference's chunk ``q`` (no boundaries for generation, under
    its ``("fused_bf16", ...)`` key); the Function's forward hands it a
    ``(b, S / q, D, N)`` float32 boundary buffer (``("fused_bf16_bound",
    ...)``) and its backward hands ``selective_scan_fused_bf16_bwd`` that
    buffer, ``q`` and the float32 backward's workspace
    (``("fused_bf16_bwd", ...)``)."""
    calls = []
    monkeypatch.setattr(ss, "launch",
                        lambda name, index, *a: calls.append((name, a)))
    monkeypatch.setattr(ss.selective_scan, "launches", 0)
    monkeypatch.setattr(ss.selective_scan, "bwd_launches", 0)
    monkeypatch.setattr(ss.selective_scan, "shapes", type(
        ss.selective_scan.shapes)())
    b, s, d, n = 2, 130, 45, 5
    _, args, (dout, _) = _inputs((b, s, d, n), 11, torch.bfloat16)
    args = [torch.Tensor._make_subclass(_OnCard, t) for t in args]
    with torch.no_grad():
        ss.selective_scan_fused(*args, work_dtype=torch.bfloat16)
    [(name, a)] = calls
    assert name == "selective_scan_fused_bf16_fwd"
    assert a[11] is None and a[22:] == (b, s, d, n, 65, 1)
    ctx = _Ctx()
    ss.SelectiveScanFusedBf16Fn.forward(ctx, *args)
    bounds = ctx.saved_tensors[-1]
    assert bounds.shape == (b, 2, d, n) and bounds.dtype == torch.float32
    name, a = calls[-1]
    assert name == "selective_scan_fused_bf16_fwd"
    assert a[11] == bounds.data_ptr()
    grads = ss.SelectiveScanFusedBf16Fn.backward(
        ctx, torch.Tensor._make_subclass(_OnCard, dout), None)
    assert len(grads) == 9 and grads[-1].shape == (b, d, n)
    name, a = calls[-1]
    assert name == "selective_scan_fused_bf16_bwd"
    assert a[11] == bounds.data_ptr()
    assert a[22] == ss._bwd_work_floats(b, s, d, n)
    assert a[35:] == (b, s, d, n, 65, 1)
    assert dict(ss.selective_scan.shapes) == {
        ("fused_bf16", (b, s, d), n, torch.bfloat16): 1,
        ("fused_bf16_bound", (b, s, d), n, torch.bfloat16): 1,
        ("fused_bf16_bwd", (b, s, d), n, torch.bfloat16): 1}
    assert (ss.selective_scan.launches, ss.selective_scan.bwd_launches) \
        == (2, 1)
    with pytest.raises(ValueError, match="bounds"):
        ss._bwd_cuda(*args, dout, None, bounds[:, :1], work_bf16=True)


def test_meta_branch_counts_the_bf16_work_by_hand():
    """On meta tensors the bfloat16 working type counts, without
    computing: the forward ``13 b S D N + b S D`` operations and its
    inputs' and outputs' bytes; under a gradient the Function's forward
    the same plus its ``(b, S / q, D, N)`` float32 boundaries, and its
    backward ``b S D N`` operations and the bytes of its inputs (the
    boundaries not among them) and of the nine gradients."""
    b, s, d, n = 2, 12, 8, 4
    meta = torch.device("meta")
    io, f32 = torch.bfloat16, torch.float32
    x, dt, z = (torch.empty((b, s, d), dtype=io, device=meta)
                for _ in range(3))
    B, C = (torch.empty((b, s, n), dtype=io, device=meta) for _ in range(2))
    bias, D = (torch.empty((d,), dtype=f32, device=meta) for _ in range(2))
    A_log = torch.empty((d, n), dtype=f32, device=meta)
    args = (x, dt, bias, B, C, A_log, D, z)
    in_bytes = 3 * b * s * d * 2 + 2 * b * s * n * 2 + (2 * d + d * n) * 4
    out_bytes = b * s * d * 2 + b * d * n * 4
    _meta.reset()
    with torch.no_grad():
        out, h = ss.selective_scan_fused(*args, work_dtype=torch.bfloat16)
    assert out.shape == (b, s, d) and h.shape == (b, d, n)
    assert _meta.CALLS == {"selective_scan_bf16": 1}
    assert _meta.COUNTS == {"flops": 13 * b * s * d * n + b * s * d,
                            "bytes": in_bytes + out_bytes}
    _meta.reset()
    xl = x.clone().requires_grad_()
    out, h = ss.selective_scan_fused(xl, *args[1:],
                                     work_dtype=torch.bfloat16)
    q = ss._pick_chunk(s, ss.SCAN_CHUNK)
    bounds_bytes = b * (s // q) * d * n * 4
    assert _meta.CALLS == {"selective_scan_bf16": 1}
    assert _meta.COUNTS["bytes"] == in_bytes + out_bytes + bounds_bytes
    _meta.reset()
    out.sum().backward()
    assert _meta.CALLS == {"selective_scan_bf16_bwd": 1}
    grad_bytes = in_bytes          # the nine gradients, no h0
    assert _meta.COUNTS == {"flops": b * s * d * n,
                            "bytes": in_bytes + b * s * d * 2 + grad_bytes}
    assert xl.grad.shape == x.shape


def test_meta_branch_runs_no_plain_scan_at_train_4k_size(monkeypatch):
    """falcon-mamba-7b's scan at ``train_4k``'s sequence (4096) and full
    width on meta tensors, forward and backward, returns in seconds and
    never calls the plain chunked scan or its backward."""
    def refuse(*a, **k):
        raise AssertionError("the meta branch ran a plain version")

    for name in ("selective_scan_chunked_ref", "selective_scan_fused_bf16_ref",
                 "selective_scan_fused_bf16_bwd_ref", "associative_scan"):
        monkeypatch.setattr(ss, name, refuse)
    meta, io, f32 = torch.device("meta"), torch.bfloat16, torch.float32
    b, s, d, n = 1, 4096, 8192, 16
    x = torch.empty((b, s, d), dtype=io, device=meta, requires_grad=True)
    dt, z = (torch.empty((b, s, d), dtype=io, device=meta) for _ in range(2))
    B, C = (torch.empty((b, s, n), dtype=io, device=meta) for _ in range(2))
    bias, D = (torch.empty((d,), dtype=f32, device=meta) for _ in range(2))
    A_log = torch.empty((d, n), dtype=f32, device=meta)
    t0 = time.perf_counter()
    out, _ = ss.selective_scan_fused(x, dt, bias, B, C, A_log, D, z,
                                     work_dtype=torch.bfloat16)
    out.sum().backward()
    assert time.perf_counter() - t0 < 5.0
    assert x.grad.shape == x.shape


def test_mamba1_block_on_meta_tensors_takes_the_bf16_instance():
    """Reduced falcon-mamba-7b's block on meta tensors with ``scan_dtype =
    "bfloat16"`` counts one call of the bfloat16 instance."""
    cfg = configs.get("falcon-mamba-7b").reduced(scan_dtype="bfloat16")
    p = {k: v[0] for k, v in init_params(cfg, seed=0, device="meta")[
        "layers"].items()}
    x = torch.empty((2, 64, cfg.d_model), device="meta")
    _meta.reset()
    with torch.no_grad():
        y, _ = port_mamba.mamba1_block(x, p, cfg)
    assert y.shape == x.shape and _meta.CALLS["selective_scan_bf16"] == 1

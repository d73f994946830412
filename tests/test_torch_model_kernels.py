"""Model kernels of the PyTorch package against the JAX package's.

Each plain PyTorch version (``rmsnorm_ref``, ``add_rmsnorm_ref``,
``flash_attention_ref``, ``selective_scan_ref``) is held to the JAX
package's oracle in ``repro.kernels.ref`` on the same NumPy inputs, at the
reference's own tolerances (``tests/test_kernels.py``); the residual form's
sum is held bit-equal to jnp's add.  The fused scan's plain version
(``selective_scan_fused_ref``) is held to the reference model's own
sequence (``repro.models.mamba``: softplus, scan or one-step update, D
skip, gate, cast).  One small case per kernel also runs
the Pallas kernel in interpret mode.  On the CPU each wrapper takes its plain
version and counts no launch.  The CUDA kernels can only run on a card:
their tests (``tests/test_torch_gpu.py``) carry the ``gpu`` marker and skip
without one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as pallas_fa
from repro.kernels.rmsnorm import rmsnorm as pallas_rms
from repro.kernels.selective_scan import selective_scan as pallas_scan
from repro.models import mamba as ref_mamba
from repro.models.layers import silu as ref_silu
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import selective_scan as ss

#: (b, h, kv, sq, sk, d, causal, window, bf16): the reference's sweep, a
#: ragged length, a window that masks whole tiles, and rows with no allowed
#: key (sk < sq under a window; the reference oracle gives their mean of V,
#: so those rows are held to the Pallas semantics separately below).
FA_CASES = [
    (2, 4, 2, 128, 128, 32, True, 0, False),
    (1, 4, 4, 256, 256, 64, True, 0, False),
    (2, 2, 1, 128, 256, 32, False, 0, False),
    (1, 4, 2, 256, 256, 32, True, 64, False),
    (1, 8, 2, 128, 128, 128, True, 0, True),
    (1, 2, 2, 64, 192, 16, True, 48, False),
    (2, 4, 2, 50, 50, 64, True, 0, False),
    (1, 2, 1, 37, 71, 32, False, 0, True),
]
#: (b, s, d, n): the reference's sweep.
SCAN_CASES = [(2, 64, 32, 8), (1, 96, 16, 4), (2, 128, 64, 16),
              (1, 50, 24, 8)]
RMS_CASES = [(rows, d, bf16) for rows in (1, 7, 33, 70)
             for d in (32, 128, 384) for bf16 in (False, True)]


def _pair(a: np.ndarray, bf16: bool):
    """The same values in both frameworks (rounded to bfloat16 in both when
    asked: both round to nearest even)."""
    j = jnp.asarray(a)
    t = torch.from_numpy(a.copy())
    if bf16:
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,d,bf16", RMS_CASES)
def test_rmsnorm_plain_matches_jax_oracle(rows, d, bf16):
    rng = np.random.default_rng(rows * 1000 + d)
    xj, xt = _pair(rng.standard_normal((rows, d)).astype(np.float32) * 3,
                   bf16)
    wj, wt = _pair(rng.standard_normal(d).astype(np.float32), bf16)
    got = rn.rmsnorm(xt, wt)                     # CPU tensor: plain version
    assert got.dtype == xt.dtype and got.shape == xt.shape
    tol = 3e-2 if bf16 else 1e-5
    np.testing.assert_allclose(_np32(got), _np32(ref.rmsnorm_ref(xj, wj)),
                               rtol=tol, atol=tol)


def test_rmsnorm_pallas_interpret_case():
    rng = np.random.default_rng(5)
    xj, xt = _pair(rng.standard_normal((20, 128)).astype(np.float32), False)
    wj, wt = _pair(rng.standard_normal(128).astype(np.float32), False)
    out = pallas_rms(xj, wj, interpret=True, block_rows=8)
    np.testing.assert_allclose(_np32(rn.rmsnorm_ref(xt, wt)), _np32(out),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _fa_inputs(case):
    b, h, kv, sq, sk, d, causal, window, bf16 = case
    rng = np.random.default_rng(sq * 7 + sk + d)
    qj, qt = _pair(rng.standard_normal((b, h, sq, d)).astype(np.float32),
                   bf16)
    kj, kt = _pair(rng.standard_normal((b, kv, sk, d)).astype(np.float32),
                   bf16)
    vj, vt = _pair(rng.standard_normal((b, kv, sk, d)).astype(np.float32),
                   bf16)
    return (qj, kj, vj), (qt, kt, vt)


@pytest.mark.parametrize("case", FA_CASES, ids=[str(c[:8]) for c in FA_CASES])
def test_flash_attention_plain_matches_jax_oracle(case):
    causal, window, bf16 = case[6], case[7], case[8]
    (qj, kj, vj), (qt, kt, vt) = _fa_inputs(case)
    got = fa.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    want = ref.attention_ref(qj, kj, vj, causal=causal, window=window)
    tol = 2e-2 if bf16 else 2e-5
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=tol, atol=tol)


def test_flash_attention_rows_without_keys_are_zero_like_pallas():
    """sk < sq under a window: rows 16+8.. see no key.  The Pallas kernel
    (interpret mode) returns 0 there, and so does the plain version."""
    case = (1, 2, 1, 64, 16, 16, True, 8, False)
    (qj, kj, vj), (qt, kt, vt) = _fa_inputs(case)
    got = fa.flash_attention(qt, kt, vt, causal=True, window=8)
    want = pallas_fa(qj, kj, vj, causal=True, window=8, block_q=32,
                     block_k=16, interpret=True)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=2e-5,
                               atol=2e-5)
    assert not got[:, :, 24:].any() and got[:, :, :23].abs().sum() > 0


def test_flash_attention_strided_views_match_contiguous():
    """The model hands (B, S, H, D) tensors in as transposed views."""
    case = (2, 4, 2, 40, 40, 32, True, 0, False)
    _, (qt, kt, vt) = _fa_inputs(case)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (qt, kt, vt)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(fa.flash_attention(*views),
                               fa.flash_attention(qt, kt, vt), rtol=0,
                               atol=0)


def _emulate_tensor_core_kernel(q, k, v, causal, window, block_k=64):
    """The bfloat16 tensor-core kernel's arithmetic, replayed in float32 on
    the CPU: q.k of bfloat16 values in float32 (the products are exact),
    online softmax over key tiles of ``block_k`` with running (m, l) in
    float32, the scale folded with log2 e into exp2, a row max still at
    NEG_INF giving weight 0, P rounded to bfloat16 before ``P V`` while l
    sums the float32 weights, and the output rounded to bfloat16."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, kv, h // kv, sq, d)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    c = torch.tensor((1.0 / d ** 0.5) * np.log2(np.e), dtype=torch.float32)
    neg = torch.tensor(fa.NEG_INF, dtype=torch.float32)
    ok = fa._allowed(sq, sk, causal, window, "cpu")
    m = torch.full(qf.shape[:-1], fa.NEG_INF)
    lsum = torch.zeros(qf.shape[:-1])
    acc = torch.zeros(qf.shape)
    for k0 in range(0, sk, block_k):
        s = qf @ kf[..., k0:k0 + block_k, :].transpose(-1, -2)
        s = torch.where(ok[:, k0:k0 + block_k], s, neg)
        mx = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp2((m - mx) * c)
        msc = torch.where(mx == neg, torch.zeros_like(mx), mx * c)
        p = torch.exp2(s * c - msc[..., None])
        lsum = lsum * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] \
            + p.bfloat16().float() @ vf[..., k0:k0 + block_k, :]
        m = mx
    out = acc / lsum.clamp_min(1e-30)[..., None]
    out = torch.where((m <= fa.NEG_INF * 0.5)[..., None],
                      torch.zeros_like(out), out)
    return out.reshape(b, h, sq, d).to(torch.bfloat16)


#: FA_CASES and one long causal case (qwen2-7b's head dim, 4096 keys).
EMU_CASES = FA_CASES + [(1, 2, 1, 4096, 4096, 128, True, 0, True)]


@pytest.mark.parametrize("case", EMU_CASES,
                         ids=[str(c[:8]) for c in EMU_CASES])
def test_tensor_core_numerics_within_bf16_tolerance_of_jax_oracle(case):
    """Before any card: the bfloat16 kernel's rounding points (P to
    bfloat16, l from float32 weights, exp2 with the folded scale) keep the
    output within the reference's bfloat16 tolerance of 2e-2."""
    causal, window = case[6], case[7]
    (qj, kj, vj), (qt, kt, vt) = _fa_inputs(case[:8] + (True,))
    got = _emulate_tensor_core_kernel(qt, kt, vt, causal, window)
    want = ref.attention_ref(qj, kj, vj, causal=causal, window=window)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=2e-2, atol=2e-2)
    # the emulation is no copy of the plain version: P in bfloat16 moves it
    assert not torch.equal(got, fa.flash_attention_ref(
        qt, kt, vt, causal=causal, window=window))


@pytest.mark.parametrize("view,what", [
    (lambda: torch.zeros(1, 2, 16, 40, dtype=torch.bfloat16)[..., 1:33],
     "pointer"),
    (lambda: torch.zeros(1, 2, 16, 36, dtype=torch.bfloat16)[..., :32],
     "sequence stride"),
    (lambda: torch.zeros(1, 2, 16 * 32 + 4, dtype=torch.bfloat16)
     [..., :16 * 32].reshape(1, 2, 16, 32), "head stride"),
], ids=["pointer", "sequence-stride", "head-stride"])
def test_bf16_kernel_refuses_a_misaligned_view(view, what):
    """The check the wrapper runs before a CUDA launch refuses the view
    (on the card it raises before the kernel); the plain version on the
    CPU takes any alignment, in both types."""
    q = view()
    assert q.dtype == torch.bfloat16 and q.stride(-1) == 1
    with pytest.raises(ValueError, match=what):
        fa._check_kernel(q, q, q, 0)
    fa._check_kernel(q.float(), q.float(), q.float(), 0)   # float32 takes it
    for t in (q, q.float()):
        out = fa.flash_attention(t, t, t)
        assert out.shape == q.shape and out.dtype == t.dtype


# ---------------------------------------------------------------------------
# selective scan
# ---------------------------------------------------------------------------

def _scan_inputs(case, with_h0=False):
    b, s, d, n = case
    rng = np.random.default_rng(sum(case))
    x = rng.standard_normal((b, s, d)).astype(np.float32) * 0.5
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, d)))) * 0.1
          ).astype(np.float32)
    bb = rng.standard_normal((b, s, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, n)).astype(np.float32)
    a = (-np.exp(rng.standard_normal((d, n)) * 0.3)).astype(np.float32)
    h0 = rng.standard_normal((b, d, n)).astype(np.float32) if with_h0 \
        else None
    return x, dt, bb, cc, a, h0


@pytest.mark.parametrize("case", SCAN_CASES, ids=str)
def test_selective_scan_plain_matches_jax_oracle(case):
    x, dt, bb, cc, a, _ = _scan_inputs(case)
    y, h = ss.selective_scan(*(torch.from_numpy(t)
                               for t in (x, dt, bb, cc, a)))
    yr, hr = ref.selective_scan_ref(x, dt, bb, cc, a)
    assert y.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), rtol=2e-4,
                               atol=2e-4)


def test_selective_scan_initial_state_matches_models_scan():
    """h0 keeps the meaning of ``repro.models.mamba.selective_scan``'s."""
    from repro.models.mamba import selective_scan as assoc_scan
    x, dt, bb, cc, a, h0 = _scan_inputs((2, 40, 16, 8), with_h0=True)
    y, h = ss.selective_scan(*(torch.from_numpy(t)
                               for t in (x, dt, bb, cc, a, h0)))
    yr, hr = assoc_scan(x, dt, bb, cc, a, h0=jnp.asarray(h0), chunk=8)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), rtol=2e-4,
                               atol=2e-4)


def test_selective_scan_pallas_interpret_case():
    x, dt, bb, cc, a, _ = _scan_inputs((1, 32, 16, 4))
    y, h = ss.selective_scan(*(torch.from_numpy(t)
                               for t in (x, dt, bb, cc, a)))
    yp, hp = pallas_scan(x, dt, bb, cc, a, chunk=16, block_d=16,
                         interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(hp), rtol=2e-4,
                               atol=2e-4)


def test_selective_scan_takes_column_slices_of_one_projection():
    x, dt, bb, cc, a, _ = _scan_inputs((2, 24, 16, 8))
    proj = torch.from_numpy(np.concatenate([bb, cc], axis=-1))
    B, C = proj[..., :8], proj[..., 8:]
    assert not B.is_contiguous()
    y, h = ss.selective_scan(torch.from_numpy(x), torch.from_numpy(dt), B, C,
                             torch.from_numpy(a))
    y2, h2 = ss.selective_scan(*(torch.from_numpy(t)
                                 for t in (x, dt, bb, cc, a)))
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    torch.testing.assert_close(h, h2, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# wrappers on the CPU
# ---------------------------------------------------------------------------

def test_cpu_calls_do_not_count_as_launches():
    counts = (rn.rmsnorm.launches, fa.flash_attention.launches,
              ss.selective_scan.launches)
    x = torch.ones(3, 32)
    rn.rmsnorm(x, torch.ones(32))
    q = torch.ones(1, 2, 4, 16)
    fa.flash_attention(q, q, q)
    s = torch.ones(1, 4, 8)
    ss.selective_scan(s, s, torch.ones(1, 4, 2), torch.ones(1, 4, 2),
                      -torch.ones(8, 2))
    assert (rn.rmsnorm.launches, fa.flash_attention.launches,
            ss.selective_scan.launches) == counts
    assert not rn.rmsnorm.shapes and not fa.flash_attention.shapes \
        and not ss.selective_scan.shapes


@pytest.mark.parametrize("call,err", [
    (lambda: rn.rmsnorm(torch.ones(3, 8, dtype=torch.float16),
                        torch.ones(8)), TypeError),
    (lambda: rn.rmsnorm(torch.ones(3, 8), torch.ones(4)), ValueError),
    (lambda: fa.flash_attention(torch.ones(1, 3, 4, 16),
                                torch.ones(1, 2, 4, 16),
                                torch.ones(1, 2, 4, 16)), ValueError),
    (lambda: fa.flash_attention(torch.ones(1, 2, 4, 16),
                                torch.ones(1, 2, 4, 16).double(),
                                torch.ones(1, 2, 4, 16)), TypeError),
    (lambda: fa.flash_attention(*[torch.ones(1, 2, 16, 4).transpose(2, 3)]
                                * 3), ValueError),
    (lambda: ss.selective_scan(torch.ones(1, 4, 8), torch.ones(1, 4, 8),
                               torch.ones(1, 4, 2), torch.ones(1, 4, 2),
                               torch.ones(8, 2).double()), TypeError),
    (lambda: ss.selective_scan(torch.ones(1, 4, 8),
                               torch.ones(1, 4, 8).bfloat16(),
                               torch.ones(1, 4, 2), torch.ones(1, 4, 2),
                               torch.ones(8, 2)), TypeError),
], ids=["rms-f16", "rms-w-shape", "fa-groups", "fa-types",
        "fa-head-stride", "scan-A-type", "scan-mixed"])
def test_wrappers_refuse_what_the_kernels_do_not_take(call, err):
    with pytest.raises(err):
        call()


#: Head dims the CUDA kernel has no instance for (48) or that it takes
#: since the shipped configs need them (96: gpt-1.1b; 112: kimi-k2 and
#: zamba2; 136: gpt-11.1b, a 144-wide tile on the card), in both types.
#: On the CPU every head dim is the plain version's.
ANY_HEAD_DIM_CASES = [
    (1, 4, 2, 40, 40, 48, True, 0, False), (2, 4, 2, 33, 50, 96, False, 0,
                                            False),
    (1, 8, 1, 64, 64, 112, True, 20, False),
    (1, 4, 4, 45, 45, 136, True, 0, False),
    (1, 4, 2, 40, 40, 48, True, 0, True), (1, 4, 2, 70, 70, 136, True, 16,
                                           True),
]


@pytest.mark.parametrize("case", ANY_HEAD_DIM_CASES,
                         ids=[f"d{c[5]}-{'bf16' if c[8] else 'f32'}"
                              for c in ANY_HEAD_DIM_CASES])
def test_flash_attention_takes_any_head_dim_on_the_cpu(case):
    """The kernels' head-dim limit is checked on the card only: on the CPU
    the wrapper is the plain version at any head dim, held to the JAX
    oracle (at the tolerances of the other head dims)."""
    test_flash_attention_plain_matches_jax_oracle(case)


@pytest.mark.parametrize("n", [17, 32])
def test_selective_scan_takes_any_state_size_on_the_cpu(n):
    """N past the kernel's 16 (checked on the card only): the plain
    version against the JAX oracle, with and without an initial state."""
    x, dt, bb, cc, a, h0 = _scan_inputs((2, 40, 16, n), with_h0=True)
    y, h = ss.selective_scan(*(torch.from_numpy(t)
                               for t in (x, dt, bb, cc, a)))
    yr, hr = ref.selective_scan_ref(x, dt, bb, cc, a)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), rtol=2e-4,
                               atol=2e-4)
    from repro.models.mamba import selective_scan as assoc_scan
    y, h = ss.selective_scan(*(torch.from_numpy(t)
                               for t in (x, dt, bb, cc, a, h0)))
    yr, hr = assoc_scan(x, dt, bb, cc, a, h0=jnp.asarray(h0), chunk=8)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), rtol=2e-4,
                               atol=2e-4)


# ---------------------------------------------------------------------------
# rmsnorm, residual form: s = x + r, then the norm of s
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,d,bf16", RMS_CASES)
def test_add_rmsnorm_plain_matches_jax_add_and_oracle(rows, d, bf16):
    rng = np.random.default_rng(rows * 1000 + d + 7)
    xj, xt = _pair(rng.standard_normal((rows, d)).astype(np.float32) * 3,
                   bf16)
    rj, rt = _pair(rng.standard_normal((rows, d)).astype(np.float32), bf16)
    wj, wt = _pair(rng.standard_normal(d).astype(np.float32), bf16)
    sj = xj + rj
    want_y = ref.rmsnorm_ref(sj, wj)
    tol = 3e-2 if bf16 else 1e-5
    for s, y in (rn.add_rmsnorm_ref(xt, rt, wt), rn.add_rmsnorm(xt, rt, wt)):
        assert s.dtype == y.dtype == xt.dtype
        assert s.shape == y.shape == xt.shape
        # the sum is bit-equal to jnp's add in either type
        assert s.view(torch.int16 if bf16 else torch.int32).numpy() \
            .tobytes() == np.asarray(sj).tobytes()
        np.testing.assert_allclose(_np32(y), _np32(want_y), rtol=tol,
                                   atol=tol)


def test_add_rmsnorm_pallas_interpret_case():
    rng = np.random.default_rng(6)
    xj, xt = _pair(rng.standard_normal((20, 128)).astype(np.float32), False)
    rj, rt = _pair(rng.standard_normal((20, 128)).astype(np.float32), False)
    wj, wt = _pair(rng.standard_normal(128).astype(np.float32), False)
    out = pallas_rms(xj + rj, wj, interpret=True, block_rows=8)
    s, y = rn.add_rmsnorm_ref(xt, rt, wt)
    np.testing.assert_allclose(_np32(y), _np32(out), rtol=1e-5, atol=1e-5)


def test_add_rmsnorm_cpu_calls_do_not_count_as_launches():
    before = (rn.rmsnorm.launches, dict(rn.rmsnorm.shapes))
    x = torch.ones(3, 32)
    rn.add_rmsnorm(x, x, torch.ones(32))
    assert (rn.rmsnorm.launches, dict(rn.rmsnorm.shapes)) == before


_X = torch.ones(3, 8)


@pytest.mark.parametrize("call,err", [
    (lambda: rn.add_rmsnorm(_X, _X.bfloat16(), torch.ones(8)), TypeError),
    (lambda: rn.add_rmsnorm(_X.half(), _X.half(), torch.ones(8)), TypeError),
    (lambda: rn.add_rmsnorm(_X, _X.numpy(), torch.ones(8)), TypeError),
    (lambda: rn.add_rmsnorm(_X, torch.ones(1, 8), torch.ones(8)),
     ValueError),
    (lambda: rn.add_rmsnorm(_X, _X, torch.ones(4)), ValueError),
    (lambda: rn.add_rmsnorm(_X, torch.ones(8, 3).T, torch.ones(8)),
     ValueError),
    (lambda: rn.add_rmsnorm(torch.ones(3, 16)[:, ::2], _X, torch.ones(8)),
     ValueError),
], ids=["mixed-types", "f16", "ndarray", "broadcast", "w-width",
        "r-strided", "x-strided"])
def test_add_rmsnorm_refuses_what_the_kernel_does_not_take(call, err):
    with pytest.raises(err):
        call()


# ---------------------------------------------------------------------------
# selective scan, fused Mamba1 form: bias, softplus, scan, D skip, gate
# ---------------------------------------------------------------------------

def _fused_inputs(case, bf16, step):
    """NumPy inputs of one fused call (``S = 1`` for a step), rounded to
    bfloat16 in both frameworks where ``bf16``: x, dt (before the bias),
    B, C, z in the working type; dt_bias, A_log, D, h0 in float32."""
    b, s, d, n = case
    s = 1 if step else s
    rng = np.random.default_rng(sum(case) + 17 * step + 3 * bf16)
    f = np.float32
    io = [rng.standard_normal((b, s, d)).astype(f) * 0.5,          # x
          rng.standard_normal((b, s, d)).astype(f) * 0.5 - 1.0,    # dt
          rng.standard_normal((b, s, n)).astype(f),                # B
          rng.standard_normal((b, s, n)).astype(f),                # C
          rng.standard_normal((b, s, d)).astype(f)]                # z
    params = [rng.standard_normal(d).astype(f) * 0.5,              # dt_bias
              (np.log(np.arange(1, n + 1, dtype=f))[None, :]
               + rng.standard_normal((d, n)).astype(f) * 0.1),     # A_log
              rng.standard_normal(d).astype(f),                    # D
              rng.standard_normal((b, d, n)).astype(f)]            # h0
    io = [_pair(a, bf16) for a in io]
    params = [(jnp.asarray(a), torch.from_numpy(a.copy())) for a in params]
    x, dt, B, C, z = io
    bias, A_log, D, h0 = params
    return x, dt, bias, B, C, A_log, D, z, h0


def _jax_fused(x, dt, bias, B, C, A_log, D, z, h0, step):
    """The reference model's ``mamba1_block`` from the bias add to the
    cast, on its own functions."""
    A = -jnp.exp(A_log.astype(jnp.float32))
    dt = jax.nn.softplus(dt + bias.astype(dt.dtype))
    if step:
        y, h = ref_mamba.selective_scan_step(x[:, 0], dt[:, 0], B[:, 0],
                                             C[:, 0], A, h0)
        y = y[:, None]
    else:
        y, h = ref_mamba.selective_scan(x, dt, B, C, A, h0=h0, chunk=16)
    y = y + D.astype(jnp.float32) * x.astype(jnp.float32)
    y = y * ref_silu(z.astype(jnp.float32))
    return y.astype(x.dtype), h


@pytest.mark.parametrize("step", [False, True], ids=["seq", "step"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", SCAN_CASES, ids=str)
def test_selective_scan_fused_plain_matches_jax_model(case, bf16, step):
    """The state within the scan's 2e-4 in both types, and the output
    within 2e-4 in float32 and 4e-3 (one bfloat16 step, 2**-8) in
    bfloat16.  The port's softplus rounds its ``exp``, its ``log1p`` and
    their sum to bfloat16 as ``jax.nn.softplus`` does, so ``dt`` is the
    same value and the state agrees to float32 rounding (largest seen:
    9e-8 of ``1 + |h|``); an output rounds to the other side of a
    bfloat16 step where the two scans' float32 ``y`` straddle it (largest
    seen: 1.3e-3 of ``1 + |y|``).  A softplus rounded once, in float32,
    gives a ``dt`` one bfloat16 step away on a fifth of the values and
    fails both bounds (state: 1.7e-3 to 5.3e-3, output up to 2.4e-2)."""
    pairs = _fused_inputs(case, bf16, step)
    want_out, want_h = _jax_fused(*(j for j, _ in pairs), step)
    out, h = ss.selective_scan_fused_ref(*(t for _, t in pairs), step=step)
    assert out.dtype == pairs[0][1].dtype and h.dtype == torch.float32
    assert tuple(out.shape) == want_out.shape
    tol = 4e-3 if bf16 else 2e-4
    np.testing.assert_allclose(_np32(out), _np32(want_out), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=2e-4,
                               atol=2e-4)


def test_softplus_is_jax_softplus_bit_for_bit_in_bfloat16():
    """2**20 seeded bfloat16 values, ``N(-0.5, 0.7)`` as the model's
    ``dt`` runs, a wide uniform band and the extremes of the type: each op
    of JAX's ``logaddexp(x, 0)`` rounds to bfloat16, and so does the
    port's.  The band stops at -80: below about -87 the result is
    subnormal, which XLA's CPU backend flushes to zero and PyTorch keeps —
    a difference of the two hosts' float modes, not of the softplus."""
    rng = np.random.default_rng(16)
    x = np.concatenate([rng.normal(-0.5, 0.7, 1 << 20),
                        rng.uniform(-80.0, 80.0, 1 << 12),
                        [0.0, -0.0, 3e38, -3e38, np.inf, -np.inf]])
    xj, xt = _pair(x.astype(np.float32), True)
    want = np.asarray(jax.nn.softplus(xj))
    got = ss.softplus(xt)
    assert got.dtype == torch.bfloat16
    assert got.view(torch.int16).numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("step", [False, True], ids=["seq", "step"])
def test_selective_scan_fused_wrapper_updates_the_state_in_place(step):
    """On the CPU the wrapper is the plain version, bit for bit; with
    ``h_out`` aliasing ``h0`` the state is read first and then written
    over, and ``h_out`` is what comes back."""
    args = [t for _, t in _fused_inputs((2, 24, 16, 8), True, step)]
    want_out, want_h = ss.selective_scan_fused_ref(*args, step=step)
    state = args[-1].clone()
    out, h = ss.selective_scan_fused(*args[:-1], state, state, step=step)
    assert h is state
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(h, want_h, rtol=0, atol=0)
    out0, h0 = ss.selective_scan_fused(*args[:-1])      # a zero start
    want0, wanth0 = ss.selective_scan_fused_ref(*args[:-1], step=step) \
        if step else ss.selective_scan_fused_ref(*args[:-1])
    if not step:
        torch.testing.assert_close(out0, want0, rtol=0, atol=0)
        torch.testing.assert_close(h0, wanth0, rtol=0, atol=0)


def test_selective_scan_fused_takes_the_models_views():
    """``B, C`` column slices of one projection and ``z`` the second half
    of ``xz`` give what their contiguous copies give, to a float32 ulp
    (PyTorch's CPU ``sigmoid`` takes a vectorised path on contiguous
    memory and a scalar one on a strided view)."""
    args = [t for _, t in _fused_inputs((2, 24, 16, 8), False, False)]
    x, dt, bias, B, C, A_log, D, z, h0 = args
    proj = torch.cat([torch.zeros(2, 24, 3), B, C], dim=-1)
    xz = torch.cat([x, z], dim=-1)
    Bv, Cv, zv = proj[..., 3:11], proj[..., 11:], xz[..., 16:]
    assert not (Bv.is_contiguous() or Cv.is_contiguous()
                or zv.is_contiguous())
    got = ss.selective_scan_fused(x, dt, bias, Bv, Cv, A_log, D, zv, h0)
    want = ss.selective_scan_fused(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_selective_scan_fused_cpu_calls_do_not_count_as_launches():
    before = (ss.selective_scan.launches, dict(ss.selective_scan.shapes))
    args = [t for _, t in _fused_inputs((1, 8, 16, 4), False, True)]
    ss.selective_scan_fused(*args, args[-1], step=True)
    ss.selective_scan_fused(*args[:-1])
    assert (ss.selective_scan.launches,
            dict(ss.selective_scan.shapes)) == before


_F = [t for _, t in _fused_inputs((1, 4, 8, 2), False, False)]


def _fused(**swap):
    names = ("x", "dt", "dt_bias", "B", "C", "A_log", "D", "z", "h0")
    kw = dict(zip(names, _F))
    step = swap.pop("step", False)
    kw.update(swap)
    return lambda: ss.selective_scan_fused(**kw, step=step)


@pytest.mark.parametrize("call,err", [
    (_fused(dt=_F[1].bfloat16()), TypeError),
    (_fused(x=_F[0].half(), dt=_F[1].half(), B=_F[3].half(),
            C=_F[4].half(), z=_F[7].half()), TypeError),
    (_fused(A_log=_F[5].double()), TypeError),
    (_fused(h_out=torch.zeros(1, 8, 3)), ValueError),
    (_fused(h_out=torch.zeros(1, 2, 8).transpose(1, 2)), ValueError),
    (_fused(h_out=torch.zeros(1, 8, 2, dtype=torch.float64)), TypeError),
    (_fused(step=True), ValueError),
    (_fused(z=torch.ones(1, 8, 4).transpose(1, 2)), ValueError),
    (_fused(D=torch.ones(9)), ValueError),
], ids=["mixed-types", "f16", "A_log-f64", "h_out-shape",
        "h_out-strided", "h_out-f64", "step-of-4", "z-strided", "D-width"])
def test_selective_scan_fused_refuses_what_the_kernel_does_not_take(call,
                                                                    err):
    with pytest.raises(err):
        call()


@pytest.mark.parametrize("step", [False, True], ids=["seq", "step"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [17, 32])
def test_selective_scan_fused_takes_any_state_size_on_the_cpu(n, bf16,
                                                              step):
    """N past the kernel's 16 (checked on the card only): the fused
    wrapper on the CPU against the reference model's own sequence, at the
    tolerances of ``test_selective_scan_fused_plain_matches_jax_model``."""
    pairs = _fused_inputs((2, 24, 16, n), bf16, step)
    want_out, want_h = _jax_fused(*(j for j, _ in pairs), step)
    out, h = ss.selective_scan_fused(*(t for _, t in pairs), step=step)
    tol = 4e-3 if bf16 else 2e-4
    np.testing.assert_allclose(_np32(out), _np32(want_out), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=2e-4,
                               atol=2e-4)


# ---------------------------------------------------------------------------
# the scan's working type: cfg.scan_dtype (ROADMAP Queue C 7)
# ---------------------------------------------------------------------------

#: (b, S, D, N): chunks of 80 (two), 7 (one, odd), 65 (two, odd), 128 (two).
CHUNKED_CASES = [(2, 160, 32, 16), (1, 7, 8, 4), (2, 130, 16, 8),
                 (1, 256, 24, 16)]


@pytest.mark.parametrize("case", CHUNKED_CASES, ids=str)
def test_chunked_bf16_scan_matches_the_reference_scan(case):
    """``selective_scan_chunked_ref`` in bfloat16 against the reference's
    ``models/mamba.py::selective_scan(work_dtype=bfloat16)`` with an
    initial state: the same chunks, ``a`` and ``u`` rounded alike and
    folded in ``lax.associative_scan``'s order, so the outputs differ only
    by the float32 sum over N (within 1e-5 at |y| up to 30, the state
    within 1e-6), where the float32 scan is 4e-3 to 1.3e-1 off."""
    x, dt, bb, cc, a, h0 = _scan_inputs(case, with_h0=True)
    yr, hr = ref_mamba.selective_scan(
        *(jnp.asarray(t) for t in (x, dt, bb, cc, a)), h0=jnp.asarray(h0),
        work_dtype=jnp.bfloat16)
    y, h = ss.selective_scan_chunked_ref(
        *(torch.from_numpy(t) for t in (x, dt, bb, cc, a, h0)))
    assert y.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=0, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_associative_scan_rounds_in_jax_order(n):
    """The bfloat16 prefix of ``associative_scan`` bit for bit against
    ``jax.lax.associative_scan`` with the reference's combine, at even and
    odd lengths (the recursion's two branches)."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 3)).astype(np.float32)
    u = rng.standard_normal((2, n, 3)).astype(np.float32)

    def combine(left, right):
        return left[0] * right[0], left[1] * right[0] + right[1]

    with jax.disable_jit():
        ra, ru = jax.lax.associative_scan(
            combine, (jnp.asarray(a, jnp.bfloat16),
                      jnp.asarray(u, jnp.bfloat16)), axis=1)
    ta, tu = ss.associative_scan(torch.from_numpy(a).bfloat16(),
                                 torch.from_numpy(u).bfloat16(), dim=1)
    for got, want in ((ta, ra), (tu, ru)):
        assert torch.equal(got.float(),
                           torch.from_numpy(np.asarray(want, np.float32)))


def _falcon_block(scan_dtype, seed, s):
    """Reduced falcon-mamba-7b's first layer with ``scan_dtype`` (float32
    weights from ``init_params(PRNGKey(0))``, a random ``dt_bias``) and an
    input ``(2, s, d)``, for both packages."""
    from repro import configs as ref_configs
    from repro.models import model as ref_model
    from repro_torch import configs
    rcfg = ref_configs.get("falcon-mamba-7b").reduced().replace(
        scan_dtype=scan_dtype)
    tcfg = configs.get("falcon-mamba-7b").reduced().replace(
        scan_dtype=scan_dtype)
    full = ref_model.init_params(rcfg, jax.random.PRNGKey(0))
    p = {k: np.array(v[0], np.float32) for k, v in full["layers"].items()}
    rng = np.random.default_rng(seed)
    p["dt_bias"] = rng.standard_normal(p["dt_bias"].shape).astype(
        np.float32)
    x = rng.standard_normal((2, s, rcfg.d_model)).astype(np.float32)
    return rcfg, tcfg, p, x


#: The block with the bfloat16 prefix against the reference's: a and u
#: are rounded to bfloat16 from float32 values that the two packages
#: compute to within a float32 ulp, so now and then one lands a bfloat16
#: step from the reference's and its chunk carries it: 2.3e-4 to 9.0e-4
#: on outputs up to 17, the state 0 to 2.4e-4, over these and other
#: seeds; the float32 scan in its place is 1.08e-2 and 3.0e-2 off.
SCAN_BF16_BLOCK_TOL = 2e-3


@pytest.mark.parametrize("scan_dtype,seed,s", [
    ("float32", 0, 64), ("bfloat16", 0, 64), ("bfloat16", 1, 160),
    ("bfloat16", 3, 200)])
def test_mamba1_block_honours_scan_dtype(scan_dtype, seed, s):
    """The port's ``mamba1_block`` against ``repro.models.mamba.
    mamba1_block`` on reduced falcon-mamba-7b at both working types: at
    float32 within the float32 scan's 2e-5, at bfloat16 within
    ``SCAN_BF16_BLOCK_TOL`` (output and final state); the decode step
    ignores the knob in both packages."""
    from repro_torch.models import mamba as port_mamba
    rcfg, tcfg, p, x = _falcon_block(scan_dtype, seed, s)
    y_r, (h_r, _) = ref_mamba.mamba1_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, rcfg)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    y, (h, conv) = port_mamba.mamba1_block(torch.from_numpy(x), tp, tcfg)
    tol = 2e-5 if scan_dtype == "float32" else SCAN_BF16_BLOCK_TOL
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=0, atol=tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), rtol=0, atol=tol)
    # one decode step from that state: the float32 step in both
    y1_r, (h1_r, _) = ref_mamba.mamba1_block(
        jnp.asarray(x[:, 0]), {k: jnp.asarray(v) for k, v in p.items()},
        rcfg, h0=h_r, conv0=jnp.asarray(conv.numpy()), single_step=True)
    y1, (h1, _) = port_mamba.mamba1_block(
        torch.from_numpy(x[:, 0]), tp, tcfg,
        h0=torch.from_numpy(np.array(h_r)), conv0=conv, single_step=True)
    np.testing.assert_allclose(y1.numpy(), np.asarray(y1_r), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(h1.numpy(), np.asarray(h1_r), rtol=0,
                               atol=2e-5)


def test_scan_dtype_bf16_dispatch_runs_the_card_instance():
    """By source: the fused wrapper takes the bfloat16 working type's meta
    branch and plain version (``selective_scan_chunked_ref``) only off
    the card, first; on the card it hands an input that requires a
    gradient to ``SelectiveScanFusedBf16Fn`` and otherwise launches the
    bfloat16 instance (``_fused_fwd_cuda(..., work_bf16=...)``), with no
    ``try``/``except`` around either and nothing refused for the working
    type; a decode step with the bfloat16 working type is a
    ``ValueError``."""
    import ast
    import inspect
    import textwrap
    assert not hasattr(ss, "NO_WORK_DTYPE")
    tree = ast.parse(textwrap.dedent(inspect.getsource(
        ss.selective_scan_fused)))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    src = ast.unparse(tree)
    assert "NotImplementedError" not in src
    cpu = src.find("if not x.is_cuda:")
    meta = src.find("_meta_fused(", cpu)
    plain = src.find("functools.partial(selective_scan_chunked_ref", cpu)
    sizes = src.find("_check_kernel_sizes(", cpu)
    fn = src.find("SelectiveScanFusedBf16Fn.apply(")
    launch = src.find("_fused_fwd_cuda(")
    assert 0 <= cpu < meta < plain < sizes < fn < launch
    assert "work_bf16=work_bf16" in src[launch:]
    args = [t for _, t in _fused_inputs((1, 1, 8, 2), False, True)]
    with pytest.raises(ValueError, match="work_dtype"):
        ss.selective_scan_fused(*args, step=True,
                                work_dtype=torch.bfloat16)

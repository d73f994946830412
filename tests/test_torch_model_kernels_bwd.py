"""The backward kernels' plain versions, the autograd Functions around the
model kernels, and the rule that no CUDA wrapper drops a gradient.

``rmsnorm_bwd_ref`` (with and without ``ds_in``, the residual form's
gradient from the stream) and ``flash_attention_bwd_ref`` (causal, sliding
window, GQA, ``Sq != Sk``, rows with no allowed key) are held to the
vector-Jacobian products of the JAX package's oracles (``kernels/ref.py``)
by ``jax.vjp`` and to torch autograd of the port's plain forwards; the
Functions (``RMSNormFn``, ``AddRMSNormFn``, ``FlashAttentionFn``), which on
the CPU run the plain versions on both sides, pass ``gradcheck`` in
float64.  The backward kernels themselves run only on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``); here a host emulation
of the bfloat16 tensor-core backward's roundings (``P`` and ``dS`` rounded
to bfloat16 as product operands) is held to the plain backward within the
kernel's bfloat16 tolerance, the attention, scan and norm sources are held
to the determinism rule (no atomics), and the norm backward's row split
(its blocks' runs and workspace) is checked as the wrapper hands it over.

Tolerances: float32 against JAX and autograd 2e-5 relative to the
largest magnitude (sums in another order); bfloat16 one bfloat16 step
(1e-2) against autograd, both rounding once from float32, and the
emulated tensor-core roundings against the plain backward (the kernel's
``TOL_BWD`` in ``chip_smoke.py``).
"""
import ast
import inspect
import re
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as kref
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import group_reduce as gr
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import selective_scan as ss

F32_TOL, BF16_TOL = 2e-5, 1e-2
#: (b, h, kv, sq, sk, d, causal, window): GQA, Sq != Sk both ways, a window
#: that masks whole blocks, and rows with no allowed key (the last).
FA_CASES = [(2, 4, 2, 16, 16, 16, True, 0), (1, 4, 1, 12, 20, 16, False, 0),
            (1, 2, 2, 24, 24, 32, True, 5), (2, 4, 2, 20, 9, 16, True, 0),
            (1, 2, 1, 32, 8, 16, True, 4)]
RMS_SHAPES = [(3, 5, 64), (7, 384), (1, 1, 32)]


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, copy=True)).to(dtype)


def _close(got, want, tol):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = want.detach().double().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

def _rms_inputs(shape, seed):
    rng = _rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 2
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, w, dy


@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rmsnorm_bwd_ref_matches_jax_vjp(shape):
    x, w, dy = _rms_inputs(shape, sum(shape))
    _, vjp = jax.vjp(lambda a, b: kref.rmsnorm_ref(a, b, eps=1e-5), x, w)
    want_dx, want_dw = vjp(dy)
    dx, dw = rn.rmsnorm_bwd_ref(_t(x), _t(w), _t(dy), 1e-5)
    _close(dx, want_dx, F32_TOL)
    _close(dw, want_dw, F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rmsnorm_bwd_ref_matches_autograd(shape, dtype):
    x, w, dy = _rms_inputs(shape, sum(shape) + 1)
    xt = _t(x, dtype).requires_grad_()
    wt = _t(w, dtype).requires_grad_()
    torch.autograd.backward(rn.rmsnorm_ref(xt, wt), _t(dy, dtype))
    dx, dw = rn.rmsnorm_bwd_ref(_t(x, dtype), _t(w, dtype), _t(dy, dtype))
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert dx.dtype == dtype and dw.dtype == dtype
    _close(dx, xt.grad, tol)
    _close(dw, wt.grad, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("with_ds", [True, False], ids=["ds_in", "no_ds"])
def test_residual_form_gradient_is_the_norm_bwd_plus_ds_in(with_ds, dtype):
    """The residual form's ``(dx, dr, dw)``: ``dx = dr`` is the plain
    backward at the stored sum ``s`` with the stream's gradient added."""
    x, w, dy = _rms_inputs((4, 6, 64), 11)
    r = _rng(12).standard_normal((4, 6, 64)).astype(np.float32)
    ds = _rng(13).standard_normal((4, 6, 64)).astype(np.float32)
    xt, rt, wt = (_t(a, dtype).requires_grad_() for a in (x, r, w))
    s, y = rn.add_rmsnorm_ref(xt, rt, wt)
    grads = [_t(ds, dtype) if with_ds else None, _t(dy, dtype)]
    outs = [s, y] if with_ds else [y]
    torch.autograd.backward(outs, [g for g in grads if g is not None])
    s_val = (_t(x, dtype) + _t(r, dtype))
    dx, dw = rn.rmsnorm_bwd_ref(s_val, _t(w, dtype), _t(dy, dtype), 1e-5,
                                _t(ds, dtype) if with_ds else None)
    tol = F32_TOL if dtype == torch.float32 else 2 * BF16_TOL
    _close(dx, xt.grad, tol)
    _close(dx, rt.grad, tol)
    _close(dw, wt.grad, tol)


def test_norm_functions_pass_gradcheck_in_float64():
    rng = _rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 16))).requires_grad_()
    r = torch.from_numpy(rng.standard_normal((3, 16))).requires_grad_()
    w = torch.from_numpy(rng.standard_normal(16)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b: rn.RMSNormFn.apply(a, b, 1e-5), (x, w))
    assert torch.autograd.gradcheck(
        lambda a, b, c: rn.AddRMSNormFn.apply(a, b, c, 1e-5), (x, r, w))
    # only the norm's output used: the sum's gradient comes in as None
    assert torch.autograd.gradcheck(
        lambda a, b, c: rn.AddRMSNormFn.apply(a, b, c, 1e-5)[1], (x, r, w))


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

def _fa_inputs(case, seed, dtype=np.float32):
    b, h, kv, sq, sk, d, _, _ = case
    rng = _rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(dtype)
    k = rng.standard_normal((b, kv, sk, d)).astype(dtype)
    v = rng.standard_normal((b, kv, sk, d)).astype(dtype)
    do = rng.standard_normal((b, h, sq, d)).astype(dtype)
    return q, k, v, do


def _empty_rows(case):
    _, _, _, sq, sk, _, causal, window = case
    ok = fa._allowed(sq, sk, causal, window, "cpu")
    return ~ok.any(dim=-1)


def test_some_case_has_rows_with_no_allowed_key():
    assert bool(_empty_rows(FA_CASES[-1]).any())


@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_bwd_ref_matches_jax_vjp(case):
    """Against ``jax.vjp`` of ``kernels/ref.py::attention_ref``.  That
    oracle gives a row with no allowed key the mean of V where the kernel
    gives 0, so the cotangent is 0 on those rows (which then add nothing
    on either side)."""
    *_, causal, window = case
    q, k, v, do = _fa_inputs(case, 7)
    do[:, :, _empty_rows(case).numpy()] = 0
    _, vjp = jax.vjp(lambda a, b, c: kref.attention_ref(
        a, b, c, causal=causal, window=window), q, k, v)
    want = vjp(do)
    out, lse = fa.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                      window=window, return_lse=True)
    got = fa.flash_attention_bwd_ref(_t(q), _t(k), _t(v), out, lse, _t(do),
                                     causal=causal, window=window)
    for g, w in zip(got, want):
        _close(g, w, F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_bwd_ref_matches_autograd(case, dtype):
    """Against torch autograd of the plain forward, rows with no allowed
    key included (their output is 0, so they pass no gradient)."""
    *_, causal, window = case
    q, k, v, do = _fa_inputs(case, 8)
    qt, kt, vt = (_t(a, dtype).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention_ref(qt, kt, vt, causal=causal, window=window)
    torch.autograd.backward(out, _t(do, dtype))
    with torch.no_grad():
        o2, lse = fa.flash_attention_ref(qt, kt, vt, causal=causal,
                                         window=window, return_lse=True)
    got = fa.flash_attention_bwd_ref(qt.detach(), kt.detach(), vt.detach(),
                                     o2, lse, _t(do, dtype), causal=causal,
                                     window=window)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for g, t in zip(got, (qt, kt, vt)):
        assert g.dtype == dtype and g.shape == t.shape
        _close(g, t.grad, tol)
    empty = _empty_rows(case)
    if bool(empty.any()):
        assert torch.all(got[0][:, :, empty] == 0)
        assert torch.all(lse[:, :, empty] == float("inf"))


def test_lse_is_the_rows_logsumexp():
    case = FA_CASES[2]
    q, k, v, _ = _fa_inputs(case, 9)
    _, lse = fa.flash_attention_ref(_t(q), _t(k), _t(v), causal=True,
                                    window=5, return_lse=True)
    s, ok = fa._scores(_t(q), _t(k), True, 5)
    want = torch.logsumexp(s.masked_fill(~ok, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want.reshape(lse.shape))


LOG2E = 1.4426950408889634
#: The bfloat16 rounding budget's cases: ``FA_CASES`` and qwen2-7b's heads
#: (28 query, 4 KV, D 128) at the training length, causal.
TC_CASES = FA_CASES + [(1, 28, 4, 512, 512, 128, True, 0)]


def _tc_bwd_emulated(q, k, v, out, lse, dout, causal, window):
    """The bfloat16 tensor-core backward's arithmetic on the host: products
    of bfloat16 operands summed in float32; ``P = exp2(S scale log2 e -
    lse log2 e)`` on the allowed keys; ``P`` rounded to bfloat16 for
    ``P^T dO`` and ``dS = P (dP - delta)`` for ``dS^T Q`` and ``dS K``;
    ``dK``, ``dV`` summed over a group's heads in float32, then scaled and
    rounded once, as the fold does."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / d ** 0.5
    qf = q.float().reshape(b, kv, g, sq, d)
    kf, vf = k.float(), v.float()
    do = dout.float().reshape(b, kv, g, sq, d)
    ok = fa._allowed(sq, sk, causal, window, "cpu")
    s = torch.einsum("bkgqd,bkcd->bkgqc", qf, kf)
    lse2 = (lse.float() * LOG2E).reshape(b, kv, g, sq, 1)
    p = torch.where(ok, torch.exp2(s * (scale * LOG2E) - lse2),
                    torch.zeros_like(s))
    delta = (do * out.float().reshape(b, kv, g, sq, d)).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bkgqd,bkcd->bkgqc", do, vf) - delta)
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bkgqc,bkgqd->bkcd", p16, do)
    dq = torch.einsum("bkgqc,bkcd->bkgqd", ds16, kf) * scale
    dk = torch.einsum("bkgqc,bkgqd->bkcd", ds16, qf) * scale
    return (dq.reshape(b, h, sq, d).bfloat16(), dk.bfloat16(),
            dv.bfloat16())


@pytest.mark.parametrize("case", TC_CASES, ids=str)
def test_tensor_core_roundings_fit_the_bf16_tolerance(case):
    """The tensor-core backward rounds ``P`` and ``dS`` to bfloat16 where
    the plain backward keeps float32: emulated on bfloat16 inputs, with
    the forward's bfloat16 ``out`` and its ``lse``, the gradients stay
    within the kernel's bfloat16 tolerance of the plain backward's."""
    *_, causal, window = case
    q, k, v, do = (_t(a, torch.bfloat16) for a in _fa_inputs(case, 14))
    out, lse = fa.flash_attention_ref(q, k, v, causal=causal, window=window,
                                      return_lse=True)
    got = _tc_bwd_emulated(q, k, v, out, lse, do, causal, window)
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                      window=window)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        _close(a, w, BF16_TOL)
    empty = _empty_rows(case)
    if bool(empty.any()):
        assert torch.all(got[0][:, :, empty] == 0)


def test_attention_source_uses_no_atomics():
    """Determinism: the attention kernels sum every gradient in a fixed
    order (the bfloat16 dK, dV partials folded in head order), so a resumed
    training run repeats the uninterrupted one bit for bit.  An atomic add
    would make the order, and so the bits, depend on scheduling."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    assert "atomicAdd" not in src
    assert not re.search(r"\batomic[A-Z]\w*\s*\(", src)


def test_scan_source_uses_no_atomics():
    """The same rule for the scan's backward: ``dB``, ``dC`` (sums over the
    channels) and ``dA_log``, ``dD``, ``ddt_bias`` (sums over the batch)
    leave each block as float32 partials that a second launch folds in
    index order."""
    src = (_build.CSRC / "selective_scan.cu").read_text()
    assert "atomicAdd" not in src
    assert not re.search(r"\batomic[A-Z]\w*\s*\(", src)
    assert "selective_scan_fused_bwd" in src


def test_rmsnorm_source_uses_no_atomics():
    """The same rule for the norm's backward: each block's ``dw`` sums leave
    it as one float32 partial row, and after a grid-wide sync the blocks
    fold the rows in block order."""
    src = (_build.CSRC / "rmsnorm.cu").read_text()
    assert "atomicAdd" not in src
    assert not re.search(r"\batomic[A-Z]\w*\s*\(", src)
    assert "rmsnorm_bwd" in src


#: (rows, d) of the norm backward's row split: the training paths' rows
#: (gpt-demo's (4, 256, 768), zamba2's gated (2, 512, 7168), gpt-1.1b's
#: pipeline (1, 512, 1920) and tensor-parallel (2, 512, 1920) rows,
#: qwen2-7b's (2, 512, 3584), falcon-mamba-7b's (2, 512, 4096), a
#: (64, 12288) row set) and ragged counts: one row, fewer rows than
#: blocks, one past a multiple of 128, not a multiple of the runs.
RMS_SPLIT_SHAPES = [(1024, 768), (1024, 7168), (512, 1920), (1024, 1920),
                    (1024, 3584), (1024, 4096), (64, 12288), (1, 32),
                    (7, 384), (127, 64), (128, 64), (129, 64), (300, 128),
                    (1000, 33), (100003, 16)]


@pytest.mark.parametrize("rows, d", RMS_SPLIT_SHAPES, ids=str)
def test_rmsnorm_bwd_row_split(rows, d, monkeypatch):
    """Every row in exactly one block's run, runs consecutive and in order,
    at most 128 blocks (one a row below that), and runs that differ by at
    most one row.  The split asks nothing of a card: with every device
    query refusing, it is the same."""
    runs = rn.bwd_runs(rows)
    blocks = len(runs)
    assert rn.BWD_MAX_BLOCKS == 128 and blocks == min(rows, 128)
    assert runs[0][0] == 0 and runs[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    lengths = [b - a for a, b in runs]
    assert min(lengths) >= 1 and max(lengths) - min(lengths) <= 1
    assert lengths == sorted(lengths, reverse=True)   # the longer runs first

    def refuse(*a, **k):
        raise AssertionError("the split asked the card")
    for name in ("device_count", "get_device_properties", "current_device"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    assert rn.bwd_runs(rows) == runs


@pytest.mark.parametrize("rows, d", [(1024, 768), (512, 1920), (7, 384),
                                     (129, 64), (1000, 33)], ids=str)
@pytest.mark.parametrize("with_ds", [False, True], ids=["plain", "ds_in"])
def test_rmsnorm_bwd_wrapper_hands_the_kernel_the_split(rows, d, with_ds,
                                                         monkeypatch):
    """``_rmsnorm_bwd_cuda`` hands the C entry point ``bwd_runs``' block
    count and a float32 workspace of one partial row of ``dw`` a block
    (the call is caught before it reaches the library)."""
    calls = []

    def catch(name, index, *args):
        calls.append((name, args))
    monkeypatch.setattr(rn, "launch", catch)
    monkeypatch.setattr(rn.rmsnorm, "bwd_launches", 0)
    monkeypatch.setattr(rn.rmsnorm, "shapes", rn.Counter())
    x, dy = torch.empty(rows, d), torch.empty(rows, d)
    ds = torch.empty(rows, d) if with_ds else None
    seen = {}
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        seen[t.data_ptr()] = t.numel()
        return t
    monkeypatch.setattr(rn.torch, "empty", empty)
    rn._rmsnorm_bwd_cuda(x, torch.ones(d), dy, 1e-5, ds, ("test",))
    assert [c[0] for c in calls] == ["rmsnorm_bwd"]
    args = calls[0][1]
    # (x, w, dy, ds, dx, dw, work, rows, d, eps, types, blocks)
    assert args[7:9] == (rows, d) and args[11] == len(rn.bwd_runs(rows))
    assert (args[3] is None) == (ds is None)
    assert seen[args[6]] == len(rn.bwd_runs(rows)) * d


#: Small cases for gradcheck, whose Jacobians take a forward pass per
#: input element: causal, a window, and rows with no allowed key (rows 4
#: to 7 of the last).  The plain versions take any head dim.
FA_GRADCHECK = [(1, 2, 1, 6, 6, 4, True, 0), (1, 2, 2, 7, 7, 4, True, 3),
                (1, 2, 1, 8, 3, 4, True, 2)]


@pytest.mark.parametrize("case", FA_GRADCHECK)
def test_flash_attention_function_passes_gradcheck_in_float64(case):
    *_, causal, window = case
    q, k, v, _ = _fa_inputs(case, 10, np.float64)
    args = tuple(torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.FlashAttentionFn.apply(a, b, c, causal, window),
        args)


# ---------------------------------------------------------------------------
# no CUDA wrapper drops a gradient
# ---------------------------------------------------------------------------

MODULES = (rn, fa, ss, gr)
#: The public wrappers and what their CUDA branch does for an input that
#: requires a gradient: go through an autograd Function, or refuse.
GUARDED = {"rmsnorm": "RMSNormFn.apply", "add_rmsnorm": "AddRMSNormFn.apply",
           "flash_attention": "FlashAttentionFn.apply",
           "selective_scan": "refuse_grad", "selective_scan_fused":
           "SelectiveScanFusedFn.apply", "group_min_scale": "refuse_grad",
           "group_min_scale_gather": "refuse_grad",
           "group_max": "refuse_grad", "group_max_gather": "refuse_grad"}


def _functions(mod):
    tree = ast.parse(textwrap.dedent(inspect.getsource(mod)))
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


def _calls(node) -> set:
    return {ast.unparse(c.func) for c in ast.walk(node)
            if isinstance(c, ast.Call)}


def _launches(node) -> bool:
    return any(name in ("launch", "_launch") for name in _calls(node))


def test_every_launch_is_behind_a_function_or_a_refusal():
    """By source: every function of the kernel modules that launches a
    kernel is either a public wrapper whose CUDA branch checks for a
    gradient before the launch (and then builds its Function or refuses),
    or a private helper called only by such wrappers and by Functions."""
    seen = set()
    for mod in MODULES:
        defs = _functions(mod)
        for name, node in defs.items():
            if isinstance(node, ast.ClassDef) or not _launches(node) \
                    and not any(c.startswith("_") and c.endswith("_cuda")
                                for c in _calls(node)):
                continue
            if name in GUARDED:
                seen.add(name)
                src = ast.unparse(node)
                guard = src.find(GUARDED[name])
                first = min(i for i in (src.find("launch("),
                                        src.find("_cuda(")) if i >= 0)
                assert 0 <= guard < first, (mod.__name__, name)
                continue
            assert name.startswith("_"), (mod.__name__, name)
            callers = [n for n, d in defs.items() if n != name and
                       any(c.split(".")[-1] == name for c in _calls(d))]
            assert callers, (mod.__name__, name)
            for c in callers:
                ok = c in GUARDED or (isinstance(defs[c], ast.ClassDef)
                                      and c.endswith("Fn")) \
                    or c in ("_bwd",)
                assert ok, (mod.__name__, name, c)
    assert seen == set(GUARDED)


def test_refusal_names_the_roadmap_item():
    """What the scan still refuses on the card under a gradient — the
    decode step, a state written into ``h_out``, the plain form — names
    its ROADMAP entry; the refusal checks grad mode and the tensors."""
    x = torch.ones(2, requires_grad=True)
    with pytest.raises(NotImplementedError, match="Queue A 10c"):
        _build.refuse_grad("selective_scan_fused (decode step or h_out)",
                           ss.NO_BACKWARD, None, x)
    with pytest.raises(NotImplementedError, match="decode step"):
        _build.refuse_grad("selective_scan", ss.NO_BACKWARD, x)
    _build.refuse_grad("selective_scan_fused", ss.NO_BACKWARD, x.detach())
    with torch.no_grad():
        _build.refuse_grad("selective_scan_fused", ss.NO_BACKWARD, x)


def test_fused_scan_refuses_only_the_step_and_h_out_under_a_gradient():
    """By source: the fused wrapper's CUDA branch refuses a gradient for
    the step form and ``h_out`` and hands every other input that requires
    one to ``SelectiveScanFusedFn``; the plain form refuses it outright."""
    defs = _functions(ss)
    fused = ast.unparse(defs["selective_scan_fused"])
    refuse = fused.find("refuse_grad(")
    assert 0 <= fused.find("if step or h_out is not None:") < refuse \
        < fused.find("SelectiveScanFusedFn.apply(") < fused.find(
            "_fused_fwd_cuda(")
    plain = ast.unparse(defs["selective_scan"])
    assert 0 <= plain.find("refuse_grad(") < plain.find("launch(")


def test_plain_paths_differentiate_on_the_host():
    """On the CPU every wrapper takes its plain version, which autograd
    differentiates: the fused scan included."""
    rng = _rng(3)
    b, s, d, n = 1, 5, 8, 4

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * scale).requires_grad_()

    x, dt, z = t(b, s, d), t(b, s, d, scale=0.5), t(b, s, d)
    B, C = t(b, s, n), t(b, s, n)
    A_log, D, bias = t(d, n, scale=0.1), t(d), t(d)
    out, h = ss.selective_scan_fused(x, dt, bias, B, C, A_log, D, z)
    (out.sum() + h.sum()).backward()
    for p in (x, dt, z, B, C, A_log, D, bias):
        assert p.grad is not None and bool(torch.isfinite(p.grad).all())

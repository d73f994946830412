"""The float32 attention kernels as the CPU can see them.

The kernels themselves (``csrc/flash_attention.cu``: ``flash_fwd_f32_tiled``,
``bwd_delta_f32``, ``bwd_dkv_dq_f32`` and the fold's float32 instance) run
only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).  Here:

- the backward wrapper's launch, with the library replaced by a recorder:
  a float32 ``(2, B, H, Sk, D)`` workspace goes to the kernel whenever a KV
  group has more than one query head, in float32 as in bfloat16, and none
  when it has one;
- the source: the old CUDA-core kernels are gone, nothing switches back
  to them, and no atomic sum is used;
- ``FlashAttentionFn`` in float32 (the plain versions on the CPU) against
  the JAX package's ``kernels/ref.py::attention_ref`` and its Pallas
  ``flash_attention`` in interpret mode, forward, and against ``jax.vjp``
  of ``attention_ref``, backward, at reduced forms of the training paths'
  shapes: head dim 64, causal, MHA (gpt-demo) and a group of 3 query heads
  per KV head (granite's tensor-parallel slice), and one with a window.
  The JAX functions take no query offset; the offset is held to the port's
  plain versions in ``tests/test_torch_gpu.py``.

Tolerance: 2e-5 of the largest magnitude, forward and backward (float32
sums in another order on the two sides).
"""
import re

import jax
import numpy as np
import pytest
import torch

from repro.kernels import ref as kref
from repro.kernels.flash_attention import flash_attention as pallas_fa
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa

TOL = 2e-5
#: (b, h, kv, sq, sk, d, causal, window): reduced gpt-demo (MHA), reduced
#: granite slice (3 query heads a KV head), and the slice with a window.
CASES = [(2, 4, 4, 128, 128, 64, True, 0), (1, 6, 2, 128, 128, 64, True, 0),
         (1, 6, 2, 128, 128, 64, True, 48)]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs several workers side by side; keep each fit to two
    intra-op threads instead of one per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(case, seed):
    b, h, kv, sq, sk, d, _, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, sq, d), (b, kv, sk, d), (b, kv, sk, d),
                      (b, h, sq, d))]


def _close(got, want, tol=TOL):
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


# ---------------------------------------------------------------------------
# the backward wrapper's launch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h,kv", [(6, 2), (4, 4), (7, 1)])
def test_backward_hands_the_kernel_a_workspace_per_query_head(dtype, h, kv,
                                                              monkeypatch):
    """With ``h > kv`` the launch gets a float32 ``(2, B, H, Sk, D)``
    workspace (each query head's partial dK and dV), in either type; with
    one head a group it gets none.  The launch is counted as one backward
    under the shape key led by ``"bwd"``."""
    b, sq, sk, d = 2, 40, 24, 64
    calls, works = [], []
    monkeypatch.setattr(fa, "launch",
                        lambda name, index, *a: calls.append((name, a)))
    real = fa._bwd_workspace

    def record(q, k):
        works.append(real(q, k))
        return works[-1]

    monkeypatch.setattr(fa, "_bwd_workspace", record)
    monkeypatch.setattr(fa.flash_attention, "bwd_launches", 0)
    monkeypatch.setattr(fa.flash_attention, "shapes",
                        type(fa.flash_attention.shapes)())
    q = torch.zeros((b, h, sq, d), dtype=dtype)
    k = torch.zeros((b, kv, sk, d), dtype=dtype)
    lse = torch.zeros((b, h, sq))
    dq, dk, dv = fa._bwd_cuda(q, k, k.clone(), q.clone(), lse, q.clone(),
                              True, 0)
    [(name, a)] = calls
    assert name == "flash_attention_bwd"
    [work] = works
    if h > kv:
        assert work.shape == (2, b, h, sk, d)
        assert work.dtype == torch.float32 and work.is_contiguous()
        assert a[7] == work.data_ptr()
    else:
        assert work is None and a[7] is None
    assert a[-1] == (dtype == torch.bfloat16)
    assert a[-11:-8] == (b, h, kv) and a[-8:-5] == (sq, sk, d)
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    assert fa.flash_attention.bwd_launches == 1
    assert dict(fa.flash_attention.shapes) == {
        ("bwd", (b, h, sq, d), (b, kv, sk, d), True, 0, str(dtype)): 1}


def test_float32_forward_takes_rows_off_16_bytes(monkeypatch):
    """A float32 view one float into its storage reaches the forward's
    launch as it is (the kernel picks 4-byte copies), where bfloat16 is
    refused."""
    calls = []
    monkeypatch.setattr(fa, "launch",
                        lambda name, index, *a: calls.append((name, a)))
    monkeypatch.setattr(fa.flash_attention, "launches", 0)
    flat = torch.zeros(1 * 2 * 16 * 32 + 1)
    view = flat[1:].view(1, 2, 16, 32)
    assert view.data_ptr() % 16 == 4
    out = fa._fwd_cuda(view, view, view, True, 0, None)
    [(name, a)] = calls
    assert name == "flash_attention_fwd" and a[0] == view.data_ptr()
    assert a[3] == out.data_ptr() and a[-1] == 0
    with pytest.raises(ValueError, match="pointer"):
        fa._check_kernel(*(view.bfloat16()[..., 1:17],) * 3, 0)


# ---------------------------------------------------------------------------
# the source
# ---------------------------------------------------------------------------

def _source() -> str:
    return (_build.CSRC / "flash_attention.cu").read_text()


@pytest.mark.parametrize("name", ["flash_fwd_f32", "bwd_dq", "bwd_dkv",
                                  "bwd_delta"])
def test_the_old_cuda_core_kernels_are_gone(name):
    """PR 12's forward and PR 17's three backward passes are not defined
    (nor named) anywhere in the source any more."""
    assert not re.search(rf"\b{name}\b", _source()), name


@pytest.mark.parametrize("name", ["flash_fwd_f32_tiled", "bwd_delta_f32",
                                  "bwd_dkv_dq_f32"])
def test_the_float32_path_launches_the_tiled_kernels(name):
    """Each new float32 kernel is defined and launched (``<<<``) by the
    float32 launchers that the C entries call; the backward's dK/dV and dQ
    items run in its one kernel."""
    src = _source()
    assert re.search(rf"\n{name}\(", src), name
    assert re.search(rf"{name}<[^>]*(<[^>]*>[^>]*)?><<<", src), name
    assert "f32::launch_fwd<" in src and "f32::launch_bwd<" in src
    assert "dkv_item<D>(" in src and "dq_item<D>(" in src


def test_no_switch_back_and_no_atomics():
    """Nothing picks between old and new float32 kernels: no environment
    read, no flag argument in the C entries or the wrapper; and no atomic
    sum anywhere (two launches give the same bits)."""
    src = _source()
    assert "getenv" not in src and "atomicAdd" not in src
    assert not re.search(r"\batomic[A-Z]\w*\s*\(", src)
    py = open(fa.__file__).read()
    assert "environ" not in py and "getenv" not in py
    # the C entries take one type flag (bf16) and nothing else of the kind
    for entry in ("flash_attention_fwd", "flash_attention_bwd"):
        sig = re.search(rf"int {entry}\((.*?)\)\s*{{", src, re.S).group(1)
        flags = [p.split()[-1] for p in sig.split(",")
                 if p.split()[0] == "int"]
        assert flags == ["batch", "heads", "kv_heads", "head_dim", "causal",
                         "bf16"], flags


# ---------------------------------------------------------------------------
# the Function in float32 against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=str)
def test_function_forward_matches_attention_ref_and_pallas(case):
    """Forward of ``FlashAttentionFn`` (float32, on the CPU its plain
    version) against ``attention_ref`` and the Pallas kernel in interpret
    mode."""
    *_, causal, window = case
    q, k, v, _ = _inputs(case, sum(case[:6]))
    got = fa.FlashAttentionFn.apply(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal, window)
    assert got.dtype == torch.float32
    _close(got, kref.attention_ref(q, k, v, causal=causal, window=window))
    _close(got, pallas_fa(q, k, v, causal=causal, window=window,
                          block_q=64, block_k=32, interpret=True))


@pytest.mark.parametrize("case", CASES, ids=str)
def test_function_gradients_match_jax_vjp(case):
    """``FlashAttentionFn``'s dq, dk, dv (float32) against ``jax.vjp`` of
    ``attention_ref``; every row of these cases sees at least its own key,
    so the two agree on every row."""
    *_, causal, window = case
    q, k, v, do = _inputs(case, sum(case[:6]) + 1)
    _, vjp = jax.vjp(lambda a, b, c: kref.attention_ref(
        a, b, c, causal=causal, window=window), q, k, v)
    want = vjp(do)
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.FlashAttentionFn.apply(*ins, causal, window)
    out.backward(torch.from_numpy(do))
    for t, w in zip(ins, want):
        assert t.grad.dtype == torch.float32
        _close(t.grad, w)

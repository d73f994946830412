"""``chunked_attention`` of the PyTorch package against the JAX package's.

The ports of the reference's gates for it: ``tests/test_attention_extra.py``
(``test_chunked_attention_matches_reference`` — there a hypothesis search
over the sequence length, KV heads, group size and chunk, here every
point of that space —, ``test_q_offset_matches_suffix_of_full``,
``test_empty_window_rows_are_zero``) and ``tests/test_models.py::
test_sliding_window_matches_reference``, each at the reference test's
tolerance (3e-5, 3e-5, 1e-6, 2e-5), on the same NumPy inputs made from a
seed.  The port is also held to the reference's ``chunked_attention``
itself (2e-6: float32 sums in another order).  It runs on the CPU here;
``chip_smoke.py`` holds the card's ``flash_attention`` kernel to it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro_torch.models import attention as attn


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _qkv(b, sq, sk, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, sk, kv, hd)).astype(np.float32),
            rng.standard_normal((b, sk, kv, hd)).astype(np.float32))


def _both(q, k, v, **kw):
    got = attn.chunked_attention(_t(q), _t(k), _t(v), **kw).numpy()
    want = np.asarray(ref_attn.chunked_attention(q, k, v, **kw))
    return got, want


SPACE = [(sq, kv, g, cq) for sq in (32, 48, 64) for kv in (1, 2, 4)
         for g in (1, 2) for cq in (8, 16, 32)]


@pytest.mark.parametrize("sq,kv,g,cq", SPACE)
def test_chunked_attention_matches_reference(sq, kv, g, cq):
    h, hd, b = kv * g, 16, 2
    q, k, v = _qkv(b, sq, sq, h, kv, hd, sq * 100 + kv * 10 + g)
    got, want = _both(q, k, v, chunk_q=cq, chunk_k=cq)
    oracle = attn.reference_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, oracle, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def test_q_offset_matches_suffix_of_full():
    """A query suffix at ``q_offset`` equals the suffix of the full
    computation (continuation semantics)."""
    q, k, v = _qkv(1, 64, 64, 4, 2, 16, 1)
    full = attn.chunked_attention(_t(q), _t(k), _t(v), chunk_q=16,
                                  chunk_k=16)
    tail, want = _both(q[:, 48:], k, v, q_offset=48, chunk_q=16, chunk_k=16)
    np.testing.assert_allclose(tail, full[:, 48:].numpy(), rtol=3e-5,
                               atol=3e-5)
    np.testing.assert_allclose(tail, want, rtol=2e-6, atol=2e-6)


def test_empty_window_rows_are_zero():
    """Rows whose mask excludes every key come out exactly zero, not
    NaN."""
    q, k, v = _qkv(1, 16, 16, 2, 2, 8, 2)
    got, want = _both(q, k, v, causal=True, q_offset=-4, chunk_q=8,
                      chunk_k=8)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:, :4], 0.0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("window", [0, 8, 17])
def test_sliding_window_matches_reference(window):
    q, k, v = _qkv(2, 64, 64, 4, 2, 16, 3)
    got, want = _both(q, k, v, causal=True, window=window, chunk_q=16,
                      chunk_k=16)
    oracle = attn.reference_attention(_t(q), _t(k), _t(v), causal=True,
                                      window=window).numpy()
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("min_q_blocks", [1, 3, 4])
def test_min_q_blocks_changes_only_the_chunking(min_q_blocks, causal):
    """``min_q_blocks`` lowers the q chunk until it divides the block
    count; the result is the same function, and equals the reference's at
    the same chunking (keys of another length than the queries)."""
    q, k, v = _qkv(2, 48, 40, 4, 2, 16, 4)
    got, want = _both(q, k, v, causal=causal, chunk_q=32, chunk_k=16,
                      min_q_blocks=min_q_blocks)
    plain, _ = _both(q, k, v, causal=causal, chunk_q=48, chunk_k=40)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got, plain, rtol=3e-5, atol=3e-5)


def test_bfloat16_inputs_come_back_in_bfloat16():
    """The sums run in float32 (``q`` scaled before the product); the
    output takes ``q``'s type, as the reference's."""
    q, k, v = _qkv(1, 32, 32, 4, 2, 16, 5)
    qb, kb, vb = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (q, k, v))
    to_t = (lambda a: torch.from_numpy(a.view(np.int16).copy())
            .view(torch.bfloat16))
    got = attn.chunked_attention(to_t(qb), to_t(kb), to_t(vb), chunk_q=8,
                                 chunk_k=8)
    want = np.asarray(ref_attn.chunked_attention(qb, kb, vb, chunk_q=8,
                                                 chunk_k=8), np.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -8 * float(np.abs(want).max()))


def test_block_constrain_is_refused_naming_the_roadmap_item():
    """The reference's q-block hook is no longer refused: it is called
    where the reference calls it — on the scaled query blocks ``(b, nq,
    cq, KV, G, hd)`` and on the output blocks ``(b, nq, KV, G, cq, hd)``,
    the q-block dim 1 — and a layout-only hook leaves the result as it
    is."""
    q, k, v = map(_t, _qkv(1, 16, 16, 2, 2, 8, 6))
    seen = []

    def hook(t, dim):
        seen.append((tuple(t.shape), dim))
        return t

    got = attn.chunked_attention(q, k, v, chunk_q=4, chunk_k=8,
                                 min_q_blocks=2, block_constrain=hook)
    assert seen == [((1, 4, 4, 2, 1, 8), 1), ((1, 4, 2, 1, 4, 8), 1)]
    want = attn.chunked_attention(q, k, v, chunk_q=4, chunk_k=8,
                                  min_q_blocks=2)
    assert torch.equal(got, want)

"""Group-reduce kernels of the PyTorch package against the JAX package's.

The plain PyTorch versions are held bit-equal (float64) to the JAX
package's ``*_ref`` functions and to its Pallas kernels run in interpret
mode, on the same NumPy inputs.  The CUDA kernels themselves can only run
on a card: their tests (``tests/test_torch_gpu.py``) carry the ``gpu``
marker and skip without one.
float64 on the JAX side comes from the scoped ``jax.enable_x64`` — never a
global flag, which would leak into the float32 model tests of the same
worker process.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import group_reduce as ref_gr
from repro_torch.kernels import group_reduce as gr

MIN_SCALE_SHAPES = [(1, 2), (7, 4), (128, 8), (130, 2)]
MAX_SHAPES = [(1, 3), (9, 16), (128, 4), (257, 8)]


def _random_sub(rng, n, m):
    sub = rng.uniform(0.5, 300.0, size=(n, m, m)) * 1e9
    di = np.arange(m)
    sub[:, di, di] = np.inf                     # self links masked upstream
    sub[rng.integers(n), 0, min(1, m - 1)] = 0.0  # degenerate link
    return sub


@pytest.mark.parametrize("n,m", MIN_SCALE_SHAPES)
def test_group_min_scale_plain_bit_equal_to_jax(n, m):
    sub = _random_sub(np.random.default_rng(n * 31 + m), n, m)
    if n > 2:
        sub[1] = np.inf                          # an all-inf group -> 1.0
    with jax.enable_x64(True):
        want_ref = np.asarray(ref_gr.group_min_scale_ref(jnp.asarray(sub),
                                                         25e9))
        want_pal = np.asarray(ref_gr.group_min_scale(jnp.asarray(sub), 25e9,
                                                     interpret=True))
    assert want_ref.dtype == np.float64
    got_plain = gr.group_min_scale_ref(torch.from_numpy(sub), 25e9).numpy()
    got_wrap = gr.group_min_scale(torch.from_numpy(sub), 25e9).numpy()
    assert got_plain.shape == (n,)
    for got in (got_plain, got_wrap):
        assert got.tobytes() == want_ref.tobytes()
        assert got.tobytes() == want_pal.tobytes()


@pytest.mark.parametrize("n,m", MAX_SHAPES)
def test_group_max_plain_bit_equal_to_jax(n, m):
    vals = np.random.default_rng(n * 17 + m).uniform(1.0, 3.0, size=(n, m))
    with jax.enable_x64(True):
        want_ref = np.asarray(ref_gr.group_max_ref(jnp.asarray(vals)))
        want_pal = np.asarray(ref_gr.group_max(jnp.asarray(vals),
                                               interpret=True))
    got_plain = gr.group_max_ref(torch.from_numpy(vals)).numpy()
    got_wrap = gr.group_max(torch.from_numpy(vals)).numpy()
    for got in (got_plain, got_wrap):
        assert got.tobytes() == want_ref.tobytes()
        assert got.tobytes() == want_pal.tobytes()


def test_leading_batch_axes_flatten_to_groups():
    rng = np.random.default_rng(3)
    sub = torch.from_numpy(_random_sub(rng, 24, 4)).reshape(2, 3, 4, 4, 4)
    out = gr.group_min_scale(sub, 25e9)
    assert out.shape == (2, 3, 4)
    flat = gr.group_min_scale_ref(sub.reshape(24, 4, 4), 25e9)
    assert torch.equal(out.reshape(-1), flat)
    vals = torch.from_numpy(rng.uniform(1.0, 3.0, size=(2, 5, 7)))
    assert gr.group_max(vals).shape == (2, 5)
    assert torch.equal(gr.group_max(vals).reshape(-1),
                       gr.group_max_ref(vals.reshape(10, 7)))


def test_cpu_calls_do_not_count_as_launches():
    before = (gr.group_min_scale.launches, gr.group_max.launches)
    gr.group_min_scale(torch.ones(3, 2, 2, dtype=torch.float64), 1.0)
    gr.group_max(torch.ones(3, 2, dtype=torch.float64))
    assert (gr.group_min_scale.launches, gr.group_max.launches) == before


@pytest.mark.parametrize("bad,err", [
    (lambda: gr.group_min_scale(torch.ones(3, 2, 2, dtype=torch.float16),
                                1.0), TypeError),
    (lambda: gr.group_min_scale(torch.ones(3, 2, 2, dtype=torch.int64),
                                1.0), TypeError),
    (lambda: gr.group_min_scale(torch.ones(3, 2, 3, dtype=torch.float64),
                                1.0), ValueError),
    (lambda: gr.group_min_scale(torch.ones(2, 2, dtype=torch.float64),
                                1.0), ValueError),
    (lambda: gr.group_min_scale(
        torch.ones(3, 2, 4, dtype=torch.float64)[:, :, ::2], 1.0),
     ValueError),
    (lambda: gr.group_min_scale(np.ones((3, 2, 2)), 1.0), TypeError),
    (lambda: gr.group_max(torch.ones(3, 2, dtype=torch.bfloat16)),
     TypeError),
    (lambda: gr.group_max(torch.ones(3, dtype=torch.float64)), ValueError),
    (lambda: gr.group_max(torch.ones(3, 0, dtype=torch.float64)),
     ValueError),
    (lambda: gr.group_max(torch.ones(4, 6, dtype=torch.float64).T),
     ValueError),
], ids=["min-f16", "min-int", "min-not-square", "min-2d", "min-strided",
        "min-ndarray", "max-bf16", "max-1d", "max-empty-axis",
        "max-transposed"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad, err):
    with pytest.raises(err):
        bad()

"""Group-reduce kernels of the PyTorch package against the JAX package's.

The plain PyTorch versions are held bit-equal (float64) to the JAX
package's ``*_ref`` functions and to its Pallas kernels run in interpret
mode, on the same NumPy inputs; the gather forms to the engine's sequence
of gather, JAX reduce and the folds around it.  The CUDA kernels themselves can only run
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


# ---------------------------------------------------------------------------
# the gather form: groups read through the permutation, folded per row
# ---------------------------------------------------------------------------

#: (name, tp, cp, n): TP groups, CP groups with tp = 1, and CP groups whose
#: members sit tp apart (cp > 1 and tp > 1), as the engine forms them.
GEOMETRIES = [("tp", 4, 1, 32), ("tp8", 8, 1, 64), ("cp", 1, 4, 32),
              ("cp-tp", 4, 2, 32), ("cp4-tp2", 2, 4, 48)]


def _table(rng, n):
    """A ``bw_noself``-like table: self links inf, one degenerate link."""
    t = rng.uniform(0.5, 300.0, size=(n, n)) * 1e9
    np.fill_diagonal(t, np.inf)
    t[0, 1] = 0.0
    return t


def _members(perm, tp, cp, scale):
    """The engine's groups of each row, by its own reshapes (NumPy)."""
    b = perm.shape[0]
    if scale == "tp":
        return perm.reshape(b, -1, tp)
    return perm.reshape(b, -1, cp, tp).transpose(0, 1, 3, 2) \
        .reshape(b, -1, cp)


@pytest.mark.parametrize("ref_bw", [25e9, 1e8], ids=["scaled", "clamped"])
@pytest.mark.parametrize("name,tp,cp,n", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_gather_form_plain_bit_equal_to_jax(name, tp, cp, n, ref_bw):
    rng = np.random.default_rng(n * 7 + tp + 3 * cp)
    table = _table(rng, n)
    perm = np.stack([rng.permutation(n) for _ in range(5)])
    scale = "cp" if cp > 1 else "tp"
    g = _members(perm, tp, cp, scale)
    sub = table[g[:, :, :, None], g[:, :, None, :]]
    with jax.enable_x64(True):
        per_group = ref_gr.group_min_scale_ref(
            jnp.asarray(sub.reshape(-1, *sub.shape[2:])), ref_bw)
        want = np.asarray(jnp.maximum(
            1.0, per_group.reshape(sub.shape[:2]).max(axis=1)))
    assert want.dtype == np.float64
    geom = gr.tp_geometry(tp) if scale == "tp" else gr.cp_geometry(tp, cp)
    tt, pt = torch.from_numpy(table), torch.from_numpy(perm)
    got_plain = gr.group_min_scale_gather_ref(tt, pt, ref_bw, *geom).numpy()
    got_wrap = gr.group_min_scale_gather(tt, pt, ref_bw, *geom).numpy()
    assert got_plain.shape == (5,)
    for got in (got_plain, got_wrap):
        assert got.tobytes() == want.tobytes()
    if ref_bw == 1e8:
        assert (got_plain == 1.0).all()
    else:
        assert (got_plain > 1.0).all()


@pytest.mark.parametrize("name,tp,cp,n", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_group_positions_replay_the_engines_reshapes(name, tp, cp, n):
    perm = np.stack([np.random.default_rng(s).permutation(n)
                     for s in range(3)])
    scale = "cp" if cp > 1 else "tp"
    geom = gr.tp_geometry(tp) if scale == "tp" else gr.cp_geometry(tp, cp)
    pos = gr.group_positions(n, *geom).numpy()
    assert (perm[:, pos] == _members(perm, tp, cp, scale)).all()


def test_gather_form_cpu_calls_do_not_count_as_launches():
    before = (gr.group_min_scale.launches, dict(gr.group_min_scale.shapes))
    table = torch.from_numpy(_table(np.random.default_rng(1), 8))
    gr.group_min_scale_gather(table, torch.arange(8)[None], 1e9,
                              *gr.tp_geometry(2))
    assert (gr.group_min_scale.launches,
            dict(gr.group_min_scale.shapes)) == before


_T8 = torch.ones(8, 8, dtype=torch.float64)
_P8 = torch.arange(8)[None]


@pytest.mark.parametrize("bad,err", [
    (lambda: gr.group_min_scale_gather(_T8.half(), _P8, 1.0, 2, 1, 2, 1),
     TypeError),
    (lambda: gr.group_min_scale_gather(_T8, _P8.int(), 1.0, 2, 1, 2, 1),
     TypeError),
    (lambda: gr.group_min_scale_gather(_T8[:, :4], _P8, 1.0, 2, 1, 2, 1),
     ValueError),
    (lambda: gr.group_min_scale_gather(_T8, _P8[0], 1.0, 2, 1, 2, 1),
     ValueError),
    (lambda: gr.group_min_scale_gather(_T8, _P8, 1.0, 3, 1, 3, 1),
     ValueError),
    (lambda: gr.group_min_scale_gather(_T8, _P8, 1.0, 2, 2, 4, 3),
     ValueError),
    (lambda: gr.group_min_scale_gather(_T8, _P8.repeat(2, 2)[:, ::2], 1.0,
                                       2, 1, 2, 1), ValueError),
    (lambda: gr.group_min_scale_gather(_T8.numpy(), _P8, 1.0, 2, 1, 2, 1),
     TypeError),
], ids=["f16-table", "int32-perm", "table-not-square", "perm-1d",
        "m-not-dividing", "group-past-row", "perm-strided", "ndarray"])
def test_gather_form_refuses_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        bad()


# ---------------------------------------------------------------------------
# group_max, gather form: stage members read through the permutation
# ---------------------------------------------------------------------------

#: (B, pp, nc): the row-max shapes above as (B * pp, nc), with the stages
#: of one permutation row split as a tiered score splits them.
MAX_GATHER_CASES = [(1, 1, 3), (3, 3, 16), (16, 8, 4), (257, 1, 8)]


def _max_gather_inputs(b, pp, nc):
    rng = np.random.default_rng(b * 131 + pp * 7 + nc)
    n = pp * nc
    slow = rng.uniform(1.0, 3.0, size=n)
    slow[rng.integers(n)] = 1.0                  # ties with the fast tier
    perm = np.stack([rng.permutation(n) for _ in range(b)])
    cw = rng.uniform(0.5, 2.0, size=(b, pp)) * 1e-3
    return slow, perm, cw


@pytest.mark.parametrize("b,pp,nc", MAX_GATHER_CASES, ids=str)
def test_group_max_gather_plain_bit_equal_to_jax(b, pp, nc):
    slow, perm, cw = _max_gather_inputs(b, pp, nc)
    with jax.enable_x64(True):
        sv = ref_gr.group_max_ref(jnp.asarray(slow)[perm.reshape(b * pp,
                                                                   nc)])
        c_x_want = jnp.asarray(cw) * sv.reshape(b, pp)
        want = (np.asarray(c_x_want), np.asarray(c_x_want.max(axis=1)))
    assert want[0].dtype == np.float64
    args = (torch.from_numpy(slow), torch.from_numpy(perm),
            torch.from_numpy(cw), nc)
    got_plain = gr.group_max_gather_ref(*args)
    got_wrap = gr.group_max_gather(*args)           # CPU: the plain version
    assert got_plain[0].shape == (b, pp) and got_plain[1].shape == (b,)
    for got in (got_plain, got_wrap):
        for g, w in zip(got, want):
            assert g.numpy().tobytes() == w.tobytes()


def test_group_max_gather_plain_bit_equal_to_pallas_interpret():
    b, pp, nc = 9, 4, 16
    slow, perm, cw = _max_gather_inputs(b, pp, nc)
    with jax.enable_x64(True):
        sv = ref_gr.group_max(jnp.asarray(slow)[perm.reshape(b * pp, nc)],
                              interpret=True)
        c_x_want = np.asarray(jnp.asarray(cw) * sv.reshape(b, pp))
    c_x, c_max = gr.group_max_gather_ref(torch.from_numpy(slow),
                                         torch.from_numpy(perm),
                                         torch.from_numpy(cw), nc)
    assert c_x.numpy().tobytes() == c_x_want.tobytes()
    assert c_max.numpy().tobytes() == c_x_want.max(axis=1).tobytes()


def test_group_max_gather_cpu_calls_do_not_count_as_launches():
    before = (gr.group_max.launches, dict(gr.group_max.shapes))
    slow, perm, cw = (torch.from_numpy(a) for a in _max_gather_inputs(2, 2,
                                                                        3))
    gr.group_max_gather(slow, perm, cw, 3)
    assert (gr.group_max.launches, dict(gr.group_max.shapes)) == before


_S6 = torch.ones(6, dtype=torch.float64)
_PM6 = torch.arange(6)[None]
_CW2 = torch.ones(1, 2, dtype=torch.float64)


@pytest.mark.parametrize("bad,err", [
    (lambda: gr.group_max_gather(_S6, _PM6, _CW2.float(), 3), TypeError),
    (lambda: gr.group_max_gather(_S6.half(), _PM6, _CW2.half(), 3),
     TypeError),
    (lambda: gr.group_max_gather(_S6, _PM6.int(), _CW2, 3), TypeError),
    (lambda: gr.group_max_gather(_S6.numpy(), _PM6, _CW2, 3), TypeError),
    (lambda: gr.group_max_gather(_S6, _PM6, _CW2, 2), ValueError),
    (lambda: gr.group_max_gather(_S6, _PM6.repeat(2, 1), _CW2, 3),
     ValueError),
    (lambda: gr.group_max_gather(_S6, _PM6[0], _CW2, 3), ValueError),
    (lambda: gr.group_max_gather(_S6, _PM6, _CW2, 0), ValueError),
    (lambda: gr.group_max_gather(_S6, _PM6.repeat(1, 2)[:, ::2], _CW2, 3),
     ValueError),
    (lambda: gr.group_max_gather(_S6, _PM6, _CW2.repeat(1, 2)[:, ::2], 3),
     ValueError),
], ids=["mixed-types", "f16", "int32-perm", "ndarray", "nc-not-tiling",
        "cw-rows", "perm-1d", "nc-0", "perm-strided", "cw-strided"])
def test_group_max_gather_refuses_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        bad()

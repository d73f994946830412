"""The MoE layer of the PyTorch package against the JAX package's.

``router_topk``, ``_capacity``, ``moe_apply_local`` (both dispatch forms,
both combine forms) and ``moe_block`` of ``repro_torch.models.moe`` are
held to ``repro.models.moe`` on the same NumPy inputs: the reference's
dense-oracle test (``tests/test_models.py::test_moe_matches_dense_oracle``,
rtol = atol = 2e-4) and its capacity test, where the port must drop the
same (token, rank) assignments as the reference; then gradients against
``jax.vjp`` and the top-k tie order of ``jax.lax.top_k``.  Everything runs
on the CPU.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import silu
from repro_torch.models.sharding import ShardCtx
from repro_torch.models.transformer import moe_mlp

FORMS = list(itertools.product([False, True], [True, False]))
FORM_IDS = [f"{'gather' if g else 'scatter'}-{'f32' if c else 'einsum'}"
            for g, c in FORMS]


def _weights(seed, t, d, f, e, scaled=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    router = rng.standard_normal((d, e)).astype(np.float32)
    wg = rng.standard_normal((e, d, f)).astype(np.float32)
    wu = rng.standard_normal((e, d, f)).astype(np.float32)
    wd = rng.standard_normal((e, f, d)).astype(np.float32)
    if scaled:
        wg, wu, wd = (a / np.float32(np.sqrt(n))
                      for a, n in ((wg, d), (wu, d), (wd, f)))
    return x, router, wg, wu, wd


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _both(arrays, k, e, cf, gather, f32, offset=0):
    kw = dict(k=k, n_experts=e, expert_offset=offset, capacity_factor=cf,
              f32_combine=f32, gather_dispatch=gather)
    want = np.asarray(ref_moe.moe_apply_local(*arrays, **kw))
    got = moe.moe_apply_local(*map(_t, arrays), **kw)
    return got, want


def _expert_rows(x, ids, wg, wu, wd):
    """Each (token, rank)'s expert output, ``(T, k, d)`` in float64."""
    x, wg, wu, wd = (np.asarray(a, np.float64) for a in (x, wg, wu, wd))
    out = np.zeros(ids.shape + (x.shape[1],))
    for t, r in np.ndindex(*ids.shape):
        e = ids[t, r]
        h = x[t] @ wg[e]
        out[t, r] = (h / (1 + np.exp(-h)) * (x[t] @ wu[e])) @ wd[e]
    return out


def _kept(y, rows, gates):
    """Which of each token's k assignments the output ``y`` sums: the
    subset whose gate-weighted expert rows are nearest ``y[t]``."""
    t, k, _ = rows.shape
    subsets = list(itertools.product([False, True], repeat=k))
    kept = set()
    for ti in range(t):
        errs = [np.abs(y[ti] - sum((gates[ti, r] * rows[ti, r]
                                    for r in range(k) if s[r]),
                                   np.zeros(rows.shape[-1]))).max()
                for s in subsets]
        best = int(np.argmin(errs))
        assert sorted(errs)[1] > 100 * errs[best], (ti, errs)
        kept |= {(ti, r) for r in range(k) if subsets[best][r]}
    return kept


@pytest.mark.parametrize("gather,f32", FORMS, ids=FORM_IDS)
def test_moe_matches_dense_oracle(gather, f32):
    """No drops (capacity factor E): exactly the gate-weighted sum of the
    top-k experts, as the reference's own test asserts, and equal to the
    reference's output on the same inputs."""
    t, d, f, e, k = 24, 16, 32, 8, 2
    arrays = _weights(0, t, d, f, e)
    got, want = _both(arrays, k, e, float(e), gather, f32)
    x, router, wg, wu, wd = arrays
    ids, gates = moe.router_topk(_t(x), _t(router), k)
    ids_r, gates_r = ref_moe.router_topk(x, router, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_r))
    np.testing.assert_allclose(gates.numpy(), np.asarray(gates_r),
                               rtol=1e-6, atol=1e-6)
    oracle = (_expert_rows(x, ids.numpy(), wg, wu, wd)
              * gates.numpy()[..., None].astype(np.float64)).sum(1)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("gather,f32", FORMS, ids=FORM_IDS)
def test_moe_capacity_drops_tokens(gather, f32):
    """Capacity factor 0.2 (capacity 7 of 32 assignments an expert): the
    output shrinks, as the reference's test asserts, and the port keeps
    exactly the (token, rank) assignments the reference keeps — the first
    ``capacity`` of each expert in token-major, then rank, order."""
    t, d, f, e, k = 64, 8, 8, 4, 2
    arrays = _weights(1, t, d, f, e, scaled=False)
    full, _ = _both(arrays, k, e, 8.0, gather, f32)
    tight, tight_r = _both(arrays, k, e, 0.2, gather, f32)
    assert float(tight.abs().sum()) < float(full.abs().sum())
    x, router, wg, wu, wd = arrays
    ids, gates = (a.numpy() for a in moe.router_topk(_t(x), _t(router), k))
    rows = _expert_rows(x, ids, wg, wu, wd)
    kept, kept_r = _kept(tight.numpy(), rows, gates), \
        _kept(tight_r, rows, gates)
    assert kept == kept_r
    cap = moe._capacity(t, k, e, 0.2)
    assert cap == ref_moe._capacity(t, k, e, 0.2) == 7
    # the rule itself: the first `cap` assignments of each expert
    want, count = set(), {}
    for ti, r in itertools.product(range(t), range(k)):
        ei = ids[ti, r]
        if count.get(ei, 0) < cap:
            want.add((ti, r))
        count[ei] = count.get(ei, 0) + 1
    assert kept == want and len(kept) == e * cap


@pytest.mark.parametrize("n,k,e,cf", [(24, 2, 8, 1.25), (2048, 8, 40, 1.25),
                                      (64, 2, 4, 0.2), (1, 8, 384, 1.25),
                                      (7, 3, 5, 0.1), (100, 1, 3, 8.0)])
def test_capacity_is_the_references(n, k, e, cf):
    assert moe._capacity(n, k, e, cf) == ref_moe._capacity(n, k, e, cf)


def test_router_topk_keeps_jax_tie_order():
    """Equal gates: ``jax.lax.top_k`` takes the lower expert id first, and
    so does the port (``torch.topk`` promises no order)."""
    d, e, k = 8, 6, 3
    x = np.ones((4, d), np.float32)
    router = np.zeros((d, e), np.float32)
    router[:, 5] = 1.0                       # expert 5 first, then a tie
    ids, gates = moe.router_topk(_t(x), _t(router), k)
    ids_r, gates_r = ref_moe.router_topk(x, router, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_r))
    assert ids[0].tolist() == [5, 0, 1] and ids.dtype == torch.int32
    np.testing.assert_allclose(gates.numpy(), np.asarray(gates_r), rtol=1e-6)


@pytest.mark.parametrize("gather,f32", FORMS, ids=FORM_IDS)
def test_moe_gradients_match_jax_vjp(gather, f32):
    """With drops (capacity factor 0.5): the gradients of every input
    against ``jax.vjp`` of the reference, relative to each one's largest
    magnitude (float32 sums in another order)."""
    t, d, f, e, k = 32, 16, 24, 6, 2
    arrays = _weights(2, t, d, f, e)
    cot = np.random.default_rng(3).standard_normal((t, d)).astype(np.float32)
    kw = dict(k=k, n_experts=e, expert_offset=0, capacity_factor=0.5,
              f32_combine=f32, gather_dispatch=gather)
    _, vjp = jax.vjp(lambda *a: ref_moe.moe_apply_local(*a, **kw), *arrays)
    want = vjp(jnp.asarray(cot))
    ts = [_t(a).requires_grad_() for a in arrays]
    moe.moe_apply_local(*ts, **kw).backward(_t(cot))
    for g, w in zip(ts, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1.0))


@pytest.mark.parametrize("gather,f32", FORMS, ids=FORM_IDS)
def test_moe_bfloat16_matches_reference(gather, f32):
    """bfloat16 activations and experts, float32 router: the port's silu
    replays JAX's bfloat16 roundings; the two frameworks' bfloat16 matrix
    products round once each, so outputs agree to a bfloat16 step of the
    largest magnitude."""
    t, d, f, e, k = 40, 32, 64, 8, 2
    x, router, wg, wu, wd = _weights(4, t, d, f, e)
    bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, wg, wu, wd)]
    kw = dict(k=k, n_experts=e, expert_offset=0, capacity_factor=1.25,
              f32_combine=f32, gather_dispatch=gather)
    want = ref_moe.moe_apply_local(bf[0], router, *bf[1:], **kw)
    tb = [_t(np.asarray(a.astype(jnp.float32))).bfloat16() for a in bf]
    got = moe.moe_apply_local(tb[0], _t(router), *tb[1:], **kw)
    assert got.dtype == torch.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), w, rtol=0,
                               atol=2 ** -7 * np.abs(w).max())


def test_moe_local_shard_owns_an_expert_slice():
    """``expert_offset``: two shards of the experts, each computing its own
    slice, sum to the whole (the reference's expert-parallel identity)."""
    t, d, f, e, k = 20, 8, 16, 6, 2
    x, router, wg, wu, wd = _weights(5, t, d, f, e)
    kw = dict(k=k, n_experts=e, capacity_factor=8.0)
    whole = moe.moe_apply_local(*map(_t, (x, router, wg, wu, wd)),
                                expert_offset=0, **kw)
    parts = [moe.moe_apply_local(_t(x), _t(router), _t(wg[o:o + 3]),
                                 _t(wu[o:o + 3]), _t(wd[o:o + 3]),
                                 expert_offset=o, **kw) for o in (0, 3)]
    for o, part in zip((0, 3), parts):
        want = ref_moe.moe_apply_local(x, router, wg[o:o + 3], wu[o:o + 3],
                                       wd[o:o + 3], expert_offset=o, **kw)
        np.testing.assert_allclose(part.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), whole.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_moe_block_local_path_and_mesh_refusal():
    b, s, d, f, e, k = 2, 6, 8, 16, 4, 2
    x, router, wg, wu, wd = _weights(6, b * s, d, f, e)
    x3 = x.reshape(b, s, d)
    p = {"router": router, "gate": wg, "up": wu, "down": wd}
    kw = dict(k=k, n_experts=e, capacity_factor=1.25)
    got = moe.moe_block(_t(x3), {n: _t(a) for n, a in p.items()}, **kw)
    want = ref_moe.moe_block(x3, p, **kw)
    assert tuple(got.shape) == (b, s, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    # the expert-parallel path takes a port Mesh, with a process group up
    # (it runs, against the reference's, in tests/test_torch_distributed.py)
    with pytest.raises(TypeError, match="repro_torch.launch.mesh.Mesh"):
        moe.moe_block(_t(x3), {n: _t(a) for n, a in p.items()},
                      mesh=object(), **kw)
    mesh = Mesh(np.arange(2).reshape(1, 2), ("data", "model"))
    with pytest.raises(RuntimeError, match="no torch.distributed process "
                                           "group is up"):
        moe.moe_block(_t(x3), {n: _t(a) for n, a in p.items()}, mesh=mesh,
                      data_axes=("data",), **kw)
    # the MoE layer inside the model under an active context calls
    # moe_block's expert-parallel path, which wants a process group
    lp = {"router": _t(router), "e_gate": _t(wg), "e_up": _t(wu),
          "e_down": _t(wd)}
    cfg = ModelConfig(name="m", family="moe", n_layers=1, d_model=d,
                      n_heads=2, n_kv_heads=2, d_ff=f, vocab_size=16,
                      n_experts=e, experts_per_token=k, capacity_factor=1.25,
                      dtype="float32")
    ctx = ShardCtx(mesh=mesh, dp=("data",), tp="model")
    with pytest.raises(RuntimeError, match="no torch.distributed process "
                                           "group is up"):
        moe_mlp(_t(x3), lp, cfg, ctx)
    np.testing.assert_allclose(moe_mlp(_t(x3), lp, cfg, ShardCtx()).numpy(),
                               got.numpy(), rtol=0, atol=0)


def test_moe_silu_is_the_layers_one():
    """The expert activation is the port's ``layers.silu`` (the bfloat16
    replay of JAX's sigmoid), imported, not a copy."""
    assert moe.silu is silu


def test_backward_scatters_without_float_atomics_by_source():
    """By source: the dispatch and the combine scatter with ``index_put``
    without accumulation (every kept row written once, the dropped ones
    into a sentinel row that is cut off), never with ``index_add``,
    ``gather``, ``index_select``, ``scatter_add`` or an accumulating
    ``index_put``, which use float atomics or a sort on the card."""
    import inspect
    src = inspect.getsource(moe.moe_apply_local)
    for op in ("index_add", "scatter_add", "index_select", "torch.gather",
               ".gather(", "accumulate=", "scatter_reduce"):
        assert op not in src, op
    assert src.count("index_put(") == 3

"""Prefill and decode under an active ``ShardCtx`` against the JAX
package's single-device ``prefill`` and ``decode_step``, across
processes; and the partial decode attention with its combine against
``decode_attention``.

Each case runs the port on a ``(data, model)`` mesh of four ``gloo`` ranks
(``launch/collectives.spawn``; the rank body is
``tests/torch_dist_workers.py::tp_serve_case``, which imports no
``jax``), as the reference's ``launch/dryrun.py`` serves: no FSDP.  Every
rank holds its blocks of the reference's parameters and the rows of the
prompt it computes (its data shard's, or every row where the batch does
not divide the data axis); ``prefill`` returns its vocabulary block of the
last row's logits and its blocks of the cache under ``cache_specs``.
Then four teacher-forced ``decode_step``s (``make_decode_step``) from the
reference's own decode cache (its prefill cache grown to ``_seq_len``
positions), cut by ``cache_specs``; a ``CHAIN`` case decodes from the
ranks' own prefill cache (``make_prefill_step``), grown and cut again.  The logits of every step are gathered from the blocks,
the caches put back together, and the greedy token of each step held to
``jnp.argmax`` of the reference's logits; a planted tie across the
vocabulary blocks goes to the lower index.

The reference runs first, in this process on one device with
``ShardCtx()``: its prefill cache is the ranks' input.  Tolerances (float32): logits 2e-3 (8e-3 for the
MoE and the hybrid), caches 1e-4, as ``tests/test_torch_models.py``
holds the single-process port to the same reference, for the same reasons
(both packages round the final state to bfloat16 before the head; the
MoE and Mamba2's SSD sum in another order than XLA).
"""
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_dist_workers as W
from test_torch_mamba_parallel import HYBRID
from repro_torch import configs
from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as M
from repro_torch.models import sharding as sh
from repro_torch.models.attention import (combine_partials,
                                          decode_attention,
                                          decode_attention_partial)
from repro_torch.models.config import ModelConfig

SPAWN_S = 300.0
LOGIT_TOL = {"moe": 8e-3, "hybrid": 8e-3}
CACHE_TOL = 1e-4

#: a permuted (data 2, model 2) mesh and a (data 1, model 4) one
R22 = np.asarray([[2, 0], [3, 1]])
R14 = np.asarray([[1, 3, 0, 2]])

B, S, N_GEN = 4, 16, 4
#: the decode cache's positions (``odd_batch``'s do not divide the four
#: ranks its sequence would be cut over: its KV rows stay whole)
SEQ_LEN = {"odd_batch": 22}

BASE = dict(n_layers=2, d_model=32, d_ff=64, vocab_size=256, head_dim=8,
            dtype="float32", remat=False)
#: name -> (config, mesh ranks, batch)
CASES = {
    # 4 heads and 2 KV heads cut over a 2-way model axis
    "dense": (dict(BASE, name="dense", family="dense", n_heads=4,
                   n_kv_heads=2, qkv_bias=True), R22, B),
    # 3 heads on a 4-way axis: the sequence-sharded prefill, replicated
    # heads in decode; the batch does not "divide" a 1-way data axis, so
    # the cache's sequence is cut over (model, data)
    "uneven": (dict(BASE, name="uneven", family="dense", n_heads=3,
                    n_kv_heads=3, d_model=24), R14, B),
    "moe": (dict(BASE, name="moe", family="moe", n_heads=4, n_kv_heads=4,
                 n_experts=4, experts_per_token=2, capacity_factor=8.0),
            R22, B),
    "mamba1": (dict(BASE, name="mamba1", family="ssm", n_heads=0,
                    n_kv_heads=0, d_ff=0, ssm_variant="mamba1",
                    ssm_state=8), R22, B),
    # Mamba2 (4 heads of 16, one a rank; the packed width 148 cut at 37,
    # inside a head) and the weight-tied block after layer 1
    "hybrid": (dict(BASE, name="hybrid", family="hybrid", n_layers=3,
                    n_heads=4, n_kv_heads=4, ssm_variant="mamba2",
                    ssm_state=8, ssm_head_dim=16, hybrid_attn_period=2),
               R14, B),
    # a sliding-window layer (ring cache, held whole) and a global one,
    # one KV head held whole over a 4-way axis, a vocabulary that pads
    "ring": (dict(BASE, name="ring", family="dense", n_heads=4,
                  n_kv_heads=1, sliding_window=8, local_global_period=2,
                  vocab_size=300), R14, B),
    # 3 rows on a 2-way data axis: every rank computes them all, and the
    # cache's sequence would be cut over (model, data), but 22 positions
    # do not divide 4
    "odd_batch": (dict(BASE, name="odd_batch", family="dense", n_heads=4,
                       n_kv_heads=4), R22, 3),
    # the same 3 rows through ``make_prefill_step``, then
    # ``make_decode_step`` from the ranks' own prefill cache: 16 and 24
    # positions divide (model, data), so both caches cut the sequence
    # over both axes, and the prefill's blocks must land where the decode
    # step reads them
    "odd_batch_chain": (dict(BASE, name="odd_batch_chain", family="dense",
                             n_heads=4, n_kv_heads=4), R22, 3),
    # the Mamba tests' hybrid (4 Mamba2 layers, the weight-tied block
    # after layers 1 and 3, 4 heads over 2 KV heads) on a 4-way model
    # axis: the shared block's cache cut along the sequence
    "hybrid_tp4": (HYBRID, R14, B),
}
#: the cases that decode from the ranks' own prefill cache, grown
CHAIN = {"odd_batch_chain"}
#: name -> (case, fault): a case's decode steps again, with a fault of
#: ``tools/tp_faults.py`` planted in the ranks
FAULTED = {"hybrid_tp4_combine_unscaled": ("hybrid_tp4", "combine_unscaled")}


def _seq_len(name):
    return SEQ_LEN.get(name, 24)


def _reference(kw, seed, tokens, feed, seq_len):
    """The reference's weights (``init_params`` from ``PRNGKey(seed)``),
    its prefill of ``tokens``, its decode cache grown to ``seq_len``
    positions, and its teacher-forced decode steps on ``feed``: NumPy
    trees."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as ref_model
    from repro.models.config import ModelConfig as RefConfig
    from repro.models.sharding import ShardCtx
    cfg = RefConfig(**kw)
    params = jax.jit(ref_model.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(seed))
    logits, cache = jax.jit(lambda p, t: ref_model.prefill(
        p, cfg, ShardCtx(), t))(params, jnp.asarray(tokens))
    to_np = lambda t: jax.tree.map(np.asarray, t)      # noqa: E731
    out = {"params": to_np(params), "prefill_logits": np.asarray(logits),
           "prefill_cache": to_np(cache)}
    grown = {}
    for k, v in cache.items():
        if k in ("k", "v"):
            pad = [(0, 0)] * v.ndim
            pad[2] = (0, seq_len - v.shape[2])
            v = jnp.pad(v, pad)
        grown[k] = v
    out["cache_in"] = to_np(grown)
    step = jax.jit(lambda p, t, c, pos: ref_model.decode_step(
        p, cfg, ShardCtx(), t, c, pos))
    lg, greedy = [], []
    c = grown
    for j, tok in enumerate(feed):
        g, c = step(params, jnp.asarray(tok), c, jnp.int32(S + j))
        lg.append(np.asarray(g))
        greedy.append(np.asarray(jnp.argmax(g, axis=-1)))
    out.update(logits=lg, greedy=greedy, cache=to_np(c))
    return out


def _inputs(name):
    kw, _, b = CASES[name]
    rng = np.random.default_rng(len(name))
    toks = rng.integers(0, kw["vocab_size"], (b, S)).astype(np.int32)
    feed = [rng.integers(0, kw["vocab_size"], (b, 1)).astype(np.int32)
            for _ in range(N_GEN)]
    return toks, feed


@pytest.fixture(scope="module")
def runs():
    """``(reference, the ranks' results)``: the reference's weights,
    prefill and decode steps first (its weights and grown cache are the
    ranks' inputs), then the spawn."""
    refs = {}
    for i, name in enumerate(CASES):
        toks, feed = _inputs(name)
        refs[name] = _reference(CASES[name][0], i, toks, feed,
                                _seq_len(name))
    cases = {}
    for name, (kw, ranks, b) in CASES.items():
        toks, feed = _inputs(name)
        cases[name] = {"cfg": kw, "ranks": ranks,
                       "params": refs[name]["params"], "tokens": toks,
                       "cache": refs[name]["cache_in"], "feed": feed,
                       "pos": S, "seq_len": _seq_len(name),
                       "chain": name in CHAIN}
    for name, (base, fault) in FAULTED.items():
        cases[name] = dict(cases[base], fault=fault)
    results = C.spawn(W.tp_serve_cases, 4, (cases,), timeout=SPAWN_S,
                      threads=1)
    return refs, {n: [r[n] for r in results] for n in cases}


def _ctx(name):
    kw, ranks, b = CASES[name]
    mesh = Mesh(ranks, ("data", "model"))
    return ModelConfig(**kw), sh.ShardCtx(mesh=mesh, dp=("data",),
                                          tp="model"), b


def _logits(results, name, key, j=None):
    """The whole logits ``(b, V)`` from the ranks' blocks: vocabulary
    blocks over the model axis, rows over the data axis (or every rank's
    rows whole, where the batch does not divide it)."""
    cfg, ctx, b = _ctx(name)
    out = np.zeros((b, cfg.padded_vocab), np.float32)
    cut = cfg.padded_vocab % ctx.n("model") == 0
    for rank, r in enumerate(results):
        blk = r[key] if j is None else r[key][j]
        c = ctx.mesh.coords(rank)
        per = b // ctx.n("data") if b % ctx.n("data") == 0 else b
        rows = slice(c["data"] * per, (c["data"] + 1) * per) \
            if per != b else slice(None)
        n = blk.shape[-1]
        cols = slice(c["model"] * n, (c["model"] + 1) * n) if cut \
            else slice(None)
        out[rows, cols] = blk
    return out


def _cache(results, name, key, seq_len):
    """The whole cache from the ranks' blocks under ``cache_specs``
    (``gather_params``' rule: a block held twice must agree)."""
    cfg, ctx, b = _ctx(name)
    specs = M.cache_specs(cfg, ctx, b, seq_len)
    out = {}
    for k, spec in specs.items():
        parts = [torch.from_numpy(r[key][k]) for r in results]
        blk = parts[0]
        whole = torch.zeros(tuple(s * n for s, n in zip(
            blk.shape, [_n(e, ctx) for e in tuple(spec) + (None,) * (
                blk.dim() - len(spec))])), dtype=blk.dtype)
        for rank, part in enumerate(parts):
            dst = sh.shard_leaf(whole, spec, ctx.mesh, rank)
            dst.copy_(part)
        for rank, part in enumerate(parts):
            assert torch.equal(sh.shard_leaf(whole, spec, ctx.mesh, rank),
                               part), (name, k, rank)
        out[k] = whole.numpy()
    return out


def _n(entry, ctx):
    n = 1
    for a in sh.spec_axes(entry):
        n *= ctx.n(a)
    return n


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_under_a_context_matches_single_device(runs, name):
    """The last row's logits gathered from the ranks' vocabulary blocks and
    the cache put back together from their blocks (full KV rows cut along
    the sequence, ring rows whole, Mamba state and conv rows by channel or
    head) against the reference's single-device ``prefill``."""
    ref, ranks = runs[0][name], runs[1][name]
    cfg, ctx, b = _ctx(name)
    tol = LOGIT_TOL.get(cfg.family, 2e-3)
    np.testing.assert_allclose(_logits(ranks, name, "prefill_logits"),
                               ref["prefill_logits"], rtol=tol, atol=tol)
    got = _cache(ranks, name, "prefill_cache", S)
    assert sorted(got) == sorted(ref["prefill_cache"]), name
    for k, want in ref["prefill_cache"].items():
        np.testing.assert_allclose(got[k], want, rtol=CACHE_TOL,
                                   atol=CACHE_TOL, err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_decode_under_a_context_matches_single_device(runs, name):
    """Four teacher-forced decode steps from the reference's cache, cut by
    ``cache_specs``: every step's logits (gathered from the vocabulary
    blocks), the greedy token of every step on every rank against
    ``jnp.argmax`` of the reference's logits, and the cache after the
    last step against the reference's."""
    ref, ranks = runs[0][name], runs[1][name]
    cfg, ctx, b = _ctx(name)
    tol = LOGIT_TOL.get(cfg.family, 2e-3)
    for j in range(N_GEN):
        np.testing.assert_allclose(_logits(ranks, name, "logits", j),
                                   ref["logits"][j], rtol=tol, atol=tol,
                                   err_msg=f"{name} step {j}")
        for rank, r in enumerate(ranks):
            c = ctx.mesh.coords(rank)
            want = ref["greedy"][j]
            if b % ctx.n("data") == 0:
                per = b // ctx.n("data")
                want = want[c["data"] * per:(c["data"] + 1) * per]
            assert r["greedy"][j][:, 0].tolist() == want.tolist(), \
                (name, j, rank)
    got = _cache(ranks, name, "cache", _seq_len(name))
    for k, want in ref["cache"].items():
        np.testing.assert_allclose(got[k], want, rtol=CACHE_TOL,
                                   atol=CACHE_TOL, err_msg=f"{name} {k}")


def test_greedy_token_takes_the_lowest_index_of_a_tie(runs):
    """Logits whose largest value sits at two columns in different
    vocabulary blocks (and, in the second row, in the last block twice
    over the model axis' blocks): every rank picks the lower index, as
    ``jnp.argmax`` does."""
    for name in ("dense", "ring", "uneven"):
        cfg, _, _ = _ctx(name)
        v = cfg.padded_vocab
        for r in runs[1][name]:
            assert r["tie"][:, 0].tolist() == [3, v // 2 + 1], (name, r["tie"])


def test_decode_moves_bytes_of_its_own_kind(runs):
    """A decode step's combine, q/k/v gathers and greedy reductions count
    under ``decode``; a prefill moves none of them."""
    for name in ("dense", "uneven", "hybrid"):
        for r in runs[1][name]:
            assert r["decode_stats"]["decode"] > 0, (name, r["decode_stats"])
            assert r["prefill_stats"]["decode"] == 0, name
            assert r["prefill_stats"]["fsdp"] == 0, name


# ---------------------------------------------------------------------------
# the partial decode attention and its combine, rank-free
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_blocks", [1, 2, 4])
def test_partial_attention_and_combine_match_decode_attention(n_blocks):
    """``decode_attention_partial`` over 1, 2 and 4 blocks of a cache's
    sequence, combined over a stacked leading dim, against
    ``decode_attention`` over the whole cache, with ``pos`` in each block
    in turn (blocks wholly past it contribute nothing)."""
    rng = np.random.default_rng(n_blocks)
    b, h, kv, hd, s = 2, 4, 2, 8, 16
    q = torch.from_numpy(rng.standard_normal((b, 1, h, hd)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, s, kv, hd)).astype(
        np.float32)) for _ in range(2))
    n = s // n_blocks
    for pos in sorted({blk * n + n // 2 for blk in range(n_blocks)}
                      | {0, s - 1}):
        want = decode_attention(q, k, v, pos)
        parts = [decode_attention_partial(q, k[:, i * n:(i + 1) * n],
                                          v[:, i * n:(i + 1) * n], pos,
                                          i * n)
                 for i in range(n_blocks)]
        m, l, o = (torch.stack(t) for t in zip(*parts))
        assert not torch.isfinite(m[pos // n + 1:]).any()
        got = combine_partials(m, l, o, lambda t: t.amax(0),
                               lambda t: t.sum(0), q.dtype)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    return chip_smoke


def _combines(name) -> bool:
    """Whether the case's decode steps combine partial attentions: its
    full KV rows' sequence is cut over mesh axes."""
    cfg, ctx, b = _ctx(name)
    specs = M.cache_specs(cfg, ctx, b, _seq_len(name))
    return "k" in specs and bool(sh.spec_axes(specs["k"][2]))


@pytest.mark.parametrize("name", list(CASES))
def test_decode_combine_matches_attention_over_the_gathered_cache(runs,
                                                                  name):
    """``chip_smoke.CombineWatch``, as ``tp_generate_on_card`` runs it on
    the card: every decode step's ``combine_partials`` over the sequence's
    blocks against ``decode_attention`` over the blocks gathered whole,
    within ``COMBINE_TOL_STEPS`` (one bfloat16 step) on every rank; a
    case whose cache is not cut combines nothing."""
    tol = _chip_smoke().COMBINE_TOL_STEPS
    for rank, r in enumerate(runs[1][name]):
        got = r["combine_steps"]
        if not _combines(name):
            assert got == [], (name, rank, got)
            continue
        assert len(got) == N_GEN and max(got) <= tol, (name, rank, got)


def test_combine_check_catches_an_unscaled_combine(runs):
    """The same reading with ``tools/tp_faults.py``'s ``combine_unscaled``
    planted in the hybrid's ranks (the blocks' partial sums added without
    their ``e^(m - M)`` weights): every rank reads it far past the
    tolerance."""
    tol = _chip_smoke().COMBINE_TOL_STEPS
    for name in FAULTED:
        for rank, r in enumerate(runs[1][name]):
            got = r["combine_steps"]
            assert len(got) == N_GEN and min(got) > 10 * tol, (name, rank,
                                                               got)


def test_rank_calls_match_the_chip_phase_count(runs, monkeypatch):
    """The calls of the norm, attention and scan wrappers on each rank (a
    prefill and ``N_GEN`` decode steps) are those that
    ``chip_smoke.tp_generate_launches`` counts for a rank of
    ``tp_generate_on_card``, whose launch counts the card's kernel
    counters assert."""
    chip_smoke = _chip_smoke()
    monkeypatch.setattr(chip_smoke, "TPG_TOKENS", N_GEN + 1)
    monkeypatch.setattr(chip_smoke, "TPG_PROMPT", S)
    for name in CASES:
        cfg, ctx, b = _ctx(name)
        nd = ctx.n("data")
        rows = b // nd if b % nd == 0 else b
        for rank, r in enumerate(runs[1][name]):
            want, _ = chip_smoke.tp_generate_launches(
                cfg, ctx.n("model"), rows, ctx.mesh.coords(rank)["model"])
            got = {k: v["fwd"] for k, v in r["calls"].items()}
            assert got == {k: want[k] for k in got}, (name, rank, got, want)


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_cache_specs_equal_the_reference_layout(arch, monkeypatch):
    """``cache_specs`` against the reference's ``launch/specs.py``
    ``cache_spec`` (``cache_pspecs`` with the axes that do not divide a
    dim dropped) on both production meshes, at the reference's serving
    shapes and at a batch and a sequence that divide nothing: spec for
    spec, leaf for leaf.  The reference lays the specs on a
    ``NamedSharding`` of a real mesh; here its ``jax`` and
    ``NamedSharding`` names are stood in for, in this test only, so that
    its specs come back as they are."""
    import jax
    from repro import configs as r_configs
    from repro.launch import specs as r_specs
    from repro.models import sharding as r_sh
    from repro.models.config import SHAPES, ShapeSpec
    monkeypatch.setattr(r_specs, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(r_specs, "jax", SimpleNamespace(
        eval_shape=jax.eval_shape,
        ShapeDtypeStruct=lambda shape, dtype, sharding=None:
        SimpleNamespace(shape=shape, sharding=sharding)))
    shapes = [SHAPES[k] for k in ("prefill_32k", "decode_32k", "long_500k")]
    shapes.append(ShapeSpec("odd", 1_000, 3, "decode"))
    for mesh_shape in ({"data": 16, "model": 16},
                       {"pod": 2, "data": 16, "model": 16}):
        dp = ("pod", "data") if "pod" in mesh_shape else ("data",)
        mesh = SimpleNamespace(shape=mesh_shape)
        rctx = r_sh.ShardCtx(mesh=mesh, dp=dp, tp="model")
        tctx = sh.ShardCtx(mesh=mesh, dp=dp, tp="model")
        for shape in shapes:
            want = {k: tuple(v.sharding) for k, v in r_specs.cache_spec(
                r_configs.get(arch), shape, rctx).items()}
            got = {k: tuple(v) for k, v in M.cache_specs(
                configs.get(arch), tctx, shape.global_batch,
                shape.seq_len).items()}
            assert got == want, (arch, mesh_shape, shape.name)

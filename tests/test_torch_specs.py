"""``launch/specs.py`` of the PyTorch package against the JAX package's.

Every spec tree — ``params_spec``, ``opt_spec`` with and without
``zero1``, ``batch_spec``, ``cache_spec`` and ``decode_inputs`` — leaf for
leaf (global shape and partition spec), for every arch and input shape, on
both production meshes, with and without FSDP.  The reference lays its
specs on ``NamedSharding``s of a real mesh of 256 or 512 devices; here, in
this test only, its ``NamedSharding`` and ``jax.ShapeDtypeStruct`` names
are stood in for (as ``tests/test_torch_serve_parallel.py``'s cache test
does), so that its specs come back as they are; ``jax.eval_shape`` still
runs on the real structs.  Then the ZeRO-1 rule and ``shard_sizes`` on
small cases.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch._tree import leaves, tree_map
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import Mesh
from repro_torch.models.sharding import P, ShardCtx, shard_leaf
from repro_torch.optim.adamw import AdamW

MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})


class _SDS:
    """Stands in for ``jax.ShapeDtypeStruct`` in the reference's module:
    keeps the sharding it is handed (here a namespace holding the spec)."""

    def __init__(self, shape, dtype, sharding=None):
        self.shape, self.dtype, self.sharding = tuple(shape), dtype, sharding


@pytest.fixture
def ref_specs(monkeypatch):
    import jax
    from repro.launch import specs as r_specs
    from repro.models import sharding as r_sh

    def eval_shape(fn, *args):
        real = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype),
                            args, is_leaf=lambda x: isinstance(x, _SDS))
        return jax.eval_shape(fn, *real)

    def named(mesh, spec):
        return SimpleNamespace(spec=spec)
    monkeypatch.setattr(r_specs, "NamedSharding", named)
    monkeypatch.setattr(r_sh, "NamedSharding", named)
    monkeypatch.setattr(r_specs, "jax", SimpleNamespace(
        eval_shape=eval_shape, ShapeDtypeStruct=_SDS, tree=jax.tree,
        random=jax.random))
    return r_specs


def _ref_leaves(tree):
    import jax
    return [(s.shape, tuple(s.sharding.spec)) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, _SDS))]


def _leaves(tree):
    return [(s.shape, tuple(s.spec)) for s in leaves(tree)]


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_specs_equal_the_reference_leaf_for_leaf(arch, ref_specs):
    """Parameters, optimizer state (``zero1`` False and True: ZeRO-1 on
    the axis named ``data``, never ``pod``), the batch of every shape and
    a decode cell's token, cache and position: the same shapes, the same
    specs, leaf for leaf, in the reference's leaf order."""
    from repro import configs as r_configs
    from repro.models import sharding as r_sh
    from repro.models.config import SHAPES
    from repro.optim.adamw import AdamW as RAdamW
    rcfg, tcfg = r_configs.get(arch), configs.get(arch)
    for mesh_shape in MESHES:
        dp = ("pod", "data") if "pod" in mesh_shape else ("data",)
        mesh = SimpleNamespace(shape=mesh_shape)
        for fsdp in ((), ("data",)):
            rctx = r_sh.ShardCtx(mesh=mesh, dp=dp, tp="model", fsdp=fsdp)
            tctx = ShardCtx(mesh=mesh, dp=dp, tp="model", fsdp=fsdp)
            assert _leaves(SP.params_spec(tcfg, tctx)) == _ref_leaves(
                ref_specs.params_spec(rcfg, rctx)), (arch, mesh_shape)
            for zero1 in (False, True):
                got = SP.opt_spec(tcfg, tctx, AdamW(), zero1=zero1)
                want = ref_specs.opt_spec(rcfg, rctx, RAdamW(), zero1=zero1)
                for part in ("m", "v"):
                    assert _leaves(getattr(got, part)) == _ref_leaves(
                        getattr(want, part)), (arch, mesh_shape, zero1)
                assert tuple(got.step.spec) == tuple(want.step.sharding.spec)
                if zero1:
                    # the moments' ZeRO-1 axis is "data" alone
                    axes = {a for _, spec in _leaves(got.m) for e in spec
                            for a in ((e,) if isinstance(e, str)
                                      else (e or ()))}
                    assert "pod" not in axes
        for shape in SHAPES.values():
            got = SP.batch_spec(tcfg, shape, tctx)
            want = ref_specs.batch_spec(rcfg, shape, rctx)
            assert {k: (v.shape, tuple(v.spec)) for k, v in got.items()} \
                == {k: (v.shape, tuple(v.sharding.spec))
                    for k, v in want.items()}, (arch, shape.name)
            if shape.kind != "decode":
                continue
            tok, cache, pos = SP.decode_inputs(tcfg, shape, tctx)
            rtok, rcache, rpos = ref_specs.decode_inputs(rcfg, shape, rctx)
            assert (tok.shape, tuple(tok.spec)) == (
                rtok.shape, tuple(rtok.sharding.spec))
            assert (pos.shape, tuple(pos.spec)) == (
                rpos.shape, tuple(rpos.sharding.spec))
            assert {k: (v.shape, tuple(v.spec)) for k, v in cache.items()} \
                == {k: (v.shape, tuple(v.sharding.spec))
                    for k, v in rcache.items()}, (arch, shape.name)


@pytest.mark.parametrize("shape,spec,n,want", [
    ((8, 6), P(None, None), 2, P("data", None)),        # the largest dim
    ((6, 6), P(None, None), 2, P("data", None)),        # the first on a tie
    ((6, 8), P(None, "model"), 2, P("data", "model")),  # a free dim only
    ((5, 8), P(None, "model"), 2, P(None, "model")),    # none divides
    ((8, 4), P("data", None), 2, P("data", None)),      # data already used
    ((8, 4), P(("pod", "data"), None), 2, P(("pod", "data"), None)),
    ((8,), P(), 4, P("data")),                          # padded to the rank
])
def test_zero1_rule(shape, spec, n, want):
    """The reference's ZeRO-1 rule for a moment: the axis ``data`` on the
    largest dim no axis cuts and the axis divides, the first on a tie;
    nothing when the spec names ``data`` already or no dim divides."""
    got = SP.z1_spec(shape, spec, n)
    assert tuple(got) == tuple(want)
    assert SP.zero1_dim(spec, got) == (
        None if tuple(got) == tuple(spec) + (None,) * (len(shape) - len(spec))
        else next(i for i, e in enumerate(got) if e == "data"))


def test_pp_step_spec_trees_share_the_rule():
    """``launch/pp_step.py``'s moment specs are ``z1_spec`` of its
    parameter specs: the stage leaves' on a free dim after the pipe dim,
    the shared leaves' as their FSDP specs (which name ``data``)."""
    from repro_torch.launch.pp_step import make_pp_train_step
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(name="pp", family="dense", n_layers=4, d_model=64,
                      n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
                      head_dim=16, dtype="float32")
    mesh = Mesh(np.arange(4).reshape(2, 2), ("data", "model"))
    _, p_spec, o_spec, _ = make_pp_train_step(cfg, mesh, AdamW(), n_mb=2)
    for p, m in zip(leaves(p_spec), leaves(o_spec.m)):
        assert m.dtype == torch.float32
        assert tuple(m.spec) == tuple(SP.z1_spec(p.shape, p.spec, 2))
    for k, s in p_spec["shared"].items():
        assert "data" in tuple(s.spec), k


def test_shard_sizes_are_the_bytes_of_each_ranks_blocks():
    """``shard_sizes`` of a spec tree on a (pod 2, data 2, model 2) mesh
    equals, for every rank, the bytes of that rank's blocks of whole
    tensors cut by ``shard_leaf``: parameters with FSDP, and ZeRO-1
    moments."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.transformer import init_params
    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=16,
                      n_heads=2, n_kv_heads=2, d_ff=32, vocab_size=64,
                      head_dim=8, dtype="float32")
    mesh = Mesh(np.arange(8).reshape(2, 2, 2), ("pod", "data", "model"))
    ctx = ShardCtx(mesh=mesh, dp=("pod", "data"), tp="model",
                   fsdp=("data",))
    whole = init_params(cfg, seed=0, device="cpu")
    p_spec = SP.params_spec(cfg, ctx)
    m_spec = SP.opt_spec(cfg, ctx, AdamW(), zero1=True).m
    for rank in range(8):
        for spec in (p_spec, m_spec):
            blocks = tree_map(lambda t, s: shard_leaf(t, s.spec, mesh,
                                                      rank), whole, spec)
            got = [t.numel() * 4 for t in leaves(blocks)]
            assert leaves(SP.shard_sizes(spec, mesh, rank)) == got
            for t, s in zip(leaves(blocks), leaves(spec)):
                assert tuple(t.shape) == SP.block_shape(s.shape, s.spec,
                                                        mesh)


def test_blocks_and_shard_params_hold_only_the_rank_block():
    """``specs.blocks`` makes zeros of a rank's block shape (``lead`` dims
    dropped, as a pipeline stage stores its layers), and every leaf that
    ``shard_params`` cuts owns a storage of its block's bytes: a block
    along the leading dims, a view of the whole, would keep the whole
    tensor alive on the rank."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.sharding import shard_params
    from repro_torch.models.transformer import ShapeDtype, init_params
    mesh = Mesh(np.arange(4).reshape(2, 2), ("data", "model"))
    s = ShapeDtype((4, 8, 6), torch.float32, P("model", "data"))
    got = SP.blocks({"a": s}, mesh, "cpu", lead=1)["a"]
    assert got.shape == (4, 6) and not got.any()
    assert SP.blocks(s, mesh).shape == (2, 4, 6)
    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=16,
                      n_heads=2, n_kv_heads=2, d_ff=32, vocab_size=64,
                      head_dim=8, dtype="float32")
    ctx = ShardCtx(mesh=mesh, dp=("data",), tp="model", fsdp=("data",))
    whole = init_params(cfg, seed=0, device="cpu")
    for rank in range(4):
        for t in leaves(shard_params(whole, cfg, ctx, rank)):
            assert t.untyped_storage().nbytes() == t.numel() * 4


def test_zero1_dims_of_both_training_steps():
    """``launch/zero1.py``'s dims: the tensor-parallel step cuts each
    gradient and parameter where its ZeRO-1 moment names ``data``; the
    pipeline step cuts a stage leaf's there (less its pipe dim), and a
    shared leaf's gradient on its FSDP dim while the parameter, stored as
    that block already, is neither narrowed nor gathered."""
    from repro_torch.launch import steps
    from repro_torch.launch import zero1 as Z
    from repro_torch.launch.pp_step import make_pp_train_step
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(name="pp", family="dense", n_layers=4, d_model=64,
                      n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
                      head_dim=16, dtype="float32")
    mesh = Mesh(np.arange(4).reshape(2, 2), ("data", "model"))
    ctx = ShardCtx(mesh=mesh, dp=("data",), tp="model")
    dims = steps.zero1_dims(cfg, ctx)
    m = SP.opt_spec(cfg, ctx, AdamW(), zero1=True).m
    assert dims == Z.cut_dims(m, "data")
    assert dims["layers"]["wq"] is not None and dims["final_norm"] == 0
    _, p_spec, o_spec, _ = make_pp_train_step(cfg, mesh, AdamW(), n_mb=2)
    for k, s in p_spec["shared"].items():
        got = Z.cut_dims(o_spec.m["shared"][k], "data")
        assert got == tuple(s.spec).index("data"), k
        assert Z.block_dims(s, o_spec.m["shared"][k], "data") is None, k
    for k, s in o_spec.m["stages"].items():
        d = Z.cut_dims(s, "data", 1)
        assert d == tuple(s.spec).index("data") - 1, k
        assert Z.block_dims(p_spec["stages"][k], s, "data", 1) == d, k

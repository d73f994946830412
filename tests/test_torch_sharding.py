"""The port's sharding policy and rank meshes against the JAX package's.

No process group here: specs come from shapes alone (the port's
``param_shapes`` on the meta device, the reference's ``jax.eval_shape``),
and the mesh tests compare rank arrays.  Where the reference needs real
devices (``mesh_from_plan``'s device ids, ``jax.device_put`` shards, the
spec trees of ``make_pp_train_step``) it runs in one subprocess with 8
forced host devices, as ``tests/test_multidevice.py`` runs it.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RP

from repro import configs as r_configs
from repro.core import cluster as r_cluster
from repro.core import plan as r_plan
from repro.core import simulator as r_sim
from repro.launch import mesh as r_mesh
from repro.models import model as RM
from repro.models import sharding as r_sh
from repro.models import transformer as r_tr
from repro.models.config import ModelConfig as RModelConfig
from repro_torch import _tree
from repro_torch import configs
from repro_torch.core import Conf
from repro_torch.core import cluster as t_cluster
from repro_torch.core import plan as t_plan
from repro_torch.core import simulator as t_sim
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import steps as t_steps
from repro_torch.launch.pp_step import make_pp_train_step
from repro_torch.models import model as TM
from repro_torch.models import sharding as t_sh
from repro_torch.models import transformer as t_tr
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.models.moe import moe_block
from repro_torch.optim.adamw import AdamW

SRC = str(Path(__file__).resolve().parent.parent / "src")
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
#: a permuted (data 2, model 4) mesh of 8 ranks for the shard checks
PERM = [3, 6, 0, 5, 7, 1, 4, 2]
DENSE = dict(name="sh-dense", family="dense", n_layers=4, d_model=64,
             n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=256, head_dim=16,
             dtype="float32", remat=False)
MOE = dict(name="sh-moe", family="moe", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=4, d_ff=96, vocab_size=256, head_dim=16, n_experts=8,
           experts_per_token=2, capacity_factor=8.0, dtype="float32",
           remat=False)
SHARD_LEAVES = ["tok_embed", "lm_head", "final_norm", "layers.wq",
                "layers.wo", "layers.gate", "layers.down", "layers.e_gate",
                "layers.e_down", "layers.router", "layers.ln1"]
GPT_KW = dict(name="g8", family="dense", n_layers=8, d_model=512,
              n_heads=8, n_kv_heads=8, d_ff=2048, vocab_size=32000)


def _ctx(mod, mesh_name):
    shape = MESHES[mesh_name]
    dp = ("pod", "data") if "pod" in shape else ("data",)
    return mod.ShardCtx(mesh=SimpleNamespace(shape=shape), dp=dp, tp="model",
                        fsdp=("data",))


def _spec_leaves(tree):
    """The specs of a ``tree_pspecs`` tree in the reference's leaf order
    (keys sorted; a ``P`` is a tuple, so ``_tree.leaves`` would open it)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    return [tree]


def _ref_specs(arch, mesh_name):
    cfg = r_configs.get(arch)
    sds = jax.eval_shape(lambda: RM.init_params(cfg, jax.random.PRNGKey(0)))
    specs = r_sh.tree_pspecs(sds, cfg, _ctx(r_sh, mesh_name))
    flat = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, RP))
    return [tuple(s) for s in flat], [tuple(s.shape) for s in
                                      jax.tree.leaves(sds)]


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_tree_pspecs_equal_reference_leaf_for_leaf(arch, mesh_name):
    """Every leaf's spec, in the reference's leaf order, with the port's
    shapes from ``param_shapes`` (nothing allocated) equal to
    ``jax.eval_shape``'s; and every spec divides its dim (the reference's
    ``test_param_specs_divide``)."""
    want, want_shapes = _ref_specs(arch, mesh_name)
    cfg = configs.get(arch)
    shapes = t_tr.param_shapes(cfg)
    specs = t_sh.tree_pspecs(shapes, cfg, _ctx(t_sh, mesh_name))
    got = _spec_leaves(specs)
    assert all(isinstance(s, t_sh.P) for s in got)
    assert [tuple(s) for s in got] == want
    assert [s.shape for s in _tree.leaves(shapes)] == want_shapes
    for leaf, spec in zip(_tree.leaves(shapes), got):
        assert len(spec) <= len(leaf.shape)
        for dim, ax in zip(leaf.shape, spec):
            n = int(np.prod([MESHES[mesh_name][a]
                             for a in t_sh.spec_axes(ax)]))
            assert dim % n == 0, (arch, leaf, spec)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "command-r-plus-104b",
                                  "qwen2-7b"])
def test_tp_lands_on_big_weights(arch):
    """The model axis shards the FFN or expert weights (the reference's
    ``test_tp_actually_shards_big_weights``)."""
    cfg = configs.get(arch)
    specs = t_sh.tree_pspecs(t_tr.param_shapes(cfg), cfg,
                             _ctx(t_sh, "16x16"))
    key = "e_gate" if cfg.family == "moe" else "gate"
    assert "model" in {a for ax in specs["layers"][key]
                       for a in t_sh.spec_axes(ax)}


def test_param_shapes_allocate_nothing():
    shapes = t_tr.param_shapes(configs.get("kimi-k2-1t-a32b"))
    leaves = _tree.leaves(shapes)
    assert all(isinstance(s, t_tr.ShapeDtype) for s in leaves)
    assert sum(int(np.prod(s.shape)) for s in leaves) > 1e12


@pytest.mark.parametrize("n_heads", [16, 24, 20, 3])
@pytest.mark.parametrize("stacked", [True, False])
def test_head_specs_equal_reference(n_heads, stacked):
    for mesh_name in MESHES:
        want = r_sh.head_specs(_ctx(r_sh, mesh_name), n_heads, 128, stacked)
        got = t_sh.head_specs(_ctx(t_sh, mesh_name), n_heads, 128, stacked)
        assert [tuple(s) for s in got] == [tuple(s) for s in want]
    assert t_sh.head_specs(t_sh.ShardCtx(), n_heads, 128, stacked) == (
        t_sh.P(*([None] * stacked), None, None, None),
        t_sh.P(*([None] * stacked), None, None, None))


FAMILY_ARCHS = ["qwen2-7b", "falcon-mamba-7b", "zamba2-7b",
                "granite-moe-3b-a800m", "gemma3-12b"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("batch", [32, 48, 3])
def test_cache_pspecs_equal_reference(arch, batch):
    """Batch dividing the data axes (32), not dividing them (48 on the
    two-pod mesh, 3 on both)."""
    for mesh_name in MESHES:
        want = RM.cache_pspecs(r_configs.get(arch), _ctx(r_sh, mesh_name),
                               batch)
        got = TM.cache_pspecs(configs.get(arch), _ctx(t_sh, mesh_name), batch)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("seq_shard", [False, True])
def test_residual_spec_equal_reference(seq_shard):
    r_cfg = r_configs.get("qwen2-7b").replace(seq_shard_residuals=seq_shard)
    t_cfg = configs.get("qwen2-7b").replace(seq_shard_residuals=seq_shard)
    for mesh_name in MESHES:
        for cfg_r, cfg_t in ((r_cfg, t_cfg), (None, None)):
            want = r_tr._residual_spec(_ctx(r_sh, mesh_name), cfg_r)
            got = t_tr._residual_spec(_ctx(t_sh, mesh_name), cfg_t)
            assert tuple(got) == tuple(want)


@pytest.mark.parametrize("ndim", [3, 4])
def test_mesh_from_mapping_ranks_are_the_mapping(ndim):
    shape = (2, 2, 2) if ndim == 3 else (2, 1, 2, 2)
    conf = Conf(2, 2, 2, 1, 16) if ndim == 3 else Conf(2, 1, 2, 1, 16, cp=2)
    mapping = np.random.default_rng(ndim).permutation(8).reshape(shape)
    mesh = t_mesh.mesh_from_mapping(conf, mapping)
    assert np.array_equal(mesh.ranks, mapping)
    want = ("pipe", "model", "data") if ndim == 3 else \
        ("pipe", "model", "context", "data")
    assert mesh.axis_names == want
    assert list(mesh.shape) == list(want)
    assert tuple(mesh.shape.values()) == shape
    for r in range(8):
        c = mesh.coords(r)
        assert mapping[tuple(c[a] for a in want)] == r
    named = t_mesh.mesh_from_mapping(conf, mapping, axes=tuple("abcd"[:ndim]))
    assert named.axis_names == tuple("abcd"[:ndim])


def test_make_mesh_and_production_meshes():
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        t_mesh.make_mesh((2, 2), ("data", "model"))
    one = t_mesh.make_mesh((1, 1), ("data", "model"))
    assert one.shape == {"data": 1, "model": 1}
    single = t_mesh.make_production_mesh()
    assert single.shape == {"data": 16, "model": 16}
    assert np.array_equal(single.ranks.reshape(-1), np.arange(256))
    multi = t_mesh.make_production_mesh(multi_pod=True)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(RuntimeError, match="process group"):
        single.group("data")


def _plans():
    spec_r = r_cluster.mixed_fleet_spec(
        "mesh-8x1", 8, (r_cluster.A100_TIER, r_cluster.V100_TIER),
        (0.5, 0.5), gpus_per_node=1, seed=5)
    spec_t = t_cluster.mixed_fleet_spec(
        "mesh-8x1", 8, (t_cluster.A100_TIER, t_cluster.V100_TIER),
        (0.5, 0.5), gpus_per_node=1, seed=5)
    bw, _ = r_cluster.profile_bandwidth(spec_r)

    def req(pmod, smod, cfg_cls, spec, backend):
        return pmod.PlanRequest(
            workload=smod.Workload(cfg_cls(**GPT_KW), 1024, 32), spec=spec,
            space=pmod.SearchSpace(max_micro=2),
            budget=pmod.Budget(sa_seconds=60.0, sa_iters=40, n_chains=2,
                               sa_topk=2, backend=backend), seed=3)

    ref = r_plan.Planner(r_plan.PipetteStrategy()).plan(
        req(r_plan, r_sim, RModelConfig, spec_r, "numpy"), bw)
    port = t_plan.Planner(t_plan.PipetteStrategy(), device="cpu").plan(
        req(t_plan, t_sim, TModelConfig, spec_t, "torch"), bw)
    return ref, port


REFERENCE = """
import pickle, sys
import jax, numpy as np
from jax.sharding import NamedSharding
from repro.core.plan import Plan
from repro.launch.mesh import mesh_from_plan
from repro.launch.pp_step import make_pp_train_step
from repro.models import model as M
from repro.models.config import ModelConfig
from repro.models.sharding import ShardCtx, tree_shardings
from repro.optim.adamw import AdamW

inp = pickle.load(open(sys.argv[1], "rb"))
out = {}
import json
mesh = mesh_from_plan(Plan.from_json_dict(json.loads(inp["plan"])))
out["plan_ids"] = np.vectorize(lambda d: d.id)(mesh.devices)
out["plan_axes"] = mesh.axis_names

devs = np.array(jax.devices())
mesh = jax.sharding.Mesh(devs[np.asarray(inp["perm"])].reshape(2, 4),
                         ("data", "model"))
ctx = ShardCtx(mesh=mesh, dp=("data",), tp="model", fsdp=("data",))
out["shards"] = {}
for name in ("dense", "moe"):
    cfg = ModelConfig(**inp[name])
    params = M.init_params(cfg, jax.random.PRNGKey(1))
    put = jax.device_put(params, tree_shardings(params, cfg, ctx))
    leaves = {}
    for key in inp["leaves"]:
        a = put
        for part in key.split("."):
            a = a.get(part) if isinstance(a, dict) else None
            if a is None:
                break
        if a is None:
            continue
        leaves[key] = {s.device.id: np.asarray(s.data)
                       for s in a.addressable_shards}
    out["shards"][name] = {"whole": jax.tree.map(np.asarray, params),
                           "leaves": leaves}

cfg = ModelConfig(**inp["dense"])
mesh = jax.sharding.Mesh(devs.reshape(2, 4), ("data", "model"))
_, p_sds, o_sds, b_sds = make_pp_train_step(cfg, mesh, AdamW(), n_mb=8)
def describe(tree):
    return [(tuple(s.shape), str(s.dtype), tuple(s.sharding.spec))
            for s in jax.tree.leaves(tree)]
out["specs"] = {"params": describe(p_sds), "opt": describe(o_sds),
                "batch": describe(b_sds)}
pickle.dump(out, open(sys.argv[2], "wb"))
print("OK")
"""


@pytest.fixture(scope="module")
def plans():
    return _plans()


@pytest.fixture(scope="module")
def ref(tmp_path_factory, plans):
    """The reference's device-backed results, from one subprocess with 8
    forced host devices."""
    tmp = tmp_path_factory.mktemp("sharding")
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"plan": plans[0].to_json(), "perm": PERM, "dense": DENSE,
                     "moe": MOE, "leaves": SHARD_LEAVES}, f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                        str(tmp / "in.pkl"), str(tmp / "out.pkl")],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    with open(tmp / "out.pkl", "rb") as f:
        return pickle.load(f)


def test_mesh_from_plan_equals_reference(plans, ref):
    """A ``backend="torch"`` plan's mesh: its ranks equal the device ids of
    the reference's mesh of the NumPy-backend plan."""
    mesh = t_mesh.mesh_from_plan(plans[1])
    assert plans[1].conf is not None and mesh.size == 8
    assert np.array_equal(mesh.ranks, ref["plan_ids"])
    assert mesh.axis_names == tuple(ref["plan_axes"])


def test_infeasible_plan_raises_the_reference_message(plans):
    msgs = []
    for plan, mod in zip(plans, (r_mesh, t_mesh)):
        bad = dataclasses.replace(plan, conf=None, mapping=None)
        with pytest.raises(ValueError, match="infeasible") as e:
            mod.mesh_from_plan(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _leaf(tree, key):
    for part in key.split("."):
        if not isinstance(tree, dict) or part not in tree:
            return None
        tree = tree[part]
    return tree


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_shard_leaf_equals_reference_device_put(name, ref):
    """Each rank's block of a leaf (fsdp on a permuted (data 2, model 4)
    mesh) is bit for bit the reference's shard on the device of the same
    id."""
    cfg = TModelConfig(**(DENSE if name == "dense" else MOE))
    mesh = t_mesh.Mesh(np.asarray(PERM).reshape(2, 4), ("data", "model"))
    ctx = t_sh.ShardCtx(mesh=mesh, dp=("data",), tp="model", fsdp=("data",))
    whole = ref["shards"][name]["whole"]
    specs = t_sh.tree_pspecs(whole, cfg, ctx)
    checked = 0
    for key, by_dev in ref["shards"][name]["leaves"].items():
        x = torch.from_numpy(np.array(_leaf(whole, key)))
        spec = _leaf(specs, key)
        for rank in range(8):
            got = t_sh.shard_leaf(x, spec, mesh, rank).numpy()
            assert got.shape == by_dev[rank].shape, key
            np.testing.assert_array_equal(got, by_dev[rank], err_msg=key)
            checked += 1
    assert checked >= 8 * 8
    # the placements: one per mesh dim
    pl = t_sh.tree_shardings(whole, cfg, ctx)
    from torch.distributed.tensor import Replicate, Shard
    assert pl["tok_embed"] == (Shard(1), Shard(0))     # P("model", "data")
    assert pl["final_norm"] == (Replicate(), Replicate())


def test_pp_step_spec_trees_equal_reference(ref):
    """``make_pp_train_step``'s ``params_spec``, ``opt_spec`` and
    ``batch_spec`` against the reference's ``*_sds``: shape, type and
    spec of every leaf, in the reference's leaf order."""
    cfg = TModelConfig(**DENSE)
    mesh = t_mesh.Mesh(np.arange(8).reshape(2, 4), ("data", "model"))
    _, p_spec, o_spec, b_spec = make_pp_train_step(cfg, mesh, AdamW(),
                                                   n_mb=8)

    def describe(tree):
        return [(tuple(s.shape), str(s.dtype).replace("torch.", ""),
                 tuple(s.spec)) for s in _tree.leaves(tree)]

    assert describe(p_spec) == ref["specs"]["params"]
    assert describe(o_spec) == ref["specs"]["opt"]
    assert describe(b_spec) == ref["specs"]["batch"]


def test_model_entry_points_refuse_an_active_context():
    """Every model entry point runs under an active context, one process
    per rank (``tests/test_torch_tensor_parallel.py``,
    ``tests/test_torch_mamba_parallel.py``,
    ``tests/test_torch_serve_parallel.py``): without a process group each
    of them — training, prefill and decode of the attention, MoE and
    Mamba families, the greedy token — fails on the missing group, none
    with ``NotImplementedError``, and none runs unsharded in silence.
    Prefill and decode need the global batch (and decode the cache's
    positions) under a context, and refuse to guess them."""
    cfg = TModelConfig(**MOE)
    params = t_tr.init_params(cfg, seed=0, device="cpu")
    mesh = t_mesh.Mesh(np.arange(8).reshape(2, 4), ("data", "model"))
    ctx = t_sh.ShardCtx(mesh=mesh, dp=("data",), tp="model")
    toks = torch.zeros((2, 8), dtype=torch.long)
    x = torch.zeros((2, 8, cfg.d_model))
    pos = torch.zeros((2, 8), dtype=torch.int32)
    ssm = TModelConfig(name="sh-ssm", family="ssm", ssm_variant="mamba1",
                       n_layers=1, d_model=16, n_heads=0, n_kv_heads=0,
                       d_ff=0, vocab_size=64, ssm_state=4, dtype="float32")
    ssm_params = t_tr.init_params(ssm, seed=0, device="cpu")
    hyb = TModelConfig(name="sh-hyb", family="hybrid", ssm_variant="mamba2",
                       n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
                       head_dim=8, d_ff=64, vocab_size=64, ssm_state=8,
                       ssm_head_dim=16, hybrid_attn_period=2,
                       dtype="float32")
    hyb_params = t_tr.init_params(hyb, seed=0, device="cpu")
    runs = {
        "prefill": lambda: TM.prefill(params, cfg, ctx, toks, batch=2),
        "decode_step": lambda: TM.decode_step(
            params, cfg, ctx, toks[:, :1],
            TM.init_cache(cfg, 2, 8, device="cpu"), 0, batch=2, seq_len=8),
        "run_stack (ssm)": lambda: t_tr.run_stack(
            torch.zeros((2, 8, 16)), ssm_params, ssm, ctx, pos),
        "run_stack (hybrid)": lambda: t_tr.run_stack(
            torch.zeros((2, 8, 32)), hyb_params, hyb, ctx, pos),
        "greedy_token": lambda: t_steps.greedy_token(
            torch.zeros((2, cfg.padded_vocab // 4)), cfg, ctx),
        "forward_logits": lambda: TM.forward_logits(params, cfg, ctx, toks),
        "loss_fn": lambda: TM.loss_fn(params, cfg, ctx, {"tokens": toks,
                                                         "labels": toks}),
        "run_stack": lambda: t_tr.run_stack(x, params, cfg, ctx, pos),
        "the MoE layer": lambda: t_tr.moe_mlp(
            x, t_tr.layer_params(params, 0), cfg, ctx),
    }
    for where, call in runs.items():
        with pytest.raises((RuntimeError, ValueError)) as e:
            call()
        assert "process group" in str(e.value), (where, e.value)
    cache = TM.init_cache(cfg, 2, 8, device="cpu")
    for call in (lambda: TM.prefill(params, cfg, ctx, toks),
                 lambda: TM.decode_step(params, cfg, ctx, toks[:, :1], cache,
                                        0, batch=2),
                 lambda: TM.decode_step(params, cfg, ctx, toks[:, :1], cache,
                                        0, seq_len=8)):
        with pytest.raises(ValueError, match="global batch"):
            call()
    # the same calls run with the inactive context
    assert TM.forward_logits(params, cfg, t_sh.ShardCtx(), toks).shape == \
        (2, 8, cfg.padded_vocab)
    # moe_block itself takes a mesh only as a port Mesh
    with pytest.raises(TypeError, match="Mesh"):
        moe_block(x, {"router": params["layers"]["router"][0]},
                  k=2, n_experts=8, capacity_factor=8.0, mesh=object())

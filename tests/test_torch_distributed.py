"""The pipeline, the pipeline-parallel train step and the expert-parallel
MoE of the PyTorch package against the JAX package's, across processes.

Multi-rank behaviour is tested here only with CPU ``gloo`` process groups:
the ranks are processes spawned by ``launch/collectives.spawn`` (a
``file://`` store in a temporary directory, a 60 s timeout on every
collective, the ranks killed and the first failing rank's traceback
raised on any failure or after the spawn's own time limit), and the
reference runs in one subprocess with 8 forced host devices, as
``tests/test_multidevice.py`` runs it.  The ranks' bodies are in
``tests/torch_dist_workers.py``, which imports no ``jax``.  The card
runs the same code at gpt-1.1b's width in ``chip_smoke.py``
(``pp_train_gpt_1_1b``).

Cases: the reference's own pipeline case (pp 4, tanh stages), pp 2 x
dp 2 over a permuted mapping with ``data_axis``, one step of
``make_pp_train_step`` at pp 2 x dp 2 and at pp 4 (each rank storing its
FSDP blocks of the shared leaves and ZeRO-1 blocks of the moments), and
``moe_block`` on a (data 2, model 4) mesh of 8 ranks.  Two spawns in
all: the four 4-rank cases share one.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import torch_dist_workers as W
from repro_torch.launch import collectives as C
from repro_torch.models.config import ModelConfig

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

SRC = str(Path(__file__).resolve().parent.parent / "src")
SPAWN_S = 90.0

# the reference's pipeline case (tests/test_multidevice.py)
PP, L, D, V, MB, N_MB, S = 4, 8, 32, 64, 2, 8, 16
#: a permuted (pipe 2, data 2) mapping: rank at [x, z] is GPU f(x, z)
PP_DP_MAPPING = [[1, 3], [0, 2]]
#: the pp 2 x dp 2 train step's (data 2, model 2) mesh, model as the pipe;
#: the pp 4 step's (data 1, model 4)
STEP_RANKS = [[2, 0], [3, 1]]
STEP_RANKS_PP4 = [[3, 1, 0, 2]]
STEP_CFG = dict(name="pp-dense", family="dense", n_layers=4, d_model=64,
                n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
                head_dim=16, dtype="float32", remat=True)
STEP_N_MB, STEP_MB, STEP_S = 2, 2, 16
#: AdamW's eps in the step case, on both sides.  At the default 1e-8 an
#: element whose clipped gradient is near eps (the smallest here is 4e-8
#: before a clip scale of 0.16) turns the f32 roundoff between the two
#: attention algorithms (the reference's chunked online softmax, the
#: port's exact one: 2e-9 there) into 1.2e-5 of parameter; at 1e-12 the
#: first step is +-lr wherever the gradient is above 1e-10.
STEP_EPS = 1e-12
#: the MoE cases: (n_experts, top-k, fsdp) on a (data 2, model 4) mesh
MOE_RANKS = [[5, 0, 7, 2], [1, 6, 3, 4]]
MOE_CASES = [(8, 2, False), (8, 2, True), (6, 2, False), (6, 2, True)]
MOE_B, MOE_S, MOE_D, MOE_F = 4, 6, 16, 8


def _inputs():
    rng = np.random.default_rng(23)
    f32 = np.float32
    pipe = {"w": (rng.standard_normal((L, D, D)) * 0.05).astype(f32),
            "embed": (rng.standard_normal((V, D)) * 0.1).astype(f32),
            "head": (rng.standard_normal((D, V)) * 0.1).astype(f32),
            "tokens": rng.integers(0, V, (N_MB, MB, S)).astype(np.int32),
            "labels": rng.integers(0, V, (N_MB, MB, S)).astype(np.int32)}
    step = {"tokens": rng.integers(0, 256, (STEP_N_MB, STEP_MB, STEP_S))
            .astype(np.int32),
            "labels": rng.integers(0, 256, (STEP_N_MB, STEP_MB, STEP_S))
            .astype(np.int32)}
    moe = []
    for e, k, fsdp in MOE_CASES:
        moe.append({
            "e": e, "k": k, "fsdp": fsdp,
            "x": rng.standard_normal((MOE_B, MOE_S, MOE_D)).astype(f32),
            "router": rng.standard_normal((MOE_D, e)).astype(f32),
            "gate": (rng.standard_normal((e, MOE_D, MOE_F)) * 0.3)
            .astype(f32),
            "up": (rng.standard_normal((e, MOE_D, MOE_F)) * 0.3).astype(f32),
            "down": (rng.standard_normal((e, MOE_F, MOE_D)) * 0.3)
            .astype(f32),
            "cot": rng.standard_normal((MOE_B, MOE_S, MOE_D)).astype(f32)})
    return pipe, step, moe


REFERENCE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.launch.pipeline import pipeline_loss_fn, stage_params_split
from repro.launch.pp_step import make_pp_train_step
from repro.models import model as M
from repro.models.config import ModelConfig
from repro.models.moe import moe_block
from repro.optim.adamw import AdamW

inp = pickle.load(open(sys.argv[1], "rb"))
pipe, step, moe = inp["pipe"], inp["step"], inp["moe"]
devs = np.array(jax.devices())
out = {}

def embed_fn(sh, t):
    return sh["embed"][t]
def stage_fn(st, x):
    h, _ = jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x, st["w"])
    return h
def head_loss_fn(sh, h, lbl):
    lg = h @ sh["head"]
    lse = jax.nn.logsumexp(lg, -1)
    pick = jnp.take_along_axis(lg, lbl[..., None], -1)[..., 0]
    return jnp.mean(lse - pick)

def pipeline(mesh, pp, data_axis):
    params = {"stages": stage_params_split({"w": pipe["w"]}, pp),
              "shared": {"embed": pipe["embed"], "head": pipe["head"]}}
    fn = pipeline_loss_fn(embed_fn, stage_fn, head_loss_fn, mesh,
                          data_axis=data_axis)
    with jax.set_mesh(mesh):
        loss, g = jax.jit(jax.value_and_grad(fn))(
            params, pipe["tokens"], pipe["labels"])
    return {"loss": float(loss),
            "w": np.asarray(g["stages"]["w"]).reshape(pipe["w"].shape),
            "embed": np.asarray(g["shared"]["embed"]),
            "head": np.asarray(g["shared"]["head"])}

out["pp4"] = pipeline(jax.sharding.Mesh(devs[:4], ("pipe",)), 4, "")
mapping = np.asarray(inp["pp_dp_mapping"])
out["pp2dp2"] = pipeline(jax.sharding.Mesh(devs[:4][mapping],
                                           ("pipe", "data")), 2, "data")

cfg = ModelConfig(**inp["step_cfg"])
full = M.init_params(cfg, jax.random.PRNGKey(3))
to_np = lambda t: jax.tree.map(np.asarray, t)
for name, shape in (("step", (2, 2)), ("step_pp4", (1, 4))):
    mesh = jax.sharding.Mesh(devs[:4].reshape(shape), ("data", "model"))
    opt = AdamW(lr=1e-3, eps=inp["step_eps"])
    fn, *_ = make_pp_train_step(cfg, mesh, opt, n_mb=inp["step_n_mb"])
    params = {"stages": stage_params_split(full["layers"], shape[1]),
              "shared": {k: full[k] for k in ("tok_embed", "final_norm",
                                              "lm_head")}}
    batch = {"tokens_mb": step["tokens"], "labels_mb": step["labels"]}
    with jax.set_mesh(mesh):
        new, _, m = jax.jit(fn)(params, opt.init(params), batch)
    out[name] = {"params": to_np(params), "new": to_np(new),
                 "loss": float(m["loss"])}

mesh = jax.sharding.Mesh(devs[:8].reshape(2, 4), ("data", "model"))
out["moe"] = []
for cs in moe:
    p = {k: cs[k] for k in ("router", "gate", "up", "down")}
    def loss(x, p):
        y = moe_block(x, p, k=cs["k"], n_experts=cs["e"],
                      capacity_factor=8.0, mesh=mesh, data_axes=("data",),
                      model_axis="model", fsdp=cs["fsdp"])
        return jnp.sum(y * cs["cot"]), y
    with jax.set_mesh(mesh):
        (_, y), (dx, dp) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(cs["x"], p)
    out["moe"].append({"y": np.asarray(y), "dx": np.asarray(dx),
                       **{"d" + k: np.asarray(v) for k, v in dp.items()}})
pickle.dump(out, open(sys.argv[2], "wb"))
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results for every case, from one subprocess with 8
    forced host devices."""
    tmp = tmp_path_factory.mktemp("ref")
    pipe, step, moe = _inputs()
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"pipe": pipe, "step": step, "moe": moe,
                     "pp_dp_mapping": PP_DP_MAPPING, "step_cfg": STEP_CFG,
                     "step_n_mb": STEP_N_MB, "step_eps": STEP_EPS}, f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                        str(tmp / "in.pkl"), str(tmp / "out.pkl")],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    with open(tmp / "out.pkl", "rb") as f:
        out = pickle.load(f)
    return {"inputs": (pipe, step, moe), **out}


def _by_stage(results, key):
    """The ranks' stage blocks of ``key`` in stage order (one rank per
    stage)."""
    seen = {}
    for r in results:
        seen.setdefault(r["stage"], r[key])
    return np.concatenate([seen[s] for s in sorted(seen)])


def _check_pipeline(results, want):
    for r in results:
        assert abs(r["loss"] - want["loss"]) < 1e-5, (r["loss"],
                                                       want["loss"])
        np.testing.assert_allclose(r["embed"], want["embed"], rtol=3e-4,
                                   atol=3e-5)
        np.testing.assert_allclose(r["head"], want["head"], rtol=3e-4,
                                   atol=3e-5)
    np.testing.assert_allclose(_by_stage(results, "w"), want["w"],
                               rtol=3e-4, atol=3e-5)


def _reduce_scatter_inputs():
    """Each rank's tensors of the reduce-scatter case: float32 values over
    16 binades (so that the order of a sum shows in its bits) cut on dim
    1, and bfloat16 ones cut on dim 0."""
    rng = np.random.default_rng(31)
    scale = np.exp2(rng.integers(-8, 8, (4, 8, 12))).astype(np.float32)
    return {"ranks2": np.asarray(STEP_RANKS), "ranks4": np.asarray(
        STEP_RANKS_PP4[0]), "dims": [1, 0], "dtypes": ["float32",
                                                        "bfloat16"],
            "inputs": [rng.standard_normal((4, 8, 12)).astype(np.float32)
                       * scale,
                       rng.standard_normal((4, 4, 6)).astype(np.float32)]}


@pytest.fixture(scope="module")
def four_ranks(ref):
    """The four 4-rank cases, run by one spawn of 4 ranks (each case on a
    mesh of its own): the reference's pipeline case, the permuted pp 2 x
    dp 2 pipeline and the pp 2 x dp 2 and pp 4 train steps; per case, the
    ranks' results in rank order."""
    pipe, step = ref["inputs"][:2]
    want = ref["step"]
    step_case = {"cfg": ModelConfig(**STEP_CFG),
                 "ranks": np.asarray(STEP_RANKS), "axes": ("data", "model"),
                 "pipe_axis": "model", "data_axis": "data",
                 "n_mb": STEP_N_MB, "remat": True, "eps": STEP_EPS,
                 "layers": {k: v.reshape((-1,) + v.shape[2:])
                            for k, v in want["params"]["stages"].items()},
                 "shared": want["params"]["shared"], **step}
    cases = {
        "pp4": dict(pipe, ranks=np.arange(PP), axes=("pipe",), data_axis="",
                    remat=True),
        "pp2dp2": dict(pipe, ranks=np.asarray(PP_DP_MAPPING),
                       axes=("pipe", "data"), data_axis="data", remat=False),
        "step": step_case,
        "step_pp4": dict(step_case, ranks=np.asarray(STEP_RANKS_PP4)),
        "reduce_scatter": _reduce_scatter_inputs()}
    results = C.spawn(W.four_rank_cases, 4, (cases,), timeout=SPAWN_S,
                      threads=1)
    return {name: [r[name] for r in results] for name in cases}


def test_pipeline_matches_reference_pp4(ref, four_ranks):
    """The reference's own case: pp 4, L 8, tanh stages; the loss, the
    stage gradients and the shared (embed, head) gradients."""
    results = four_ranks["pp4"]
    assert sorted(r["stage"] for r in results) == list(range(PP))
    _check_pipeline(results, ref["pp4"])


def test_pipeline_matches_reference_pp2_dp2_permuted(ref, four_ranks):
    """pp 2 x dp 2 over a permuted mapping with ``data_axis``, without
    remat: the pmean'd loss and gradients; each rank's pipe and data
    groups (and a ``DeviceMesh``'s) are the mapping's lines."""
    ranks = np.asarray(PP_DP_MAPPING)
    results = four_ranks["pp2dp2"]
    for rank, r in enumerate(results):
        x, z = (int(c[0]) for c in np.nonzero(ranks == rank))
        assert r["stage"] == x
        assert r["pipe_line"] == tuple(ranks[:, z])
        assert r["data_line"] == tuple(ranks[x, :])
        assert r["pipe_group"] == sorted(ranks[:, z])
        assert r["data_group"] == sorted(ranks[x, :])
        assert r["device_mesh"] == {"pipe": sorted(ranks[:, z]),
                                    "data": sorted(ranks[x, :])}
    _check_pipeline(results, ref["pp2dp2"])


def _check_pp_step(results, want, ranks):
    """The loss and every parameter after the update against the
    reference's ``train_step``: a rank's stage whole, its block of each
    shared leaf (cut by the step's spec tree); and the bytes each rank
    stores, before and after the step, equal to the spec trees' shard
    sizes."""
    import torch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.pp_step import make_pp_train_step
    from repro_torch.models.sharding import shard_leaf
    from repro_torch.optim.adamw import AdamW
    mesh = Mesh(np.asarray(ranks), ("data", "model"))
    _, p_spec, _, _ = make_pp_train_step(ModelConfig(**STEP_CFG), mesh,
                                         AdamW(), n_mb=STEP_N_MB)
    for rank, r in enumerate(results):
        assert abs(r["loss"] - want["loss"]) < 1e-5, (r["loss"],
                                                       want["loss"])
        for k, v in r["shared"].items():
            block = shard_leaf(torch.from_numpy(want["new"]["shared"][k]),
                               p_spec["shared"][k].spec, mesh, rank)
            np.testing.assert_allclose(v, block.numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)
        for k, v in r["stages"].items():
            np.testing.assert_allclose(v, want["new"]["stages"][k][
                r["stage"]], rtol=0, atol=1e-5, err_msg=k)
        assert r["stored_before"] == r["stored_after"] == r["spec_bytes"], \
            (rank, r["stored_before"], r["stored_after"], r["spec_bytes"])


def test_pp_train_step_matches_reference_pp2_dp2(ref, four_ranks):
    """One step of ``make_pp_train_step`` (4 dense layers, d 64, f32,
    ``n_mb`` 2, AdamW at lr 1e-3) on a permuted (data 2, model 2) mesh
    with the model axis as the pipe, against the reference's
    ``train_step``: the loss, and every parameter after the update; each
    rank stores the spec trees' blocks (half of each shared leaf and of
    every moment)."""
    want = ref["step"]
    results = four_ranks["step"]
    _check_pp_step(results, want, STEP_RANKS)
    # whole storage: the stage and the shared leaves, float32 moments of
    # both, the step; the shared leaves and every moment are halved
    shared = sum(v.size for v in want["params"]["shared"].values())
    for r in results:
        stage = sum(want["params"]["stages"][k][r["stage"]].size
                    for k in want["params"]["stages"])
        whole = 4 * (stage + shared) + 8 * (stage + shared) + 4
        assert r["spec_bytes"] == 4 * (stage + shared // 2) \
            + 8 * (stage + shared) // 2 + 4, (r["spec_bytes"], whole)
    # the launch formula of chip_smoke.py's pp_train_gpt_1_1b, per rank,
    # against the wrapper calls of this run (a call under grad with an
    # input that requires one is one backward launch on the card)
    cfg = ModelConfig(**STEP_CFG)
    for r in results:
        fwd, bwd, _ = chip_smoke.pp_rank_launches(
            cfg, cfg.n_layers // 2, STEP_N_MB, r["stage"] == 1, 1,
            (STEP_MB // 2, STEP_S, cfg.d_model))
        assert r["calls"] == {
            "rmsnorm": {"fwd": fwd["rmsnorm"], "bwd": bwd["rmsnorm_bwd"]},
            "flash_attention": {"fwd": fwd["flash_attention"],
                                "bwd": bwd["flash_attention_bwd"]}}, \
            (r["stage"], r["calls"])
    # every parameter moved: the step is not the identity
    moved = [np.abs(r["stages"]["wq"]
                    - want["params"]["stages"]["wq"][r["stage"]]).max()
             for r in results]
    assert min(moved) > 5e-4


def test_pp_train_step_matches_reference_pp4(ref, four_ranks):
    """The same step at pp 4 on a permuted (data 1, model 4) mesh: one
    layer a stage, the shared leaves and moments whole on a data axis of
    one rank; the loss, the parameters and the stored bytes."""
    _check_pp_step(four_ranks["step_pp4"], ref["step_pp4"], STEP_RANKS_PP4)


@pytest.mark.parametrize("case,ranks", [("step", STEP_RANKS),
                                        ("step_pp4", STEP_RANKS_PP4)])
def test_dry_run_counts_what_the_pp_ranks_moved_and_stored(four_ranks, case,
                                                           ranks):
    """``launch/dryrun.py``'s ``measure`` of the same step on meta tensors
    of each rank's blocks (``collectives.dry``, no process group), as that
    rank: its collective bytes by kind equal what the rank counted a step
    (``collectives.STATS``), and its stored bytes what the rank stores;
    chip_smoke.py's ``dryrun_vs_card`` makes the same check on the card."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.pp_step import make_pp_train_step
    from repro_torch.optim.adamw import AdamW
    mesh = Mesh(np.asarray(ranks), ("data", "model"))
    step, p_spec, o_spec, _ = make_pp_train_step(
        ModelConfig(**STEP_CFG), mesh, AdamW(lr=1e-3, eps=STEP_EPS),
        n_mb=STEP_N_MB)
    params, state = dryrun.pp_meta_state(p_spec, o_spec, mesh)
    rows = STEP_MB // mesh.shape["data"]
    batch = {k: torch.empty((STEP_N_MB, rows, STEP_S), dtype=torch.int64,
                            device="meta") for k in ("tokens_mb",
                                                     "labels_mb")}
    for rank, r in enumerate(four_ranks[case]):
        m = dryrun.measure(step, (params, state, batch), rank=rank)
        assert m["stats"] == r["stats"], (rank, m["stats"], r["stats"])
        assert dryrun._tree_bytes((params, state)) == r["stored_before"]
        assert m["stats"]["p2p"] > 0 and m["ops"]["collective-permute"] > 0
        assert m["flops"] > 0 and m["temp_bytes"] > 0


def test_reduce_scatter_is_all_reduce_then_a_cut(four_ranks):
    """``collectives.reduce_scatter`` (gloo has none: an ``all_to_all`` of
    the blocks, added in coordinate order): on a line of two data ranks
    bit-equal to ``all_reduce`` followed by this rank's block, for sum
    and mean, float32 and bfloat16 in one call; on a permuted line of 4,
    the left fold of the four ranks' blocks in the line's coordinate
    order, within rounding of the all-reduce's sum in another order."""
    inp = _reduce_scatter_inputs()
    for rank, r in enumerate(four_ranks["reduce_scatter"]):
        for op in ("sum", "mean"):
            got, want, _ = r["data2", op]
            for g, w in zip(got, want):
                assert g.shape == w.shape
                assert np.array_equal(g, w), (rank, op)
            got, want, line = r["line4", op]
            import torch
            blocks = []
            for a, dt, d in zip(inp["inputs"], inp["dtypes"], inp["dims"]):
                xs = [torch.from_numpy(a[q]).to(getattr(torch, dt))
                      for q in line]
                total = xs[0].clone()
                for x in xs[1:]:
                    total += x
                if op == "mean":
                    total /= torch.full((), 4.0, dtype=total.dtype)
                c = line.index(rank)
                n = total.shape[d] // 4
                blocks.append(total.narrow(d, c * n, n).float().numpy())
            # another order of the sum: float32 roundoff, or a few steps
            # of bfloat16 at the partial sums' size (up to 8)
            for g, b, w, tol in zip(got, blocks, want, (1e-6, 2.0 ** -4)):
                assert np.array_equal(g, b), (rank, op)
                np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def test_moe_expert_parallel_matches_reference(ref):
    """``moe_block`` on a permuted (data 2, model 4) mesh of 8 ranks, 8
    experts top-2 and 6 experts padded to 8, with and without ``fsdp``:
    each rank's output block and the gradients of its ``x`` block and of
    its expert blocks (summed over the data group where the weights are
    replicated over it, and the router's always) against the reference's
    ``moe_block(mesh=...)``."""
    moe = ref["inputs"][2]
    ranks = np.asarray(MOE_RANKS)
    results = C.spawn(W.moe_expert_parallel, 8, ({"ranks": ranks,
                                                   "cases": moe},),
                      timeout=SPAWN_S, threads=1)
    for i, (cs, want) in enumerate(zip(moe, ref["moe"])):
        e_per = -(-cs["e"] // 4)
        f_per = MOE_F // 2
        sums, wants = {}, {}
        for r in results:
            c, got = r["coords"], r["cases"][i]
            rows = slice(c["data"] * 2, (c["data"] + 1) * 2)
            np.testing.assert_allclose(got["y"], want["y"][rows], rtol=0,
                                       atol=1e-5)
            np.testing.assert_allclose(got["dx"], want["dx"][rows], rtol=0,
                                       atol=1e-5)
            for k in ("gate", "up", "down"):
                pad = np.zeros((e_per * 4 - cs["e"],)
                               + want["d" + k].shape[1:], np.float32)
                full = np.concatenate([want["d" + k], pad])
                block = full[c["model"] * e_per:(c["model"] + 1) * e_per]
                if cs["fsdp"]:
                    fdim = 1 if k == "down" else 2
                    block = np.take(block, range(c["data"] * f_per,
                                                 (c["data"] + 1) * f_per),
                                    axis=fdim)
                    np.testing.assert_allclose(got["d" + k], block, rtol=0,
                                               atol=1e-5, err_msg=k)
                else:
                    key = (k, c["model"])
                    sums[key] = sums.get(key, 0) + got["d" + k]
                    wants[key] = block
            key = ("router", c["model"])
            sums[key] = sums.get(key, 0) + got["drouter"]
            wants[key] = want["drouter"]
        assert len(sums) == (4 if cs["fsdp"] else 16)
        for key, v in sums.items():
            np.testing.assert_allclose(v, wants[key], rtol=0, atol=1e-5,
                                       err_msg=str(key))

"""The model under an active ``ShardCtx`` (tensor, FSDP and data
parallelism of the dense, vlm and MoE families) against the JAX package's
single-device results, across processes.

Each case runs the port on a ``(data, model)`` mesh of ``gloo`` ranks
(``launch/collectives.spawn``; the bodies in ``tests/torch_dist_workers.py``,
which imports no ``jax``): every rank holds its blocks of the reference's
parameters (``sharding.shard_params``) and its rows of the batch
(``steps.shard_batch``).  The reference runs once, in one subprocess, on
one device with ``ShardCtx()``, while the ranks run: the weights are
drawn once, here, by the reference's ``init_params`` (the gates' own
``PRNGKey(0)`` for their cases), and handed to both.  One spawn of 8
ranks runs every case in turn on a permuted (data 2, model 4) mesh: the
counterparts of ``tests/test_multidevice.py``'s MoE and uneven-heads
gates, experts and a sequence that do not divide the model axis, two
``make_train_step`` steps, a vlm, the ZeRO-1 step (``zero1=True``:
moments as data-axis blocks) against the reference and, without the grad
clip, against the replicated step bit for bit, and Mamba1's
channel-parallel block with ``scan_dtype="bfloat16"``.
The kernel's ``q_offset`` is held to the reference's
``chunked_attention(q_offset=)`` in this process.

Tolerances (float32 throughout): the loss within 1e-5 (the gates'); every
gathered gradient within ``GRAD_RTOL`` of itself plus ``GRAD_ATOL`` of the
leaf's largest: the row-parallel sums and the vocabulary's logsumexp add
in another order, the port's attention is the exact softmax where the
reference's is the chunked online one, and the head rounds its input to
bfloat16 (both packages do), so a float32 difference of the final hidden
state that crosses a bfloat16 rounding boundary moves that element of
the head's products by 2**-8 of itself; a parameter after one AdamW step
within ``STEP_ATOL``.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_workers as W
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import collectives as C
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh
from repro_torch.models import sharding as sh
from repro_torch.models.config import ModelConfig

SRC = str(Path(__file__).resolve().parent.parent / "src")
SPAWN_S = 300.0
GRAD_RTOL, GRAD_ATOL = 2e-4, 2.0 ** -9
STEP_ATOL = 1e-5
#: AdamW's eps in the step cases, on both sides.  A first step moves an
#: element by ``lr * g / (|g| + eps)``: at a tiny eps that is ``+-lr`` by
#: the sign of ``g``, and a gradient near 0 flips with float32 roundoff
#: (2 lr of parameter).  At 1e-3 the step is smooth in ``g`` (at most
#: ``lr / eps`` = 1 times its error, here below 1e-6), and a gradient
#: wrong by a factor still moves a 5e-3 element's step by 8e-5.
STEP_EPS = 1e-3

#: a permuted (data 2, model 4) mesh
RANKS = [[5, 0, 7, 2], [1, 6, 3, 4]]

# tests/test_multidevice.py:38 (MoE, FSDP) and :70 (3 heads on 4, no FSDP)
MOE = dict(name="moe", family="moe", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=4, d_ff=96, vocab_size=256, head_dim=16, n_experts=8,
           experts_per_token=2, capacity_factor=8.0, dtype="float32",
           remat=False)
UNEVEN = dict(name="d", family="dense", n_layers=2, d_model=60, n_heads=3,
              n_kv_heads=3, d_ff=128, vocab_size=256, head_dim=20,
              dtype="float32", remat=False)
#: 6 experts on a 4-way model axis: held whole over it, cut padded to 8
MOE6 = dict(MOE, name="moe6", n_experts=6, capacity_factor=4.0)
#: GQA with 1 KV head on a 4-way model axis (the KV weights held whole),
#: biases, remat and a vocabulary that pads (300 -> 512)
GQA = dict(name="gqa", family="dense", n_layers=2, d_model=32, n_heads=4,
           n_kv_heads=1, d_ff=64, vocab_size=300, head_dim=8,
           qkv_bias=True, dtype="float32", remat=True)
#: tied embeddings, 4 KV heads cut over the model axis (GQA, 2 query
#: heads a rank)
TIED = dict(name="tied", family="dense", n_layers=2, d_model=32, n_heads=8,
            n_kv_heads=4, d_ff=64, vocab_size=256, head_dim=8,
            tie_embeddings=True, dtype="float32", remat=True)
VLM = dict(name="vlm", family="vlm", frontend="vlm", n_img_tokens=6,
           n_layers=2, d_model=32, n_heads=4, n_kv_heads=4, d_ff=64,
           vocab_size=256, head_dim=8, dtype="float32", remat=False)
#: 3 heads do not divide a 4-way axis, and 15 rows do not divide it
#: either: the attention stays replicated, as the reference's
ODD_SEQ = dict(UNEVEN, name="odd", d_model=24, head_dim=8, d_ff=32)
#: Mamba1 with the scan's prefix in bfloat16 (Queue C 7): 64 channels,
#: 16 a rank of the 4-way model axis
MAMBA_BF16 = dict(name="mb16", family="ssm", n_layers=2, d_model=32,
                  n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=256,
                  ssm_variant="mamba1", ssm_state=8, ssm_conv=4,
                  ssm_expand=2, dtype="float32", remat=False,
                  scan_dtype="bfloat16")
#: The bfloat16 prefix against the reference's: a and u are rounded to
#: bfloat16 from float32 exponentials and products that the two packages
#: compute to within a float32 ulp, so now and then one lands a bfloat16
#: step (2**-8 of itself) from the reference's, and the chunk carries it.
#: At 64 positions (one chunk) the ranks read 1.4e-6 on the loss and at
#: most 5.1e-3 of a leaf's largest gradient; with the knob ignored (the
#: float32 scan) 3.5e-4 and 1.9e-2.  The loss within ``BF16_LOSS_TOL``,
#: each gathered gradient within ``BF16_GRAD_RTOL`` of the leaf's
#: largest.
BF16_LOSS_TOL, BF16_GRAD_RTOL = 3e-5, 1e-2
BF16_S = 64

B, S = 4, 16
STEP_B, N_MICRO = 8, 2


def _batch(rng, cfg, b, s, masked=False, img=False):
    toks = rng.integers(0, cfg["vocab_size"], (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg["vocab_size"], (b, s)).astype(np.int32)
    if masked:
        labels[rng.random((b, s)) < 0.3] = -1
        labels[0] = -1                    # a row with no label at all
    out = {"tokens": toks, "labels": labels}
    if img:
        n = cfg["n_img_tokens"]
        out["img_embeds"] = rng.standard_normal(
            (b, n, cfg["d_model"])).astype(np.float32)
        out["labels"] = np.concatenate(
            [np.full((b, n), -1, np.int32), labels], axis=1)
    return out


def _params(kw, seed):
    """Whole weights of the config ``kw``: the reference's ``init_params``
    from ``PRNGKey(seed)`` (the gates' own draw at seed 0), as NumPy,
    handed to both packages."""
    import jax
    from repro.models import model as ref_model
    from repro.models.config import ModelConfig as RefConfig
    params = jax.jit(ref_model.init_params, static_argnums=0)(
        RefConfig(**kw), jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


def _gate_batch(kw):
    """``tests/test_multidevice.py``'s batch: tokens ``randint(PRNGKey(0),
    (4, 32), 0, vocab)``, and the tokens as labels."""
    import jax
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (4, 32), 0,
                                         kw["vocab_size"]), np.int32)
    return {"tokens": toks, "labels": toks.copy()}


def _cases():
    """name -> (config, seed, batch, kind, fsdp, n_micro)."""
    rng = np.random.default_rng(24)
    return {
        "moe": (MOE, 0, _gate_batch(MOE), "grad", True, 1),
        "uneven": (UNEVEN, 0, _gate_batch(UNEVEN), "grad", False, 1),
        "moe6": (MOE6, 1, _batch(rng, MOE6, B, S, masked=True), "grad",
                 True, 1),
        "gqa_step": (GQA, 2, _batch(rng, GQA, STEP_B, S, masked=True),
                     "step", True, N_MICRO),
        "tied_step": (TIED, 3, _batch(rng, TIED, STEP_B, S, masked=True),
                      "step", True, N_MICRO),
        "vlm": (VLM, 4, _batch(rng, VLM, B, S, img=True), "grad", True, 1),
        "odd_seq": (ODD_SEQ, 5, _batch(rng, ODD_SEQ, B, 15), "grad", False,
                    1),
        "mamba_bf16": (MAMBA_BF16, 6, _batch(rng, MAMBA_BF16, B, BF16_S),
                       "grad", False, 1),
        "z1_step": (GQA, 2, _batch(np.random.default_rng(26), GQA, STEP_B, S,
                                   masked=True), "step", False, N_MICRO),
    }


#: Rank-only step cases (no reference run): the ZeRO-1 step and the
#: replicated step without the grad clip, on ``z1_step``'s weights and
#: batch; name -> (zero1, grad_clip).
RANK_ONLY = {"z1_noclip": (True, 0.0), "rep_noclip": (False, 0.0)}
#: The cases run with ``zero1=True``.
ZERO1 = ("z1_step", "z1_noclip")


REFERENCE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.launch.steps import make_train_step
from repro.models import model as M
from repro.models.config import ModelConfig
from repro.models.sharding import ShardCtx
from repro.optim.adamw import AdamW

inp = pickle.load(open(sys.argv[1], "rb"))
to_np = lambda t: jax.tree.map(np.asarray, t)
out = {}
for name, (kw, params, batch, kind, n_micro) in inp["cases"].items():
    cfg = ModelConfig(**kw)
    params = jax.tree.map(jnp.asarray, params)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    res = {}
    if kind == "grad":
        (loss, aux), g = jax.jit(jax.value_and_grad(
            lambda p: M.loss_fn(p, cfg, ShardCtx(), batch),
            has_aux=True))(params)
        res.update(loss=float(loss), tokens=float(aux["tokens"]),
                   grads=to_np(g))
    else:
        opt = AdamW(lr=1e-3, eps=inp["eps"])
        step = make_train_step(cfg, ShardCtx(), opt, n_micro=n_micro)
        new, _, m = jax.jit(step)(params, opt.init(params), batch)
        res.update(loss=float(m["loss"]), new=to_np(new))
    out[name] = res
pickle.dump(out, open(sys.argv[2], "wb"))
print("OK")
"""


def _spawn(params):
    """Every case in one spawn of 8 ranks; name -> the ranks' results in
    rank order."""
    cases = {name: {"cfg": kw, "ranks": np.asarray(RANKS), "fsdp": fsdp,
                    "params": params[name], "batch": batch, "kind": kind,
                    "n_micro": n_micro, "eps": STEP_EPS,
                    "zero1": name in ZERO1}
             for name, (kw, _, batch, kind, fsdp, n_micro)
             in _cases().items()}
    for name, (zero1, clip) in RANK_ONLY.items():
        cases[name] = dict(cases["z1_step"], zero1=zero1, grad_clip=clip)
    results = C.spawn(W.tp_model_cases, 8, (cases,), timeout=SPAWN_S,
                      threads=1)
    return {name: [r[name] for r in results] for name in cases}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference, the ranks' results)``: the reference's single-device
    results from one subprocess, started first, and the spawn while it
    runs."""
    tmp = tmp_path_factory.mktemp("ref")
    cases = _cases()
    # one compile a config: they run side by side
    with ThreadPoolExecutor(len(cases)) as pool:
        drawn = {n: pool.submit(_params, c[0], c[1])
                 for n, c in cases.items()}
        params = {n: f.result() for n, f in drawn.items()}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"cases": {n: (c[0], params[n], c[2], c[3], c[5])
                               for n, c in cases.items()},
                     "eps": STEP_EPS}, f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c",
                             textwrap.dedent(REFERENCE), str(tmp / "in.pkl"),
                             str(tmp / "out.pkl")], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        ranks = _spawn(params)
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err}"
    with open(tmp / "out.pkl", "rb") as f:
        ref = pickle.load(f)
    for name in ref:
        ref[name]["params"] = params[name]
    return ref, ranks


@pytest.fixture(scope="module")
def ref(runs):
    return runs[0]


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[1]


def _ctx(name):
    kw, _, _, _, fsdp, _ = _cases()["z1_step" if name in RANK_ONLY
                                    else name]
    mesh = Mesh(np.asarray(RANKS), ("data", "model"))
    return ModelConfig(**kw), sh.ShardCtx(
        mesh=mesh, dp=("data",), tp="model", fsdp=("data",) if fsdp else ())


def _whole(results, key, name):
    """The ranks' blocks of ``key`` put together (``gather_params``)."""
    cfg, ctx = _ctx(name)

    def to_t(tree):
        if isinstance(tree, dict):
            return {k: to_t(v) for k, v in tree.items()}
        return torch.from_numpy(tree)
    return sh.gather_params([to_t(r[key]) for r in results], cfg, ctx)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {n: v for k in sorted(tree)
                for n, v in _flat(tree[k], f"{prefix}{k}.").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _check_grad_case(results, want, name):
    for r in results:
        assert abs(r["loss"] - want["loss"]) < 1e-5, (name, r["loss"],
                                                       want["loss"])
        assert r["tokens"] == want["tokens"], name
    got = _flat(_whole(results, "grads", name))
    exp = _flat(want["grads"])
    assert sorted(got) == sorted(exp), name
    for k in exp:
        atol = max(2e-5, GRAD_ATOL * float(np.abs(exp[k]).max()))
        np.testing.assert_allclose(got[k], exp[k], rtol=GRAD_RTOL,
                                   atol=atol, err_msg=f"{name} {k}")


def test_moe_under_fsdp_matches_single_device(ref, ranks):
    """``tests/test_multidevice.py:38``'s case: MoE (8 experts, top-2) on a
    permuted (data 2, model 4) mesh with FSDP; the loss within 1e-5 of the
    single-device loss, and every parameter's gradient, gathered from the
    ranks' blocks, against ``jax.grad``."""
    _check_grad_case(ranks["moe"], ref["moe"], "moe")


def test_uneven_heads_sequence_sharded_matches_single_device(ref, ranks):
    """``tests/test_multidevice.py:70``'s case: 3 heads on a 4-way model
    axis (the sequence-sharded attention, 8 rows a rank of 32), no FSDP;
    the loss and every gathered gradient against the single device."""
    _check_grad_case(ranks["uneven"], ref["uneven"], "uneven")
    # the rows of each share were gathered over the model axis, and the
    # replicated projections' gradients summed over it: tp bytes moved
    assert all(r["stats"]["tp"] > 0 and r["stats"]["fsdp"] == 0
               for r in ranks["uneven"])


def test_experts_not_dividing_the_model_axis(ref, ranks):
    """6 experts on a 4-way model axis with FSDP, masked labels: the spec
    holds the experts whole over the model axis, and the layer cuts the
    zero-padded expert dim (8) for ``moe_block``; the gradients summed
    over the model ranks' cuts."""
    _check_grad_case(ranks["moe6"], ref["moe6"], "moe6")


def test_sequence_not_dividing_the_model_axis_stays_replicated(ref, ranks):
    """3 heads and 15 rows on a 4-way model axis: the reference keeps the
    attention replicated (``min_q_blocks``' condition), and so does the
    port; the MLP and vocabulary stay cut."""
    _check_grad_case(ranks["odd_seq"], ref["odd_seq"], "odd_seq")


def _check_step_case(results, want, name):
    for r in results:
        assert abs(r["loss"] - want["loss"]) < 1e-5, (name, r["loss"],
                                                       want["loss"])
    got = _flat(_whole(results, "params", name))
    exp = _flat(want["new"])
    assert sorted(got) == sorted(exp), name
    for k in exp:
        np.testing.assert_allclose(got[k], exp[k], rtol=0,
                                   atol=STEP_ATOL, err_msg=f"{name} {k}")
    moved = _flat(want["params"])
    assert max(float(np.abs(exp[k] - moved[k]).max()) for k in exp) > 5e-4


def test_train_step_dp2_tp2_fsdp_masked_labels(ref, ranks):
    """One ``make_train_step`` step on a permuted (data 2, model 4) mesh
    with FSDP, 2 microbatches, labels masked (one row wholly), GQA with
    the single KV head held whole over the model axis, biases, remat and
    a padded vocabulary: the loss and every parameter after the update
    against the reference's single-device step.  Every kind of collective
    moved bytes."""
    _check_step_case(ranks["gqa_step"], ref["gqa_step"], "gqa_step")
    for r in ranks["gqa_step"]:
        assert min(r["stats"][k] for k in ("fsdp", "tp", "vocab", "data")) \
            > 0, r["stats"]


def test_train_step_tied_embeddings(ref, ranks):
    """The same step with tied embeddings (the head is ``tok_embed.T``, on
    the same vocabulary rows) and KV heads cut over the model axis; the
    forward calls of the norms and the attention on each rank are those
    of ``chip_smoke.tp_rank_launches``, whose backward counts the card's
    kernel counters assert."""
    _check_step_case(ranks["tied_step"], ref["tied_step"], "tied_step")
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    cfg = ModelConfig(**TIED)
    mb = (STEP_B // 2 // N_MICRO, S, cfg.d_model)
    fwd, _, _ = chip_smoke.tp_rank_launches(cfg, 4, N_MICRO, 1, mb)
    for r in ranks["tied_step"]:
        assert {k: v["fwd"] for k, v in r["calls"].items()} == {
            "rmsnorm": fwd["rmsnorm"],
            "flash_attention": fwd["flash_attention"]}, r["calls"]


def test_zero1_step_matches_single_device(ref, ranks):
    """``make_train_step(zero1=True)`` on the (data 2, model 4) mesh
    without FSDP (GQA, biases, remat, masked labels, 2 microbatches, the
    grad clip on): the loss and every parameter after the update against
    the reference's single-device step, as the FSDP step is held; each
    rank stores its moments at the ZeRO-1 spec's shard sizes, less than
    the whole blocks; the reduce-scatter counts under ``data``, the
    gathered parameter blocks under ``zero1``, and no FSDP gather runs."""
    _check_step_case(ranks["z1_step"], ref["z1_step"], "z1_step")
    for r, rep_r in zip(ranks["z1_step"], ranks["rep_noclip"]):
        assert r["moment_bytes"] == r["moment_spec_bytes"], r
        assert r["moment_bytes"] < rep_r["moment_bytes"]
        assert r["stats"]["zero1"] > 0 and r["stats"]["fsdp"] == 0, \
            r["stats"]


@pytest.mark.parametrize("name", ["gqa_step", "z1_step"])
def test_dry_run_counts_what_the_tp_ranks_moved_and_stored(ranks, name):
    """``launch/dryrun.py``'s ``measure`` of the same step (FSDP, then
    ZeRO-1) on meta tensors of each rank's blocks, as that rank: its
    collective bytes by kind equal what the rank counted
    (``collectives.STATS``); its stored moments are the ZeRO-1 spec's."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.optim.adamw import AdamW
    cfg, ctx = _ctx(name)
    zero1 = name in ZERO1
    step = steps.make_train_step(cfg, ctx, AdamW(lr=1e-3, eps=STEP_EPS),
                                 n_micro=N_MICRO, zero1=zero1)
    params, state = dryrun.train_meta_state(cfg, ctx, ctx.mesh, zero1)
    rows = STEP_B // ctx.n("data")
    batch = {k: torch.empty((rows, S), dtype=torch.int64, device="meta")
             for k in ("tokens", "labels")}
    for rank, r in enumerate(ranks[name]):
        m = dryrun.measure(step, (params, state, batch), rank=rank)
        assert m["stats"] == r["stats"], (rank, m["stats"], r["stats"])
        assert dryrun._tree_bytes((state.m, state.v)) == r["moment_bytes"]
        assert m["flops"] > 0 and m["temp_bytes"] > 0


def test_zero1_step_is_bit_equal_to_the_replicated_step(ranks):
    """With the grad clip off, the ZeRO-1 step and the replicated step
    (no FSDP) on the same weights and batch give every rank the same bits
    of every parameter: the reduce-scatter's sums over the two data ranks
    are the all-reduce's, and AdamW is elementwise."""
    for z, r in zip(ranks["z1_noclip"], ranks["rep_noclip"]):
        assert z["loss"] == r["loss"]
        got, want = _flat(z["params"]), _flat(r["params"])
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), k


def test_mamba1_channel_parallel_bf16_scan_matches_single_device(ref,
                                                                 ranks):
    """Mamba1 channel-parallel on the (data 2, model 4) mesh (16 of 64
    channels a rank) with ``scan_dtype="bfloat16"``: the loss within
    ``BF16_LOSS_TOL`` of the reference's single device, and every
    gathered gradient within ``BF16_GRAD_RTOL`` of its leaf's largest."""
    results, want = ranks["mamba_bf16"], ref["mamba_bf16"]
    for r in results:
        assert abs(r["loss"] - want["loss"]) < BF16_LOSS_TOL, (
            r["loss"], want["loss"])
    got = _flat(_whole(results, "grads", "mamba_bf16"))
    exp = _flat(want["grads"])
    assert sorted(got) == sorted(exp)
    for k in exp:
        atol = BF16_GRAD_RTOL * float(np.abs(exp[k]).max())
        np.testing.assert_allclose(got[k], exp[k], rtol=0, atol=atol,
                                   err_msg=k)


def test_vlm_image_embeddings_under_a_context(ref, ranks):
    """A vlm's ``img_embeds`` arrive as each data rank's rows, ahead of its
    text; the loss (image positions masked) and the gradients against the
    single device, with FSDP on (data 2, model 4)."""
    _check_grad_case(ranks["vlm"], ref["vlm"], "vlm")


def test_shard_params_and_gather_params_are_inverse():
    """``shard_params`` cuts each rank's blocks under ``tree_pspecs`` (the
    reference's placement), ``gather_params`` puts them back bit for bit;
    ranks that disagree on a replicated block are refused."""
    from repro_torch.models import transformer as tr
    cfg, ctx = _ctx("moe")
    whole = tr.init_params(cfg, seed=7, device="cpu")
    blocks = [sh.shard_params(whole, cfg, ctx, r) for r in range(8)]
    assert blocks[0]["tok_embed"].shape == (256 // 4, 64 // 2)
    assert blocks[0]["layers"]["e_gate"].shape == (2, 8 // 4, 64, 96 // 2)
    back = sh.gather_params(blocks, cfg, ctx)
    for k, v in _flat(whole).items():
        assert np.array_equal(_flat(back)[k], v), k
    blocks[3]["final_norm"] = blocks[3]["final_norm"] + 1
    with pytest.raises(ValueError, match="disagree"):
        sh.gather_params(blocks, cfg, ctx)


def test_shard_batch_keeps_the_reference_microbatches():
    """Under ``n_micro`` microbatches each data rank holds, of every
    microbatch of consecutive rows, its block: the data ranks' microbatch
    ``j`` together is the reference's."""
    mesh = Mesh(np.asarray(RANKS), ("data", "model"))
    ctx = sh.ShardCtx(mesh=mesh, dp=("data",), tp="model")
    rows = np.arange(8)[:, None] * np.ones((1, 3), np.int64)
    got = {r: steps.shard_batch({"t": rows}, ctx, r, 2)["t"][:, 0]
           for r in range(8)}
    for r, c in ((r, mesh.coords(r)) for r in range(8)):
        want = [0, 1, 4, 5] if c["data"] == 0 else [2, 3, 6, 7]
        assert got[r].tolist() == want, (r, c)


# ---------------------------------------------------------------------------
# the kernel's q_offset: its plain versions against the reference
# ---------------------------------------------------------------------------

#: (b, h, kv, sq, sk, d, window, q_offset): a share of rows against the keys
#: up to its last one (the model's call), against a longer K, a window
#: across the offset, and GQA
OFFSET_CASES = [(2, 4, 4, 8, 32, 16, 0, 24), (1, 4, 2, 8, 16, 16, 0, 8),
                (2, 2, 1, 12, 40, 8, 0, 12), (1, 4, 2, 8, 24, 16, 6, 16),
                (1, 2, 2, 16, 16, 8, 0, 0)]


def _jax():
    import jax
    import jax.numpy as jnp
    from repro.models.attention import chunked_attention
    return jax, jnp, chunked_attention


@pytest.mark.parametrize("case", OFFSET_CASES)
def test_q_offset_plain_forward_matches_chunked_attention(case):
    """``flash_attention_ref(q_offset=)`` (and the CPU wrapper) against the
    reference's ``chunked_attention(q_offset=)`` in float32."""
    jax, jnp, chunked = _jax()
    b, h, kv, sq, sk, d, window, off = case
    rng = np.random.default_rng(sum(case))
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    want = np.asarray(chunked(q, k, v, causal=True, window=window,
                              q_offset=off, chunk_q=4, chunk_k=8))
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    for fn in (fa.flash_attention_ref, fa.flash_attention):
        got = fn(tq, tk, tv, causal=True, window=window, q_offset=off)
        np.testing.assert_allclose(got.transpose(1, 2).numpy(), want,
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", OFFSET_CASES)
def test_q_offset_plain_backward_matches_vjp(case):
    """``flash_attention_bwd_ref(q_offset=)`` and ``FlashAttentionFn``'s
    gradient on the CPU against ``jax.vjp`` of the reference's
    ``chunked_attention(q_offset=)``."""
    jax, jnp, chunked = _jax()
    b, h, kv, sq, sk, d, window, off = case
    rng = np.random.default_rng(sum(case) + 1)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d), (b, sq, h, d)))
    _, vjp = jax.vjp(lambda a, c, e: chunked(
        a, c, e, causal=True, window=window, q_offset=off, chunk_q=4,
        chunk_k=8), q, k, v)
    want = [np.asarray(g) for g in vjp(do)]
    tq, tk, tv, tdo = (torch.from_numpy(a).transpose(1, 2)
                       for a in (q, k, v, do))
    out, lse = fa.flash_attention_ref(tq, tk, tv, window=window,
                                      return_lse=True, q_offset=off)
    got = fa.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo,
                                     window=window, q_offset=off)
    leaves = [t.detach().requires_grad_() for t in (tq, tk, tv)]
    fn_out = fa.FlashAttentionFn.apply(*leaves, True, window, off)
    by_fn = torch.autograd.grad(fn_out, leaves, tdo)
    for g, f, w in zip(got, by_fn, want):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), w, rtol=1e-4,
                                   atol=1e-5)
        assert torch.equal(g, f)

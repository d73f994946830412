"""The Mamba families under an active ``ShardCtx`` (Mamba1 channel-
parallel, Mamba2 head-parallel with the hybrid's weight-tied attention
block) against the JAX package's single-device loss, gradients and train
steps, across processes.

As in ``tests/test_torch_tensor_parallel.py``: every case runs the port
on a ``(data, model)`` mesh of ``gloo`` ranks (one spawn of four; the rank
body is ``tests/torch_dist_workers.py::tp_model_case``), each rank on its
blocks of the reference's weights and its rows of the batch; the
reference's ``jax.value_and_grad`` and ``make_train_step`` run once, in
one subprocess on one device with ``ShardCtx()``, while the ranks run.

The meshes: a permuted (data 2, model 2) with FSDP over data, a (data 1,
model 4) without, and a (data 1, model 3) on three of the four ranks.
The stored cut of the packed ``in_proj`` never matches a rank's channels:
at tp 2 Mamba1's rank 0 holds all of ``x`` and rank 1 all of ``z``, at tp
3 the middle rank's block straddles the ``x``/``z`` boundary, and
Mamba2's packed ``z‖x‖B‖C‖dt`` (width 296) is cut at 148 (tp 2) and at
74, 148, 222 (tp 4), inside a head each time; its convolution's ``di +
2N`` channels are cut out of line with the heads too.  At tp 3 the
hybrid's 8 SSD heads do not divide the axis, and its Mamba2 layers run
replicated, every weight whole; a narrower hybrid's 6 heads do, but its
packed width (230) does not, so its ``in_proj`` is stored whole and each
rank takes its heads from the whole packed activation.

Tolerances (float32): the loss within 1e-5 (Mamba1) or, for the hybrid,
within ``tests/test_torch_train.py``'s ``LOSS_TOL * (1 + loss)``: the
one-process port's SSD sums in another order than XLA's, and its loss is
already 1.05e-5 from the reference's on ``hybrid_fsdp``'s weights and
batch (the ranks reproduce the one-process port's loss to the last bit
there); every gathered gradient within
``GRAD_RTOL`` of itself plus ``GRAD_ATOL`` of the leaf's largest; a
parameter after one AdamW step within ``STEP_ATOL`` (the tensor-parallel
file's, for the same reasons: the row-parallel sums and the gated norm's
split statistic add in another order, and the head rounds its input to
bfloat16 in both packages).
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_workers as W
from test_torch_tensor_parallel import (GRAD_ATOL, GRAD_RTOL, REFERENCE,
                                        SRC, STEP_ATOL, STEP_EPS, _flat,
                                        _params)
from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import Mesh
from repro_torch.models import sharding as sh
from repro_torch.models.config import ModelConfig

SPAWN_S = 300.0
#: ``tests/test_torch_train.py``'s loss tolerance of the one-process port
LOSS_TOL = 1e-4
R22 = np.asarray([[3, 0], [1, 2]])
R14 = np.asarray([[2, 0, 3, 1]])
R13 = np.asarray([[1, 2, 0]])

MAMBA1 = dict(name="m1", family="ssm", n_layers=3, d_model=64, n_heads=0,
              n_kv_heads=0, d_ff=0, vocab_size=256, ssm_variant="mamba1",
              ssm_state=16, dtype="float32", remat=True)
#: d_inner 96: 192 packed columns, 64 a rank at tp 3
MAMBA1_TP3 = dict(MAMBA1, name="m1t3", d_model=48, remat=False)
HYBRID = dict(name="hyb", family="hybrid", n_layers=4, d_model=64,
              n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
              vocab_size=256, ssm_variant="mamba2", ssm_state=16,
              ssm_head_dim=16, hybrid_attn_period=2, dtype="float32",
              remat=True)
#: d_inner 96: 6 SSD heads, two a rank at tp 3, but the packed width 230
#: does not divide 3, so ``in_proj`` is stored whole and every rank
#: computes the whole packed activation
HYBRID_TP3 = dict(HYBRID, name="hybt3", d_model=48, n_heads=3, n_kv_heads=3,
                  d_ff=96, remat=False)

B, S = 4, 16
STEP_B, N_MICRO = 8, 2


def _batch(rng, kw, b):
    toks = rng.integers(0, kw["vocab_size"], (b, S)).astype(np.int32)
    labels = rng.integers(0, kw["vocab_size"], (b, S)).astype(np.int32)
    labels[rng.random((b, S)) < 0.2] = -1
    return {"tokens": toks, "labels": labels}


def _cases():
    """name -> (config, seed, batch, kind, mesh ranks, fsdp, n_micro)."""
    rng = np.random.default_rng(25)
    return {
        "mamba1_fsdp": (MAMBA1, 0, _batch(rng, MAMBA1, B), "grad", R22,
                        True, 1),
        "mamba1_tp4": (MAMBA1, 1, _batch(rng, MAMBA1, B), "grad", R14,
                       False, 1),
        "mamba1_step": (MAMBA1, 2, _batch(rng, MAMBA1, STEP_B), "step", R22,
                        True, N_MICRO),
        "mamba1_tp3": (MAMBA1_TP3, 3, _batch(rng, MAMBA1_TP3, B), "grad",
                       R13, False, 1),
        "hybrid_fsdp": (HYBRID, 4, _batch(rng, HYBRID, B), "grad", R22,
                        True, 1),
        "hybrid_tp4": (HYBRID, 5, _batch(rng, HYBRID, B), "grad", R14,
                       False, 1),
        "hybrid_step": (HYBRID, 6, _batch(rng, HYBRID, STEP_B), "step", R14,
                        False, N_MICRO),
        "hybrid_tp3": (HYBRID, 7, _batch(rng, HYBRID, B), "grad", R13,
                       False, 1),
        "hybrid_tp3_packed": (HYBRID_TP3, 8, _batch(rng, HYBRID_TP3, B),
                              "grad", R13, False, 1),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference, the ranks' results)``: the reference's single-device
    results from one subprocess, started first, and the spawn while it
    runs."""
    tmp = tmp_path_factory.mktemp("ref")
    cases = _cases()
    params = {n: _params(c[0], c[1]) for n, c in cases.items()}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"cases": {n: (c[0], params[n], c[2], c[3], c[6])
                               for n, c in cases.items()},
                     "eps": STEP_EPS}, f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c",
                             textwrap.dedent(REFERENCE), str(tmp / "in.pkl"),
                             str(tmp / "out.pkl")], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        spec = {name: {"cfg": kw, "ranks": ranks, "fsdp": fsdp,
                       "params": params[name], "batch": batch, "kind": kind,
                       "n_micro": n_micro, "eps": STEP_EPS}
                for name, (kw, _, batch, kind, ranks, fsdp, n_micro)
                in cases.items()}
        results = C.spawn(W.tp_serve_cases, 4, (spec,), timeout=SPAWN_S,
                          threads=1)
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
    # the ranks of each case's mesh, in rank order
    ranks = {name: [r[name] for r in results if r[name] is not None]
             for name in cases}
    return ref, ranks


def _ctx(name):
    kw, _, _, _, ranks, fsdp, _ = _cases()[name]
    mesh = Mesh(ranks, ("data", "model"))
    return ModelConfig(**kw), sh.ShardCtx(
        mesh=mesh, dp=("data",), tp="model", fsdp=("data",) if fsdp else ())


def _whole(results, key, name):
    """The ranks' blocks of ``key`` put together (``gather_params``; the
    results of a case's mesh ranks, in rank order)."""
    cfg, ctx = _ctx(name)

    def to_t(tree):
        if isinstance(tree, dict):
            return {k: to_t(v) for k, v in tree.items()}
        return torch.from_numpy(tree)
    return sh.gather_params([to_t(r[key]) for r in results], cfg, ctx)


def _loss_tol(name, loss):
    """The loss tolerance of a case (the module docstring)."""
    return LOSS_TOL * (1 + abs(loss)) if name.startswith("hybrid") else 1e-5


def _check_grad(ref, ranks, name):
    results, want = ranks[name], ref[name]
    for r in results:
        assert abs(r["loss"] - want["loss"]) < _loss_tol(name, want["loss"]), \
            (name, r["loss"], want["loss"])
        assert r["tokens"] == want["tokens"], name
    got, exp = _flat(_whole(results, "grads", name)), _flat(want["grads"])
    assert sorted(got) == sorted(exp), name
    for k in exp:
        atol = max(2e-5, GRAD_ATOL * float(np.abs(exp[k]).max()))
        np.testing.assert_allclose(got[k], exp[k], rtol=GRAD_RTOL,
                                   atol=atol, err_msg=f"{name} {k}")


def _check_step(ref, ranks, name):
    results, want = ranks[name], ref[name]
    for r in results:
        assert abs(r["loss"] - want["loss"]) < _loss_tol(name, want["loss"]), \
            (name, r["loss"], want["loss"])
    got, exp = _flat(_whole(results, "params", name)), _flat(want["new"])
    assert sorted(got) == sorted(exp), name
    for k in exp:
        np.testing.assert_allclose(got[k], exp[k], rtol=0, atol=STEP_ATOL,
                                   err_msg=f"{name} {k}")
    moved = _flat(want["params"])
    assert max(float(np.abs(exp[k] - moved[k]).max()) for k in exp) > 5e-4


@pytest.mark.parametrize("name", ["mamba1_fsdp", "mamba1_tp4", "mamba1_tp3"])
def test_mamba1_channel_parallel_loss_and_gradients(ref_ranks, name):
    """Mamba1 channel-parallel (remat, masked labels) on (data 2, model 2)
    with FSDP, on (data 1, model 4), and at tp 3, where a stored block of
    the packed ``in_proj`` straddles the ``x``/``z`` boundary: the loss
    and every parameter's gradient, gathered from the ranks' blocks,
    against ``jax.value_and_grad`` of the reference's loss."""
    _check_grad(*ref_ranks, name)


@pytest.mark.parametrize("name", ["hybrid_fsdp", "hybrid_tp4", "hybrid_tp3",
                                  "hybrid_tp3_packed"])
def test_hybrid_head_parallel_loss_and_gradients(ref_ranks, name):
    """The hybrid (Mamba2 head-parallel, its gated norm's statistic summed
    over the model axis, the weight-tied attention + MLP block after
    layers 1 and 3 under the context, its ``shared`` leaves' gradients
    too) on (data 2, model 2) with FSDP, on (data 1, model 4), and at tp
    3, where its 8 SSD heads do not divide the axis and its Mamba2 layers
    run replicated, or where 6 heads do but the packed ``in_proj`` is
    stored whole: the loss and the gathered gradients against the
    reference."""
    _check_grad(*ref_ranks, name)


@pytest.mark.parametrize("name", ["mamba1_step", "hybrid_step"])
def test_train_steps_under_a_context(ref_ranks, name):
    """``make_train_step`` with 2 microbatches (Mamba1 on (data 2, model 2)
    with FSDP, the hybrid on (data 1, model 4)): the loss and every
    parameter after the AdamW update against the reference's
    single-device step."""
    _check_step(*ref_ranks, name)


def test_mamba_paths_move_tensor_parallel_bytes(ref_ranks):
    """The packed activations' gathers and the row-parallel sums count
    under ``tp``, the FSDP gathers under ``fsdp``; the scan's and the
    norms' calls on each rank of the Mamba1 case are those of a layer's
    forward twice (remat) and its final norm."""
    _, ranks = ref_ranks
    for r in ranks["mamba1_fsdp"]:
        assert r["stats"]["tp"] > 0 and r["stats"]["fsdp"] > 0, r["stats"]
        # ln1 a layer, twice under remat, and the final norm
        assert r["calls"]["rmsnorm"]["fwd"] == 2 * MAMBA1["n_layers"] + 1
    for r in ranks["hybrid_tp4"]:
        assert r["stats"]["tp"] > 0 and r["stats"]["fsdp"] == 0, r["stats"]


@pytest.fixture(scope="module")
def ref_ranks(runs):
    return runs


@pytest.mark.parametrize("name", ["mamba1_step", "hybrid_step"])
def test_rank_calls_match_the_chip_phase_count(ref_ranks, name):
    """The forward calls of the norm, attention and scan wrappers on each
    rank of a train step are those that
    ``chip_smoke.tp_mamba_rank_launches`` counts for a rank of
    ``tp_train_mamba_on_card``, whose launch counts the card's kernel
    counters assert (its Mamba1 scan on the rank's channels, its hybrid
    without the gated norm's launch)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    cfg, ctx = _ctx(name)
    rows = STEP_B // ctx.n("data") // N_MICRO
    want, _, _ = chip_smoke.tp_mamba_rank_launches(
        cfg, ctx.n("model"), N_MICRO, 1, (rows, S, cfg.d_model))
    for r in ref_ranks[1][name]:
        got = {k: v["fwd"] for k, v in r["calls"].items()}
        assert got == {k: want[k] for k in got}, (name, got, want)
        assert len(got) == (3 if cfg.family == "ssm" else 2), got


@pytest.mark.parametrize("blocks", [1, 2, 4])
def test_split_gated_norm_matches_the_norm(blocks):
    """Mamba2's gated norm under a context (each block's sum of squares
    summed over the blocks, ``split_gated_norm``) against the one-process
    norm's plain version on the whole rows, float32 input and a bfloat16
    weight, rank-free: within float32 rounding (the sum runs in another
    order)."""
    from repro_torch.kernels.rmsnorm import rmsnorm_ref
    from repro_torch.models.mamba import split_gated_norm
    rng = np.random.default_rng(blocks)
    g = torch.from_numpy(rng.standard_normal((2, 8, 64)).astype(np.float32))
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(64).astype(
        np.float32)).to(torch.bfloat16)
    dl = 64 // blocks
    got = split_gated_norm(torch.stack(g.split(dl, -1)),
                           w.view(blocks, 1, 1, dl), 64, 1e-5,
                           lambda t: t.sum(0, keepdim=True))
    torch.testing.assert_close(torch.cat(list(got), -1),
                               rmsnorm_ref(g, w, 1e-5), rtol=1e-6,
                               atol=1e-6)

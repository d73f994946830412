#!/usr/bin/env python3
"""What the checks of ``chip_smoke.py``'s tensor-parallel phases read on
runs with a fault planted in the ranks, beside the same reading of the
program as it is.

    python3 tools/tp_faults.py [PHASE ...]

Runs on one NVIDIA GPU, from the root of a checkout; with phase names,
only those phases' runs.  Each run spawns four ranks of
``tp_train_gpt_1_1b`` (gpt-1.1b, 8 layers, tp 2 x dp 2 with FSDP, 3
steps), of ``tp_models_on_card``'s gpt-3.1b case (4 layers, model 4: the
sequence-sharded attention, one step), of one case of
``tp_train_mamba_on_card`` (falcon-mamba-7b, 4 layers, tp 2 x dp 2 with
FSDP, or zamba2-7b, 6 layers, model 4; 2 steps) or of one case of
``tp_generate_on_card`` (qwen2-7b or falcon-mamba-7b, 4 layers, (data 2,
model 2), or zamba2-7b, 6 layers, model 4; prefill and 15 teacher-forced
decode steps) with one fault, named in ``TP_FAULT`` in the environment
(the case's model in ``TP_ARCH``), which the spawned ranks inherit and
read when they import this module:

- ``none``: the program as it is;
- ``no_data_sync``: ``steps.sync_grads`` does nothing, so a leaf
  replicated over the data axis keeps its data shard's part of the
  gradient (the step trains on half the batch there);
- ``attn_input_unsummed``: layer 0's attention input enters its heads
  without ``copy_to``, so its gradient lacks the other model ranks' heads;
- ``seq_weights_unsummed`` (gpt-3.1b): the sequence-sharded attention's
  weights enter without ``copy_to``, so each model rank keeps its own
  rows' part of their gradients;
- ``x_proj_unsummed`` (falcon-mamba-7b, trained and generating):
  Mamba1's row-parallel ``x_proj`` output is not summed over the model
  axis, so each rank's ``dt``, ``B`` and ``C`` come from its own
  channels alone;
- ``in_proj_as_channels`` (falcon-mamba-7b): a Mamba1 rank takes the
  column block of the packed ``x‖z`` that its stored ``in_proj`` block
  gives as its channels of ``x`` and ``z`` (its first half as ``x``, its
  second as ``z``) instead of gathering the packed activation;
- ``combine_unscaled`` (qwen2-7b, zamba2-7b): the decode attention's
  combine adds the sequence blocks' partial sums without rescaling each
  by ``e^(m - M)``;
- ``gated_norm_unsummed`` (zamba2-7b, trained and generating): Mamba2's
  gated norm takes its statistic from the rank's own channels, not
  summed over the model axis;
- ``conv_tail_miscut`` (zamba2-7b generating): Mamba2's conv tail, cut
  out of line with the heads, is re-cut to the next model rank's block.

A phase name alone runs each of its models; ``phase:model`` one.
Prints one JSON line a run: for a training phase the step losses
against one process's ``make_train_step`` on the same weights and
batches (run once a model), and, for the parameters and for AdamW's
first moment, what ``chip_smoke.param_readings`` reads of the ranks'
blocks: the leaves on whose blocks the ranks that hold them disagree,
and each leaf's relative error beside its tolerance
(``chip_smoke.TP_UPDATE_TOL``, ``TP_MOMENT_TOL``, or the Mamba phase's
``TPMB_*``); for the generate phase the logits' largest and mean
absolute difference from one process's on the same tokens, beside
their tolerances (``chip_smoke.tpg_tolerance``), and the greedy tokens
that differ with the one process's margin at each, and the largest
distance, in bfloat16 steps, of a decode step's combined attention from
``decode_attention`` over the gathered cache beside its tolerance
(``chip_smoke.CombineWatch``, ``COMBINE_TOL_STEPS``); then
``nvidia-smi``'s name and power limit of the card.  The greedy tokens'
margins stand beside the near-tie margin of ``chip_smoke.tpg_tolerance``.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.launch import collectives as C  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import mamba as MB  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import sharding as sh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TPM_ARCH = "gpt-3.1b"
#: (phase, fault); a Mamba training or a generate run's phase names its
#: model too
RUNS = [("tp_train_gpt_1_1b", f)
        for f in ("none", "no_data_sync", "attn_input_unsummed")] + \
    [(TPM_ARCH, f) for f in ("none", "seq_weights_unsummed")] + \
    [("tp_train_mamba_on_card:falcon-mamba-7b", f)
     for f in ("none", "x_proj_unsummed", "in_proj_as_channels")] + \
    [("tp_train_mamba_on_card:zamba2-7b", f)
     for f in ("none", "gated_norm_unsummed")] + \
    [("tp_generate_on_card:qwen2-7b", f)
     for f in ("none", "combine_unscaled")] + \
    [("tp_generate_on_card:falcon-mamba-7b", f)
     for f in ("none", "x_proj_unsummed")] + \
    [("tp_generate_on_card:zamba2-7b", f)
     for f in ("none", "combine_unscaled", "gated_norm_unsummed",
               "conv_tail_miscut")]
# the spawned ranks run one case of each multi-case phase (a Mamba
# training or a generate run's model is named in TP_ARCH)
cs.TPM_CASES = {TPM_ARCH: cs.TPM_CASES[TPM_ARCH]}
if os.environ.get("TP_ARCH"):
    _arch = os.environ["TP_ARCH"]
    cs.TPMB_CASES = {_arch: cs.TPMB_CASES[_arch]} \
        if _arch in cs.TPMB_CASES else {}
    cs.TPG_CASES = {_arch: cs.TPG_CASES[_arch]} \
        if _arch in cs.TPG_CASES else {}


def combine_unscaled(m, l, o, max_fn, sum_fn, dtype):
    """``combine_partials`` with the ``combine_unscaled`` fault: the
    blocks' partial sums added without rescaling each by ``e^(m - M)``
    (also planted by ``tests/torch_dist_workers.py::tp_serve_case``)."""
    out = sum_fn(o) / sum_fn(l)[..., None]
    b, h, hd = out.shape
    return out.reshape(b, 1, h, hd).to(dtype)


def _plant(fault: str) -> None:
    """Put ``fault`` into this process's modules (see the docstring)."""
    if fault == "none":
        return
    if fault == "no_data_sync":
        steps.sync_grads = lambda grads, cfg, ctx: None
        return
    if fault in ("x_proj_unsummed", "in_proj_as_channels"):
        _plant_mamba1(fault)
        return
    if fault in ("gated_norm_unsummed", "conv_tail_miscut"):
        _plant_mamba2(fault)
        return
    if fault == "combine_unscaled":
        M.combine_partials = combine_unscaled
        return
    if fault not in ("attn_input_unsummed", "seq_weights_unsummed"):
        raise ValueError(f"unknown fault {fault!r}")
    real_attn, real_copy = T._attn_sharded, C.copy_to
    on_input = fault == "attn_input_unsummed"

    def attn(x, p, cfg, ctx, *rest):
        if on_input and p["wq"].storage_offset():     # not layer 0
            return real_attn(x, p, cfg, ctx, *rest)

        def copy_to(t, mesh, axis, kind="tp"):
            if (t is x) == on_input:
                return t
            return real_copy(t, mesh, axis, kind)
        C.copy_to = copy_to
        try:
            return real_attn(x, p, cfg, ctx, *rest)
        finally:
            C.copy_to = real_copy
    T._attn_sharded = attn


def _plant_mamba1(fault: str) -> None:
    """Mamba1's two faults: inside ``_mamba1_sharded`` the model-axis sum
    of ``x_proj``'s output is skipped, or the gather of the packed
    ``x‖z`` is replaced by this rank's column block laid out at its own
    channels (half ``x``, half ``z``)."""
    real_block, real_sum, real_gather = (MB._mamba1_sharded, C.sum_over,
                                         C.gather_over)

    def block(x, p, cfg, ctx, *rest):
        width = cfg.dt_rank + 2 * cfg.ssm_state

        def sum_over(t, mesh, axis, kind="tp"):
            if t.shape[-1] == width:
                return t
            return real_sum(t, mesh, axis, kind)

        def gather_over(t, mesh, axis, dim, kind="fsdp"):
            if kind != "tp":
                return real_gather(t, mesh, axis, dim, kind)
            di, dl = cfg.d_inner, t.shape[-1] // 2
            c0 = sh.coord(ctx, ctx.tp) * dl

            def zeros(n):
                return t.new_zeros(t.shape[:-1] + (n,))
            return torch.cat([zeros(c0), t[..., :dl], zeros(di - dl),
                              t[..., dl:], zeros(di - c0 - dl)], dim=-1)
        if fault == "x_proj_unsummed":
            C.sum_over = sum_over
        else:
            C.gather_over = gather_over
        try:
            return real_block(x, p, cfg, ctx, *rest)
        finally:
            C.sum_over, C.gather_over = real_sum, real_gather
    MB._mamba1_sharded = block


def _plant_mamba2(fault: str) -> None:
    """Mamba2's faults: inside ``_mamba2_sharded`` the gated norm's
    statistic is left unsummed, or the conv tail is cut to the next model
    rank's block (the whole tail rolled by one block first)."""
    if fault == "gated_norm_unsummed":
        real_norm = MB.split_gated_norm
        MB.split_gated_norm = lambda g, w, width, eps, sum_fn: real_norm(
            g, w, width, eps, lambda t: t)
        return
    real_block = MB._conv_block

    def conv_block(whole, cfg, ctx):
        shift = -whole.shape[-1] // ctx.n(ctx.tp)
        return real_block(torch.roll(whole, shift, -1), cfg, ctx)
    MB._conv_block = conv_block


_plant(os.environ.get("TP_FAULT", "none"))


def _summary(rows: dict, tol: float) -> dict:
    """One tree's :func:`chip_smoke.param_readings` beside its
    tolerance."""
    worst = sorted(rows.items(), key=lambda kv: -kv[1]["rel_err"])
    return {"disagreeing_leaves": [n for n, r in rows.items()
                                   if not r["replicas_agree"]],
            "max_rel_err": worst[0][1]["rel_err"], "tol": tol,
            "leaves_over_tol": [n for n, r in worst if r["rel_err"] > tol],
            "rel_err": {n: r["rel_err"] for n, r in worst},
            "max_abs_diff": max(r["max_abs_diff"] for r in rows.values())}


def _spawn(fault: str, fn, args: tuple, timeout: float,
           arch: str = "") -> list:
    os.environ.update(TP_FAULT=fault, TP_ARCH=arch)
    try:
        return C.spawn(fn, 4, args, timeout=timeout)
    finally:
        os.environ.pop("TP_FAULT")
        os.environ.pop("TP_ARCH")


def _train_setup(phase: str) -> tuple:
    """``(cfg, ctx, global batches, n_micro)`` of a training run."""
    if phase == "tp_train_gpt_1_1b":
        cfg = cs.configs.get(cs.PP_ARCH).replace(n_layers=cs.TP_LAYERS)
        conf = cs.Conf(*cs.TP_CONF)
        ctx = cs.ShardCtx(mesh=cs.mesh_from_mapping(
            conf, np.asarray(cs.TP_MAPPING)), dp=("data",), tp="model",
            fsdp=("data",))
        return cfg, ctx, [cs._global_batch(t, lb)
                          for t, lb in cs._pp_batches(cfg, conf)], conf.n_mb
    if phase.startswith("tp_train_mamba_on_card"):
        arch = phase.split(":")[1]
        cfg, _, ctx, n_micro, batches = cs._tpmb_setup(
            arch, cs.TPMB_CASES[arch])
        return cfg, ctx, batches, n_micro
    cfg, _, ctx, batch = cs._tpm_setup(phase, cs.TPM_CASES[phase])
    return cfg, ctx, [batch], 1


def _train_run(phase: str, fault: str, ref, cfg) -> tuple:
    """``(losses, block sums)`` of the ranks of a training run."""
    if phase == "tp_train_gpt_1_1b":
        res = _spawn(fault, cs.tp_rank,
                     (cs.TP_CONF, cs.TP_MAPPING, list(ref[:3])),
                     cs.TP_SPAWN_S)
        # the FSDP run (the ranks go on to the ZeRO-1 layout after it)
        return ([r["fsdp"]["losses"] for r in res],
                [r["fsdp"]["sums"] for r in res])
    if phase.startswith("tp_train_mamba_on_card"):
        arch = phase.split(":")[1]
        res = _spawn(fault, cs.tp_mamba_rank, ({arch: ref[:3]},),
                     cs.TPMB_SPAWN_S, arch)
        got = [r["cases"][arch] for r in res]
        return [r["losses"] for r in got], [r["sums"] for r in got]
    res = _spawn(fault, cs.tp_models_rank, ({phase: ref[:3]},),
                 cs.TPM_SPAWN_S)
    return ([[r["cases"][phase]["loss"]] for r in res],
            [r["cases"][phase]["sums"] for r in res])


def _generate_line(arch: str, fault: str, device) -> dict:
    """One ``tp_generate_on_card`` run of ``arch``: the logits and greedy
    tokens of the ranks against one process's."""
    cfg, _, _, prompt = cs._tpg_setup(arch, cs.TPG_CASES[arch])
    ref = cs._one_process_generate(cfg, prompt, device)
    t0 = time.perf_counter()
    res = _spawn(fault, cs.tp_generate_rank, ({arch: ref},),
                 cs.TPG_SPAWN_S, arch)
    spawn_s = time.perf_counter() - t0
    got = [r["cases"][arch] for r in res]
    reads = [x for r in got for x in r["readings"]]
    tol_max, tol_mean, margin = cs.tpg_tolerance(cfg)
    return {"phase": "tp_generate_on_card", "fault": fault,
            "model": cfg.name,
            "logits_max_abs": max(x["max_abs"] for x in reads),
            "logits_mean_abs": sum(x["sum_abs"] for x in reads)
            / sum(x["n"] for x in reads),
            "tol": {"max_abs": tol_max, "mean_abs": tol_mean},
            "tokens_equal": sum(r["tokens_equal"] for r in got),
            "tokens": sum(r["tokens"] for r in got),
            "token_margins": [m for r in got for m in r["token_margins"]],
            "tie_margin": margin,
            "combine_max_bf16_steps": max(
                (x for r in got for x in r["combine_steps"]), default=None),
            "combine_tol_bf16_steps": cs.COMBINE_TOL_STEPS,
            "spawn_s": spawn_s}


def run(device, phases=None) -> None:
    """Every run of ``RUNS`` (of ``phases``, where given) on ``device``,
    one JSON line each."""
    refs, ref_s = {}, {}
    runs = [r for r in RUNS if not phases or r[0] in phases
            or r[0].split(":")[0] in phases]
    for phase, fault in runs:
        refs = {k: v for k, v in refs.items() if k == phase}
        if phase.startswith("tp_generate_on_card"):
            arch = phase.split(":")[1]
            print(json.dumps(_generate_line(arch, fault, device)),
                  flush=True)
            torch.cuda.ipc_collect()
            torch.cuda.empty_cache()
            continue
        cfg, ctx, batches, n_micro = _train_setup(phase)
        if phase not in refs:
            t0 = time.perf_counter()
            refs[phase] = cs._one_process_run(cfg, batches, device, n_micro,
                                              cs.TRAIN_LR)
            ref_s[phase] = time.perf_counter() - t0
        ref = refs[phase]
        t0 = time.perf_counter()
        losses, sums = _train_run(phase, fault, ref, cfg)
        spawn_s = time.perf_counter() - t0
        got = cs.param_readings(sums, cfg, ctx)
        tols = (cs.TPMB_UPDATE_TOL, cs.TPMB_MOMENT_TOL) \
            if phase.startswith("tp_train_mamba_on_card") else \
            (cs.TP_UPDATE_TOL, cs.TP_MOMENT_TOL)
        line = {"phase": phase, "fault": fault, "model": cfg.name,
                "losses": losses[0],
                "ranks_agree_on_loss": all(x == losses[0] for x in losses),
                "one_process_losses": ref[3],
                "loss_abs_diff": [abs(a - b)
                                  for a, b in zip(losses[0], ref[3])],
                "loss_tol": cs.TP_LOSS_TOL,
                "one_process_s": ref_s[phase], "spawn_s": spawn_s,
                "params": _summary(got["params"], tols[0]),
                "moment": _summary(got["moment"], tols[1])}
        print(json.dumps(line), flush=True)
        del ref
        if (phase, fault) == runs[-1]:
            refs.clear()
        torch.cuda.ipc_collect()        # the ranks' handles are gone
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("tp_faults: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    cs._build.build()
    cs._build.load_library()
    run(torch.device("cuda"), sys.argv[1:])
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

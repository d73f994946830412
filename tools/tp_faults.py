#!/usr/bin/env python3
"""What the checks of ``chip_smoke.py``'s tensor-parallel phases read on
runs with a fault planted in the ranks, beside the same reading of the
program as it is.

    python3 tools/tp_faults.py

Runs on one NVIDIA GPU, from the root of a checkout.  Each run spawns
four ranks of ``tp_train_gpt_1_1b`` (gpt-1.1b, 12 layers, tp 2 x dp 2
with FSDP, 3 steps) or of ``tp_models_on_card``'s gpt-3.1b case (4
layers, model 4: the sequence-sharded attention, one step) with one
fault, named in ``TP_FAULT`` in the environment, which the spawned ranks
inherit and read when they import this module:

- ``none``: the program as it is;
- ``no_data_sync``: ``steps.sync_grads`` does nothing, so a leaf
  replicated over the data axis keeps its data shard's part of the
  gradient (the step trains on half the batch there);
- ``attn_input_unsummed``: layer 0's attention input enters its heads
  without ``copy_to``, so its gradient lacks the other model ranks' heads;
- ``seq_weights_unsummed`` (gpt-3.1b): the sequence-sharded attention's
  weights enter without ``copy_to``, so each model rank keeps its own
  rows' part of their gradients.

Prints one JSON line a run: the step losses against one process's
``make_train_step`` on the same weights and batches (run once a model),
and, for the parameters and for AdamW's first moment, what
``chip_smoke.param_readings`` reads of the ranks' blocks: the leaves on
whose blocks the ranks that hold them disagree, and each leaf's relative
error beside its tolerance (``chip_smoke.TP_UPDATE_TOL``,
``TP_MOMENT_TOL``); then ``nvidia-smi``'s name and power limit of the
card.
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
from repro_torch.models import sharding as sh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TPM_ARCH = "gpt-3.1b"
RUNS = [("tp_train_gpt_1_1b", f)
        for f in ("none", "no_data_sync", "attn_input_unsummed")] + \
    [(TPM_ARCH, f) for f in ("none", "seq_weights_unsummed")]
# the spawned ranks of tp_models_on_card run the gpt-3.1b case only
cs.TPM_CASES = {TPM_ARCH: cs.TPM_CASES[TPM_ARCH]}


def _plant(fault: str) -> None:
    """Put ``fault`` into this process's modules (see the docstring)."""
    if fault == "none":
        return
    if fault == "no_data_sync":
        steps.sync_grads = lambda grads, cfg, ctx: None
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


def _spawn(fault: str, fn, args: tuple, timeout: float) -> list:
    os.environ["TP_FAULT"] = fault
    try:
        return C.spawn(fn, 4, args, timeout=timeout)
    finally:
        os.environ.pop("TP_FAULT")


def run(device) -> None:
    """Every run of ``RUNS`` on ``device``, one JSON line each."""
    refs, ref_s = {}, {}
    for phase, fault in RUNS:
        refs = {k: v for k, v in refs.items() if k == phase}
        if phase == "tp_train_gpt_1_1b":
            cfg = cs.configs.get(cs.PP_ARCH).replace(n_layers=cs.PP_LAYERS)
            conf = cs.Conf(*cs.TP_CONF)
            ctx = cs.ShardCtx(mesh=cs.mesh_from_mapping(
                conf, np.asarray(cs.TP_MAPPING)), dp=("data",), tp="model",
                fsdp=("data",))
            batches = [cs._global_batch(t, lb)
                       for t, lb in cs._pp_batches(cfg, conf)]
            n_micro = conf.n_mb
        else:
            cfg, _, ctx, batch = cs._tpm_setup(phase, cs.TPM_CASES[phase])
            batches, n_micro = [batch], 1
        if phase not in refs:
            t0 = time.perf_counter()
            refs[phase] = cs._one_process_run(cfg, batches, device, n_micro,
                                              cs.TRAIN_LR)
            ref_s[phase] = time.perf_counter() - t0
        ref = refs[phase]
        t0 = time.perf_counter()
        if phase == "tp_train_gpt_1_1b":
            res = _spawn(fault, cs.tp_rank,
                         (cs.TP_CONF, cs.TP_MAPPING, list(ref[:3])),
                         cs.TP_SPAWN_S)
            losses = [r["losses"] for r in res]
            sums = [r["sums"] for r in res]
        else:
            res = _spawn(fault, cs.tp_models_rank, ({phase: ref[:3]},),
                         cs.TPM_SPAWN_S)
            losses = [[r["cases"][phase]["loss"]] for r in res]
            sums = [r["cases"][phase]["sums"] for r in res]
        spawn_s = time.perf_counter() - t0
        got = cs.param_readings(sums, cfg, ctx)
        line = {"phase": phase, "fault": fault, "model": cfg.name,
                "losses": losses[0],
                "ranks_agree_on_loss": all(x == losses[0] for x in losses),
                "one_process_losses": ref[3],
                "loss_abs_diff": [abs(a - b)
                                  for a, b in zip(losses[0], ref[3])],
                "loss_tol": cs.TP_LOSS_TOL,
                "one_process_s": ref_s[phase], "spawn_s": spawn_s,
                "params": _summary(got["params"], cs.TP_UPDATE_TOL),
                "moment": _summary(got["moment"], cs.TP_MOMENT_TOL)}
        print(json.dumps(line), flush=True)
        del ref
        if (phase, fault) == RUNS[-1]:
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
    run(torch.device("cuda"))
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA package on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the package's main paths at full size — the planner
(``Planner.plan``: enumerate, memory prune, profiles, pre-score, simulated-
annealing dedication on the card, and the planner's other entry points:
the live bandwidth probe, the plan server, elastic replanning and the
churn replay), generation (``launch.generate``: prefill and greedy
decode of qwen2-7b, falcon-mamba-7b, granite-moe-3b-a800m,
llava-next-mistral-7b, musicgen-large and the hybrid zamba2-7b) and
training (``launch.train``: qwen2-7b at full width and 1 layer,
falcon-mamba-7b, granite-moe-3b-a800m and gpt-1.1b at 2, zamba2-7b at 12,
each with a crash and a resume), pipeline-parallel training (``launch.pp_step``:
gpt-1.1b at 8 layers, pp 2 x dp 2, four ranks on the card), and
tensor-parallel training, prefill and decode under a ``ShardCtx`` (four
ranks on the card), and the four examples of ``examples/torch`` as a user
runs them — builds the
CUDA kernels from the sources in this checkout, holds each kernel against
its plain PyTorch version, and proves that each path went through its
kernels by their launch counts.  Needs a CUDA device and ``nvcc``; exits
non-zero without them.  Every phase prints one JSON line; any mismatch is a
failed assertion (non-zero exit, no final line).

Phases: ``env`` (with the SM count and maximum SM clock that set the
exponentials' rate of the scan's bound), ``build`` (with the ``ptxas``
report: the bfloat16 D=128 attention instance must not spill, the scan's
registers and spills per instance — plain, fused, and fused_bound, the
training forward that keeps the chunk boundaries, and the bfloat16
working type's forward (both instances) and backward — none of which may
spill, the registers and spills of the bfloat16 attention backward's
three passes at every head dim, none of which may spill at D=128, every
bfloat16 attention instance's registers, spills, dynamic shared memory
and blocks an SM (no spill at the head dims 96, 112, 136), the
registers, spills and dynamic shared memory of the scan backward's two
launches in both types, the bfloat16 one (the training path's) without a
spill and holding 4 blocks an SM, and the cost
of reading the stream handle and the device index both ways), ``kernels``
(group-reduce kernels
bit-equal at ragged shapes, both forms of ``group_min_scale`` and of
``group_max``), ``plan_uniform``
(gpt-3.1b on 128 GPUs, estimator fitted on the card), ``plan_tiered``
(gpt-11.1b on a 1024-GPU mixed fleet, hierarchical search), ``probe``
(``profile_bandwidth_live()`` on the visible cards: 1x1 ``inf`` on one),
``serve_plan`` (plan_uniform's request through an in-process
``PlanServer`` and ``PlanClient``: miss, then a hit with the same bytes
at least 10x faster, three concurrent submits coalesced into one search,
the verifier, byte-equal to the NumPy backend's), ``replan``
(``replan_on`` the tiered fleet after node 5 is replaced: warm never
worse than cold and cheaper, byte-equal to the NumPy backend's),
``churn`` (``simulate_churn`` over four seeded events on the 128-GPU
cluster, its report equal to the NumPy backend's; the four phases under
60 s in all), ``examples_on_card`` (``examples/torch``: quickstart's
``run`` as ``main`` calls it, ``train_gpt --full`` straight and with a
crash at step 40 and ``--resume`` in a temporary directory — the final
checkpoint and the logged losses bit-equal —, elastic_failover's ``run``
— the restored state bit-equal to the saved — and configure_cluster on
``mid-range`` — its estimator fitted in 12,000 steps on the card, the
five strategies' table —; every plan made under iteration-bound budgets
and byte-equal to the host NumPy backend's; each example's wall seconds,
launches by kernel and printed lines; the SA budgets and the steps cut
to stay within 120 s, named on the line), ``kernels_at_path_shapes``,
``model_kernels`` (rmsnorm in both forms, flash_attention,
selective_scan in both forms — the fused one over a sequence and as a
decode step — against their plain versions at ragged shapes, float32
and bfloat16, and the tensor-core attention at 2048 keys and D=256; a
misaligned bfloat16 view is refused), ``model_kernels_bwd``
(the backward kernels of rmsnorm, both forms with and without the
stream's gradient, and of flash_attention, causal and windowed, GQA,
``Sq != Sk``, rows with no allowed key, strided views, against their plain
versions in float32 and bfloat16, with the forward's ``lse``, the bfloat16
attention backward launched twice for the same bits; the fused scan's
backward with and without ``h0`` and ``dh_final``, S no multiple of its
chunk, D no multiple of its block, N in 1, 5, 7, 16, launched twice for
the same bits in both types, fed by the forward kernel's chunk
boundaries, which are held to the plain walk's, and the forward's outputs
bit-equal to the generation instance's; each plain
backward against autograd of its plain forward; each autograd Function by
finite differences in float32; the refusal of a gradient by the scan's
decode step and its plain form), ``kernels_at_new_head_dims`` (the
attention at head dims 96, 112 and 136, forward and backward, both types:
gpt-1.1b's, kimi-k2-1t-a32b's and gpt-11.1b's training shapes checked and
timed beside SDPA, and ragged cases, each with its kernel launches),
``flash_vs_chunked_attention`` (the attention kernel in both types
against the port's ``chunked_attention``, float32 plain torch, at
zamba2-7b's prefill and at a sliding window: an oracle written apart
from the kernel's plain version), ``kernels_with_q_offset`` (the
attention with a query offset, forward and backward in both types, at
ragged offsets against its plain versions, and at gpt-3.1b's shares
against ``chunked_attention(q_offset=)``), ``scan_at_falcon_shapes``
(the plain-form scan at falcon-mamba-7b's prefill shape in both types, and
the fused form at its prefill and step shapes in float32, checked and
timed), ``scan_by_batch`` (the plain form at that prefill shape with batch
1, 4 and 16, beside the warps an SM holds at each), ``generate_qwen2_7b``,
``generate_falcon_mamba_7b``, ``generate_granite_moe_3b_a800m``,
``generate_llava_next_mistral_7b`` (2,880 image embeddings and 8 text
tokens, the reference's prompt at 512), ``generate_musicgen_large`` and
``generate_zamba2_7b`` (81 Mamba2 layers, the weight-tied attention block
after 13 of them) (full width and depth, batch 4, prompt 512, 32 tokens,
weights from a seeded generator on the card; exact launch counts, the
prefill's one attention shape, the split of plain, residual and — for
the hybrid — gated norms, and falcon's scans all in the fused form: one a
layer per prefill and per step), ``slice_check_*`` (qwen2-7b,
falcon-mamba-7b, granite-moe-3b-a800m — in float32 and at a capacity that
drops nothing —, gpt-1.1b and zamba2-7b — its shared block's period cut
to the slice — at full width and 2 layers: the card's prefill logits
against the host's, and the first decode step against ``forward_logits``
at the next position), ``ssd_at_zamba2_shapes`` (CUDA-event times of the
plain-torch SSD and of a whole Mamba2 block at zamba2-7b's prefill and
step),
``train_qwen2_7b`` (``launch.train.train``: qwen2-7b at
full width and 1 of its 28 layers — the one cut — bf16, remat, random
weights from a seeded generator on the card, ``SyntheticCorpus`` batches
of 4 x 512 in 2 microbatches, AdamW on the reference's cosine schedule, 4
steps (the uninterrupted and the resumed run saving no checkpoint); exact
forward and backward launch counts
of both norm forms and of the attention; then a run that fails at step 3
and its resume from the step-2 checkpoint, which must give the same losses
and final parameters bit for bit), ``slice_check_train`` (qwen2-7b at full
width and 1 layer, 1 x 64 tokens: a step's loss and every leaf's gradient
on the card against the host's plain path), ``train_falcon_mamba_7b`` and
``slice_check_train_falcon_mamba_7b`` (the same two for falcon-mamba-7b:
2 of its 64 layers; the fused scan forward twice a layer, in its instance
that keeps the chunk boundaries, and its backward kernel once, both norm
forms, counted exactly), ``train_granite_moe_3b_a800m`` and
``train_gpt_1_1b`` with their ``slice_check_train_*`` (the same for
granite-moe-3b-a800m, 2 of 32 layers, its slice in float32, gpt-1.1b,
2 of 24 layers, head dim 96, and zamba2-7b, 12 of 81 layers so that the
shared block runs twice, its slice at 1 layer with the block after it),
``pp_train_gpt_1_1b`` (a Pipette configuration launched as ranks:
gpt-1.1b at full width and 8 of 24 layers, pp 2 x dp 2 over the permuted
mapping ``[[[1, 3]], [[0, 2]]]`` through ``mesh_from_mapping``, four
processes on the card in a ``gloo`` group, ``make_pp_train_step`` for 3
AdamW steps of 8 x 512 tokens in 4 microbatches; each rank's coordinates,
layers and groups held to the mapping and its launches to
:func:`pp_rank_launches`; each rank stores its stage whole, its FSDP
block of the shared leaves and ZeRO-1 blocks of the moments, its stored
bytes asserted against ``specs.shard_sizes``; then the same at pp 1 x
dp 2, two processes, whose losses and every layer's parameters must be
bit-equal), ``tp_train_gpt_1_1b`` (the same model, weights and batches
at (pp 1, tp 2, dp 2) over the mapping ``[[[3, 1], [0, 2]]]``: the
model under an active ``ShardCtx`` through ``make_train_step`` in four
processes on the card, 3 steps with FSDP and then 3 with ZeRO-1
(``zero1=True``: moments as data-axis blocks, stored bytes asserted),
each held to one process's run within the stated tolerances, launches
against :func:`tp_rank_launches`, bytes by kind), ``dryrun_vs_card``
(``launch/dryrun.py`` on meta tensors of exactly those layouts: each
rank's collective bytes by kind and stored bytes must equal what the
rank counted; the dry peak and FLOPs beside the card's), ``tp_models_on_card`` (gpt-3.1b's sequence-sharded attention on
(data 1, model 4) and granite-moe-3b-a800m's expert-parallel MoE in
float32 on (data 2, model 2) with FSDP, 4 layers each, one step each
against one process), ``tp_train_mamba_on_card`` (falcon-mamba-7b's
channel-parallel Mamba1 at 4 layers for Conf(pp 1, tp 2, dp 2, bs_micro
2, bs_global 8) over a permuted mapping with FSDP, and zamba2-7b's
head-parallel Mamba2 and weight-tied block at 6 layers on (data 1, model
4), 2 steps each against one process, launches against
:func:`tp_mamba_rank_launches`), ``tp_generate_on_card`` (prefill of 4 x
512 and 15 decode steps under a context of qwen2-7b and falcon-mamba-7b
on (data 2, model 2), gpt-3.1b and zamba2-7b on (data 1, model 4), the
cache's sequence cut over the model axis and the partial attentions
combined, teacher-forced on one process's greedy tokens and held to its
logits; each decode step's combined attention held to
``decode_attention`` over the gathered cache within one bfloat16 step,
:class:`CombineWatch`; launches against :func:`tp_generate_launches`),
``model_kernels_at_path_shapes`` (the training
phases' forward shapes too, the attention's query offsets among them,
timed beside SDPA with a boolean mask), ``bwd_kernels_at_path_shapes``,
``bwd_attention_full_grid`` (the bfloat16 attention backward at qwen2-7b's
heads and 2048 tokens, where its grid fills the card; off the main path)
and ``host_cost`` (host
microseconds of one call of each redesigned wrapper and of its library
call); with ``--profile`` also ``profile_sa``, ``profile_generate_*``
(qwen2-7b, falcon-mamba-7b, granite-moe-3b-a800m, zamba2-7b),
``profile_train`` and
``profile_train_*`` of the other trained archs (torch.profiler: device
busy and idle share).  ``scan_bf16_on_card`` (after the scan's
phases) holds the bfloat16 working type's forward and backward kernels
(``scan_dtype="bfloat16"``) against their plain versions at
falcon-mamba-7b's prefill and training shapes and at ragged ones, their
bits under relaunch and CUDA-graph replay, and prints the gap a
sequential bfloat16 prefix (the wrong order) leaves against the
reference's tree; ``generate_falcon_mamba_7b_scan_bf16``,
``train_falcon_mamba_7b_scan_bf16`` (no crash and resume) and
``slice_check_train_falcon_mamba_7b_scan_bf16`` drive that working type
through ``generate`` and ``train`` beside the float32 figures.
Each plan is made twice — SA on the card
(``backend="torch"``) and on the host (``backend="numpy"``) — and the two
Plan JSONs must be byte-equal once the backend's name is dropped.  The
wrappers record every input shape the main paths hand them; the path-shape
phases check the kernels and take their times at exactly those shapes.
The forms that fuse their callers' ATen operations are timed beside
``unfused_ms``, the sequence each replaces: the gather form of
``group_min_scale`` (gather, sub-form kernel, ``amax``, ``clamp_min``), the
gather form of ``group_max`` (gather, row-max kernel, multiply, ``amax``),
the residual form of ``rmsnorm`` (an ATen add, then the plain form) and
the fused scan (ATen's bias add, softplus and ``-exp(A_log)``, the plain
form's kernel or, for a step, ATen's one-step update and the copy into the
cache row, then the D skip, the gate and the cast).
Then one ``{"kernels": [...]}`` line for all five kernels, the training
forward of the scan (``selective_scan_fused_bound``, its instance that
keeps the chunk boundaries, beside the generation instance on the same
inputs), the bfloat16 working type's forward
(``selective_scan_fused_bf16``) and the four backward kernels (the
bfloat16 working type's ``selective_scan_fused_bf16_bwd`` among them)
(after a ``run`` line with the whole run's seconds; each new phase
prints its own), the ``nvidia-smi`` line, and the final ``{"ok": true,
...}`` line.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import (MID_RANGE, Budget, PipetteStrategy,  # noqa: E402
                              Planner, PlanRequest, SearchSpace, Workload,
                              enumerate_confs, fit_memory_estimator,
                              ground_truth_memory, mape, mixed_fleet_spec,
                              profile_bandwidth)
from repro_torch.analysis import verify_plan_dict  # noqa: E402
from repro_torch.core.cluster import (A100_TIER, V100_TIER,  # noqa: E402
                                      profile_bandwidth_live)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import group_reduce as gr  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import selective_scan as ss  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.core import Conf  # noqa: E402
from repro_torch.launch import collectives  # noqa: E402
from repro_torch.launch import generate as gen_cli  # noqa: E402
from repro_torch.launch.mesh import mesh_from_mapping  # noqa: E402
from repro_torch.launch.pp_step import (init_pp_state,  # noqa: E402
                                        make_pp_train_step,
                                        shard_pp_params)
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.launch import steps as train_steps  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import silu  # noqa: E402
from repro_torch.models.sharding import ShardCtx  # noqa: E402
from repro_torch.models.transformer import (ATTENTION_FAMILIES,  # noqa: E402
                                            init_params, layer_plan)
from repro_torch.runtime.churn import (WARM_POLICY, generate_trace,  # noqa: E402
                                       simulate_churn)
from repro_torch.runtime.elastic import replan_on  # noqa: E402
from repro_torch.service import PlanClient, PlanServer  # noqa: E402

#: Published peaks of one H100 SXM used for the bounds: device-memory rate;
#: the non-tensor-core float32 rate (also an upper bound on the rate of the
#: float64 comparisons, so that operations bound is, if anything, low); and
#: the dense bfloat16 tensor-core rate, for products on bfloat16 inputs.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
#: Exponentials a clock on one SM (the special function units: 16 a clock
#: on compute capability 9.0, CUDA programming guide's throughput table);
#: the rate of the card is this times its SMs and its maximum SM clock,
#: both read in ``main`` (``EXP_PER_S``).
EXP_PER_SM_CLOCK = 16
EXP_PER_S = None
#: Per-SM limits of compute capability 9.0 (CUDA programming guide's table
#: of technical specifications) that set how many blocks of a kernel an SM
#: holds, with its shared memory per SM read from the device: 32-bit
#: registers, allocated to a warp in units of 256; shared memory the system
#: keeps per block; blocks; threads.
REGS_PER_SM, REG_UNIT, SMEM_PER_BLOCK_RESERVED = 65536, 256, 1024
BLOCKS_PER_SM, THREADS_PER_SM = 32, 2048

#: Ragged shapes (groups or rows, m) checked besides the main path's own,
#: which are not listed here: the wrappers record every shape the two plan
#: phases hand them, and the kernels are checked and timed at exactly those.
RAGGED_MIN_SCALE = [(1, 2), (7, 4), (130, 2)]
RAGGED_MAX = [(1, 3), (9, 16), (257, 8)]
#: Ragged gather-form cases (rows, tp, cp, width): TP and CP groups,
#: m in {2, 4, 8, 16}.
RAGGED_GATHER = [(1, 2, 1, 6), (7, 4, 1, 28), (3, 1, 16, 48),
                 (130, 2, 4, 64), (9, 8, 2, 32)]
#: Ragged gather-form cases of ``group_max`` (rows, pp, nc): one stage,
#: more stages than warps in a block, more members than lanes.
RAGGED_MAX_GATHER = [(1, 1, 3), (3, 3, 16), (5, 40, 3), (4, 2, 512),
                     (257, 1, 8)]
#: ``group_max`` launches of ``plan_tiered`` (all of the gather form): one
#: per tiered score of its hierarchical search.
TIERED_GROUP_MAX_LAUNCHES = 63
#: SA iterations a candidate of each replan of the ``churn`` phase: each
#: replan anneals every surviving candidate (about 180 at 120-128 GPUs,
#: in some 30 shape groups), 3-4.5 s a replan at 50 on the card's host.
CHURN_SA_ITERS = 20
#: The four phases of the planner's other entry points share this limit.
OTHER_ENTRY_POINTS_S = 60.0
WRAPPERS = {
    "group_min_scale": gr.group_min_scale,
    "group_max": gr.group_max,
    "rmsnorm": rn.rmsnorm,
    "flash_attention": fa.flash_attention,
    "selective_scan": ss.selective_scan,
}
KERNELS = {
    "group_min_scale": "src/repro/kernels/group_reduce.py:60",
    "group_max": "src/repro/kernels/group_reduce.py:99",
    "rmsnorm": "src/repro/kernels/rmsnorm.py:25",
    "flash_attention": "src/repro/kernels/flash_attention.py:70",
    "selective_scan": "src/repro/kernels/selective_scan.py:50",
}
SOURCES = {
    "group_min_scale": "src/repro_torch/kernels/csrc/group_reduce.cu",
    "group_max": "src/repro_torch/kernels/csrc/group_reduce.cu",
    "rmsnorm": "src/repro_torch/kernels/csrc/rmsnorm.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "selective_scan": "src/repro_torch/kernels/csrc/selective_scan.cu",
}
PLAN_KERNELS = ("group_min_scale", "group_max")
MODEL_KERNELS = ("rmsnorm", "flash_attention", "selective_scan")
#: The backward kernels (no TPU counterpart: the JAX package differentiates
#: its plain jnp by autodiff), by the wrapper whose ``bwd_launches`` counts
#: them.
BWD_KERNELS = {"rmsnorm_bwd": "rmsnorm",
               "flash_attention_bwd": "flash_attention",
               "selective_scan_fused_bwd": "selective_scan"}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
        if hasattr(fn, "bwd_launches"):
            fn.bwd_launches = 0
        fn.shapes.clear()


def read_launches() -> dict:
    """Per kernel, its forward launches since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def read_bwd_launches() -> dict:
    """Per backward kernel, its launches since the last reset."""
    return {name: WRAPPERS[w].bwd_launches for name, w in BWD_KERNELS.items()}


def is_bwd_key(key) -> bool:
    """Whether a wrapper's shape key counts a backward launch."""
    return isinstance(key, tuple) and bool(key) and key[0] in (
        "bwd", "add_bwd", "fused_bwd", "fused_bf16_bwd")


def read_shapes() -> dict:
    """Per kernel, {input shape key: launches} since the last reset."""
    return {name: dict(fn.shapes) for name, fn in WRAPPERS.items()}


# ---------------------------------------------------------------------------
# kernels: bit-equality and timing
# ---------------------------------------------------------------------------

def random_sub(rng, shape):
    """Gathered bandwidth sub-matrices ``(..., m, m)`` as the engine makes
    them: self links ``inf``, one degenerate ``0.0`` link, one all-``inf``
    group."""
    m = shape[-1]
    n = int(np.prod(shape[:-2]))
    sub = rng.uniform(0.5, 300.0, size=(n, m, m)) * 1e9
    di = np.arange(m)
    sub[:, di, di] = np.inf                  # self links masked upstream
    sub[rng.integers(n), 0, min(1, m - 1)] = 0.0   # a degenerate link
    if n > 2:
        sub[1] = np.inf                      # an all-inf group
    return sub.reshape(shape)


def make_input(name, shape, dtype, device):
    rng = np.random.default_rng(sum(shape) * 31 + len(shape))
    x = (random_sub(rng, shape) if name == "group_min_scale"
         else rng.uniform(1.0, 3.0, size=shape))
    return torch.from_numpy(x).to(dtype).to(device)


REF_BW = 25e9
CALLS = {
    "group_min_scale": (lambda x: gr.group_min_scale(x, REF_BW),
                        lambda x: gr.group_min_scale_ref(x, REF_BW),
                        lambda x: torch.amin(x, dim=(-2, -1)), 2),
    "group_max": (gr.group_max, gr.group_max_ref,
                  lambda x: torch.amax(x, dim=-1), 1),
}


def time_ms(fn, reps: int = 200) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back calls,
    by CUDA events, after a warm-up.  Inputs that fit (the group reduces'
    few MB, the attention and norm inputs of the generate path) stay in the
    50 MB L2 cache between calls — as they are for their callers, which
    made them just before.  ``reps=0`` picks the count that fills about
    0.3 s (3 to 200 calls)."""
    for _ in range(3 if reps == 0 else 10):
        fn()
    torch.cuda.synchronize()
    if reps == 0:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        reps = int(min(200, max(3, 0.3 / max(time.perf_counter() - t0,
                                              1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: Rounds of each comparison of times (a kernel against its plain version,
#: its library call and the sequence it replaced; a wrapper's host time
#: against its library call's).
ROUNDS = 5


def interleaved(measure, fns: dict, rounds: int = ROUNDS) -> dict:
    """``{name: median of rounds measure(fn) values}``, the functions taken
    in turns (the order reversed every other round), so that a drift in
    the shared host's speed falls on all of them alike."""
    got = {name: [] for name in fns}
    names = list(fns)
    for i in range(rounds):
        for name in (names if i % 2 == 0 else names[::-1]):
            got[name].append(measure(fns[name]))
    return {name: float(np.median(v)) for name, v in got.items()}


def device_ms(fn, reps: int = 50, replays: int = 5) -> float:
    """Mean milliseconds of one ``fn()`` on the device alone: ``reps`` calls
    are captured into a CUDA graph and the replay is timed, so the host's
    share of a wrapper call (argument checks, ``ctypes``, the allocator)
    is left out.  ``ms`` minus this is what the host adds per call."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def bound(x: torch.Tensor, n_out: int) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate (each
    input read once, each output written once) and comparisons over the
    operation rate."""
    t_bytes = (x.numel() + n_out) * x.element_size() / HBM_BYTES_PER_S
    t_ops = x.numel() / OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_kernel(name, shape, device, timed: bool) -> dict:
    """Kernel vs plain version at one input shape, bit-equal in both
    dtypes; with ``timed``, also the float64 times and the bound."""
    kernel, plain, library, n_reduced = CALLS[name]
    for dtype in (torch.float32, torch.float64):
        x = make_input(name, shape, dtype, device)
        got = kernel(x)
        torch.cuda.synchronize()
        want = plain(x)
        assert got.shape == tuple(shape[:-n_reduced]) and got.dtype == dtype
        assert torch.equal(got, want), (name, shape, dtype)
    row = {"name": name, "shape": list(shape), "bit_equal": True,
           "max_abs_err": float((got - want).abs().max())}
    if timed:
        b_ms, b_by = bound(x, got.numel())
        row.update(**interleaved(time_ms, {
            "ms": lambda: kernel(x), "plain_ms": lambda: plain(x),
            "library_ms": lambda: library(x)}),
            device_ms=device_ms(lambda: kernel(x)),
            bound_ms=b_ms, bound_by=b_by)
    return row


def gather_key(rows: int, tp: int, cp: int, width: int) -> tuple:
    """``group_min_scale.shapes`` key of a gather-form call on the TP
    (``cp == 1``) or CP groups of ``(rows, width)`` permutations."""
    geom = gr.tp_geometry(tp) if cp == 1 else gr.cp_geometry(tp, cp)
    return ("gather", rows, width, width) + geom


def gather_inputs(key: tuple, dtype, device) -> tuple:
    """``(table, perm)`` for one gather-form key: a bandwidth table as the
    engine has it (self links ``inf``, one degenerate ``0.0`` link) and
    random permutation rows."""
    _, rows, width, n_tab = key[:4]
    rng = np.random.default_rng(zlib.crc32(repr(key).encode()))
    table = rng.uniform(0.5, 300.0, size=(n_tab, n_tab)) * 1e9
    np.fill_diagonal(table, np.inf)
    table[0, 1] = table[1, 0] = 0.0
    perm = np.stack([rng.permutation(n_tab)[:width] for _ in range(rows)])
    return (torch.from_numpy(table).to(dtype).to(device),
            torch.from_numpy(perm).to(device))


def gather_bound(key: tuple, table, perm) -> tuple:
    """(bound_ms, bound_by) of one gather-form call: the permutation and
    the distinct table entries these rows read, each read once, the output
    written once; one comparison per gathered entry."""
    _, rows, width, n_tab, m = key[:5]
    pos = gr.group_positions(width, *key[4:]).numpy()
    g = perm.cpu().numpy()[:, pos]
    entries = np.unique(g[:, :, :, None] * n_tab + g[:, :, None, :]).size
    t_bytes = (perm.numel() * perm.element_size()
               + (entries + rows) * table.element_size()) / HBM_BYTES_PER_S
    t_ops = g.size * m / OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_gather(key: tuple, device, timed: bool) -> dict:
    """The gather form against its plain version, bit-equal in both dtypes;
    with ``timed`` also the float64 times: the wrapper (``ms``), the device
    alone (``device_ms``), the plain version, ``torch.amin`` over the
    gathered sub-matrices (``library_ms``) and the engine's former sequence
    of gather, sub-form kernel, ``amax`` and ``clamp_min`` (``unfused_ms``),
    with the bound."""
    _, rows, width, _, m, inner, outer, step = key
    geom = key[4:]
    for dtype in (torch.float32, torch.float64):
        table, perm = gather_inputs(key, dtype, device)
        got = gr.group_min_scale_gather(table, perm, REF_BW, *geom)
        torch.cuda.synchronize()
        want = gr.group_min_scale_gather_ref(table, perm, REF_BW, *geom)
        assert got.shape == (rows,) and got.dtype == dtype
        assert torch.equal(got, want), (key, dtype)
    row = {"name": "group_min_scale", "form": "gather",
           "shape": [rows, width // m, m, m],
           "geometry": {"width": width, "m": m, "inner": inner,
                        "outer": outer, "step": step},
           "bit_equal": True, "max_abs_err": float((got - want).abs().max())}
    if timed:
        def gathered():
            if inner == 1:                       # TP: a reshape
                g = perm.reshape(rows, -1, m)
            else:                                # CP: reshape, transpose
                g = perm.reshape(rows, -1, m, inner).transpose(2, 3) \
                    .reshape(rows, -1, m)
            return table[g[:, :, :, None], g[:, :, None, :]]

        def unfused():
            return torch.clamp_min(
                gr.group_min_scale(gathered(), REF_BW).amax(dim=1), 1.0)

        def fused():
            return gr.group_min_scale_gather(table, perm, REF_BW, *geom)

        assert torch.equal(unfused(), got)
        sub = gathered()
        b_ms, b_by = gather_bound(key, table, perm)
        row.update(**interleaved(time_ms, {
            "ms": fused,
            "plain_ms": lambda: gr.group_min_scale_gather_ref(
                table, perm, REF_BW, *geom),
            "library_ms": lambda: torch.amin(sub, dim=(-2, -1)),
            "unfused_ms": unfused}),
            device_ms=device_ms(fused), bound_ms=b_ms, bound_by=b_by)
    return row


def max_gather_inputs(key: tuple, dtype, device) -> tuple:
    """``(slow, perm, cw)`` for one ``group_max`` gather key ``("gather",
    rows, pp, nc, n)``: slowdowns of two tiers and a degraded one, random
    permutation rows, stage weights of a tiered score's size."""
    _, rows, pp, nc, n = key
    rng = np.random.default_rng(zlib.crc32(repr(key).encode()))
    slow = rng.choice([1.0, 2.0, 3.25], size=n) \
        * rng.uniform(1.0, 1.01, size=n)
    perm = np.stack([rng.permutation(n)[:pp * nc] for _ in range(rows)])
    cw = rng.uniform(0.5, 2.0, size=(rows, pp)) * 1e-3
    return tuple(torch.from_numpy(a).to(device) if a.dtype == np.int64
                 else torch.from_numpy(a).to(dtype).to(device)
                 for a in (slow, perm, cw))


def check_max_gather(key: tuple, device, timed: bool) -> dict:
    """The gather form of ``group_max`` against its plain version, both
    outputs bit-equal in both dtypes; with ``timed`` also the float64
    times: the wrapper, the device alone, the plain version, ``torch.amax``
    over the gathered slowdowns (``library_ms``) and the engine's former
    sequence of gather, row-max kernel, multiply and ``amax``
    (``unfused_ms``), with the bound."""
    _, rows, pp, nc, n = key
    for dtype in (torch.float32, torch.float64):
        slow, perm, cw = max_gather_inputs(key, dtype, device)
        got = gr.group_max_gather(slow, perm, cw, nc)
        torch.cuda.synchronize()
        want = gr.group_max_gather_ref(slow, perm, cw, nc)
        assert got[0].shape == (rows, pp) and got[1].shape == (rows,)
        assert got[0].dtype == got[1].dtype == dtype
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            (key, dtype)
    row = {"name": "group_max", "form": "gather", "shape": [rows, pp, nc],
           "n": n, "bit_equal": True,
           "max_abs_err": max(float((g - w).abs().max())
                              for g, w in zip(got, want))}
    if timed:
        def unfused():
            c_x = cw * gr.group_max(slow[perm.view(rows, pp, nc)])
            return c_x, c_x.amax(dim=1)

        def fused():
            return gr.group_max_gather(slow, perm, cw, nc)

        assert all(torch.equal(a, b) for a, b in zip(unfused(), got))
        gathered = slow[perm.view(rows, pp, nc)]
        # each input read once (the distinct slowdowns the rows reach), each
        # output written once; a comparison per member, a multiply and a
        # comparison per stage
        reached = int(torch.unique(perm).numel())
        item = slow.element_size()
        t_bytes = (perm.numel() * perm.element_size()
                   + (reached + cw.numel() + rows * pp + rows) * item) \
            / HBM_BYTES_PER_S
        t_ops = (perm.numel() + 2 * rows * pp) / OPS_PER_S
        row.update(**interleaved(time_ms, {
            "ms": fused,
            "plain_ms": lambda: gr.group_max_gather_ref(slow, perm, cw, nc),
            "library_ms": lambda: torch.amax(gathered, dim=-1),
            "unfused_ms": unfused}),
            device_ms=device_ms(fused), bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations")
    return row


def check_ragged(device) -> list:
    rows = [check_kernel("group_min_scale", (n, m, m), device, False)
            for n, m in RAGGED_MIN_SCALE]
    rows += [check_gather(gather_key(*c), device, False)
             for c in RAGGED_GATHER]
    rows += [check_kernel("group_max", (n, m), device, False)
             for n, m in RAGGED_MAX]
    rows += [check_max_gather(("gather", b, pp, nc, pp * nc), device, False)
             for b, pp, nc in RAGGED_MAX_GATHER]
    # what the kernels do not take is refused, not routed elsewhere
    sub = make_input("group_min_scale", (2, 3, 4, 4), torch.float64, device)
    vals = make_input("group_max", (9, 16), torch.float64, device)
    table, perm = gather_inputs(gather_key(2, 4, 1, 16), torch.float64,
                                device)
    slow, mperm, cw = max_gather_inputs(("gather", 2, 2, 4, 8),
                                        torch.float64, device)
    for bad in (lambda: gr.group_min_scale(sub.to(torch.float16), REF_BW),
                lambda: gr.group_min_scale(sub[..., :3], REF_BW),
                lambda: gr.group_max(vals.T),
                lambda: gr.group_min_scale_gather(table, perm.int(), REF_BW,
                                                  4, 1, 4, 1),
                lambda: gr.group_min_scale_gather(table, perm, REF_BW,
                                                  3, 1, 3, 1),
                lambda: gr.group_max_gather(slow, mperm.int(), cw, 4),
                lambda: gr.group_max_gather(slow, mperm, cw.float(), 4),
                lambda: gr.group_max_gather(slow, mperm, cw, 3)):
        try:
            bad()
        except (TypeError, ValueError):
            continue
        raise AssertionError("wrapper accepted an unsupported tensor")
    return rows


def check_path_shapes(device, shapes_by_phase: dict) -> list:
    """Every distinct shape a plan phase handed a wrapper: bit-equal check
    and timings at that shape, with the launches each phase made there."""
    rows = []
    for name in PLAN_KERNELS:
        seen = sorted({sh for by_kernel in shapes_by_phase.values()
                       for sh in by_kernel[name]}, key=repr)
        for shape in seen:
            if shape[0] != "gather":
                row = check_kernel(name, shape, device, True)
            elif name == "group_min_scale":
                row = check_gather(shape, device, True)
            else:
                row = check_max_gather(shape, device, True)
            row["launches"] = {phase: by_kernel[name].get(shape, 0)
                               for phase, by_kernel
                               in shapes_by_phase.items()}
            rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# the main path: Planner.plan on the card, held against the host backend
# ---------------------------------------------------------------------------

def strip_backend(text: str) -> str:
    """A Plan's JSON text without the field that names the SA backend."""
    d = json.loads(text)
    d["provenance"]["budget"].pop("backend")
    return json.dumps(d, sort_keys=True)


def run_plan(name, workload, spec, space, budget_kw, estimator, device,
             must_launch) -> tuple:
    """Plan on the card and on the host; returns the phase's line, its
    launches and shapes, and the card's plan."""
    bw, _ = profile_bandwidth(spec)

    def plan_with(backend):
        req = PlanRequest(workload=workload, spec=spec, space=space,
                          budget=Budget(backend=backend, **budget_kw),
                          seed=0)
        t0 = time.perf_counter()
        plan = Planner(PipetteStrategy(estimator=estimator),
                       device=device).plan(req, bw)
        torch.cuda.synchronize()
        return plan, time.perf_counter() - t0

    reset_launches()
    plan, wall_torch = plan_with("torch")
    launches, shapes = read_launches(), read_shapes()
    host_plan, wall_numpy = plan_with("numpy")
    assert read_launches() == launches      # the host backend launches none

    assert plan.feasible, name
    assert strip_backend(plan.to_json()) == strip_backend(host_plan.to_json()), \
        f"{name}: card plan differs from the host-backend plan"
    n = spec.n_gpus
    assert sorted(plan.mapping.reshape(-1).tolist()) == list(range(n))
    assert np.isfinite(plan.latency) and plan.latency > 0
    assert plan.overhead.sa_accepted > 0
    for k in must_launch:
        assert launches[k] > 0, f"{name}: {k} was never launched"
    o = plan.overhead
    line = {
        "phase": name, "model": workload.cfg.name, "n_gpus": n,
        "cluster": spec.name, "best": str(plan.conf),
        "latency_s": plan.latency,
        "mem_pred_bytes": (None if np.isnan(plan.mem_pred)
                           else plan.mem_pred),
        "n_enumerated": o.n_enumerated, "n_candidates": o.n_candidates,
        "n_annealed": sum(1 for c in plan.result.ranked
                          if c.sa is not None),
        "sa_accepted": o.sa_accepted, "budget": budget_kw,
        "seconds": {k: getattr(o, k) for k in
                    ("total_s", "enumerate_s", "mem_estimator_s",
                     "profile_s", "prescore_s", "sa_s")},
        "wall_s_backend_torch": wall_torch,
        "wall_s_backend_numpy": wall_numpy,
        "sa_s_backend_numpy": host_plan.overhead.sa_s,
        "launches": launches,
        "byte_equal_to_host_backend": True,
    }
    return line, launches, shapes, plan


#: The SA budget of ``plan_uniform``, which ``serve_plan`` submits too.
UNIFORM_BUDGET = dict(sa_seconds=600.0, sa_iters=2000, n_chains=4, sa_topk=8)


def plan_uniform(device) -> tuple:
    """The paper's setting: gpt-3.1b, seq 2048, global batch 512, on the
    128-GPU mid-range cluster, with the MLP memory estimator fitted on the
    card from a seed."""
    spec = MID_RANGE
    w = Workload(configs.get("gpt-3.1b"), 2048, 512)
    t0 = time.perf_counter()
    est = fit_memory_estimator([w], spec, fit_nodes=4, steps=3000,
                               residual=True, seed=0, device=device)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    # the fit is usable: finite, and close to the ground truth where it
    # was fitted
    fit_confs = [c for c in enumerate_confs(32, 512, max_tp=8,
                                            n_layers=w.cfg.n_layers,
                                            strict=False)
                 if c.bs_micro <= 16]
    preds = est.predict_batch(w.cfg, fit_confs, device=device)
    truth = [ground_truth_memory(w, c, spec) for c in fit_confs]
    fit_mape = mape(preds, truth)
    assert np.isfinite(preds).all() and fit_mape < 25.0, fit_mape
    line, launches, shapes, _ = run_plan(
        "plan_uniform", w, spec, SearchSpace(), UNIFORM_BUDGET, est, device,
        must_launch=("group_min_scale",))
    line["estimator"] = {"fit_s": fit_s, "steps": 3000,
                         "mape_on_fit_range_pct": fit_mape}
    return line, launches, shapes, est


def plan_tiered(device) -> tuple:
    """gpt-11.1b on a 1024-GPU half-A100 half-V100 fleet, hierarchical
    island search; the tiered score runs the per-stage max kernel."""
    spec = mixed_fleet_spec("smoke-mixed-128x8", 128,
                            (A100_TIER, V100_TIER), (0.5, 0.5),
                            gpus_per_node=8, seed=7)
    w = Workload(configs.get("gpt-11.1b"), 2048, 1024)
    line, launches, shapes, plan = run_plan(
        "plan_tiered", w, spec, SearchSpace(max_tp=8, max_micro=4),
        dict(sa_seconds=600.0, sa_iters=200, n_chains=4, sa_topk=2,
             hierarchical=True),
        None, device, must_launch=("group_min_scale", "group_max"))
    # every tiered score took the gather form of group_max: one launch
    assert launches["group_max"] == TIERED_GROUP_MAX_LAUNCHES, launches
    assert all(k[0] == "gather" for k in shapes["group_max"]), \
        shapes["group_max"]
    return line, launches, shapes, (w, spec, plan)


# ---------------------------------------------------------------------------
# the planner's other entry points: the live probe, the plan server,
# elastic replanning, the churn replay
# ---------------------------------------------------------------------------

def probe() -> dict:
    """``profile_bandwidth_live()`` on every visible card: ``inf`` on the
    diagonal, a timed copy between each pair (none on one card)."""
    t0 = time.perf_counter()
    bw = profile_bandwidth_live()
    seconds = time.perf_counter() - t0
    n = torch.cuda.device_count()
    assert bw.shape == (n, n), bw.shape
    assert np.isinf(np.diag(bw)).all()
    off = bw[~np.eye(n, dtype=bool)]
    assert np.isfinite(off).all() and (off > 0).all()
    return {"phase": "probe", "seconds": seconds, "shape": list(bw.shape),
            "bytes_per_s": [[None if np.isinf(v) else v for v in row]
                            for row in bw.tolist()]}


def _timed_submit(client, req) -> tuple:
    t0 = time.perf_counter()
    resp = client.submit(req)
    return resp, time.perf_counter() - t0


def serve_plan(est) -> tuple:
    """``plan_uniform``'s request through an in-process ``PlanServer``
    (device resolved at construction, here the card) and a ``PlanClient``
    on 127.0.0.1: a miss, then a hit with the same bytes at least 10x
    faster; three concurrent identical submits of a second request run one
    search; the served plan passes the verifier and equals, without its
    backend's name, the same request served on the NumPy backend.  The
    server runs without warm start, so that the two backends' requests
    search from the same cold start."""
    spec = MID_RANGE
    w = Workload(configs.get("gpt-3.1b"), 2048, 512)

    def request(backend, seed=0):
        return PlanRequest(workload=w, spec=spec, space=SearchSpace(),
                           budget=Budget(backend=backend, **UNIFORM_BUDGET),
                           seed=seed)

    server = PlanServer("127.0.0.1", 0, warm_start=False, estimator=est)
    assert server.device.type == "cuda" and server.device.index is not None
    thread = server.start_in_thread()
    t_phase = time.perf_counter()
    try:
        client = PlanClient(port=server.port)
        reset_launches()
        miss, miss_s = _timed_submit(client, request("torch"))
        hit, hit_s = _timed_submit(client, request("torch"))
        searches = server.counters["searches_run"]
        t0 = time.perf_counter()
        trio = client.submit_many([request("torch", seed=1)] * 3)
        trio_s = time.perf_counter() - t0
        trio_searches = server.counters["searches_run"] - searches
        torch.cuda.synchronize()
        launches, shapes = read_launches(), read_shapes()
        host, host_s = _timed_submit(client, request("numpy"))
        assert read_launches() == launches      # the host backend: none
        stats = client.stats()
    finally:
        server.stop()
        thread.join(timeout=120)
    assert not thread.is_alive(), "plan server did not stop"
    assert miss["meta"]["cache"] == "miss", miss["meta"]
    assert hit["meta"]["cache"] == "hit", hit["meta"]
    assert hit["plan"] == miss["plan"]
    assert hit_s * 10 <= miss_s, (hit_s, miss_s)
    assert trio_searches == 1, trio_searches
    assert len({r["plan"] for r in trio}) == 1
    assert sorted(r["meta"]["cache"] for r in trio)[-1] == "miss"
    served = json.loads(miss["plan"])
    errors = [str(i) for i in verify_plan_dict(served, spec=spec)
              if i.severity == "error"]
    assert not errors, errors
    assert served["provenance"]["budget"]["backend"] == "torch"
    assert strip_backend(miss["plan"]) == strip_backend(host["plan"])
    assert launches["group_min_scale"] > 0, launches
    assert all(k[0] == "gather" for k in shapes["group_min_scale"])
    line = {"phase": "serve_plan", "model": w.cfg.name,
            "n_gpus": spec.n_gpus, "budget": UNIFORM_BUDGET,
            "seconds": time.perf_counter() - t_phase,
            "miss_s": miss_s, "hit_s": hit_s, "hit_speedup": miss_s / hit_s,
            "server_miss_s": miss["meta"]["elapsed_s"],
            "server_hit_s": hit["meta"]["elapsed_s"],
            "coalesced_trio_s": trio_s, "coalesced_searches": trio_searches,
            "trio_cache": [r["meta"]["cache"] for r in trio],
            "numpy_backend_s": host_s, "best": served["best"]["conf"],
            "byte_equal_to_numpy_backend": True, "verifier_errors": 0,
            "server_stats": {k: v for k, v in stats.items()
                             if k != "cache"},
            "launches": launches}
    return line, launches, shapes


def replan(tiered) -> tuple:
    """``plan_tiered``'s fleet loses node 5, and a spare of its tier joins
    in its place (last, as a returning node does): ``replan_on`` the new
    fleet on the card, cold and warm (seeded by the tiered plan projected
    onto the 1,016 surviving GPUs), and the warm replan on the host's
    NumPy backend.  127 nodes alone admit no configuration of this
    workload (1,016 = 8 x 127 GPUs).  The search is flat, so that the warm
    seed is what separates the two; the budget is ``plan_tiered``'s."""
    w, spec, incumbent = tiered
    lost = 5
    nodes = [i for i in range(spec.n_nodes) if i != lost] + [lost]
    new_spec = spec.with_node_subset(nodes)
    survivors = [g for node in nodes[:-1] for g in spec.node_gpus(node)]
    bw, _ = profile_bandwidth(new_spec)
    kw = dict(sa_seconds=600.0, sa_iters=200, n_chains=4, sa_topk=2,
              hierarchical=False, max_tp=8, max_micro=4)

    def run(backend, warm):
        t0 = time.perf_counter()
        ep = replan_on(w, new_spec, bw, backend=backend,
                       incumbent=incumbent if warm else None,
                       survivors=survivors if warm else None, **kw)
        torch.cuda.synchronize()
        return ep, time.perf_counter() - t0

    reset_launches()
    cold, cold_s = run("torch", False)
    warm, warm_s = run("torch", True)
    launches, shapes = read_launches(), read_shapes()
    host, host_s = run("numpy", True)
    assert read_launches() == launches
    assert strip_backend(warm.plan.to_json()) \
        == strip_backend(host.plan.to_json())
    oc, ow = cold.plan.overhead, warm.plan.overhead
    same_best = (warm.plan.conf == cold.plan.conf and np.array_equal(
        warm.plan.mapping, cold.plan.mapping))
    # never worse, and cheaper: fewer accepted moves to its best, or the
    # same best, or -- where neither search moves off its start -- a
    # strictly better plan from the projected incumbent
    assert warm.plan.latency <= cold.plan.latency, \
        (warm.plan.latency, cold.plan.latency)
    assert ow.sa_accepted_to_best <= oc.sa_accepted_to_best
    assert (ow.sa_accepted_to_best < oc.sa_accepted_to_best or same_best
            or warm.plan.latency < cold.plan.latency)
    assert warm.plan.provenance.lineage["warm_start_projected"] is True
    assert launches["group_max"] > 0, launches
    assert all(k[0] == "gather" for k in shapes["group_max"])
    m = warm.migration
    line = {"phase": "replan", "model": w.cfg.name,
            "n_gpus": new_spec.n_gpus, "lost_node": lost,
            "seconds": cold_s + warm_s + host_s,
            "cold_s": cold_s, "warm_s": warm_s, "numpy_backend_s": host_s,
            "cold": {"best": str(cold.plan.conf),
                     "latency_s": cold.plan.latency,
                     "sa_accepted": oc.sa_accepted,
                     "sa_accepted_to_best": oc.sa_accepted_to_best},
            "warm": {"best": str(warm.plan.conf),
                     "latency_s": warm.plan.latency,
                     "sa_accepted": ow.sa_accepted,
                     "sa_accepted_to_best": ow.sa_accepted_to_best,
                     "ranks_moved": m.ranks_moved,
                     "bytes_migrated": m.bytes_migrated,
                     "downtime_s": m.downtime_s},
            "byte_equal_to_numpy_backend": True, "launches": launches}
    return line, launches, shapes


def churn() -> tuple:
    """``simulate_churn`` of the warm policy over the first four events of
    a seeded trace on ``MID_RANGE`` (seed 3: a preemption, a straggler,
    the return, a second straggler, so that tiered fleets reach
    ``group_max``), gpt-3.1b at seq 2048, global batch 512: every replan
    on the card, then on the host's NumPy backend; the reports' JSON must
    be equal (they carry no backend).  The policy's budget is made
    iteration-bound (the wall-clock cap set out of reach)."""
    import dataclasses
    spec = MID_RANGE
    w = Workload(configs.get("gpt-3.1b"), 2048, 512)
    trace = generate_trace(spec, horizon_s=3600, seed=3)
    trace = dataclasses.replace(trace, events=trace.events[:4])
    kinds = [e.kind for e in trace.events]
    assert kinds == ["preempt", "straggler", "return", "straggler"], kinds
    policy = dataclasses.replace(WARM_POLICY, sa_iters=CHURN_SA_ITERS,
                                 sa_seconds=600.0)
    reset_launches()
    t0 = time.perf_counter()
    card = simulate_churn(w, spec, trace, policy)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches, shapes = read_launches(), read_shapes()
    t0 = time.perf_counter()
    host = simulate_churn(w, spec, trace, dataclasses.replace(
        policy, backend="numpy"))
    host_s = time.perf_counter() - t0
    assert read_launches() == launches
    doc = json.dumps(card.to_json_dict(), sort_keys=True)
    assert doc == json.dumps(host.to_json_dict(), sort_keys=True)
    assert card.replans == len(trace.events)
    assert card.bytes_migrated == card.resident_bytes
    assert card.ranks_moved == card.resident_moved
    for k in PLAN_KERNELS:
        assert launches[k] > 0, (k, launches)
    return ({"phase": "churn", "model": w.cfg.name, "n_gpus": spec.n_gpus,
             "events": kinds, "policy": policy.name,
             "sa_iters": CHURN_SA_ITERS, "seconds": card_s + host_s,
             "card_s": card_s, "numpy_backend_s": host_s,
             "samples": card.samples, "downtime_s": card.downtime_s,
             "ranks_moved": card.ranks_moved,
             "bytes_migrated": card.bytes_migrated,
             "report_equal_to_numpy_backend": True,
             "launches": launches}, launches, shapes)


# ---------------------------------------------------------------------------
# the examples, run on the card as a user runs them
# ---------------------------------------------------------------------------

EXAMPLES_DIR = os.path.join(ROOT, "examples", "torch")
#: ``examples_on_card``'s limit, and the examples' settings it cuts to
#: stay within it (each cut is named on the phase line).  Every plan that
#: is compared with the host's NumPy backend runs under a budget that its
#: iterations bind, the wall-clock cap set out of reach.
EXAMPLES_S = 120.0
EX_QUICKSTART_SA = dict(sa_seconds=600.0, sa_iters=200)
EX_ELASTIC_SA = dict(sa_seconds=600.0, sa_iters=100)
EX_CLUSTER_SA_ITERS = 100
#: ``train_gpt``'s ``--configure`` budget (``launch/train.py``
#: ``CONFIGURE_BUDGET``, 2,000 iterations) in this phase.
EX_GPT_CONFIGURE = dict(sa_seconds=600.0, sa_iters=50)
#: ``train_gpt --full``: steps of the straight run, and the step at which
#: the other run fails (just after its checkpoint at step 40; it then
#: resumes from that checkpoint and runs steps 40 to 50, of which the
#: metrics file logs 40 and 50).
EX_GPT_STEPS, EX_GPT_FAIL = 51, 41


def load_example(name: str):
    """``examples/torch/<name>.py`` as a module (the folder is no
    package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES_DIR, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as integers of its element size (NaN equal to itself,
    -0.0 apart from 0.0)."""
    return t.detach().view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                            8: torch.int64}[t.element_size()])


def trees_bit_equal(a, b) -> bool:
    la, lb = _tree.leaves(a), _tree.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(_bits(x), _bits(y)) for x, y in zip(la, lb))


def _counted(fn) -> tuple:
    """``fn()`` with the launch counts set to 0 before it and read after
    it, its standard output kept: ``(result, seconds, printed lines,
    launches, backward launches, shapes)``."""
    import contextlib
    import io
    reset_launches()
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = fn()
    torch.cuda.synchronize()
    return (res, time.perf_counter() - t0, buf.getvalue().splitlines(),
            read_launches(), read_bwd_launches(), read_shapes())


def _npz_bit_equal(a: str, b: str) -> bool:
    """Whether two ``.npz`` files hold the same arrays bit for bit (each
    array read once: an ``NpzFile`` reads it again at every index)."""
    with np.load(a) as x, np.load(b) as y:
        if sorted(x.files) != sorted(y.files):
            return False
        for k in x.files:
            u, v = x[k], y[k]
            if u.dtype != v.dtype or u.shape != v.shape or \
                    not np.array_equal(u.reshape(-1).view(np.uint8),
                                       v.reshape(-1).view(np.uint8)):
                return False
    return True


def _metric_losses(path: str) -> dict:
    """step -> loss of a metrics file (a resumed run's later lines win)."""
    with open(path) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)}


def ex_quickstart(device) -> dict:
    """``examples/torch/quickstart.py``'s ``run`` as ``main`` calls it
    (reduced qwen2-7b, weights from seed 0 on the card, 40 steps) but at
    ``EX_QUICKSTART_SA``, its plan held byte-equal to the host NumPy
    backend's."""
    import dataclasses
    qs = load_example("quickstart")
    cfg = configs.get("qwen2-7b").reduced()
    budget = Budget(**EX_QUICKSTART_SA)
    res, wall, out, fwd, bwd, shapes = _counted(lambda: qs.run(
        cfg, init_params(cfg, seed=0, device=device), budget, 40, device,
        log=print))
    req, bw, _ = qs.plan_request(cfg, dataclasses.replace(budget,
                                                          backend="numpy"))
    t0 = time.perf_counter()
    host = Planner(PipetteStrategy(), device=device).plan(req, bw)
    host_s = time.perf_counter() - t0
    assert read_launches() == fwd                # the host backend: none
    assert strip_backend(res["plan_json"]) == strip_backend(host.to_json()), \
        "quickstart: card plan differs from the host-backend plan"
    losses = res["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert len(res["tokens"]) == qs.DECODE_STEPS + 1 and all(
        0 <= t < cfg.vocab_size for t in res["tokens"]), res["tokens"]
    return {"wall_s": wall, "output": out, "launches": fwd,
            "bwd_launches": bwd, "shapes": shapes,
            "cut": f"sa_iters {budget.sa_iters} (the example: 2,000)",
            "plan": str(res["plan"].conf), "n_micro": res["n_micro"],
            "plan_s": res["plan"].overhead.total_s, "numpy_backend_s": host_s,
            "losses": [losses[0], losses[-1]], "tokens": res["tokens"],
            "budget": EX_QUICKSTART_SA,
            "plan_byte_equal_to_numpy_backend": True}


def ex_train_gpt() -> dict:
    """``examples/torch/train_gpt.py --full`` in a temporary directory,
    once straight through ``EX_GPT_STEPS`` steps and once failing at
    ``EX_GPT_FAIL`` and resumed with ``--resume``: the final checkpoint
    (parameters and AdamW state) and every logged loss after the resume
    bit-equal to the straight run's."""
    tg = load_example("train_gpt")
    cwd, budget = os.getcwd(), train_cli.CONFIGURE_BUDGET
    train_cli.CONFIGURE_BUDGET = EX_GPT_CONFIGURE
    with tempfile.TemporaryDirectory(prefix="train_gpt_") as tmp:
        dirs = {k: os.path.join(tmp, k) for k in ("straight", "resumed")}

        def runs():
            try:
                os.makedirs(dirs["straight"])
                os.chdir(dirs["straight"])
                t0 = time.perf_counter()
                assert tg.main(["--full", "--steps", str(EX_GPT_STEPS)]) == 0
                seconds["straight"] = time.perf_counter() - t0
                os.makedirs(dirs["resumed"])
                os.chdir(dirs["resumed"])
                t0 = time.perf_counter()
                try:
                    tg.main(["--full", "--steps", str(EX_GPT_STEPS),
                             "--fail-at", str(EX_GPT_FAIL)])
                except RuntimeError as e:
                    assert "injected failure" in str(e), e
                else:
                    raise AssertionError("train_gpt did not fail")
                seconds["failing"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                assert tg.main(["--full", "--steps", str(EX_GPT_STEPS),
                                "--resume"]) == 0
                seconds["resumed"] = time.perf_counter() - t0
            finally:
                os.chdir(cwd)
                train_cli.CONFIGURE_BUDGET = budget
        seconds = {}
        _, wall, out, fwd, bwd, shapes = _counted(runs)
        ck = {k: os.path.join(d, "checkpoints", "gpt-demo",
                              f"step_{EX_GPT_STEPS}", "arrays.npz")
              for k, d in dirs.items()}
        losses = {k: _metric_losses(os.path.join(d, "checkpoints",
                                                 "gpt-demo-metrics.jsonl"))
                  for k, d in dirs.items()}
        params_equal = _npz_bit_equal(ck["straight"], ck["resumed"])
        plan = json.load(open(os.path.join(dirs["straight"], "checkpoints",
                                           "gpt-demo", "plan.json")))
    last, restored = EX_GPT_STEPS - 1, EX_GPT_FAIL - EX_GPT_FAIL % \
        tg.CKPT_EVERY
    assert params_equal, "train_gpt: the resumed run's final state differs"
    assert last in losses["straight"] and losses["resumed"] == \
        losses["straight"], losses
    for k in ("flash_attention", "rmsnorm"):
        assert fwd[k] > 0 and bwd[k + "_bwd"] > 0, (k, fwd, bwd)
    f32 = [k for k in shapes["flash_attention"]
           if "torch.float32" in k and not is_bwd_key(k)]
    assert f32 and sum(shapes["flash_attention"][k] for k in f32) \
        == fwd["flash_attention"], shapes["flash_attention"]
    return {"wall_s": wall, "output": out, "launches": fwd,
            "bwd_launches": bwd, "shapes": shapes,
            "argv": "--full --steps {0}; --full --steps {0} --fail-at {1}; "
                    "--full --steps {0} --resume".format(EX_GPT_STEPS,
                                                         EX_GPT_FAIL),
            "cut": f"{EX_GPT_STEPS} steps (the example: 200); --configure "
                   f"at sa_iters {EX_GPT_CONFIGURE['sa_iters']} (2,000)",
            "plan": plan["best"]["conf"],
            "final_loss": losses["straight"][last],
            "resumed_from_step": restored,
            "resumed_losses": {k: v for k, v in losses["resumed"].items()
                               if k >= restored},
            "seconds_by_run": seconds,
            "resumed_bit_equal": True}


def ex_elastic(device) -> dict:
    """``examples/torch/elastic_failover.py``'s ``run`` (reduced qwen2-7b,
    20 steps, replan from 4 nodes to 3, restore, 10 steps) with its
    checkpoints in a temporary directory: both replans byte-equal to the
    host NumPy backend's, the restored state bit-equal to the saved."""
    from repro_torch.runtime.elastic import replan as elastic_replan
    ef = load_example("elastic_failover")
    cfg = configs.get("qwen2-7b").reduced()
    with tempfile.TemporaryDirectory(prefix="elastic_") as tmp:
        res, wall, out, fwd, bwd, shapes = _counted(lambda: ef.run(
            cfg, init_params(cfg, seed=0, device=device),
            replan_kw=EX_ELASTIC_SA, ckpt_dir=tmp, device=device,
            log=print))
    w = Workload(cfg, 64, 64)
    t0 = time.perf_counter()
    for nodes, key in ((4, "plan4"), (3, "plan3")):
        host = elastic_replan(w, MID_RANGE, healthy_nodes=nodes,
                              backend="numpy", device=device,
                              **EX_ELASTIC_SA)
        assert strip_backend(res[key].plan.to_json()) \
            == strip_backend(host.plan.to_json()), \
            f"elastic_failover: the {nodes}-node replan differs from numpy"
    host_s = time.perf_counter() - t0
    assert read_launches() == fwd
    assert res["at"] == 20 and trees_bit_equal(res["saved"],
                                               res["restored"])
    assert all(np.isfinite(res["losses"] + res["more_losses"]))
    return {"wall_s": wall, "output": out, "launches": fwd,
            "bwd_launches": bwd, "shapes": shapes,
            "plans": [str(res["plan4"].result.best.conf),
                      str(res["plan3"].result.best.conf)],
            "replan_s": [res[k].plan.overhead.total_s
                         for k in ("plan4", "plan3")],
            "numpy_backend_s": host_s,
            "budget": EX_ELASTIC_SA,
            "cut": f"replan sa_iters {EX_ELASTIC_SA['sa_iters']} (the "
                   "example: sa_seconds 0.2 at Budget's default 8,000)",
            "plans_byte_equal_to_numpy_backend": True,
            "restored_bit_equal": True}


def ex_configure_cluster(device) -> dict:
    """``examples/torch/configure_cluster.py`` on ``mid-range`` (gpt-3.1b
    on 128 GPUs, the estimator fitted on the card in 12,000 steps): the
    five strategies' table; PPT-L's and PPT-LF's plans byte-equal to the
    host NumPy backend's."""
    import dataclasses
    cc = load_example("configure_cluster")
    budget = Budget(sa_seconds=600.0, sa_iters=EX_CLUSTER_SA_ITERS)
    res, wall, out, fwd, bwd, shapes = _counted(lambda: cc.run(
        "mid-range", budget=budget, device=device, log=print))
    req = dataclasses.replace(res["request"], budget=dataclasses.replace(
        budget, backend="numpy"))
    by_label = dict(cc.strategies(res["estimator"], req.spec,
                                  res["bw_true"]))
    t0 = time.perf_counter()
    for label in ("Pipette PPT-L", "Pipette PPT-LF"):
        host = Planner(by_label[label], device=device).plan(req,
                                                            res["bw_meas"])
        assert strip_backend(res["plans"][label].to_json()) \
            == strip_backend(host.to_json()), \
            f"configure_cluster: {label} differs from the numpy backend"
    host_s = time.perf_counter() - t0
    assert read_launches() == fwd
    assert fwd["group_min_scale"] > 0, fwd
    base = next(t for name, _, t in res["rows"] if name.startswith("AMP"))
    rows = [{"method": name, "config": str(conf), "iter_ms": t * 1e3,
             "vs_amp": base / t} for name, conf, t in res["rows"]]
    assert all(np.isfinite(r["iter_ms"]) for r in rows)
    return {"wall_s": wall, "output": out, "launches": fwd,
            "bwd_launches": bwd, "shapes": shapes, "table": rows,
            "estimator_fit_s": res["fit_s"],
            "pipette_search_s": res["sa_time"], "numpy_backend_s": host_s,
            "n_annealed": sum(1 for c in res["ppt_plan"].result.ranked
                              if c.sa is not None),
            "budget": {"sa_seconds": 600.0, "sa_iters": EX_CLUSTER_SA_ITERS},
            "cut": f"sa_iters {EX_CLUSTER_SA_ITERS} (the example: 20,000 "
                   "at sa_seconds 1.0)",
            "plans_byte_equal_to_numpy_backend": ["Pipette PPT-L",
                                                  "Pipette PPT-LF"]}


def examples_on_card(device) -> tuple:
    """``examples_on_card``: the four examples of ``examples/torch`` on
    the card, each with the launch counts set to 0 before it and read
    after it.  Returns ``(line, launches, shapes)``, summed over the
    examples (the backward launches in the line's ``launches_bwd``)."""
    t_phase = time.perf_counter()
    ex = {"quickstart": ex_quickstart(device)}
    ex["train_gpt --full"] = ex_train_gpt()
    ex["elastic_failover"] = ex_elastic(device)
    ex["configure_cluster mid-range"] = ex_configure_cluster(device)
    launches = {k: sum(e["launches"][k] for e in ex.values())
                for k in WRAPPERS}
    bwd = {k: sum(e["bwd_launches"][k] for e in ex.values())
           for k in BWD_KERNELS}
    shapes = {k: {} for k in WRAPPERS}
    for e in ex.values():
        for k, by in e.pop("shapes").items():
            for key, n in by.items():
                shapes[k][key] = shapes[k].get(key, 0) + n
    seconds = time.perf_counter() - t_phase
    line = {"phase": "examples_on_card", "seconds": seconds,
            "limit_s": EXAMPLES_S,
            "wall_s": {k: e["wall_s"] for k, e in ex.items()},
            "cuts": {k: e["cut"] for k, e in ex.items()},
            "table": ex["configure_cluster mid-range"]["table"],
            "launches_by_example": {k: {**e["launches"], **e["bwd_launches"]}
                                    for k, e in ex.items()},
            "launches_fwd": launches, "launches_bwd": bwd,
            "examples": ex}
    return line, launches, shapes


def trace(fn) -> dict:
    """Run ``fn()`` once under ``torch.profiler``: host wall time, device
    busy time (the sum of the device-side rows: kernels and copies), the
    idle share, the top kernels by device time, and every kernel of this
    repository's library: its kernels live in an anonymous namespace, so
    their names start ``void (anonymous namespace)::``, and name no ATen
    (``at::``, ``c10::``) type, as the few ATen kernels there do."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # device-side rows only: an operator's row repeats its kernels' time
    on_card = torch.autograd.DeviceType.CUDA
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == on_card),
                  key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    assert busy > 0, "the profiler recorded no device time"
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall,
            "device_kernel_launches": sum(e.count for e in rows),
            "top_by_device_time": [
                {"name": e.key[:80], "count": e.count,
                 "device_ms": e.self_device_time_total / 1e3}
                for e in rows[:10]],
            "repo_kernels": [
                {"name": e.key[:80], "count": e.count,
                 "device_ms": e.self_device_time_total / 1e3}
                for e in rows
                if e.key.startswith("void (anonymous namespace)::")
                and "at::" not in e.key and "c10::" not in e.key]}


def profile_sa(device) -> dict:
    """Where the card's time goes in the SA stage: the uniform request
    (no estimator, 100 steps per chain), after a warm-up plan."""
    spec = MID_RANGE
    w = Workload(configs.get("gpt-3.1b"), 2048, 512)
    bw, _ = profile_bandwidth(spec)
    req = PlanRequest(workload=w, spec=spec, space=SearchSpace(),
                      budget=Budget(sa_seconds=600.0, sa_iters=400,
                                    n_chains=4, sa_topk=8, backend="torch"),
                      seed=0)
    planner = Planner(PipetteStrategy(), device=device)
    planner.plan(req, bw)                               # warm-up
    plans = []
    out = trace(lambda: plans.append(planner.plan(req, bw)))
    return {"phase": "profile_sa", "sa_s": plans[0].overhead.sa_s, **out}


# ---------------------------------------------------------------------------
# model kernels: against their plain versions, and timing
# ---------------------------------------------------------------------------

#: (float32, bfloat16) tolerance of each kernel against its plain version:
#: the JAX package's own, from its kernel tests (``tests/test_kernels.py``).
#: The sums run in another order, ``rsqrtf``/``expf`` are within 2 ulp, and
#: in bfloat16 an output may round to the neighbouring value.
#: The fused scan's output is held at the bfloat16 kernel tolerance in that
#: type (one rounding of a gated product may land on the neighbouring
#: value), its float32 state at the scan's 2e-4 in either type.
TOL = {"rmsnorm": (1e-5, 3e-2), "flash_attention": (2e-5, 2e-2),
       "selective_scan": (2e-4, 2e-4)}
TOL_FUSED_STATE = 2e-4
RAGGED_RMS = [((rows, d), dt) for rows in (1, 2, 7, 33, 64, 70)
              for d in (32, 128, 384, 3584, 4096)
              for dt in ("float32", "bfloat16")]
#: (b, h, kv, sq, sk, d, causal, window): the JAX package's sweep
#: (``FA_CASES``), a length that is no multiple of a tile, a window that
#: masks whole key tiles, and rows with no allowed key.
RAGGED_FA = [
    (2, 4, 2, 128, 128, 32, True, 0), (1, 4, 4, 256, 256, 64, True, 0),
    (2, 2, 1, 128, 256, 32, False, 0), (1, 4, 2, 256, 256, 32, True, 64),
    (1, 8, 2, 128, 128, 128, True, 0), (1, 2, 2, 64, 192, 16, True, 48),
    (2, 4, 2, 50, 50, 64, True, 0), (1, 4, 2, 200, 200, 128, True, 40),
    (1, 2, 2, 64, 16, 16, True, 8),
]
#: bfloat16 only (the tensor-core kernel): 2048 keys, causal and against a
#: short query block, and D = 256 (gemma3-12b's head dim), ragged and
#: windowed.
RAGGED_FA_BF16 = [
    (1, 4, 2, 2048, 2048, 128, True, 0), (2, 4, 1, 100, 2048, 64, False, 0),
    (1, 2, 1, 300, 300, 256, True, 0), (1, 2, 2, 257, 257, 256, True, 50),
]
#: (b, s, d, n): the JAX package's sweep (``SCAN_CASES``), a ragged one,
#: and an odd width and state size.
RAGGED_SCAN = [(2, 64, 32, 8), (1, 96, 16, 4), (2, 128, 64, 16),
               (1, 50, 24, 8), (1, 17, 100, 16), (2, 21, 45, 7)]
#: falcon-mamba-7b's scan at batch 4: prefill (S 512) and decode-step shape.
FALCON_SCAN, FALCON_STEP = (4, 512, 8192, 16), (4, 1, 8192, 16)
#: Threads and channels a block of the scan kernel
#: (``csrc/selective_scan.cu``: 4 lanes a channel, two channels a thread).
SCAN_BLOCK_THREADS, SCAN_BLOCK_CHANNELS = 64, 32
#: Threads of a block of the scan backward's main kernel (``kBwdThreads``)
#: and the blocks an SM must hold (``kBwdBlocksPerSM``, its launch bound).
SCAN_BWD_THREADS, SCAN_BWD_BLOCKS_PER_SM = 4 * ss.BWD_CHANNELS, 4


def _dtype(name) -> torch.dtype:
    """A dtype, or its name (``"bfloat16"``, ``"torch.bfloat16"``)."""
    if isinstance(name, torch.dtype):
        return name
    return getattr(torch, name.split(".")[-1])


def _randn(gen, shape, dtype, device, scale=1.0):
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def model_inputs(name: str, key: tuple, device) -> tuple:
    """Random inputs for one wrapper call, laid out as the model hands them:
    attention inputs are ``(B, S, H, D)`` tensors viewed as ``(B, H, S,
    D)``; the scan's ``B`` and ``C`` are column slices of one projection
    (``dt_rank + 2N`` wide).  Returns ``(args, kwargs)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(zlib.crc32(repr(key).encode()))
    if name == "rmsnorm" and key[0] == "add":        # the residual form
        _, shape, xt, wt = key
        return ((_randn(gen, shape, _dtype(xt), device, 3.0),
                 _randn(gen, shape, _dtype(xt), device),
                 _randn(gen, shape[-1:], _dtype(wt), device), 1e-5), {})
    if name == "rmsnorm":
        shape, xt, wt = key
        return ((_randn(gen, shape, _dtype(xt), device, 3.0),
                 _randn(gen, shape[-1:], _dtype(wt), device), 1e-5), {})
    if name == "flash_attention":
        # (q shape, k shape, causal, window, dtype[, q_offset])
        qs, ks, causal, window, dt = key[:5]
        b, h, sq, d = qs
        kv, sk = ks[1], ks[2]
        q = _randn(gen, (b, sq, h, d), _dtype(dt), device).transpose(1, 2)
        k = _randn(gen, (b, sk, kv, d), _dtype(dt), device).transpose(1, 2)
        v = _randn(gen, (b, sk, kv, d), _dtype(dt), device).transpose(1, 2)
        return (q, k, v), {"causal": causal, "window": window,
                           "q_offset": _q_offset(key)}
    if key[0] == "fused":
        return fused_inputs(gen, key, device)
    if key[0] == "fused_bound":      # the training forward: no state given
        (args, _) = fused_inputs(gen, ("fused",) + tuple(key[1:]) + (False,),
                                 device)
        return args[:-2] + (None,), {}
    if key[0] in ("fused_bf16", "fused_bf16_bound"):
        # the bfloat16 working type over a sequence: a prefill's state (the
        # generation instance) or none (the training forward)
        (args, _) = fused_inputs(gen, ("fused",) + tuple(key[1:]) + (False,),
                                 device)
        return args[:-2] + ((args[-2],) if key[0] == "fused_bf16"
                            else (None,)), {}
    (b, s, d), n, dt = key
    dt_rank = -(-d // 32)            # d_inner = 2 d_model, dt_rank = d_model/16
    x = _randn(gen, (b, s, d), _dtype(dt), device, 0.5)
    delta = (torch.nn.functional.softplus(_randn(gen, (b, s, d), torch.float32,
                                                 device)) * 0.1).to(_dtype(dt))
    proj = _randn(gen, (b, s, dt_rank + 2 * n), _dtype(dt), device)
    B, C = proj[..., dt_rank:dt_rank + n], proj[..., dt_rank + n:]
    A = -torch.exp(_randn(gen, (d, n), torch.float32, device, 0.3))
    h0 = _randn(gen, (b, d, n), torch.float32, device)
    return (x, delta, B, C, A, h0), {}


def _q_offset(key: tuple) -> int:
    """The query offset of an attention shape key (forward or backward):
    its sixth entry after the ``"bwd"`` tag, 0 when it has none."""
    body = key[1:] if key[0] == "bwd" else key
    return body[5] if len(body) > 5 else 0


def _masked_sdpa(q, k, v, causal, window, q_offset):
    """SDPA with an explicit boolean mask (``is_causal`` takes no query
    offset): the keys each row may see, ``fa._allowed``'s."""
    mask = fa._allowed(q.shape[2], k.shape[2], causal, window, q.device,
                       q_offset)
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def fused_inputs(gen, key: tuple, device) -> tuple:
    """Inputs of the fused scan as ``mamba1_block`` hands them: ``x`` after
    ``silu``, ``dt`` a new GEMM output, ``B, C`` column slices of one
    projection (``dt_rank + 2N`` wide), ``z`` the second half of ``xz``,
    ``A_log`` near ``log(1..N)``, and ``h_out`` the tensor ``h0`` itself (a
    decode cache row, updated in place)."""
    _, (b, s, d), n, dt, step = key
    io = _dtype(dt)
    rank = -(-d // 32)
    xz = _randn(gen, (b, s, 2 * d), io, device)
    x = silu(xz[..., :d].float()).to(io)
    proj = _randn(gen, (b, s, rank + 2 * n), io, device)
    A_log = (torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                    device=device)).expand(d, n)
             + _randn(gen, (d, n), torch.float32, device, 0.1))
    h = _randn(gen, (b, d, n), torch.float32, device)
    return ((x, _randn(gen, (b, s, d), io, device, 0.5),
             _randn(gen, (d,), torch.float32, device, 0.5) - 2.0,
             proj[..., rank:rank + n], proj[..., rank + n:],
             A_log.contiguous(), _randn(gen, (d,), torch.float32, device),
             xz[..., d:], h, h), {"step": step})


def model_library(name: str, key: tuple):
    """One PyTorch call that computes the same function, or None; timed
    as a yardstick only, and used nowhere in the package."""
    if name == "rmsnorm" and key[0] == "add":
        d = key[1][-1]
        return lambda x, r, w, eps: torch.nn.functional.rms_norm(
            x + r, (d,), w, eps)
    if name == "rmsnorm":
        d = key[0][-1]
        # one type for F.rms_norm: a bfloat16 weight of a float32 input
        # (Mamba2's gated norm) is cast to float32, as the kernel reads it
        return lambda x, w, eps: torch.nn.functional.rms_norm(
            x, (d,), w.to(x.dtype), eps)
    if name == "flash_attention":
        qs, ks, causal, window, _ = key[:5]
        if _q_offset(key):             # a share of a sequence's rows
            return lambda q, k, v, causal, window, q_offset: \
                _masked_sdpa(q, k, v, causal, window, q_offset)
        if window == 0 and (qs[2] == ks[2] or not causal):
            return lambda q, k, v, causal, window, q_offset: \
                torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)
    return None


def model_bound(name: str, key: tuple, args, outs) -> tuple:
    """(bound_ms, bound_by): the largest of bytes over the memory rate
    (each input read once, each output written once) and operations over
    the peak rate for the inputs' type — bfloat16 products at the
    tensor-core rate, everything else at the float32 rate — and, for the
    scan, its ``b*S*D*N`` exponentials over the special function units'
    rate (``EXP_PER_S``; ``bound_by`` "exp").  The attention's operations
    count only the (query, key) pairs this mask allows."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors + list(outs))
    if name == "rmsnorm":          # an add too in the residual form
        ops = (5 if key[0] == "add" else 4) * args[0].numel()
        rate = OPS_PER_S
    elif name == "flash_attention":
        qs, ks, causal, window, dt = key[:5]
        pairs = int(fa._allowed(qs[2], ks[2], causal, window, "cpu",
                                _q_offset(key)).sum())
        ops = 4 * qs[0] * qs[1] * qs[3] * pairs
        rate = BF16_OPS_PER_S if "bfloat16" in dt else OPS_PER_S
    else:                          # any form of the scan
        x, n = args[0], (key[1] if len(key) == 3 else key[2])
        # the bfloat16 working type's tree: six more operations a state
        per = 13 if str(key[0]).startswith("fused_bf16") else 7
        ops, rate = per * x.numel() * n + x.numel(), OPS_PER_S
        if key[0] == "fused":      # h_out is h0: its bytes count once each way
            nbytes -= args[-1].numel() * 4
        t_exp = x.numel() * n / EXP_PER_S
    terms = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": ops / rate}
    if name == "selective_scan":
        terms["exp"] = t_exp
    by = max(terms, key=terms.get)
    return terms[by] * 1e3, by


def fused_bound_kernel(x, dt, dt_bias, B, C, A_log, D, z, h0=None):
    """The training path's forward of the fused scan (what
    ``SelectiveScanFusedFn`` launches): the kernel's instance that also
    keeps the state entering every chunk.  ``(out, h, bounds)``."""
    bounds = ss._bounds_for(x, A_log.shape[-1])
    out, h = ss._fused_fwd_cuda(x, dt, dt_bias, B, C, A_log, D, z, h0, None,
                                False, bounds)
    return out, h, bounds


def fused_bound_plain(x, dt, dt_bias, B, C, A_log, D, z, h0=None):
    """Its plain version: ``(out, h, bounds)``."""
    return ss.selective_scan_fused_ref(x, dt, dt_bias, B, C, A_log, D, z, h0,
                                       bounds=True)


def fused_bf16_kernel(x, dt, dt_bias, B, C, A_log, D, z, h0=None):
    """The bfloat16 working type's generation instance (what a prefill
    launches): ``(out, h)``."""
    return ss.selective_scan_fused(x, dt, dt_bias, B, C, A_log, D, z, h0,
                                   work_dtype=torch.bfloat16)


def fused_bf16_plain(x, dt, dt_bias, B, C, A_log, D, z, h0=None):
    """Its plain version: ``(out, h)``."""
    return ss.selective_scan_fused_bf16_ref(x, dt, dt_bias, B, C, A_log, D,
                                            z, h0)[:2]


def fused_bf16_bound_kernel(x, dt, dt_bias, B, C, A_log, D, z, h0=None):
    """The bfloat16 working type's training forward (what
    ``SelectiveScanFusedBf16Fn`` launches): the instance that keeps the
    state entering every chunk of ``q`` steps.  ``(out, h, bounds)``."""
    bounds = ss._bounds_for(x, A_log.shape[-1], True)
    out, h = ss._fused_fwd_cuda(x, dt, dt_bias, B, C, A_log, D, z, h0, None,
                                False, bounds, work_bf16=True)
    return out, h, bounds


def sequential_bf16_state(x, dt, dt_bias, B, C, A_log, D, z, h0=None):
    """The final state of the bfloat16 working type with a wrong order: each
    chunk's prefix of ``(a, u)`` taken sequentially in bfloat16 (``a_t =
    a_{t-1} a_t``, ``u_t = u_{t-1} a_t + u_t``, each op rounded) instead
    of the reference's tree, in plain torch."""
    f32, bf = torch.float32, torch.bfloat16
    A = -torch.exp(A_log.to(f32))
    dtf = ss.softplus(dt + dt_bias.to(dt.dtype)).to(f32)
    b, s, d = x.shape
    q = ss._pick_chunk(s, ss.SCAN_CHUNK)
    h = (torch.zeros((b, d, A.shape[-1]), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    for c0 in range(0, s, q):
        dq = dtf[:, c0:c0 + q]
        a = torch.exp(dq[..., None] * A).to(bf)
        u = ((dq * x[:, c0:c0 + q].to(f32))[..., None]
             * B[:, c0:c0 + q, None, :].to(f32)).to(bf)
        ac, uc = a[:, 0], u[:, 0]
        for t in range(1, q):
            ac, uc = ac * a[:, t], uc * a[:, t] + u[:, t]
        h = ac.to(f32) * h + uc.to(f32)
    return h


MODEL_CALLS = {
    "rmsnorm": (rn.rmsnorm, rn.rmsnorm_ref),
    "add_rmsnorm": (rn.add_rmsnorm, rn.add_rmsnorm_ref),
    "flash_attention": (fa.flash_attention, fa.flash_attention_ref),
    "selective_scan": (ss.selective_scan, ss.selective_scan_ref),
    "selective_scan_fused": (ss.selective_scan_fused,
                             ss.selective_scan_fused_ref),
    "selective_scan_fused_bound": (fused_bound_kernel, fused_bound_plain),
    "selective_scan_fused_bf16": (fused_bf16_kernel, fused_bf16_plain),
    "selective_scan_fused_bf16_bound": (fused_bf16_bound_kernel,
                                        ss.selective_scan_fused_bf16_ref),
}


def _form(name: str, key: tuple):
    """The form a shape key names: None for a plain-form key, "add" for
    the residual form of ``rmsnorm``, "fused" / "fused_step" for the fused
    scan over a sequence / for a decode step, "fused_bound" for its
    instance that keeps the chunk boundaries (the training forward), and
    "fused_bf16" / "fused_bf16_bound" for the bfloat16 working type's
    generation and training instances."""
    if name == "rmsnorm" and key[0] == "add":
        return "add"
    if name == "selective_scan" and key[0] == "fused":
        return "fused_step" if key[-1] else "fused"
    if name == "selective_scan" and key[0] in ("fused_bound", "fused_bf16",
                                               "fused_bf16_bound"):
        return key[0]
    return None


def check_model_kernel(name: str, key: tuple, device, timed: bool) -> dict:
    """Kernel vs plain version on the same inputs, within the stated
    tolerance; with ``timed`` also ``ms`` (one wrapper call), ``device_ms``
    (CUDA-graph replay), ``plain_ms``, ``library_ms`` and the bound.  A
    residual-form key of ``rmsnorm`` (``("add", ...)``) checks the sum
    ``s`` bit for bit, and is timed beside ``unfused_ms``: an ATen add,
    then the plain form's kernel.  A fused-scan key (``("fused", ...)``)
    gives each side its own copy of the state it updates in place, and is
    timed beside ``unfused_ms``: its plain version with the plain form's
    kernel for the scan over a sequence (the ATen sequence that
    ``mamba1_block`` ran before the fused form).  A ``("fused_bound",
    ...)`` key (the training forward) also holds the chunk boundaries
    within ``TOL_FUSED_STATE`` of the plain walk's, and is timed beside
    the generation instance on the same inputs (``without_bounds_ms``,
    ``without_bounds_device_ms``)."""
    form = _form(name, key)
    call = {"add": "add_rmsnorm", "fused": "selective_scan_fused",
            "fused_step": "selective_scan_fused",
            "fused_bound": "selective_scan_fused_bound",
            "fused_bf16": "selective_scan_fused_bf16",
            "fused_bf16_bound": "selective_scan_fused_bf16_bound"}.get(
                form, name)
    kernel, plain = MODEL_CALLS[call]
    args, kw = model_inputs(name, key, device)
    fused = call == "selective_scan_fused"

    def own_state(a):              # (..., h0, h_out) -> a fresh shared copy
        h = a[-1].clone()
        return a[:-2] + (h, h)

    got = kernel(*(own_state(args) if fused else args), **kw)
    torch.cuda.synchronize()
    want = plain(*(own_state(args) if fused else args), **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if form == "add":
        assert torch.equal(got[0], want[0]), (name, key, "s = x + r")
    tol = TOL[name][1 if got[0].dtype == torch.bfloat16 else 0]
    tols = [tol] * len(got)
    if fused or form in ("fused_bound", "fused_bf16", "fused_bf16_bound"):
        tol = [2e-2 if got[0].dtype == torch.bfloat16 else 2e-4,
               TOL_FUSED_STATE] + [TOL_FUSED_STATE] * (len(got) - 2)
        tols = tol
    err = 0.0
    for g, w, t in zip(got, want, tols):
        assert g.shape == w.shape and g.dtype == w.dtype, (name, key)
        diff = (g.float() - w.float()).abs()
        assert bool((diff <= t + t * w.float().abs()).all()), \
            (name, key, float(diff.max()))
        err = max(err, float(diff.max()))
    row = {"name": name, "key": json.loads(json.dumps(key, default=str)),
           "tol": tol, "max_abs_err": err}
    if form:
        row["form"] = form
    if timed:
        library = model_library(name, key)
        b_ms, b_by = model_bound(name, key, args, got)
        fns = {"ms": lambda: kernel(*args, **kw),
               "plain_ms": lambda: plain(*args, **kw)}
        if library is not None:
            fns["library_ms"] = lambda: library(*args, **kw)
        if form == "add":
            x, r, w, eps = args
            fns["unfused_ms"] = lambda: rn.rmsnorm(x + r, w, eps)
        if fused:
            fns["unfused_ms"] = lambda: plain(*args, scan=ss.selective_scan,
                                              **kw)
        if form in ("fused_bound", "fused_bf16_bound"):
            without = lambda: ss._fused_fwd_cuda(  # noqa: E731
                *args, None, False, work_bf16=form == "fused_bf16_bound")
            fns["without_bounds_ms"] = without
        row.update({"library_ms": None,
                    **interleaved(lambda fn: time_ms(fn, reps=0), fns)})
        row.update(device_ms=device_ms(lambda: kernel(*args, **kw)),
                   bound_ms=b_ms, bound_by=b_by)
        if form in ("fused_bound", "fused_bf16_bound"):
            row["without_bounds_device_ms"] = device_ms(without)
    return row


def check_model_ragged(device) -> list:
    rows = [check_model_kernel("rmsnorm", (shape, dt, dt), device, False)
            for shape, dt in RAGGED_RMS]
    rows += [check_model_kernel("rmsnorm", ("add", shape, dt, dt), device,
                                False)
             for shape, dt in RAGGED_RMS]
    for dt in ("float32", "bfloat16"):
        rows += [check_model_kernel(
            "flash_attention", ((b, h, sq, d), (b, kv, sk, d), causal,
                                window, dt), device, False)
            for b, h, kv, sq, sk, d, causal, window in RAGGED_FA]
        rows += [check_model_kernel("selective_scan", ((b, s, d), n, dt),
                                    device, False)
                 for b, s, d, n in RAGGED_SCAN]
        rows += [check_model_kernel(
            "selective_scan", ("fused", (b, 1 if step else s, d), n, dt,
                               step), device, False)
            for b, s, d, n in RAGGED_SCAN for step in (False, True)]
    rows += [check_model_kernel(
        "flash_attention", ((b, h, sq, d), (b, kv, sk, d), causal, window,
                            "bfloat16"), device, False)
        for b, h, kv, sq, sk, d, causal, window in RAGGED_FA_BF16]
    # what the kernels do not take is refused, not routed elsewhere
    q = torch.ones(1, 2, 8, 48, device=device)
    x = torch.ones(1, 4, 8, device=device)
    bn = torch.ones(1, 4, 32, device=device)
    odd = torch.ones(1, 2, 8, 36, dtype=torch.bfloat16, device=device)
    w8, b2 = torch.ones(8, device=device), torch.ones(1, 4, 2, device=device)
    a2 = torch.zeros(8, 2, device=device)
    for bad in (lambda: fa.flash_attention(q, q, q),
                lambda: fa.flash_attention(odd[..., :32], odd[..., :32],
                                           odd[..., :32]),        # stride 36
                lambda: fa.flash_attention(odd[..., 1:33], odd[..., 1:33],
                                           odd[..., 1:33]),       # pointer
                lambda: rn.rmsnorm(x.half(), torch.ones(8, device=device)),
                lambda: rn.add_rmsnorm(x, x.bfloat16(),
                                       torch.ones(8, device=device)),
                lambda: rn.add_rmsnorm(x, x.transpose(1, 2).contiguous()
                                       .transpose(1, 2),
                                       torch.ones(8, device=device)),
                lambda: ss.selective_scan(x, x, bn, bn,
                                          torch.ones(8, 32, device=device)),
                lambda: ss.selective_scan_fused(
                    x, x, w8, bn, bn, torch.ones(8, 32, device=device), w8,
                    x),
                lambda: ss.selective_scan_fused(
                    x, x.bfloat16(), w8, b2, b2, a2, w8, x),
                lambda: ss.selective_scan_fused(
                    x, x, w8, b2, b2, a2, w8, x,
                    h_out=torch.zeros(1, 8, 3, device=device))):
        try:
            bad()
        except (TypeError, ValueError):
            continue
        raise AssertionError("wrapper accepted an unsupported tensor")
    return rows


def check_model_path_shapes(device, shapes_by_phase: dict) -> list:
    """Every shape key a generate phase handed a model wrapper: checked
    against the plain version and timed, with the launches each phase made
    there."""
    rows = []
    for name in MODEL_KERNELS:
        seen = sorted({k for by_kernel in shapes_by_phase.values()
                       for k in by_kernel[name]}, key=repr)
        for key in seen:
            row = check_model_kernel(name, key, device, True)
            row["launches"] = {phase: by_kernel[name].get(key, 0)
                               for phase, by_kernel
                               in shapes_by_phase.items()}
            rows.append(row)
    return rows


def check_scan_at_falcon_shapes(device) -> list:
    """Both forms of the scan at falcon-mamba-7b's shapes where the
    generate phases do not reach them: the plain form (which the model no
    longer launches) at the prefill shape in both types, with ``h0``; the
    fused form at the prefill and the step shape in float32 (the path runs
    them in bfloat16).  Checked and timed, no launches on the path."""
    b, s, d, n = FALCON_SCAN
    keys = [((b, s, d), n, dt) for dt in ("bfloat16", "float32")]
    keys += [("fused", (b, shape[1], d), n, "float32", shape is FALCON_STEP)
             for shape in (FALCON_SCAN, FALCON_STEP)]
    rows = [check_model_kernel("selective_scan", key, device, True)
            for key in keys]
    for row in rows:
        row["launches"] = {}
    return rows


def resident_blocks(regs: int, smem: int, threads: int) -> int:
    """Blocks of a kernel (``regs`` registers a thread, ``smem`` bytes of
    static shared memory, ``threads`` a block) that one SM holds at once:
    the least of what its registers, its shared memory, its threads and its
    block slots allow."""
    warps = -(-threads // 32)
    regs_warp = -(-regs * 32 // REG_UNIT) * REG_UNIT
    smem_sm = torch.cuda.get_device_properties(0) \
        .shared_memory_per_multiprocessor
    return min(REGS_PER_SM // (regs_warp * warps),
               smem_sm // (smem + SMEM_PER_BLOCK_RESERVED),
               THREADS_PER_SM // threads, BLOCKS_PER_SM)


def scan_by_batch(device, scan_regs: dict) -> dict:
    """``device_ms`` of the plain form at falcon-mamba-7b's prefill shape in
    bfloat16 with batch 1, 4 and 16, beside the warps an SM holds at each
    (the blocks an SM is handed, up to what its registers and shared
    memory allow for the kernel's ``ptxas`` figures, two warps a block)."""
    b, s, d, n = FALCON_SCAN
    inst = scan_regs["bf16 plain"]
    cap = resident_blocks(inst["registers"], inst["smem"], SCAN_BLOCK_THREADS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"phase": "scan_by_batch", "shape": [s, d, n], "dtype": "bfloat16",
           "resident_blocks_per_sm_max": cap}
    for rows in (1, 4, 16):
        args, _ = model_inputs("selective_scan", ((rows, s, d), n,
                                                  "bfloat16"), device)
        blocks = rows * -(-d // SCAN_BLOCK_CHANNELS)
        out[f"batch_{rows}"] = {
            "device_ms": device_ms(lambda args=args: ss.selective_scan(*args)),
            "blocks": blocks,
            "resident_warps_per_sm": min(blocks / sms, cap)
            * SCAN_BLOCK_THREADS / 32}
    return out


# ---------------------------------------------------------------------------
# the generation path: full-size generate, and the slice against the host
# ---------------------------------------------------------------------------

GEN_BATCH, GEN_PROMPT, GEN_TOKENS = 4, 512, 32
#: The archs generated at full width and depth, and their phases' names:
#: the dense, Mamba1, MoE, vlm (2,880 image embeddings and 8 text tokens:
#: the reference's prompt at 512) and audio families.
GEN_ARCHS = {"qwen2-7b": "generate_qwen2_7b",
             "falcon-mamba-7b": "generate_falcon_mamba_7b",
             "granite-moe-3b-a800m": "generate_granite_moe_3b_a800m",
             "llava-next-mistral-7b": "generate_llava_next_mistral_7b",
             "musicgen-large": "generate_musicgen_large",
             "zamba2-7b": "generate_zamba2_7b"}
#: Traced under ``--profile``.
PROFILE_GEN_ARCHS = ("qwen2-7b", "falcon-mamba-7b", "granite-moe-3b-a800m",
                     "zamba2-7b")
#: The archs held card against host at full width and ``SLICE_LAYERS``
#: layers, and their phases' names (gpt-1.1b: head dim 96, the training
#: CLI's default arch).
SLICE_ARCHS = {"qwen2-7b": "slice_check_qwen2_7b",
               "falcon-mamba-7b": "slice_check_falcon_mamba_7b",
               "granite-moe-3b-a800m": "slice_check_granite_moe_3b_a800m",
               "gpt-1.1b": "slice_check_gpt_1_1b",
               "zamba2-7b": "slice_check_zamba2_7b"}
SLICE_LAYERS, SLICE_PROMPT = 2, 128


def slice_cut(arch: str, n_layers: int) -> dict:
    """The config overrides of a slice of ``arch`` at ``n_layers`` layers:
    a hybrid's shared block also runs after every ``n_layers``-th layer
    (its period cut to the slice's depth), or a slice shallower than the
    period would never apply it."""
    cut = {"n_layers": n_layers}
    if configs.get(arch).hybrid_attn_period:
        cut["hybrid_attn_period"] = n_layers
    return cut


def hybrid_generate_counts(cfg, plen: int, steps: int) -> tuple:
    """``(rmsnorm launches, shape split, flash_attention launches, per
    prefill, per step)`` of a hybrid generate: per prefill one plain norm
    over the sequence (the first ``ln1``), ``L - 1`` residual ``ln1``s and
    two residual norms per shared-block application, ``L`` gated norms
    (float32 input, the config's weight type, ``d_inner`` wide) and one
    plain norm of the last row; per step the same with the final norm
    residual, every norm over one row, and one attention launch per
    application in the prefill only."""
    _, meta = layer_plan(cfg)
    L, apps = cfg.n_layers, len(meta["shared_at"])
    d, di, bf = cfg.d_model, cfg.d_inner, torch.bfloat16
    f32, wt = torch.float32, _dtype(cfg.dtype)
    seq, last = (GEN_BATCH, plen, d), (GEN_BATCH, 1, d)
    norms = 2 * L + 2 * apps + 1
    split = {(seq, bf, bf): 1, ("add", seq, bf, bf): L - 1 + 2 * apps,
             ((GEN_BATCH, plen, di), f32, wt): L,
             (last, bf, bf): 1 + steps,
             ((GEN_BATCH, di), f32, wt): L * steps,
             ("add", last, bf, bf): (L + 2 * apps) * steps}
    per_prefill = {"rmsnorm": norms, "rmsnorm_residual_form": L - 1 + 2 * apps,
                   "rmsnorm_gated_float32_input": L,
                   "flash_attention": apps, "selective_scan_fused": 0,
                   "selective_scan_plain_form": 0}
    per_step = {"rmsnorm": norms, "rmsnorm_residual_form": L + 2 * apps,
                "rmsnorm_gated_float32_input": L, "flash_attention": 0,
                "selective_scan_fused": 0}
    return norms * (1 + steps), split, apps, per_prefill, per_step
#: Whole-slice tolerance on logits (unit scale: a normalised state times a
#: head of variance 1/d): both sides round every product to bfloat16 (8
#: significant bits), at different places and after sums in another order,
#: so a logit may move by a few bfloat16 steps of the numbers it is summed
#: from.  Held on the largest and on the mean absolute difference.
SLICE_TOL_MAX, SLICE_TOL_MEAN = 0.25, 0.02


def run_generate(name: str, arch: str, device,
                 scan_dtype: str = "float32") -> tuple:
    """``launch.generate.generate`` at full width and depth; asserts the
    exact launch count of each kernel (and, with attention, the one shape
    of the prefill's attention).  A vlm prompt is the config's image
    embeddings and ``max(GEN_PROMPT - n_img, 8)`` text tokens, as the
    reference builds it.  ``scan_dtype`` is a Mamba1 config's working type
    (``"bfloat16"``: each prefill's scan in its bfloat16 instance, the
    decode steps on the float32 step, as in the reference)."""
    cfg = configs.get(arch).replace(scan_dtype=scan_dtype)
    torch.cuda.empty_cache()
    reset_launches()
    t0 = time.perf_counter()
    res = gen_cli.generate(cfg, batch=GEN_BATCH, prompt_len=GEN_PROMPT,
                           gen=GEN_TOKENS, seed=0, device=device)
    wall = time.perf_counter() - t0
    launches, shapes = read_launches(), read_shapes()
    toks = res["tokens"]
    assert tuple(toks.shape) == (GEN_BATCH, GEN_TOKENS), toks.shape
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    steps, plen = res["decode_steps"], res["prompt_len"]
    hybrid = cfg.family == "hybrid"
    attn = cfg.family in ATTENTION_FAMILIES
    norms = 1 + (2 if attn else 1) * cfg.n_layers
    want = {k: 0 for k in WRAPPERS}
    want["rmsnorm"] = norms * (1 + steps)          # per prefill, per step
    n_attn = cfg.n_layers if attn else 0
    if hybrid:
        want["rmsnorm"], split, n_attn, per_prefill, per_step = \
            hybrid_generate_counts(cfg, plen, steps)
    elif not attn:                                 # per prefill, per step
        want["selective_scan"] = cfg.n_layers * (1 + steps)
    want["flash_attention"] = n_attn               # per prefill
    assert launches == want, (name, launches, want)
    if n_attn:
        fa_key = ((GEN_BATCH, cfg.n_heads, plen, cfg.hd),
                  (GEN_BATCH, cfg.n_kv_heads, plen, cfg.hd), True, 0,
                  str(torch.bfloat16))
        assert shapes["flash_attention"] == {fa_key: n_attn}, \
            shapes["flash_attention"]
    # per prefill one plain norm over the sequence, norms - 2 residual
    # ones and one plain norm of the last row; per step one plain and
    # norms - 1 residual ones (a hybrid's split: hybrid_generate_counts)
    d, bf = cfg.d_model, torch.bfloat16
    seq, last = (GEN_BATCH, plen, d), (GEN_BATCH, 1, d)
    if not hybrid:
        split = {(seq, bf, bf): 1, ("add", seq, bf, bf): norms - 2,
                 (last, bf, bf): 1 + steps,
                 ("add", last, bf, bf): (norms - 1) * steps}
    assert shapes["rmsnorm"] == split, shapes["rmsnorm"]
    # the scan only in its fused form: one a layer per prefill and per step
    scans = {}
    if not attn and not hybrid:
        di, n = cfg.d_inner, cfg.ssm_state
        prefill = (("fused_bf16", (GEN_BATCH, GEN_PROMPT, di), n, bf)
                   if scan_dtype == "bfloat16" else
                   ("fused", (GEN_BATCH, GEN_PROMPT, di), n, bf, False))
        scans = {prefill: cfg.n_layers,
                 ("fused", (GEN_BATCH, 1, di), n, bf, True):
                 cfg.n_layers * steps}
    assert shapes["selective_scan"] == scans, shapes["selective_scan"]
    fused = cfg.n_layers if scans else 0
    line = {
        "phase": name, "model": cfg.name, "family": cfg.family,
        "n_layers": cfg.n_layers, "d_model": d, "vocab": cfg.vocab_size,
        "batch": GEN_BATCH, "prompt_len": plen, "gen": GEN_TOKENS,
        **({"scan_dtype": scan_dtype} if scans else {}),
        **({"image_embeddings": cfg.n_img_tokens,
            "text_tokens": plen - cfg.n_img_tokens}
           if cfg.frontend == "vlm" else {}),
        **({"experts": cfg.n_experts, "top_k": cfg.experts_per_token,
            "capacity_factor": cfg.capacity_factor}
           if cfg.family == "moe" else {}),
        **({"ssm": f"Mamba2 (plain-torch SSD), d_inner {cfg.d_inner}, "
                   f"{cfg.n_ssm_heads} heads of {cfg.ssm_head_dim}, N "
                   f"{cfg.ssm_state}",
            "shared_block_after_layers": layer_plan(cfg)[1]["shared_at"]}
           if hybrid else {}),
        "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
        "decode_ms_per_token": res["decode_s"] / steps * 1e3,
        "wall_s_with_init": wall,
        "peak_memory_bytes": res["peak_bytes"],
        "launches": launches,
        "launches_per_prefill": per_prefill if hybrid else {
            "rmsnorm": norms, "rmsnorm_residual_form": norms - 2,
            "flash_attention": want["flash_attention"],
            "selective_scan_fused": fused, "selective_scan_plain_form": 0},
        "launches_per_decode_step": per_step if hybrid else {
            "rmsnorm": norms, "rmsnorm_residual_form": norms - 1,
            "selective_scan_fused": fused},
        "sample": toks[0, :8].tolist(),
        "tokens": toks.tolist() if scans else None,
        "seconds": time.perf_counter() - t0,
    }
    del res
    torch.cuda.empty_cache()
    return line, launches, shapes


def profile_generate(name: str, arch: str, device) -> dict:
    """Where the card's time goes in a generate of ``run_generate``'s size:
    one prefill and four greedy decode steps, each traced after a warm-up
    prefill and two steps."""
    cfg = configs.get(arch)
    ctx = ShardCtx()
    params = init_params(cfg, seed=0, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT),
                            generator=gen, device=device)
    prefill = make_prefill_step(cfg, ctx)
    step = make_decode_step(cfg, ctx)
    state = {}

    def run_prefill():
        logits, cache = prefill(params, {"tokens": prompts})
        state["cache"] = gen_cli.grow_cache(cache, 8)
        state["tok"] = torch.argmax(logits, dim=-1)[:, None]

    def run_steps(first, n):
        for i in range(first, first + n):
            state["tok"], _, state["cache"] = step(
                params, state["cache"], state["tok"], GEN_PROMPT + i)

    run_prefill()
    run_steps(0, 2)
    out = {"phase": name, "model": cfg.name, "batch": GEN_BATCH,
           "prompt_len": GEN_PROMPT, "prefill": trace(run_prefill),
           "decode_4_steps": trace(lambda: run_steps(2, 4))}
    del params, state
    torch.cuda.empty_cache()
    return out


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.cpu()


#: Archs whose card-against-host slices run in float32: an MoE router
#: picks its top k of many experts, and in bfloat16 a logit one step away
#: between two correct sides (the card's attention kernel against the
#: host's plain attention) can reorder a near-tie and send a token to
#: another expert; in float32 the two sides agree to 1e-6 and the checks
#: hold the MoE path and the float32 attention instance.  The bfloat16
#: MoE runs in the generate and train phases.
SLICE_DTYPE = {"granite-moe-3b-a800m": "float32"}


def slice_check(name: str, arch: str, device) -> dict:
    """One model at full width and ``SLICE_LAYERS`` layers, batch 1: the
    card's prefill logits (kernels) against the host's (plain versions) on
    the same weights, and the card's first decode step against
    ``forward_logits`` at the next position — the reference's own
    prefill/decode consistency check."""
    t_phase = time.perf_counter()
    cut = slice_cut(arch, SLICE_LAYERS)
    cfg = configs.get(arch).replace(**cut)
    if arch in SLICE_DTYPE:
        cfg = cfg.replace(dtype=SLICE_DTYPE[arch])
    if cfg.family == "moe":
        # a capacity that drops nothing: the decode step's one token never
        # fills an expert, where the forward's 129 tokens at the config's
        # factor drop the assignments past an expert's capacity (the
        # reference's own consistency test runs its MoE configs at 8)
        cfg = cfg.replace(capacity_factor=float(cfg.n_experts))
    ctx = ShardCtx()
    params = init_params(cfg, seed=1, device=device)
    host = _to_host(params)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, SLICE_PROMPT + 1),
                         generator=gen)
    prompt = toks[:, :SLICE_PROMPT]

    def diff(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        assert a.shape == b.shape and torch.isfinite(a).all() \
            and torch.isfinite(b).all()
        d = (a - b).abs()
        out = {"max_abs": float(d.max()), "mean_abs": float(d.mean()),
               "scale": float(b.abs().max()),
               "argmax_equal": bool(torch.equal(a.argmax(-1),
                                                 b.argmax(-1)))}
        assert out["max_abs"] <= SLICE_TOL_MAX and \
            out["mean_abs"] <= SLICE_TOL_MEAN, (name, out)
        return out

    card_last, card_cache = M.prefill(params, cfg, ctx, prompt.to(device))
    t0 = time.perf_counter()
    host_last, _ = M.prefill(host, cfg, ctx, prompt)
    host_s = time.perf_counter() - t0
    prefill = diff(card_last, host_last)
    step_logits, _ = M.decode_step(
        params, cfg, ctx, toks[:, SLICE_PROMPT:].to(device),
        gen_cli.grow_cache(card_cache, 1), SLICE_PROMPT)
    full = M.forward_logits(params, cfg, ctx, toks.to(device))
    decode = diff(step_logits, full[:, SLICE_PROMPT])
    del params, host, card_cache, full
    torch.cuda.empty_cache()
    return {"phase": name, "model": cfg.name, "n_layers": SLICE_LAYERS,
            **({"cut": cut} if len(cut) > 1 else {}),
            "prompt_len": SLICE_PROMPT, "dtype": cfg.dtype,
            **({"capacity_factor": cfg.capacity_factor}
               if cfg.family == "moe" else {}),
            "tol": {"max_abs": SLICE_TOL_MAX, "mean_abs": SLICE_TOL_MEAN},
            "prefill_card_vs_host": prefill,
            "decode_vs_forward_logits": decode, "host_prefill_s": host_s,
            "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# the backward kernels: against their plain versions, and timing
# ---------------------------------------------------------------------------

#: (float32, bfloat16) tolerance of each backward kernel against its plain
#: version, relative to the largest magnitude of the plain result: float32
#: sums in another order (the attention's also ``expf`` within 2 ulp); in
#: bfloat16 an output may round to the neighbouring value.  The same holds
#: each plain backward against torch autograd of its plain forward.
TOL_BWD = {"rmsnorm_bwd": (2e-5, 1e-2), "flash_attention_bwd": (1e-4, 1e-2),
           "selective_scan_fused_bwd": (1e-4, 1e-2)}
#: The bfloat16 working type's backward against its plain version, in
#: both input types: a float32 ulp between the kernel's and torch's
#: sigmoid, exp or sum order can move a bfloat16 rounding of the tree's
#: gradients a step, which the float32 gradients then carry.
TOL_BWD_BF16_WORK = 1e-2
#: The forward's log-sum-exp against the plain one (absolute, on finite
#: rows; rows with no allowed key must be +inf on both sides).
TOL_LSE = 1e-4
#: Finite-difference check of each Function in float32 (the kernels take no
#: float64): the directional derivative of sum(out * W) by a central
#: difference of step FD_EPS, against <gradient, direction>, relative.
FD_EPS, FD_TOL = 1e-3, 1e-3
#: (shape, x dtype, w dtype) of the norm backward: one row, fewer rows than
#: its 128 blocks, more (300: runs of two and three rows); packed and
#: unpacked widths, the training paths' (768, 1920, 3584, 7168, the last
#: also as Mamba2's float32-x / bfloat16-w pair) and 12288, wider than the
#: ring takes.
RAGGED_RMS_BWD = [((rows, d), dt, dt) for rows in (1, 7, 70, 300)
                  for d in (32, 36, 384, 768, 1920, 3584, 7168, 12288)
                  for dt in ("float32", "bfloat16")] + [
    ((rows, 7168), "float32", "bfloat16") for rows in (1, 7, 70, 300)]
#: (b, h, kv, sq, sk, d, causal, window): GQA, Sq != Sk both ways, a
#: window, rows with no allowed key (the fifth), D = 256 with a group of two
#: and of one, qwen2-7b's heads (a group of 7) at a ragged length, and keys
#: no query may see (the last: causal, Sq < Sk, a window).
RAGGED_FA_BWD = [
    (2, 4, 2, 64, 64, 32, True, 0), (1, 4, 1, 50, 90, 64, False, 0),
    (1, 2, 2, 100, 100, 128, True, 16), (2, 8, 2, 96, 40, 128, True, 0),
    (1, 2, 2, 64, 16, 16, True, 8), (1, 2, 1, 40, 40, 256, True, 0),
    (1, 28, 4, 130, 130, 128, True, 0), (2, 4, 4, 70, 33, 256, False, 0),
    (1, 7, 1, 33, 77, 32, True, 20),
]
#: The bfloat16 attention backward where its grid fills the card (not a
#: shape of the main path): qwen2-7b's heads at 2048 tokens, causal.
FULL_GRID_FA_BWD = ("bwd", (1, 28, 2048, 128), (1, 4, 2048, 128), True, 0,
                    "bfloat16")
#: (b, S, D, N) of the fused scan's backward: S not a multiple of its chunk
#: (16), D not a multiple of its 32 channels a block, N at 1, 5, 7 and 16;
#: each with (h0, dh_final) absent, both present, and dh_final alone.
RAGGED_SCAN_BWD = [(2, 37, 24, 5), (1, 20, 40, 16), (2, 33, 45, 1),
                   (1, 17, 100, 16), (3, 5, 9, 7), (2, 64, 32, 8)]
SCAN_BWD_STARTS = [(False, False), (True, True), (False, True)]
BWD_EPS = 1e-5


def bwd_inputs(name: str, key: tuple, device) -> dict:
    """Random inputs of one backward call at a backward shape key, laid out
    as the training path hands them: attention tensors are ``(B, S, H,
    D)`` views as ``(B, H, S, D)``, and ``out`` and ``lse`` come from the
    forward kernel; so do the scan's chunk boundaries (``bounds``), which
    are held within ``TOL_FUSED_STATE`` of the plain walk's, the forward's
    outputs bit-equal to the generation instance's."""
    gen = torch.Generator(device=device)
    gen.manual_seed(zlib.crc32(repr(key).encode()))
    if name == "selective_scan_fused_bwd":
        # ("fused_bwd" or "fused_bf16_bwd", x shape, N, dtype[, with h0,
        # with dh_final]); the training path's keys have neither
        work = key[0] == "fused_bf16_bwd"
        _, shape, n, dt = key[:4]
        with_h0, with_dhf = key[4:6] if len(key) > 4 else (False, False)
        args, _ = fused_inputs(gen, ("fused", tuple(shape), n, dt, False),
                               device)
        x, dt_, bias, B, C, A_log, D, z, h0, _ = args
        b, s, d = x.shape
        h0 = h0 if with_h0 else None
        fwd = (x, dt_, bias, B, C, A_log, D, z, h0)
        out, h, bounds = (fused_bf16_bound_kernel if work
                          else fused_bound_kernel)(*fwd)
        # the generation instance gives the same bits without them
        out_g, h_g = ss._fused_fwd_cuda(*fwd, None, False, work_bf16=work)
        torch.cuda.synchronize()
        assert torch.equal(out, out_g) and torch.equal(h, h_g), (name, key)
        want = (ss.selective_scan_fused_bf16_ref if work
                else fused_bound_plain)(*fwd)[2]
        assert bool(((bounds - want).abs() <= TOL_FUSED_STATE * (
            1 + want.abs())).all()), (name, key, "bounds")
        return {"x": x, "dt": dt_, "dt_bias": bias, "B": B, "C": C,
                "A_log": A_log, "D": D, "z": z, "h0": h0,
                "dout": _randn(gen, (b, s, d), x.dtype, device),
                "dh_final": _randn(gen, (b, d, n), torch.float32, device)
                if with_dhf else None, "bounds": bounds}
    if name == "rmsnorm_bwd":
        shape, xt, wt = key[1], _dtype(key[2]), _dtype(key[3])
        with_ds = key[0] == "add_bwd" and key[4]
        return {"x": _randn(gen, shape, xt, device, 3.0),
                "w": _randn(gen, shape[-1:], wt, device),
                "dy": _randn(gen, shape, xt, device),
                "ds": _randn(gen, shape, xt, device) if with_ds else None}
    (q, k, v), kw = model_inputs("flash_attention", key[1:], device)
    b, h, sq, d = q.shape
    dout = _randn(gen, (b, sq, h, d), q.dtype, device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=device)
    out = fa._fwd_cuda(q, k, v, kw["causal"], kw["window"], lse,
                       kw["q_offset"])
    return {"q": q, "k": k, "v": v, "out": out, "lse": lse, "dout": dout,
            **kw}


def bwd_calls(name: str, key: tuple, a: dict, timed: bool) -> tuple:
    """``(kernel, plain, library, library_note)`` calls on the inputs
    ``a``: the backward kernel's wrapper, its plain version, and, when
    ``timed``, the backward of one PyTorch call computing the forward
    (autograd of ``F.rms_norm``, of ``x + r`` and ``F.rms_norm`` for the
    residual form, and for attention SDPA's backward with the flash or
    efficient backend — the efficient one in float32 — and
    ``enable_gqa``, on KV repeated to the query heads where those
    backends refuse grouped heads), timed as a yardstick only, or None
    where there is none."""
    F = torch.nn.functional
    if name == "selective_scan_fused_bwd":
        args = [a[k] for k in ("x", "dt", "dt_bias", "B", "C", "A_log", "D",
                               "z", "h0", "dout", "dh_final")]
        work = key[0] == "fused_bf16_bwd"
        plain = (ss.selective_scan_fused_bf16_bwd_ref if work
                 else ss.selective_scan_fused_bwd_ref)
        return (lambda: ss._bwd_cuda(*args, a["bounds"], work_bf16=work),
                lambda: plain(*args), None,
                "none (no single PyTorch call computes this backward)")
    if name == "rmsnorm_bwd":
        x, w, dy, ds = a["x"], a["w"], a["dy"], a["ds"]
        d = x.shape[-1]
        kernel = lambda: rn._rmsnorm_bwd_cuda(x, w, dy, BWD_EPS, ds, key)  # noqa: E731
        plain = lambda: rn.rmsnorm_bwd_ref(x, w, dy, BWD_EPS, ds)  # noqa: E731
        if not timed:
            return kernel, plain, None, None
        xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
        wc = wr.to(x.dtype)            # one type for F.rms_norm
        if key[0] == "add_bwd":
            rr = torch.zeros_like(x).requires_grad_()
            sr = xr + rr
            yr = F.rms_norm(sr, (d,), wc, BWD_EPS)
            outs, cots = ((sr, yr), (ds, dy)) if ds is not None else \
                ((yr,), (dy,))
            library = lambda: torch.autograd.grad(  # noqa: E731
                outs, (xr, rr, wr), cots, retain_graph=True)
        else:
            yr = F.rms_norm(xr, (d,), wc, BWD_EPS)
            library = lambda: torch.autograd.grad(  # noqa: E731
                yr, (xr, wr), dy, retain_graph=True)
        return kernel, plain, library, "autograd of F.rms_norm"
    q, k, v, out, lse, dout = (a[n] for n in ("q", "k", "v", "out", "lse",
                                              "dout"))
    causal, window, off = a["causal"], a["window"], a["q_offset"]
    kernel = lambda: fa._bwd_cuda(q, k, v, out, lse, dout, causal, window,  # noqa: E731
                                  off)
    plain = lambda: fa.flash_attention_bwd_ref(  # noqa: E731
        q, k, v, out, lse, dout, causal=causal, window=window, q_offset=off)
    sq, sk = q.shape[2], k.shape[2]
    if timed and off and q.dtype == torch.bfloat16:
        # a share of a sequence's rows: SDPA with an explicit boolean mask
        # (is_causal takes no offset), its backward by autograd
        ql, kl, vl = (t.detach().contiguous().requires_grad_()
                      for t in (q, k, v))
        ol = _masked_sdpa(ql, kl, vl, causal, window, off)
        dl = dout.contiguous()
        library = lambda: torch.autograd.grad(  # noqa: E731
            ol, (ql, kl, vl), dl, retain_graph=True)
        return kernel, plain, library, ("SDPA backward with an explicit "
                                         "boolean mask (enable_gqa)")
    if not (timed and window == 0 and (sq == sk or not causal)
            and q.dtype in (torch.bfloat16, torch.float32)):
        return kernel, plain, None, None
    from torch.nn.attention import SDPBackend, sdpa_kernel
    group = q.shape[1] // k.shape[1]
    ql = q.detach().contiguous().requires_grad_()
    note = "SDPA backward (flash or efficient backend, enable_gqa)"
    try:
        kl, vl = (t.detach().contiguous().requires_grad_() for t in (k, v))
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION]):
            ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                                enable_gqa=True)
    except RuntimeError:             # the fused backends refuse grouped KV
        note = ("SDPA backward (flash or efficient backend) on KV repeated "
                "to the query heads")
        kl, vl = (t.detach().repeat_interleave(group, dim=1)
                  .requires_grad_() for t in (k, v))
        try:
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                              SDPBackend.EFFICIENT_ATTENTION]):
                ol = F.scaled_dot_product_attention(ql, kl, vl,
                                                    is_causal=causal)
        except RuntimeError:         # neither takes this head dim
            return kernel, plain, None, ("none (SDPA's flash and efficient "
                                         "backends refuse this head dim)")
    dl = dout.contiguous()
    library = lambda: torch.autograd.grad(  # noqa: E731
        ol, (ql, kl, vl), dl, retain_graph=True)
    return kernel, plain, library, note


def bwd_bound(name: str, key: tuple, a: dict, outs) -> tuple:
    """(bound_ms, bound_by) of one backward call: the larger of bytes over
    the memory rate (each input read once, each output written once) and
    operations over the peak rate for the inputs' type.  The norm's
    backward counts 11 operations an element (12 with ``ds_in``) at the
    float32 rate; the attention's its five products over the (query, key)
    pairs the mask allows, ``10 B H D pairs``, at the tensor-core rate for
    bfloat16 inputs and the CUDA cores' float32 rate for float32; the scan's
    its ``b S D N`` exponentials, one a state, at the special function
    units' rate (``EXP_PER_S``), as the forward's bound counts them.  The
    scan's chunk boundaries are the forward's output, saved for this call
    by this design, and not an input of the function: not counted."""
    ins = [t for k, t in a.items() if isinstance(t, torch.Tensor)
           and k != "bounds"]
    nbytes = sum(t.numel() * t.element_size()
                 for t in ins + [o for o in outs if o is not None])
    if name == "selective_scan_fused_bwd":
        ops, rate = a["x"].numel() * a["A_log"].shape[-1], EXP_PER_S
    elif name == "rmsnorm_bwd":
        ops, rate = (12 if a["ds"] is not None else 11) * a["x"].numel(), \
            OPS_PER_S
    else:
        qs, ks, causal, window, dt = key[1:6]
        pairs = int(fa._allowed(qs[2], ks[2], causal, window, "cpu",
                                _q_offset(key)).sum())
        ops = 10 * qs[0] * qs[1] * qs[3] * pairs
        rate = BF16_OPS_PER_S if "bfloat16" in dt else OPS_PER_S
    terms = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": ops / rate}
    by = max(terms, key=terms.get)
    return terms[by] * 1e3, by


def _max_rel(got, want) -> tuple:
    """(largest absolute difference, largest magnitude of ``want``)."""
    g, w = got.float(), want.float()
    return float((g - w).abs().max()), float(w.abs().max())


def check_bwd_kernel(name: str, key: tuple, device, timed: bool) -> dict:
    """Backward kernel vs its plain version on the same inputs, within
    ``TOL_BWD`` of the largest magnitude (``TOL_BWD_BF16_WORK`` for the
    scan's bfloat16 working type; and, for the attention, the forward's
    ``lse`` vs the plain one); a second launch bit-equal to the first (the
    attention's in bfloat16), and for the norm and the bfloat16 working
    type's scan a CUDA-graph replay too; with ``timed`` also ``ms``,
    ``device_ms``, ``plain_ms``, ``library_ms`` and the bound."""
    a = bwd_inputs(name, key, device)
    kernel, plain, library, note = bwd_calls(name, key, a, timed)
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    dt = got[0].dtype
    work = key[0] == "fused_bf16_bwd"
    tol = TOL_BWD_BF16_WORK if work else \
        TOL_BWD[name][1 if dt == torch.bfloat16 else 0]
    err = 0.0
    for g, w in zip(got, want):
        if w is None:                  # the scan's dh0 without h0
            assert g is None, (name, key)
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, (name, key)
        assert bool(torch.isfinite(g).all()), (name, key)
        diff, scale = _max_rel(g, w)
        # each output at its own type's tolerance (the gated norm's dw is
        # bfloat16 beside a float32 dx)
        t = TOL_BWD_BF16_WORK if work else \
            TOL_BWD[name][1 if g.dtype == torch.bfloat16 else 0]
        assert diff <= t * max(scale, 1e-30), (name, key, diff, scale)
        err = max(err, diff)
    row = {"name": name, "key": json.loads(json.dumps(key, default=str)),
           "tol": tol, "max_abs_err": err}
    if name == "flash_attention_bwd":
        _, want_lse = fa.flash_attention_ref(a["q"], a["k"], a["v"],
                                             causal=a["causal"],
                                             window=a["window"],
                                             return_lse=True,
                                             q_offset=a["q_offset"])
        fin = torch.isfinite(want_lse)
        assert torch.equal(torch.isfinite(a["lse"]), fin), (name, key)
        lse_err = float((a["lse"][fin] - want_lse[fin]).abs().max()) \
            if bool(fin.any()) else 0.0
        assert lse_err <= TOL_LSE, (name, key, lse_err)
        row["lse_max_abs_err"] = lse_err
        row["rows_without_keys"] = int((~fin).sum())
        if not bool(fin.all()):          # those rows pass no gradient
            assert bool((got[0].float().abs().sum(-1)[~fin] == 0).all())
    if name == "flash_attention_bwd" and dt == torch.bfloat16 \
            or name != "flash_attention_bwd":
        again = kernel()                 # no atomics: the same bits again
        torch.cuda.synchronize()
        row["repeat_bits_equal"] = all(
            (g is None and a_ is None) or torch.equal(g, a_)
            for g, a_ in zip(got, again))
        assert row["repeat_bits_equal"], (name, key)
    if name == "rmsnorm_bwd" or work:
        # its cooperative launch (the bfloat16 working type's: its pairs'
        # partials added in order) replays from a CUDA graph (device_ms,
        # the training step's capture) to the same bits
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = kernel()
        graph.replay()
        torch.cuda.synchronize()
        row["graph_bits_equal"] = all(
            (g is None and r is None) or torch.equal(g, r)
            for g, r in zip(got, replayed))
        assert row["graph_bits_equal"], (name, key)
        del graph, replayed
    if timed:
        b_ms, b_by = bwd_bound(name, key, a, got)
        fns = {"ms": kernel, "plain_ms": plain}
        if library is not None:
            fns["library_ms"] = library
        row.update({"library_ms": None, "library": note,
                    **interleaved(lambda fn: time_ms(fn, reps=0), fns)})
        # the bfloat16 working type's backward takes tens of ms a call:
        # fewer captured calls (its time is the mean all the same)
        row.update(device_ms=device_ms(kernel, reps=5, replays=2) if work
                   else device_ms(kernel), bound_ms=b_ms, bound_by=b_by)
    return row


def check_plain_bwd_against_autograd(device) -> list:
    """Each plain backward against ``torch.autograd.grad`` of its plain
    forward on the card, in both types, within ``TOL_BWD``."""
    rows = []
    for dt in ("float32", "bfloat16"):
        for shape in ((7, 384), (70, 3584)):
            for form, key in (("plain", ("bwd", shape, dt, dt)),
                              ("add", ("add_bwd", shape, dt, dt, True))):
                a = bwd_inputs("rmsnorm_bwd", key, device)
                x, w, dy, ds = a["x"], a["w"], a["dy"], a["ds"]
                xr, wr = x.detach().requires_grad_(), \
                    w.detach().requires_grad_()
                if form == "add":
                    rr = torch.zeros_like(x).requires_grad_()
                    s_, y_ = rn.add_rmsnorm_ref(xr, rr, wr, BWD_EPS)
                    auto = torch.autograd.grad((s_, y_), (xr, rr, wr),
                                               (ds, dy))
                    auto = (auto[0], auto[2])
                else:
                    auto = torch.autograd.grad(rn.rmsnorm_ref(xr, wr,
                                                              BWD_EPS),
                                               (xr, wr), dy)
                mine = rn.rmsnorm_bwd_ref(x, w, dy, BWD_EPS, ds)
                tol = TOL_BWD["rmsnorm_bwd"][dt == "bfloat16"]
                err = max(_max_rel(m, t)[0] / max(_max_rel(m, t)[1], 1e-30)
                          for m, t in zip(mine, auto))
                assert err <= tol, ("rmsnorm_bwd_ref", key, err)
                rows.append({"name": "rmsnorm_bwd_ref", "form": form,
                             "key": json.loads(json.dumps(key, default=str)),
                             "rel_err_vs_autograd": err})
        for case in (RAGGED_FA_BWD[2], RAGGED_FA_BWD[4]):
            b, h, kv, sq, sk, d, causal, window = case
            key = ("bwd", (b, h, sq, d), (b, kv, sk, d), causal, window, dt)
            a = bwd_inputs("flash_attention_bwd", key, device)
            leaves_ = [a[n].detach().requires_grad_() for n in "qkv"]
            o = fa.flash_attention_ref(*leaves_, causal=causal, window=window)
            auto = torch.autograd.grad(o, leaves_, a["dout"])
            with torch.no_grad():
                o2, lse2 = fa.flash_attention_ref(a["q"], a["k"], a["v"],
                                                  causal=causal,
                                                  window=window,
                                                  return_lse=True)
            mine = fa.flash_attention_bwd_ref(a["q"], a["k"], a["v"], o2,
                                              lse2, a["dout"], causal=causal,
                                              window=window)
            tol = TOL_BWD["flash_attention_bwd"][dt == "bfloat16"]
            err = max(_max_rel(m, t)[0] / max(_max_rel(m, t)[1], 1e-30)
                      for m, t in zip(mine, auto))
            assert err <= tol, ("flash_attention_bwd_ref", key, err)
            rows.append({"name": "flash_attention_bwd_ref",
                         "key": json.loads(json.dumps(key, default=str)),
                         "rel_err_vs_autograd": err})
    return rows


def finite_difference(fn, inputs: list, device, seed: int) -> dict:
    """Central-difference directional derivatives of ``L = sum(fn(*inputs)
    * W)`` (summed in float64) against ``<grad L, u>`` by the Function's
    backward, for two random directions ``u``; returns the largest
    relative error."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    leaves_ = [t.detach().requires_grad_() for t in inputs]
    outs = fn(*leaves_)
    outs = outs if isinstance(outs, tuple) else (outs,)
    ws = [torch.randn(o.shape, generator=gen, device=device) for o in outs]

    def loss(ts):
        with torch.no_grad():
            res = fn(*ts)
        res = res if isinstance(res, tuple) else (res,)
        return sum(float((r.double() * w.double()).sum())
                   for r, w in zip(res, ws))

    grads = torch.autograd.grad(outs, leaves_, ws)
    worst = 0.0
    for _ in range(2):
        us = [torch.randn(t.shape, generator=gen, device=device)
              for t in inputs]
        plus = loss([t + FD_EPS * u for t, u in zip(inputs, us)])
        minus = loss([t - FD_EPS * u for t, u in zip(inputs, us)])
        fd = (plus - minus) / (2 * FD_EPS)
        an = sum(float((g.double() * u.double()).sum())
                 for g, u in zip(grads, us))
        worst = max(worst, abs(fd - an) / max(abs(an), 1e-30))
    return {"rel_err": worst}


def check_functions_by_finite_differences(device) -> list:
    """``RMSNormFn``, ``AddRMSNormFn``, ``FlashAttentionFn`` and
    ``SelectiveScanFusedFn`` (with ``h0``, both outputs weighted) on the
    card in float32, by :func:`finite_difference` within ``FD_TOL``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)

    cases = {
        "RMSNormFn": (lambda x, w: rn.RMSNormFn.apply(x, w, BWD_EPS),
                      [rnd(7, 384) * 2, rnd(384)]),
        "AddRMSNormFn": (lambda x, r, w: rn.AddRMSNormFn.apply(x, r, w,
                                                                BWD_EPS),
                         [rnd(7, 384), rnd(7, 384), rnd(384)]),
    }
    for causal, window in ((True, 0), (True, 8), (False, 0)):
        q = rnd(1, 40, 4, 32).transpose(1, 2)
        k, v = (rnd(1, 33, 2, 32).transpose(1, 2) for _ in range(2))
        cases[f"FlashAttentionFn causal={causal} window={window}"] = (
            lambda q, k, v, c=causal, w=window: fa.FlashAttentionFn.apply(
                q, k, v, c, w), [q, k, v])
    b, s, d, n = 2, 21, 40, 5
    cases["SelectiveScanFusedFn"] = (
        ss.SelectiveScanFusedFn.apply,
        [rnd(b, s, d) * 0.5, rnd(b, s, d) * 0.5 - 1.0, rnd(d) * 0.5,
         rnd(b, s, n), rnd(b, s, n),
         torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                device=device)).expand(d, n).contiguous()
         + rnd(d, n) * 0.1, rnd(d), rnd(b, s, d), rnd(b, d, n)])
    rows = []
    for i, (name, (fn, inputs)) in enumerate(cases.items()):
        res = finite_difference(fn, inputs, device, 100 + i)
        assert res["rel_err"] <= FD_TOL, (name, res)
        rows.append({"function": name, "dtype": "float32", "eps": FD_EPS,
                     "tol": FD_TOL, **res})
    return rows


def check_bwd_ragged(device) -> dict:
    """The ``model_kernels_bwd`` phase: the backward kernels against their
    plain versions at ragged shapes in float32 and bfloat16 (the norm in
    both forms, with and without ``ds_in``; the scan with and without
    ``h0`` and ``dh_final``, launched twice for the same bits), each plain
    backward against autograd, each Function by finite differences, and
    the refusal of a gradient by the scan's decode step and plain form."""
    rows = []
    for shape, xt, wt in RAGGED_RMS_BWD:
        for key in (("bwd", shape, xt, wt), ("add_bwd", shape, xt, wt, True),
                    ("add_bwd", shape, xt, wt, False)):
            rows.append(check_bwd_kernel("rmsnorm_bwd", key, device, False))
    for dt in ("float32", "bfloat16"):
        for b, h, kv, sq, sk, d, causal, window in RAGGED_FA_BWD:
            rows.append(check_bwd_kernel(
                "flash_attention_bwd", ("bwd", (b, h, sq, d), (b, kv, sk, d),
                                        causal, window, dt), device, False))
    for dt in ("float32", "bfloat16"):
        for b, s, d, n in RAGGED_SCAN_BWD:
            for with_h0, with_dhf in SCAN_BWD_STARTS:
                rows.append(check_bwd_kernel(
                    "selective_scan_fused_bwd",
                    ("fused_bwd", (b, s, d), n, dt, with_h0, with_dhf),
                    device, False))
    x = torch.ones(1, 1, 8, device=device, requires_grad=True)
    w8, b2 = torch.ones(8, device=device), torch.ones(1, 1, 2, device=device)
    a_log, h0 = torch.zeros(8, 2, device=device), torch.zeros(1, 8, 2,
                                                             device=device)
    refusals = {}
    for form, call in (
            ("fused_step", lambda: ss.selective_scan_fused(
                x, x, w8, b2, b2, a_log, w8, x, h0, step=True)),
            ("plain", lambda: ss.selective_scan(x, x.detach(), b2, b2,
                                                -a_log.exp()))):
        try:
            call()
        except NotImplementedError as e:
            refusals[form] = str(e)
        else:
            raise AssertionError(f"the scan's {form} form took a tensor "
                                 f"that requires a gradient")
        assert "Queue A 10c" in refusals[form], refusals[form]
    return {"phase": "model_kernels_bwd", "kernels": rows,
            "plain_vs_autograd": check_plain_bwd_against_autograd(device),
            "finite_differences": check_functions_by_finite_differences(
                device),
            "scan_refuses_grad": refusals}


def check_bwd_path_shapes(device, shapes_by_phase: dict) -> list:
    """Every backward shape key the training phases launched: checked
    against the plain version and timed, with the launches each phase
    made there."""
    rows = []
    for name, wrapper in BWD_KERNELS.items():
        seen = sorted({k for by in shapes_by_phase.values()
                       for k in by[wrapper]}, key=repr)
        for key in seen:
            row = check_bwd_kernel(name, key, device, True)
            row["launches"] = {phase: by[wrapper].get(key, 0)
                               for phase, by in shapes_by_phase.items()}
            rows.append(row)
            torch.cuda.empty_cache()
    return rows


#: The shipped head dims the attention kernel gained, forward and
#: backward, in both types: each config's training shape (batch 2, 512
#: tokens, its heads and KV heads) checked and timed — gpt-1.1b (96, the
#: training CLI's default arch), kimi-k2-1t-a32b (112, a group of 8) and
#: gpt-11.1b (136, the 144-wide instance) — and ragged cases: Sq != Sk
#: both ways, GQA and MHA, a window, no causal mask.
NEW_DIM_SHAPES = [((2, 20, 512, 96), (2, 20, 512, 96)),
                  ((2, 64, 512, 112), (2, 8, 512, 112)),
                  ((2, 32, 512, 136), (2, 32, 512, 136))]
NEW_DIM_RAGGED = [(2, 4, 2, 130, 130, 96, True, 0),
                  (1, 4, 4, 77, 200, 96, False, 0),
                  (1, 8, 1, 100, 100, 112, True, 30),
                  (2, 2, 2, 64, 50, 112, True, 0),
                  (1, 4, 2, 150, 150, 136, True, 0),
                  (1, 2, 2, 33, 90, 136, False, 20),
                  (1, 8, 2, 257, 257, 136, True, 64)]


def check_new_head_dims(device) -> dict:
    """The ``kernels_at_new_head_dims`` phase: the instances at 96, 112
    and 136, forward (against ``flash_attention_ref``, ``TOL``) and
    backward (against ``flash_attention_bwd_ref``, ``TOL_BWD``, the
    bfloat16 one launched twice for the same bits), each row with the
    launches of the hand-written kernel it made (the timing runs' too);
    the training shapes timed beside the plain versions and SDPA."""
    rows = []
    for dt in ("float32", "bfloat16"):
        keys = [(qs, ks, True, 0, dt) for qs, ks in NEW_DIM_SHAPES]
        keys += [((b, h, sq, d), (b, kv, sk, d), causal, window, dt)
                 for b, h, kv, sq, sk, d, causal, window in NEW_DIM_RAGGED]
        for i, key in enumerate(keys):
            for name, k in (("flash_attention", key),
                            ("flash_attention_bwd", ("bwd",) + key)):
                before = (fa.flash_attention.launches,
                          fa.flash_attention.bwd_launches)
                check = check_model_kernel if name == "flash_attention" \
                    else check_bwd_kernel
                row = check(name, k, device, i < len(NEW_DIM_SHAPES))
                row["kernel_launches"] = {
                    "fwd": fa.flash_attention.launches - before[0],
                    "bwd": fa.flash_attention.bwd_launches - before[1]}
                assert row["kernel_launches"]["fwd" if name ==
                                              "flash_attention" else
                                              "bwd"] >= 1, (name, k)
                rows.append(row)
                torch.cuda.empty_cache()
    return {"phase": "kernels_at_new_head_dims", "head_dims": [96, 112, 136],
            "kernels": rows}


#: The attention kernel against the port's ``chunked_attention`` (plain
#: torch in float32, written independently of the kernel's plain version):
#: ``(b, S, H, KV, D, window)``, causal — zamba2-7b's prefill (its shared
#: block: MHA 32, head dim 112) and gemma3-12b's sliding-window layers
#: (16/8 heads of 256, window 1024) at 2,048 tokens.
FA_ORACLE_SHAPES = [(4, 512, 32, 32, 112, 0), (1, 2048, 16, 8, 256, 1024)]


def check_flash_against_chunked(device) -> dict:
    """The ``flash_vs_chunked_attention`` phase: the kernel in both types
    at ``FA_ORACLE_SHAPES`` against ``chunked_attention`` on the same
    inputs (upcast from bfloat16), at the kernel's tolerance (``TOL``:
    2e-5 float32, 2e-2 bfloat16, absolute plus relative).  Off the main
    path: its launches are not counted there."""
    from repro_torch.models.attention import chunked_attention
    t0 = time.perf_counter()
    rows = []
    for b, s_len, h, kv, d, window in FA_ORACLE_SHAPES:
        gen = torch.Generator(device=device).manual_seed(s_len + d)
        for dt in (torch.float32, torch.bfloat16):
            q = _randn(gen, (b, s_len, h, d), dt, device)
            k = _randn(gen, (b, s_len, kv, d), dt, device)
            v = _randn(gen, (b, s_len, kv, d), dt, device)
            got = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), causal=True,
                                     window=window).transpose(1, 2)
            want = chunked_attention(q.float(), k.float(), v.float(),
                                     causal=True, window=window)
            torch.cuda.synchronize()
            tol = TOL["flash_attention"][1 if dt == torch.bfloat16 else 0]
            diff = (got.float() - want).abs()
            assert bool(torch.isfinite(got).all())
            assert bool((diff <= tol + tol * want.abs()).all()), \
                ((b, s_len, h, kv, d, window), dt, float(diff.max()))
            rows.append({"q": [b, s_len, h, d], "kv_heads": kv,
                         "window": window, "causal": True,
                         "dtype": str(dt), "tol": tol,
                         "max_abs_err": float(diff.max()),
                         "max_abs_oracle": float(want.abs().max())})
            del q, k, v, got, want, diff
        torch.cuda.empty_cache()
    return {"phase": "flash_vs_chunked_attention",
            "oracle": "repro_torch.models.attention.chunked_attention "
                      "(float32, plain torch)", "cases": rows,
            "seconds": time.perf_counter() - t0}


#: (b, h, kv, sq, sk, d, causal, window, q_offset) of the attention with a
#: query offset, off the main path: K of exactly ``q_offset + sq`` rows
#: (the model's call) and longer, a window across the offset, fewer keys
#: than the last row's position, GQA, D = 256, no causal mask, offsets no
#: multiple of a tile.
RAGGED_FA_OFFSET = [
    (1, 4, 2, 50, 90, 64, True, 0, 40), (2, 4, 4, 64, 256, 128, True, 0, 100),
    (1, 2, 1, 70, 200, 32, True, 48, 130), (1, 2, 2, 33, 33, 16, True, 0, 7),
    (1, 8, 2, 128, 512, 128, True, 0, 384), (2, 2, 2, 40, 60, 256, False,
                                             16, 20),
]
#: gpt-3.1b's sequence-sharded attention: 22 heads of 128, 512 rows on a
#: 4-way model axis, 128 a rank, against the keys up to each share's end.
Q_OFFSET_MODEL = [(2, 22, 22, 128, off + 128, 128, off)
                  for off in (0, 128, 256, 384)]


def check_q_offset(device) -> dict:
    """The ``kernels_with_q_offset`` phase: the attention kernel with a
    query offset, forward and backward in both types, against its plain
    versions at ``RAGGED_FA_OFFSET`` (``TOL``, ``TOL_BWD``, the lse, and
    the bfloat16 backward twice for the same bits), and the forward at
    gpt-3.1b's sequence-sharded shapes against ``chunked_attention(
    q_offset=)`` (float32 plain torch, an oracle written apart from the
    plain version).  Off the main path: its launches are not counted
    there (the main path's offsets are checked and timed with the other
    path shapes)."""
    from repro_torch.models.attention import chunked_attention
    t0 = time.perf_counter()
    fwd, bwd, oracle = [], [], []
    for b, h, kv, sq, sk, d, causal, window, off in RAGGED_FA_OFFSET:
        for dt in ("float32", "bfloat16"):
            key = ((b, h, sq, d), (b, kv, sk, d), causal, window, dt, off)
            fwd.append(check_model_kernel("flash_attention", key, device,
                                          False))
            bwd.append(check_bwd_kernel("flash_attention_bwd",
                                        ("bwd",) + key, device, False))
    for b, h, kv, sq, sk, d, off in Q_OFFSET_MODEL:
        gen = torch.Generator(device=device).manual_seed(off + 1)
        for dt in (torch.float32, torch.bfloat16):
            q = _randn(gen, (b, sq, h, d), dt, device)
            k = _randn(gen, (b, sk, kv, d), dt, device)
            v = _randn(gen, (b, sk, kv, d), dt, device)
            got = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), causal=True,
                                     q_offset=off).transpose(1, 2)
            want = chunked_attention(q.float(), k.float(), v.float(),
                                     causal=True, q_offset=off)
            torch.cuda.synchronize()
            tol = TOL["flash_attention"][1 if dt == torch.bfloat16 else 0]
            diff = (got.float() - want).abs()
            assert bool(torch.isfinite(got).all())
            assert bool((diff <= tol + tol * want.abs()).all()), \
                ((b, sq, h, d, off), dt, float(diff.max()))
            oracle.append({"q": [b, sq, h, d], "k_rows": sk, "q_offset": off,
                           "dtype": str(dt), "tol": tol,
                           "max_abs_err": float(diff.max())})
    torch.cuda.empty_cache()
    return {"phase": "kernels_with_q_offset", "kernels": fwd + bwd,
            "oracle": "repro_torch.models.attention.chunked_attention("
                      "q_offset=) (float32, plain torch)",
            "oracle_cases": oracle, "seconds": time.perf_counter() - t0}


def ssd_at_zamba2_shapes(device) -> dict:
    """The ``ssd_at_zamba2_shapes`` phase: CUDA-event times of Mamba2's
    plain-torch SSD at zamba2-7b's generate shapes (``ssd_scan`` over the
    prompt, x (4, 512, 112, 64), N 64, chunk 128; ``ssd_step``, one
    token) and of the whole ``mamba2_block`` at both, bfloat16 weights of
    one layer: the SSD's share of a layer.  Plain torch in the reference
    too: no kernel, no launches counted."""
    from repro_torch.models import mamba
    t0 = time.perf_counter()
    cfg = configs.get("zamba2-7b")
    b, s_len = GEN_BATCH, GEN_PROMPT
    h, p, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    gen = torch.Generator(device=device).manual_seed(7)
    bf = torch.bfloat16
    x = _randn(gen, (b, s_len, h, p), bf, device, 0.5)
    dt = (torch.nn.functional.softplus(_randn(gen, (b, s_len, h),
                                              torch.float32, device))
          * 0.1).to(bf)
    B = _randn(gen, (b, s_len, n), bf, device)
    C = _randn(gen, (b, s_len, n), bf, device)
    A = -torch.arange(1, h + 1, dtype=torch.float32, device=device)
    state = _randn(gen, (b, h, p, n), torch.float32, device)
    lp = {k: v[0] for k, v in init_params(
        cfg.replace(n_layers=1), seed=3, device=device)["layers"].items()}
    xs = _randn(gen, (b, s_len, cfg.d_model), bf, device)
    _, (h_seq, tail) = mamba.mamba2_block(xs, lp, cfg)
    x1 = _randn(gen, (b, cfg.d_model), bf, device)
    fns = {"ssd_scan_prefill_ms": lambda: mamba.ssd_scan(x, dt, B, C, A),
           "ssd_step_ms": lambda: mamba.ssd_step(
               x[:, 0], dt[:, 0], B[:, 0], C[:, 0], A, state),
           "mamba2_block_prefill_ms": lambda: mamba.mamba2_block(xs, lp,
                                                                 cfg),
           "mamba2_block_step_ms": lambda: mamba.mamba2_block(
               x1, lp, cfg, h0=h_seq, conv0=tail, single_step=True)}
    times = interleaved(lambda fn: time_ms(fn, reps=0), fns)
    del x, dt, B, C, state, lp, xs, h_seq, tail, x1
    torch.cuda.empty_cache()
    return {"phase": "ssd_at_zamba2_shapes", "model": cfg.name,
            "prefill": {"x": [b, s_len, h, p], "N": n, "chunk": 128},
            "step": {"x": [b, h, p], "N": n},
            **times, "seconds": time.perf_counter() - t0}


def check_bwd_full_grid(device) -> dict:
    """The ``bwd_attention_full_grid`` phase: the bfloat16 attention
    backward at ``FULL_GRID_FA_BWD``, off the main path, checked and
    timed beside its bound and SDPA's backward."""
    row = check_bwd_kernel("flash_attention_bwd", FULL_GRID_FA_BWD, device,
                           True)
    torch.cuda.empty_cache()
    return {"phase": "bwd_attention_full_grid", "kernels": [row]}


# ---------------------------------------------------------------------------
# the training path: qwen2-7b and falcon-mamba-7b at full width, and the
# slice against the host
# ---------------------------------------------------------------------------

#: Each trained arch, its number of layers in full, the suffix of its
#: phases' names and the layers it trains at full width (the one cut: 4;
#: 2 of qwen2-7b's, whose checkpoint of a 152k vocabulary's embedding and
#: head is most of its phase's time; 12 of zamba2-7b's 81, so that its
#: shared block runs twice, after layers 5 and 11, and its gradient sums
#: two applications); the first arch's profile and slice phases keep the
#: names they had before the second's (``profile_train``,
#: ``slice_check_train``).
TRAIN_ARCHS = {"qwen2-7b": (28, "qwen2_7b", 2),
               "falcon-mamba-7b": (64, "falcon_mamba_7b", 4),
               "granite-moe-3b-a800m": (32, "granite_moe_3b_a800m", 4),
               "gpt-1.1b": (24, "gpt_1_1b", 4),
               "zamba2-7b": (81, "zamba2_7b", 12)}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 4, 512, 2
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT, TRAIN_LR = 4, 2, 3, 3e-4
SLICE_TRAIN_LAYERS, SLICE_TRAIN_BATCH, SLICE_TRAIN_SEQ = 1, 1, 64
#: Card against host, one step of qwen2-7b at full width and one layer in
#: bfloat16: the loss within this of ``1 + |loss|``, and each leaf's
#: gradient within this relative Frobenius error.  Both sides round every
#: product and every gradient to bfloat16 (8 significant bits) at
#: different places and after sums in another order; the host's attention
#: rounds nothing inside, the card's forward rounds P to bfloat16.  The
#: same holds for falcon-mamba-7b: the host differentiates the scan's plain
#: bfloat16 sequence by autograd, rounding its gradients to bfloat16 op by
#: op, the card's kernel computes them in float32 and rounds once.
SLICE_TRAIN_LOSS_TOL, SLICE_TRAIN_GRAD_TOL = 1e-2, 5e-2


def _train_phase(kind: str, arch: str) -> str:
    """The name of a profile or slice phase of ``arch``."""
    return kind if arch == next(iter(TRAIN_ARCHS)) else \
        f"{kind}_{TRAIN_ARCHS[arch][1]}"


def train_flops(cfg, params, tokens: int) -> dict:
    """Operations of one training step: ``6 N tokens`` for the parameters
    that enter a product (every layer's and the head's; the embedding is a
    lookup; of an MoE layer's experts the ``k / E`` a token uses) plus,
    with attention, its ``3 x 4 B H D pairs`` a layer (forward and
    backward); a Mamba1 model's scan and a Mamba2 model's SSD (its chunk
    products, plain torch) are not counted.  A hybrid's shared block
    counts once per application, its attention too.  ``hardware`` adds
    what remat runs again (each layer's forward; the shared block runs
    outside remat)."""
    leaves = params["layers"]
    experts = sum(leaves[k].numel() for k in ("e_gate", "e_up", "e_down")
                  if k in leaves)
    n_layers = sum(t.numel() for t in _tree.leaves(leaves)) - experts
    if experts:
        n_layers += experts * cfg.experts_per_token // cfg.n_experts
    apps = len(layer_plan(cfg)[1]["shared_at"])
    n_shared = apps * sum(t.numel() for t in _tree.leaves(
        params.get("shared", {})))
    n_head = params["lm_head"].numel() if "lm_head" in params else \
        params["tok_embed"].numel()
    seqs = tokens // TRAIN_SEQ
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2            # causal, no window
    n_attn = cfg.n_layers if cfg.family in ATTENTION_FAMILIES else apps
    attn_fwd = 4 * seqs * cfg.n_heads * cfg.hd * pairs * n_attn
    remat_attn = attn_fwd if cfg.family in ATTENTION_FAMILIES else 0
    model = 6 * (n_layers + n_shared + n_head) * tokens + 3 * attn_fwd
    return {"matmul_params": n_layers + n_shared + n_head, "model": model,
            "hardware": model + 2 * n_layers * tokens + remat_attn}


def train_launches(cfg) -> tuple:
    """``(forward launches, backward launches, shape keys, per step)`` of a
    ``run_train`` run of ``cfg``: per microbatch a forward runs 1 plain
    norm, then each layer's blocks (twice under remat) — a dense layer 2
    norms (the first layer's first plain, every other residual) and the
    attention, a Mamba1 layer 1 norm (plain in the first layer) and the
    fused scan, in its instance that keeps the chunk boundaries — and the
    final plain norm; a backward one of each, the residual norms' with
    the stream's gradient.  An MoE layer counts as a dense one (its
    experts are plain torch).  A hybrid's Mamba2 layer runs 1 norm and
    its gated norm (twice under remat), its shared block (outside remat,
    once) two residual norms and the attention per application."""
    L, micro, per = cfg.n_layers, TRAIN_MICRO, TRAIN_STEPS * TRAIN_MICRO
    bf = torch.bfloat16
    mb = (TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, cfg.d_model)
    if cfg.family == "hybrid":
        return hybrid_train_launches(cfg, mb, micro, per)
    attn = cfg.family in ATTENTION_FAMILIES
    norms_per_layer = 2 if attn else 1
    residual = norms_per_layer * L - 1
    step = {"rmsnorm_fwd_plain": 3 * micro,
            "rmsnorm_fwd_residual": 2 * residual * micro,
            "rmsnorm_bwd_plain": 2 * micro,
            "rmsnorm_bwd_residual": residual * micro}
    want = {k: 0 for k in WRAPPERS}
    want["rmsnorm"] = per * (2 * norms_per_layer * L + 1)
    want_bwd = {k: 0 for k in BWD_KERNELS}
    want_bwd["rmsnorm_bwd"] = per * (residual + 2)
    shapes = {k: {} for k in WRAPPERS}
    shapes["rmsnorm"] = {(mb, bf, bf): per * 3,
                         ("add", mb, bf, bf): per * 2 * residual,
                         ("bwd", mb, bf, bf): per * 2,
                         ("add_bwd", mb, bf, bf, True): per * residual}
    if attn:
        q_shape = (mb[0], cfg.n_heads, TRAIN_SEQ, cfg.hd)
        k_shape = (mb[0], cfg.n_kv_heads, TRAIN_SEQ, cfg.hd)
        fa_key = (q_shape, k_shape, True, 0, str(bf))
        want["flash_attention"] = per * 2 * L
        want_bwd["flash_attention_bwd"] = per * L
        shapes["flash_attention"] = {fa_key: per * 2 * L,
                                     ("bwd",) + fa_key: per * L}
        step.update(flash_attention_fwd=2 * L * micro,
                    flash_attention_bwd=L * micro)
    else:
        x_shape = (mb[0], TRAIN_SEQ, cfg.d_inner)
        n = cfg.ssm_state
        want["selective_scan"] = per * 2 * L
        want_bwd["selective_scan_fused_bwd"] = per * L
        # every forward goes through SelectiveScanFusedFn (or, with the
        # bfloat16 working type, SelectiveScanFusedBf16Fn), remat's
        # recompute too: the instance that keeps the chunk boundaries
        work = "fused_bf16" if cfg.scan_dtype == "bfloat16" else "fused"
        shapes["selective_scan"] = {(work + "_bound", x_shape, n, bf):
                                    per * 2 * L,
                                    (work + "_bwd", x_shape, n, bf): per * L}
        step.update(selective_scan_fused_fwd=2 * L * micro,
                    selective_scan_fused_bwd=L * micro)
    return want, want_bwd, shapes, step


def hybrid_train_launches(cfg, mb: tuple, micro: int, per: int) -> tuple:
    """:func:`train_launches` of a hybrid: per microbatch a forward runs
    the first ``ln1`` plain (twice: remat), ``L - 1`` residual ``ln1``s
    and ``L`` gated norms (each twice), two residual norms per
    shared-block application (once) and the final plain norm; the
    attention once per application; a backward one of each."""
    L = cfg.n_layers
    apps = len(layer_plan(cfg)[1]["shared_at"])
    bf, wt = torch.bfloat16, _dtype(cfg.dtype)
    gated = ((mb[0], TRAIN_SEQ, cfg.d_inner), torch.float32, wt)
    residual_fwd = 2 * (L - 1) + 2 * apps
    residual_bwd = L - 1 + 2 * apps
    q_shape = (mb[0], cfg.n_heads, TRAIN_SEQ, cfg.hd)
    k_shape = (mb[0], cfg.n_kv_heads, TRAIN_SEQ, cfg.hd)
    fa_key = (q_shape, k_shape, True, 0, str(bf))
    want = {k: 0 for k in WRAPPERS}
    want["rmsnorm"] = per * (3 + residual_fwd + 2 * L)
    want["flash_attention"] = per * apps
    want_bwd = {k: 0 for k in BWD_KERNELS}
    want_bwd["rmsnorm_bwd"] = per * (2 + residual_bwd + L)
    want_bwd["flash_attention_bwd"] = per * apps
    shapes = {k: {} for k in WRAPPERS}
    shapes["rmsnorm"] = {(mb, bf, bf): per * 3,
                         ("add", mb, bf, bf): per * residual_fwd,
                         gated: per * 2 * L,
                         ("bwd", mb, bf, bf): per * 2,
                         ("bwd",) + gated: per * L,
                         ("add_bwd", mb, bf, bf, True): per * residual_bwd}
    shapes["flash_attention"] = {fa_key: per * apps,
                                 ("bwd",) + fa_key: per * apps}
    step = {"rmsnorm_fwd_plain": 3 * micro,
            "rmsnorm_fwd_residual": residual_fwd * micro,
            "rmsnorm_fwd_gated": 2 * L * micro,
            "rmsnorm_bwd_plain": 2 * micro,
            "rmsnorm_bwd_gated": L * micro,
            "rmsnorm_bwd_residual": residual_bwd * micro,
            "flash_attention_fwd": apps * micro,
            "flash_attention_bwd": apps * micro}
    return want, want_bwd, shapes, step


def run_train(device, arch: str, scan_dtype: str = "float32",
              resume: bool = True) -> tuple:
    """``launch.train.train`` on ``arch`` at full width and its
    ``TRAIN_ARCHS`` layers (the one cut): exact forward (twice a layer
    under remat) and backward launch counts of every kernel and form on
    the path (:func:`train_launches`); then the bitwise resume check — a
    run that fails at step ``TRAIN_FAIL_AT``, resumed from its checkpoint,
    must give the uninterrupted run's losses and final parameters bit for
    bit.  Only the failing run saves (at step ``TRAIN_CKPT_EVERY``, the
    checkpoint the resume reads): the uninterrupted and the resumed run
    write none, since nothing would read one (each is 10–20 GB at these
    sizes), so their steps are timed without a writer beside them.
    ``scan_dtype`` is a Mamba1 config's working type; ``resume=False``
    runs the uninterrupted run alone."""
    t_phase = time.perf_counter()
    full_layers, suffix, n_layers = TRAIN_ARCHS[arch]
    cfg = configs.get(arch).replace(n_layers=n_layers, scan_dtype=scan_dtype)
    if scan_dtype != "float32":
        suffix += "_scan_" + {"bfloat16": "bf16"}[scan_dtype]
    assert cfg.remat and cfg.dtype == "bfloat16"
    kw = dict(steps=TRAIN_STEPS, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
              n_micro=TRAIN_MICRO, lr=TRAIN_LR, ckpt_every=TRAIN_CKPT_EVERY,
              seed=0, device=device)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        torch.cuda.empty_cache()
        reset_launches()
        full = train_cli.train(cfg, ckpt_dir=os.path.join(tmp, "full"),
                               **dict(kw, ckpt_every=TRAIN_STEPS + 1,
                                      save_final=False))
        launches, bwd, shapes = (read_launches(), read_bwd_launches(),
                                 read_shapes())
        hist = full["loop"].history
        flops = train_flops(cfg, full["params"], TRAIN_BATCH * TRAIN_SEQ)
        run = {"run_s": full["seconds"], "n_params": full["n_params"],
               "peak_memory_bytes": full["peak_bytes"]}
        del full["opt_state"]
        shutil.rmtree(os.path.join(tmp, "full"), ignore_errors=True)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        if resume:
            try:
                train_cli.train(cfg, ckpt_dir=os.path.join(tmp, "resume"),
                                fail_at=TRAIN_FAIL_AT, **kw)
            except RuntimeError as e:
                assert f"injected failure at step {TRAIN_FAIL_AT}" in str(e), e
            else:
                raise AssertionError("the failure was not injected")
            torch.cuda.empty_cache()
            resumed = train_cli.train(
                cfg, ckpt_dir=os.path.join(tmp, "resume"), resume=True,
                save_final=False, **dict(kw, ckpt_every=TRAIN_STEPS + 1))
        resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = [h["loss"] for h in hist]
    if resume:
        rh = resumed["loop"].history
        assert [h["step"] for h in rh] == list(range(TRAIN_CKPT_EVERY,
                                                     TRAIN_STEPS))
        assert [h["loss"] for h in rh] == losses[TRAIN_CKPT_EVERY:], \
            ([h["loss"] for h in rh], losses)
        bit_equal = all(torch.equal(a, b) for a, b in zip(
            _tree.leaves(full["params"]), _tree.leaves(resumed["params"])))
        assert bit_equal, ("resumed parameters differ from the "
                           "uninterrupted run")
        del resumed
    assert all(np.isfinite(losses)), losses
    del full
    torch.cuda.empty_cache()

    want, want_bwd, want_shapes, per_step = train_launches(cfg)
    assert launches == want, (launches, want)
    assert bwd == want_bwd, (bwd, want_bwd)
    for name, by in want_shapes.items():
        assert shapes[name] == by, (name, shapes[name], by)

    warm = [h["dt"] for h in hist[-2:]]
    warm_s = float(np.mean(warm))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    if cfg.family in ATTENTION_FAMILIES:
        width = (f"d {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
                 f"head dim {cfg.hd}, d_ff {cfg.d_ff}"
                 + (f", {cfg.n_experts} experts top-{cfg.experts_per_token}"
                    if cfg.family == "moe" else ""))
    elif cfg.family == "hybrid":
        width = (f"d {cfg.d_model}, Mamba2 d_inner {cfg.d_inner}, "
                 f"{cfg.n_ssm_heads} heads of {cfg.ssm_head_dim}, N "
                 f"{cfg.ssm_state}; shared block {cfg.n_heads}/"
                 f"{cfg.n_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, "
                 f"after layers {layer_plan(cfg)[1]['shared_at']}")
    else:
        width = (f"d {cfg.d_model}, d_inner {cfg.d_inner}, N "
                 f"{cfg.ssm_state}, dt_rank {cfg.dt_rank}")
    line = {
        "phase": f"train_{suffix}", "model": cfg.name,
        "cut": f"n_layers {n_layers} of {full_layers} (full width: "
               f"{width}, vocab {cfg.vocab_size})",
        "dtype": cfg.dtype, "remat": cfg.remat, "global_batch": TRAIN_BATCH,
        **({"scan_dtype": scan_dtype}
           if cfg.family not in ATTENTION_FAMILIES
           and cfg.family != "hybrid" else {}),
        "seq_len": TRAIN_SEQ, "n_micro": TRAIN_MICRO, "steps": TRAIN_STEPS,
        "ckpt_every": TRAIN_CKPT_EVERY,
        "saves": {"uninterrupted_run": [], "failing_run": list(range(
            TRAIN_CKPT_EVERY, TRAIN_FAIL_AT + 1, TRAIN_CKPT_EVERY)),
                  "resumed_run": []} if resume else {"uninterrupted_run": []},
        "lr": TRAIN_LR, **run,
        "losses": losses, "step_s": [h["dt"] for h in hist],
        "warm_step_s": warm_s, "tokens_per_s": tokens / warm_s,
        "flops_per_step": flops,
        "mfu": flops["model"] / (warm_s * BF16_OPS_PER_S),
        **({"mfu_note": "6 N tokens and the shared block's attention; the "
                        "SSD's own chunk products (plain torch, float32) "
                        "are not counted"}
           if cfg.family == "hybrid" else {}),
        "hfu_with_remat": flops["hardware"] / (warm_s * BF16_OPS_PER_S),
        "launches_fwd": launches, "launches_bwd": bwd,
        "launches_per_step": per_step,
        "resume": {"fail_at": TRAIN_FAIL_AT,
                   "resumed_from_step": TRAIN_CKPT_EVERY,
                   "losses_bit_equal": True, "params_bit_equal": True,
                   "seconds_fail_and_resume": resume_s} if resume else None,
        "seconds": time.perf_counter() - t_phase,
    }
    return line, shapes


def profile_train(device, arch: str) -> dict:
    """Where the card's time goes in one warm training step of
    ``run_train``'s size (the third step, after two untraced ones), with
    no checkpoint: device busy and idle share, and the top kernels."""
    from repro_torch.data.pipeline import (DataLoader, LoaderConfig,
                                           SyntheticCorpus)
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    n_layers = TRAIN_ARCHS[arch][2]
    cfg = configs.get(arch).replace(n_layers=n_layers)
    params = init_params(cfg, seed=0, device=device)
    opt = AdamW(lr=cosine_schedule(TRAIN_LR, 20, TRAIN_STEPS))
    state = {"params": params, "opt": opt.init(params)}
    step = train_steps.make_train_step(cfg, ShardCtx(), opt,
                                       n_micro=TRAIN_MICRO)
    loader = DataLoader(SyntheticCorpus(cfg.vocab_size, seed=0),
                        LoaderConfig(TRAIN_BATCH, TRAIN_SEQ))

    def run_step(i):
        state["params"], state["opt"], m = step(
            state["params"], state["opt"], loader.batch_at(i))
        float(m["loss"])

    run_step(0)
    run_step(1)
    phase = _train_phase("profile_train", arch)
    out = {"phase": phase, "model": cfg.name,
           "n_layers": n_layers, "global_batch": TRAIN_BATCH,
           "seq_len": TRAIN_SEQ, "n_micro": TRAIN_MICRO,
           "step": trace(lambda: run_step(2))}
    del params, state
    torch.cuda.empty_cache()
    return out


def slice_check_train(device, arch: str, scan_dtype: str = "float32") -> dict:
    """``arch`` at full width and ``SLICE_TRAIN_LAYERS`` layer, batch
    ``SLICE_TRAIN_BATCH`` x ``SLICE_TRAIN_SEQ``: one training step's loss
    and per-leaf gradients on the card (kernels) against the port's host
    path (``device="cpu"``, plain versions, autograd), on the same weights
    and tokens; ``scan_dtype`` as :func:`run_train`'s."""
    t_phase = time.perf_counter()
    cut = slice_cut(arch, SLICE_TRAIN_LAYERS)
    cfg = configs.get(arch).replace(**cut, scan_dtype=scan_dtype)
    if arch in SLICE_DTYPE:
        cfg = cfg.replace(dtype=SLICE_DTYPE[arch])
    ctx = ShardCtx()
    params = init_params(cfg, seed=2, device=device)
    host = _to_host(params)
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size,
                         (SLICE_TRAIN_BATCH, SLICE_TRAIN_SEQ + 1),
                         generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def grads(p_in, dev):
        p, flat = train_steps._leaves_for_grad(p_in)
        loss, _ = M.loss_fn(p, cfg, ctx, {k: v.to(dev)
                                          for k, v in batch.items()})
        names = leaf_names({k: v for k, v in p.items() if k != "layers"})
        names += [f"layers.{k}[{i}]" for i in range(len(p["layers"]))
                  for k in sorted(p["layers"][i])]
        return float(loss.detach()), dict(zip(names,
                                              torch.autograd.grad(loss, flat)))

    card_loss, card = grads(params, device)
    t0 = time.perf_counter()
    host_loss, want = grads(host, "cpu")
    host_s = time.perf_counter() - t0
    assert abs(card_loss - host_loss) <= SLICE_TRAIN_LOSS_TOL * (
        1 + abs(host_loss)), (card_loss, host_loss)
    errs = {}
    for name, g in card.items():
        a, b = g.float().cpu(), want[name].float()
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        num = torch.linalg.vector_norm(a - b, dtype=torch.float64)
        den = torch.linalg.vector_norm(b, dtype=torch.float64)
        errs[name] = float(num / den)
        assert errs[name] <= SLICE_TRAIN_GRAD_TOL, (name, errs[name])
    del params, host, card, want
    torch.cuda.empty_cache()
    phase = _train_phase("slice_check_train", arch) + (
        "_scan_bf16" if scan_dtype == "bfloat16" else "")
    return {"phase": phase, "model": cfg.name,
            **({"scan_dtype": scan_dtype} if scan_dtype != "float32"
               else {}),
            "n_layers": SLICE_TRAIN_LAYERS,
            **({"cut": cut} if len(cut) > 1 else {}),
            "batch": SLICE_TRAIN_BATCH,
            "seq_len": SLICE_TRAIN_SEQ, "dtype": cfg.dtype,
            "tol": {"loss": SLICE_TRAIN_LOSS_TOL,
                    "grad_rel_fro": SLICE_TRAIN_GRAD_TOL},
            "loss_card": card_loss, "loss_host": host_loss,
            "grad_rel_fro": errs, "host_step_s": host_s,
            "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# pipeline-parallel training: a Pipette mapping as ranks on the card
# ---------------------------------------------------------------------------

#: ``pp_train_gpt_1_1b``: gpt-1.1b at full width, cut to ``PP_LAYERS`` of
#: its 24 layers (4, 2 a stage, so that the phase stays inside its budget
#: with the shared leaves gathered and the moments' blocks reduced and
#: gathered over the data axis each step), trained ``PP_STEPS`` steps by
#: ``launch/pp_step.py`` under the Pipette configuration ``PP_CONF`` (pp,
#: tp, dp, bs_micro, bs_global: 4 microbatches of 2 sequences, one a data
#: rank) over the permuted mapping ``PP_MAPPING`` (the rank at ``[x, y,
#: z]`` is GPU f(x, y, z)), four processes on the one card in a ``gloo``
#: group; then, in the same processes, the same layers, weights and
#: batches at pp 1 x dp 2 (``PP1_CONF``, the same data mapping, no pipe),
#: whose losses and parameters must be bit-equal.
PP_ARCH, PP_LAYERS, PP_SEQ, PP_STEPS = "gpt-1.1b", 4, 512, 3
PP_CONF, PP_MAPPING = (2, 1, 2, 1, 8), [[[1, 3]], [[0, 2]]]
PP1_CONF, PP1_MAPPING = (1, 1, 2, 1, 8), [[[1, 0]]]
#: the spawn's limit (the ranks are killed past it) and the phase's budget
PP_SPAWN_S, PP_PHASE_S = 300.0, 75.0


def pp_rank_launches(cfg, layers: int, n_mb: int, last: bool, steps: int,
                     mb: tuple) -> tuple:
    """``(forward launches, backward launches, shape keys)`` of one rank of
    ``pp_train`` over ``steps`` steps: per microbatch its stage's
    ``layers`` dense layers run 2 norms and the attention in the forward
    (under ``no_grad``) and again in remat's recompute, and one backward
    of each; the last stage adds the head's final norm, forward and
    backward, once a microbatch (the head is outside remat).  No residual
    form: ``_dense_layer`` completes the stream itself."""
    per = steps * n_mb
    bf = torch.bfloat16
    head = 1 if last else 0
    want = {k: 0 for k in WRAPPERS}
    want["rmsnorm"] = per * (2 * 2 * layers + head)
    want["flash_attention"] = per * 2 * layers
    want_bwd = {k: 0 for k in BWD_KERNELS}
    want_bwd["rmsnorm_bwd"] = per * (2 * layers + head)
    want_bwd["flash_attention_bwd"] = per * layers
    q_shape = (mb[0], cfg.n_heads, mb[1], cfg.hd)
    k_shape = (mb[0], cfg.n_kv_heads, mb[1], cfg.hd)
    fa_key = (q_shape, k_shape, True, 0, str(bf))
    shapes = {k: {} for k in WRAPPERS}
    shapes["rmsnorm"] = {(mb, bf, bf): want["rmsnorm"],
                         ("bwd", mb, bf, bf): want_bwd["rmsnorm_bwd"]}
    shapes["flash_attention"] = {
        fa_key: want["flash_attention"],
        ("bwd",) + fa_key: want_bwd["flash_attention_bwd"]}
    return want, want_bwd, shapes


def stored_bytes(*trees) -> int:
    """The bytes of every storage the tensors of ``trees`` hold (a rank's
    parameters and optimizer state: what it stores between steps), each
    storage once: a view that keeps a whole tensor alive counts it all."""
    held = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for tree in trees for t in _tree.leaves(tree)
            if isinstance(t, torch.Tensor)}
    return sum(held.values())


def _pp_batches(cfg, conf) -> list:
    """``PP_STEPS`` global batches of ``conf.bs_global`` sequences, as
    ``(n_mb, bs_global / n_mb, S)`` tokens and labels, from one seed."""
    rng = np.random.default_rng(23)
    out = []
    for _ in range(PP_STEPS):
        toks = rng.integers(0, cfg.vocab_size,
                            (conf.bs_global, PP_SEQ + 1), dtype=np.int64)
        out.append((toks[:, :-1].reshape(conf.n_mb, -1, PP_SEQ),
                    toks[:, 1:].reshape(conf.n_mb, -1, PP_SEQ)))
    return out


def pp_rank(rank: int, world: int, conf_t: tuple, mapping) -> dict:
    """One rank of ``pp_train`` (a spawned process on the card): its stage
    of the weights (drawn whole from seed 0 and cut), ``PP_STEPS`` steps
    of ``make_pp_train_step``, its launch counts, and a digest of every
    layer of its parameters after the last step."""
    import hashlib
    import torch.distributed as dist
    from repro_torch.optim.adamw import AdamW
    t_run = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    _build.load_library()
    cfg = configs.get(PP_ARCH).replace(n_layers=PP_LAYERS)
    conf = Conf(*conf_t)
    mesh = mesh_from_mapping(conf, np.asarray(mapping))
    c = mesh.coords(rank)
    pp = mesh.shape["pipe"]
    per = PP_LAYERS // pp
    s = c["pipe"]
    opt = AdamW(lr=TRAIN_LR)
    step, p_spec, o_spec, _ = make_pp_train_step(
        cfg, mesh, opt, pipe_axis="pipe", data_axis="data", n_mb=conf.n_mb,
        remat=True)
    full = init_params(cfg, seed=0, device=device)
    params = shard_pp_params(
        {"stages": {k: v[s * per:(s + 1) * per].clone()
                    for k, v in full["layers"].items()},
         "shared": {k: full[k] for k in ("tok_embed", "final_norm",
                                          "lm_head")}}, p_spec, mesh, rank)
    del full
    torch.cuda.empty_cache()
    groups = {a: dist.get_process_group_ranks(mesh.group(a))
              for a in mesh.axis_names}
    report = {"rank": rank, "coords": c, "layers": [s * per, (s + 1) * per],
              "groups": groups}
    print(f"[pp_train] rank {rank}: coords {c}, layers "
          f"{s * per}..{(s + 1) * per - 1}, groups {groups}", flush=True)
    state = init_pp_state(params, o_spec, mesh)
    spec_bytes = sum(_tree.leaves(SP.shard_sizes(p_spec, mesh, rank))
                     + _tree.leaves(SP.shard_sizes(o_spec, mesh, rank)))
    assert stored_bytes(params, state) == spec_bytes, \
        (rank, stored_bytes(params, state), spec_bytes)
    nd, z = mesh.shape["data"], c["data"]
    batches = []
    for toks, lbls in _pp_batches(cfg, conf):
        rows = toks.shape[1] // nd
        cut = slice(z * rows, (z + 1) * rows)
        batches.append({"tokens_mb": toks[:, cut], "labels_mb": lbls[:, cut]})
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    collectives.reset_stats()
    losses, step_s = [], []
    for batch in batches:
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches, bwd, shapes = (read_launches(), read_bwd_launches(),
                             read_shapes())
    staged = dict(collectives.STATS)
    stored = stored_bytes(params, state)
    assert stored == spec_bytes, (rank, stored, spec_bytes)
    digests = {}
    for k in sorted(params["stages"]):
        for j in range(per):
            t = params["stages"][k][j].contiguous().view(torch.uint8).cpu()
            digests[f"{k}[{s * per + j}]"] = hashlib.blake2b(
                t.numpy().tobytes(), digest_size=16).hexdigest()
    # each data rank's FSDP block of a shared leaf
    for k in sorted(params["shared"]):
        t = params["shared"][k].contiguous().view(torch.uint8).cpu()
        digests[f"{k}[data {z}]"] = hashlib.blake2b(
            t.numpy().tobytes(), digest_size=16).hexdigest()
    assert _build.last_build_seconds is None, "a rank ran nvcc"
    return dict(report, losses=losses, step_s=step_s, stored_bytes=stored,
                run_s=time.perf_counter() - t_run,
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                staged_bytes_per_step={k: v / PP_STEPS
                                       for k, v in staged.items()},
                launches_fwd=launches, launches_bwd=bwd, shapes=shapes,
                digests=digests)


def pp_ranks(rank: int, world: int, runs) -> dict:
    """One process of ``pp_train``: each run of ``runs`` (``(name,
    conf_t, mapping)``) in turn, :func:`pp_rank` where this rank is on the
    run's mapping; a rank off it makes the run's groups in
    ``Mesh.group``'s order (``new_group`` is collective over the whole
    process group), meets the run's barrier and sits the run out.
    Returns each run's result by name (None where the rank sat out)."""
    import torch.distributed as dist
    out = {}
    for name, conf_t, mapping in runs:
        ranks = np.asarray(mapping)
        if rank in ranks:
            out[name] = pp_rank(rank, world, conf_t, mapping)
        else:
            for i in range(ranks.ndim):
                for line in np.moveaxis(ranks, i, -1).reshape(
                        -1, ranks.shape[i]):
                    dist.new_group([int(r) for r in line])
            dist.barrier()
            out[name] = None
        torch.cuda.empty_cache()
    return out


def _pp_check_run(cfg, conf_t, mapping, results) -> None:
    """Each rank's coordinates, layer range and group ranks against the
    mapping, and its launch counts against :func:`pp_rank_launches`."""
    mapping = np.asarray(mapping)
    conf = Conf(*conf_t)
    pp = conf.pp
    per = PP_LAYERS // pp
    mb = (conf.bs_micro, PP_SEQ, cfg.d_model)
    for r in results:
        x, y, z = (int(v) for v in np.argwhere(mapping == r["rank"])[0])
        assert r["coords"] == {"pipe": x, "model": y, "data": z}, r
        assert r["layers"] == [x * per, (x + 1) * per], r
        assert r["groups"] == {"pipe": sorted(mapping[:, y, z].tolist()),
                               "model": sorted(mapping[x, :, z].tolist()),
                               "data": sorted(mapping[x, y, :].tolist())}, r
        want, want_bwd, shapes = pp_rank_launches(
            cfg, per, conf.n_mb, x == pp - 1, PP_STEPS, mb)
        assert r["launches_fwd"] == want, (r["rank"], r["launches_fwd"],
                                           want)
        assert r["launches_bwd"] == want_bwd, (r["rank"], r["launches_bwd"],
                                               want_bwd)
        for name, by in shapes.items():
            assert r["shapes"][name] == by, (r["rank"], name,
                                             r["shapes"][name], by)


def pp_train() -> tuple:
    """``pp_train_gpt_1_1b``: the pp 2 x dp 2 run and the pp 1 x dp 2 run
    (:func:`pp_rank` in spawned processes, the kernels built by this
    process before), their checks, and the run's line; returns ``(line,
    shapes)`` with the pp run's summed launches and shape counts."""
    t_phase = time.perf_counter()
    cfg = configs.get(PP_ARCH).replace(n_layers=PP_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    specs = (("pp2_dp2", PP_CONF, PP_MAPPING),
             ("pp1_dp2", PP1_CONF, PP1_MAPPING))
    got = collectives.spawn(pp_ranks, int(np.asarray(PP_MAPPING).size),
                            (specs,), timeout=PP_SPAWN_S)
    runs = {}
    for name, conf_t, mapping in specs:
        results = [r[name] for r in got if r[name] is not None]
        _pp_check_run(cfg, conf_t, mapping, results)
        runs[name] = {"results": results,
                      "seconds": max(r["run_s"] for r in results)}
    pp_res, ref_res = runs["pp2_dp2"]["results"], runs["pp1_dp2"]["results"]
    # one loss per step, the same on every rank of a run and in both runs
    losses = pp_res[0]["losses"]
    assert all(r["losses"] == losses for r in pp_res + ref_res), \
        [r["losses"] for r in pp_res + ref_res]
    assert all(np.isfinite(losses)), losses

    def digests(results):
        out = {}
        for r in results:
            for k, v in r["digests"].items():
                # the data replicas of a stage hold the same bits
                assert out.setdefault(k, v) == v, (k, r["rank"])
        return out

    d_pp, d_ref = digests(pp_res), digests(ref_res)
    nd = Conf(*PP_CONF).dp
    assert len(d_ref) == len(d_pp) == 9 * PP_LAYERS + 3 * nd, len(d_pp)
    differ = sorted(k for k in d_ref if d_pp.get(k) != d_ref[k])
    assert not differ, ("pp 2 and pp 1 parameters differ", differ)

    launches = {k: sum(r["launches_fwd"][k] for r in pp_res)
                for k in WRAPPERS}
    bwd = {k: sum(r["launches_bwd"][k] for r in pp_res)
           for k in BWD_KERNELS}
    shapes = {name: {} for name in WRAPPERS}
    for r in pp_res:
        for name, by in r["shapes"].items():
            for key, n in by.items():
                shapes[name][key] = shapes[name].get(key, 0) + n
    step_s = [max(r["step_s"][i] for r in pp_res) for i in range(PP_STEPS)]
    ref_step_s = [max(r["step_s"][i] for r in ref_res)
                  for i in range(PP_STEPS)]
    seconds = time.perf_counter() - t_phase
    assert seconds <= PP_PHASE_S, ("pp_train_gpt_1_1b over its budget",
                                   seconds)
    conf = Conf(*PP_CONF)
    line = {
        "phase": "pp_train_gpt_1_1b", "model": cfg.name,
        "cut": f"n_layers {PP_LAYERS} of 24, {PP_LAYERS // conf.pp} a stage "
               f"(full width: d {cfg.d_model}, heads {cfg.n_heads} of "
               f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size})",
        "conf": {"pp": conf.pp, "tp": conf.tp, "dp": conf.dp,
                 "bs_micro": conf.bs_micro, "bs_global": conf.bs_global,
                 "n_mb": conf.n_mb},
        "mapping": PP_MAPPING, "axes": ["pipe", "model", "data"],
        "processes": len(pp_res), "backend": "gloo (host-staged)",
        "seq_len": PP_SEQ, "steps": PP_STEPS, "lr": TRAIN_LR,
        "dtype": cfg.dtype, "remat": True,
        "ranks": [{k: r[k] for k in ("rank", "coords", "layers", "groups",
                                     "peak_memory_bytes", "stored_bytes",
                                     "staged_bytes_per_step", "step_s")}
                  for r in pp_res],
        "stored_bytes_equal_specs": "every rank of both runs: parameters "
                                    "and AdamW state against "
                                    "specs.shard_sizes of the step's spec "
                                    "trees (asserted in the rank)",
        "losses": losses, "step_s": step_s,
        "peak_memory_bytes_max": max(r["peak_memory_bytes"]
                                     for r in pp_res),
        "pp1_dp2": {"mapping": PP1_MAPPING, "step_s": ref_step_s,
                    "peak_memory_bytes_max": max(r["peak_memory_bytes"]
                                                 for r in ref_res),
                    "ranks": [{k: r[k] for k in (
                        "rank", "coords", "peak_memory_bytes",
                        "stored_bytes", "staged_bytes_per_step")}
                        for r in ref_res],
                    "seconds": runs["pp1_dp2"]["seconds"]},
        "bit_equal_to_pp1_dp2": {"losses": True,
                                 "params": f"{len(d_pp)} digests (every "
                                           f"layer's leaves and each data "
                                           f"rank's block of the shared "
                                           f"ones)"},
        "launches_fwd": launches, "launches_bwd": bwd,
        "launches_per_rank_formula": "per microbatch: 2 norms + 1 attention "
                                     "a layer, twice (remat), 1 backward "
                                     "each; the last stage's head norm "
                                     "once, forward and backward",
        "pp2_dp2_seconds": runs["pp2_dp2"]["seconds"],
        "seconds": seconds,
    }
    return line, shapes



# ---------------------------------------------------------------------------
# tensor-parallel training: the model under an active ShardCtx
# ---------------------------------------------------------------------------

#: ``tp_train_gpt_1_1b``: ``pp_train_gpt_1_1b``'s model and batches
#: (gpt-1.1b at full width, bf16, remat) at ``TP_LAYERS`` of its 24
#: layers (8: the phase's budget holds its FSDP and ZeRO-1 runs) trained
#: ``TP_STEPS`` steps by ``make_train_step`` under ``ShardCtx(mesh,
#: dp=("data",), tp="model", fsdp=("data",))`` for the Pipette
#: configuration ``TP_CONF`` (pp 1, tp 2, dp 2, bs_micro 2, bs_global 8:
#: 2 microbatches a data rank) over the permuted mapping ``TP_MAPPING``,
#: four processes on the card; held to the same weights and batches
#: trained by ``make_train_step`` with ``ShardCtx()`` in this process.
TP_CONF, TP_MAPPING, TP_STEPS = (1, 2, 2, 2, 8), [[[3, 1], [0, 2]]], PP_STEPS
TP_LAYERS = 8
TP_SPAWN_S, TP_PHASE_S = 300.0, 110.0
#: Tolerances of the tensor-parallel run against the one process, stated
#: before the first run on the card.  Both run the same kernels on the
#: same bfloat16 weights; the tensor-parallel ranks sum the row-parallel
#: products' bfloat16 partials (``wo``, ``down``) over the model axis,
#: where one device rounds one float32 sum, so each block's output moves
#: by up to a bfloat16 rounding (2**-8 of itself), and the vocabulary's
#: logsumexp adds in another order.  A step's loss: within ``TP_LOSS_TOL``
#: (absolute, at a loss of 11.3; a missing reduction moves it by more
#: than 1).  The parameters and AdamW's first moment after the last step:
#: the ranks that hold the same block must hold the same bits (the
#: digests of :func:`block_sums`); each leaf's update (after minus
#: before) within ``TP_UPDATE_TOL`` of the one process's update in
#: relative Frobenius norm (the elements whose gradient lies within the
#: two runs' bfloat16 noise of 0 move either way: AdamW moves an element
#: by about ``lr`` a step, by the sign of its moments; a leaf cut into
#: the wrong blocks is 1 or more off); and each leaf's first moment, the
#: float32 average of its clipped gradients, within ``TP_MOMENT_TOL`` of
#: the one process's, relative: a gradient summed over too few ranks or
#: rows is off by its missing share, which the sign-like update hides and
#: bfloat16 weights that do not move (the norms' ones at this ``lr``)
#: cannot show.
#: ``tools/tp_faults.py`` reads these checks on runs with a fault
#: planted.
TP_LOSS_TOL, TP_UPDATE_TOL, TP_MOMENT_TOL = 1e-2, 0.5, 0.1
#: ``tp_models_on_card``: one spawn of four processes, two cases, each
#: held to one process.  gpt-3.1b (22 heads on a 4-way model axis: the
#: sequence-sharded attention, 128 rows a rank, the kernel's q_offset)
#: at full width and 4 of 32 layers, bf16, (data 1, model 4): a loss and
#: a train step of 2 x 512; granite-moe-3b-a800m (24 heads, 40 experts:
#: the expert-parallel MoE inside the model) at full width and 4 of 32
#: layers in float32 (where no router near-tie can send a token to
#: another expert), (data 2, model 2) with FSDP, at the capacity factor
#: E / k = 5 (an expert's capacity is the tokens routed, so neither side
#: drops one): a train step of 4 x 512.  The loss within
#: ``TP_LOSS_TOL`` (bf16) or ``TPM_F32_LOSS_TOL`` (float32); the
#: parameters as ``tp_train``'s, after one step.
TPM_CASES = {
    "gpt-3.1b": {"layers": 4, "dtype": "bfloat16", "ranks": [[2, 0, 3, 1]],
                 "fsdp": False, "batch": 2, "loss": True},
    "granite-moe-3b-a800m": {"layers": 4, "dtype": "float32",
                             "ranks": [[1, 3], [2, 0]], "fsdp": True,
                             "batch": 4, "loss": False},
}
TPM_SEQ, TPM_F32_LOSS_TOL = 512, 1e-4
TPM_SPAWN_S, TPM_PHASE_S = 300.0, 45.0


def tp_rank_launches(cfg, tp: int, n_micro: int, steps: int,
                     mb: tuple) -> tuple:
    """``(forward launches, backward launches, shape keys)`` of one rank of
    a ``make_train_step`` run under a context whose model axis ``tp``
    divides the heads: :func:`train_launches`' count (per microbatch 2
    norms and the attention a layer, twice under remat, and the final
    norm; one backward of each) on the rank's microbatch ``mb`` ``(b, S,
    d)`` and its ``H / tp`` query heads, against the KV heads they read
    (``KV / tp`` when those divide, else as ``transformer._kv_heads``
    picks them)."""
    from repro_torch.models.transformer import _kv_heads
    if cfg.n_heads % tp:
        raise ValueError(f"{cfg.n_heads} heads do not divide {tp}")
    L, per = cfg.n_layers, steps * n_micro
    dt = getattr(torch, cfg.dtype)
    residual = 2 * L - 1
    want = {k: 0 for k in WRAPPERS}
    want["rmsnorm"] = per * (4 * L + 1)
    want["flash_attention"] = per * 2 * L
    want_bwd = {k: 0 for k in BWD_KERNELS}
    want_bwd["rmsnorm_bwd"] = per * (residual + 2)
    want_bwd["flash_attention_bwd"] = per * L
    h, group = cfg.n_heads // tp, cfg.n_heads // cfg.n_kv_heads
    if cfg.n_kv_heads % tp:
        _, group = _kv_heads(0, h, group)
    fa_key = ((mb[0], h, mb[1], cfg.hd), (mb[0], h // group, mb[1], cfg.hd),
              True, 0, str(dt))
    shapes = {k: {} for k in WRAPPERS}
    shapes["rmsnorm"] = {(mb, dt, dt): per * 3,
                         ("add", mb, dt, dt): per * 2 * residual,
                         ("bwd", mb, dt, dt): per * 2,
                         ("add_bwd", mb, dt, dt, True): per * residual}
    shapes["flash_attention"] = {fa_key: per * 2 * L,
                                 ("bwd",) + fa_key: per * L}
    return want, want_bwd, shapes


def _global_batch(toks, lbls) -> dict:
    """``_pp_batches``' ``(n_mb, rows, S)`` arrays as one global batch of
    consecutive microbatches (``make_train_step``'s split gives them
    back)."""
    s = toks.shape[-1]
    return {"tokens": toks.reshape(-1, s), "labels": lbls.reshape(-1, s)}


def _sum_shapes(results: list) -> dict:
    """The ranks' shape counts (each result's ``shapes``) added up, per
    wrapper."""
    shapes = {name: {} for name in WRAPPERS}
    for r in results:
        for name, by in r["shapes"].items():
            for k, n in by.items():
                shapes[name][k] = shapes[name].get(k, 0) + n
    return shapes


def _rank_setup():
    """A spawned rank's card and the library the parent built."""
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    _build.load_library()
    return torch.device("cuda", 0)


#: The layouts ``tp_train`` runs in turn in one spawn: FSDP, then ZeRO-1
#: (parameters replicated over the data axis, moments as its blocks).
TP_LAYOUTS = ("fsdp", "zero1")


def tp_ctx(mesh, layout: str) -> ShardCtx:
    """``tp_train``'s context for ``layout`` (one of :data:`TP_LAYOUTS`)."""
    return ShardCtx(mesh=mesh, dp=("data",), tp="model",
                    fsdp=("data",) if layout == "fsdp" else ())


def tp_rank(rank: int, world: int, conf_t: tuple, mapping,
            ref: list) -> dict:
    """One rank of ``tp_train`` (a spawned process on the card), for each
    layout of :data:`TP_LAYOUTS` in turn: its blocks of the weights (drawn
    whole from seed 0 and cut), ``TP_STEPS`` steps of ``make_train_step``
    under the context on its rows of ``_pp_batches``, its launch counts,
    bytes by kind, peak and stored bytes (against ``specs.shard_sizes``),
    and its blocks of the parameters and of AdamW's first moment after the
    last step against the one process's trees ``ref``
    (:func:`block_sums`; the parent's tensors on the card, shared with
    this process: the rank empties the list, so that its handles on them
    are gone when it returns and the parent can free them)."""
    import torch.distributed as dist
    from repro_torch.models import sharding as sh
    from repro_torch.optim.adamw import AdamW
    t_start = time.perf_counter()
    device = _rank_setup()
    cfg = configs.get(PP_ARCH).replace(n_layers=TP_LAYERS)
    conf = Conf(*conf_t)
    mesh = mesh_from_mapping(conf, np.asarray(mapping))
    c = mesh.coords(rank)
    times = {"setup_s": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    groups = {a: dist.get_process_group_ranks(mesh.group(a))
              for a in mesh.axis_names}
    times["groups_s"] = time.perf_counter() - t0
    print(f"[tp_train] rank {rank}: coords {c}, groups {groups}", flush=True)
    out = {"rank": rank, "coords": c, "groups": groups}
    for layout in TP_LAYOUTS:
        ctx = tp_ctx(mesh, layout)
        zero1 = layout == "zero1"
        t0 = time.perf_counter()
        full = init_params(cfg, seed=0, device=device)
        params = sh.shard_params(full, cfg, ctx, rank)
        del full
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        run_times = dict(times, init_s=time.perf_counter() - t0)
        opt = AdamW(lr=TRAIN_LR)
        state = (train_steps.init_sharded(params, cfg, ctx)
                 if zero1 else opt.init(params))
        spec_bytes = sum(
            _tree.leaves(SP.shard_sizes(SP.params_spec(cfg, ctx), mesh,
                                        rank))
            + _tree.leaves(SP.shard_sizes(SP.opt_spec(cfg, ctx, opt,
                                                      zero1=zero1),
                                          mesh, rank)))
        step = train_steps.make_train_step(cfg, ctx, opt, n_micro=conf.n_mb,
                                           zero1=zero1)
        batches = [train_steps.shard_batch(_global_batch(t, lb), ctx, rank,
                                           conf.n_mb)
                   for t, lb in _pp_batches(cfg, conf)]
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        collectives.reset_stats()
        losses, step_s = [], []
        for batch in batches:
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        launches, bwd, shapes = (read_launches(), read_bwd_launches(),
                                 read_shapes())
        staged = dict(collectives.STATS)
        peak = torch.cuda.max_memory_allocated()
        stored = stored_bytes(params, state)
        assert stored == spec_bytes, (layout, rank, stored, spec_bytes)
        t0 = time.perf_counter()
        moment_specs = (_leaf_specs(cfg, ctx, SP.opt_spec(
            cfg, ctx, opt, zero1=True).m) if zero1 else None)
        sums = block_sums(params, state.m, tuple(ref), cfg, ctx, rank,
                          moment_specs)
        run_times["compare_s"] = time.perf_counter() - t0
        out[layout] = {
            "losses": losses, "sums": sums, "step_s": step_s,
            "peak_memory_bytes": peak, "stored_bytes": stored,
            "moment_bytes": stored_bytes(state.m, state.v),
            "times": run_times,
            "staged_bytes_per_step": {k: v / TP_STEPS
                                      for k, v in staged.items()},
            "launches_fwd": launches, "launches_bwd": bwd,
            "shapes": shapes}
        del params, state, step, batches
        torch.cuda.empty_cache()
    ref.clear()
    assert _build.last_build_seconds is None, "a rank ran nvcc"
    return out


def _one_process_run(cfg, batches: list, device, n_micro: int,
                     lr: float, loss_batch=None) -> tuple:
    """``(params before, params after, AdamW's first moment after, losses,
    loss of loss_batch)``: ``make_train_step`` with ``ShardCtx()`` in this
    process on the weights drawn whole from seed 0 (the ranks' draw), one
    step a batch."""
    from repro_torch.optim.adamw import AdamW
    params = init_params(cfg, seed=0, device=device)
    before = _tree.tree_map(torch.clone, params)
    loss0 = None
    if loss_batch is not None:
        with torch.no_grad():
            loss0 = float(M.loss_fn(params, cfg, ShardCtx(), {
                k: torch.as_tensor(v, device=device).long()
                for k, v in loss_batch.items()})[0])
    opt = AdamW(lr=lr)
    state = opt.init(params)
    step = train_steps.make_train_step(cfg, ShardCtx(), opt, n_micro=n_micro)
    losses = []
    for batch in batches:
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    return before, params, state.m, losses, loss0


def _leaf_specs(cfg, ctx, tree=None) -> list:
    """Each parameter leaf's spec under ``ctx``, in ``_tree.leaves``
    order (layers stacked); with ``tree`` (a spec tree of
    ``launch/specs.py``, such as ZeRO-1's moments) its leaves' specs."""
    from repro_torch.models import sharding as sh
    from repro_torch.models.transformer import param_shapes
    if tree is not None:
        return [s.spec for s in _tree.leaves(tree)]

    def walk(node):
        if isinstance(node, dict):
            return [x for k in sorted(node) for x in walk(node[k])]
        return [node]
    return walk(sh.tree_pspecs(param_shapes(cfg), cfg, ctx))


#: Elements a chunk of :func:`_digest` reads at once.
DIGEST_CHUNK = 1 << 24


def _digest(t) -> tuple:
    """Two sums of ``t``'s bits read as integers, the second weighted by
    position, chunk by chunk (a chunk's sum wraps at 64 bits alike on
    every rank): blocks of the same bits have the same digest."""
    x = t.detach().contiguous().view(-1)
    x = x.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[
        x.element_size()])
    s1 = s2 = 0
    for i in range(0, x.numel(), DIGEST_CHUNK):
        c = x[i:i + DIGEST_CHUNK].long()
        pos = torch.arange(i + 1, i + 1 + c.numel(), device=c.device)
        s1 += int(c.sum())
        s2 += int((c * pos).sum())
    return s1, s2


def block_sums(params, moment, ref, cfg, ctx, rank: int,
               moment_specs=None) -> dict:
    """What a rank reports of its blocks for :func:`param_readings`: per
    tree (``params``, and ``moment``, AdamW's first moment, cut by
    ``moment_specs`` where they differ from the parameters' specs: ZeRO-1)
    and leaf, its block against the same block of the one process's whole
    trees ``ref`` (``(before, after, moment)`` of
    :func:`_one_process_run`): ``(sum of squared differences, sum of
    squares of the one process's update or moment, largest difference,
    digest of the block's bits)``."""
    from repro_torch.models import sharding as sh
    before, after, m_ref = ref
    specs = _leaf_specs(cfg, ctx)
    out = {}
    for tree, mine, want, base, tspecs in (
            ("params", params, after, before, specs),
            ("moment", moment, m_ref, None, moment_specs or specs)):
        bases = _tree.leaves(base) if base is not None else [None] * len(
            specs)
        rows = {}
        for name, g, w, b, spec in zip(leaf_names(want), _tree.leaves(mine),
                                       _tree.leaves(want), bases, tspecs):
            w = sh.shard_leaf(w, spec, ctx.mesh, rank).float()
            d = g.float() - w
            if b is not None:
                w = w - sh.shard_leaf(b, spec, ctx.mesh, rank).float()
            rows[name] = (float(torch.sum(d * d, dtype=torch.float64)),
                          float(torch.sum(w * w, dtype=torch.float64)),
                          float(d.abs().max()), _digest(g))
        out[tree] = rows
    return out


def param_readings(sums: list, cfg, ctx, moment_specs=None) -> dict:
    """The ranks' :func:`block_sums` (``sums[r]`` rank ``r``'s) put
    together, per tree and leaf: ``rel_err``, the Frobenius norm of the
    difference from the one process over that of its update (the
    parameters) or of its moment, each block counted once (the lowest
    rank that holds it); ``max_abs_diff``; and ``replicas_agree``,
    whether the ranks that hold the same block hold the same bits."""
    import math
    from repro_torch.models import sharding as sh
    specs = _leaf_specs(cfg, ctx)
    out = {}
    for tree in ("params", "moment"):
        rows = {}
        tspecs = moment_specs if tree == "moment" and moment_specs \
            else specs
        for name, spec in zip(sums[0][tree], tspecs):
            held = {}
            for r, mine in enumerate(sums):
                key = tuple(ctx.mesh.coords(r)[a] for entry in spec
                            for a in sh.spec_axes(entry))
                held.setdefault(key, []).append(mine[tree][name])
            diff = math.fsum(h[0][0] for h in held.values())
            base = math.fsum(h[0][1] for h in held.values())
            rows[name] = {
                "rel_err": math.sqrt(diff) / max(math.sqrt(base), 1e-30),
                "max_abs_diff": max(x[2] for h in held.values() for x in h),
                "replicas_agree": all(len({x[3] for x in h}) == 1
                                      for h in held.values())}
        out[tree] = rows
    return out


def _compare_params(sums: list, cfg, ctx, tols=None,
                    moment_specs=None) -> dict:
    """:func:`param_readings` of the ranks' blocks against the one
    process, asserted: the ranks that hold the same block of the
    parameters or of the first moment hold the same bits, each leaf's
    update error is within ``tols[0]`` (``TP_UPDATE_TOL``) and its first
    moment's within ``tols[1]`` (``TP_MOMENT_TOL``); returns the largest
    of each error and of the parameters' elementwise difference."""
    got = param_readings(sums, cfg, ctx, moment_specs)
    update_tol, moment_tol = tols or (TP_UPDATE_TOL, TP_MOMENT_TOL)
    for tree, tol in (("params", update_tol), ("moment", moment_tol)):
        for name, row in got[tree].items():
            assert row["replicas_agree"], (tree, name, "replicas differ")
            assert row["rel_err"] <= tol, (tree, name, row)
    return {"leaves": len(got["params"]),
            "max_abs_diff": max(r["max_abs_diff"]
                                for r in got["params"].values()),
            "max_update_rel_err": max(r["rel_err"]
                                      for r in got["params"].values()),
            "max_moment_rel_err": max(r["rel_err"]
                                      for r in got["moment"].values())}


def tp_train(device) -> tuple:
    """``tp_train_gpt_1_1b``: the one-process run, then the (pp 1, tp 2,
    dp 2) run on the same weights and batches (:func:`tp_rank` in four
    spawned processes, which time their steps with nothing else on the
    card), their comparison, each rank's coordinates, groups and
    launches (against :func:`tp_rank_launches`), and the run's line;
    returns ``(line, shapes)`` with the ranks' summed shape counts."""
    t_phase = time.perf_counter()
    cfg = configs.get(PP_ARCH).replace(n_layers=TP_LAYERS)
    conf = Conf(*TP_CONF)
    mapping = np.asarray(TP_MAPPING)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    batches = [_global_batch(t, lb) for t, lb in _pp_batches(cfg, conf)]
    t0 = time.perf_counter()
    ref = _one_process_run(cfg, batches, device, conf.n_mb, TRAIN_LR)
    ref_losses = ref[3]
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = collectives.spawn(tp_rank, int(mapping.size),
                                (TP_CONF, TP_MAPPING, list(ref[:3])),
                                timeout=TP_SPAWN_S)
    spawn_s = time.perf_counter() - t0
    del ref
    torch.cuda.ipc_collect()            # the ranks' handles on it are gone
    mb = (conf.bs_micro, PP_SEQ, cfg.d_model)
    want, want_bwd, want_shapes = tp_rank_launches(
        cfg, conf.tp, conf.n_mb, TP_STEPS, mb)
    mesh = mesh_from_mapping(conf, mapping)
    runs = {}
    for r in results:
        x, y, z = (int(v) for v in np.argwhere(mapping == r["rank"])[0])
        assert r["coords"] == {"pipe": x, "model": y, "data": z}, r
        assert r["groups"] == {
            "pipe": sorted(mapping[:, y, z].tolist()),
            "model": sorted(mapping[x, :, z].tolist()),
            "data": sorted(mapping[x, y, :].tolist())}, r
    for layout in TP_LAYOUTS:
        rs = [dict(r[layout], rank=r["rank"], coords=r["coords"],
                   groups=r["groups"]) for r in results]
        for r in rs:
            assert r["launches_fwd"] == want, (layout, r["rank"],
                                               r["launches_fwd"])
            assert r["launches_bwd"] == want_bwd, (layout, r["rank"],
                                                   r["launches_bwd"])
            for name, by in want_shapes.items():
                assert r["shapes"][name] == by, (layout, r["rank"], name,
                                                 r["shapes"][name])
        losses = rs[0]["losses"]
        assert all(r["losses"] == losses for r in rs), \
            [r["losses"] for r in rs]
        diffs = [abs(a - b) for a, b in zip(losses, ref_losses)]
        assert all(np.isfinite(losses)) and max(diffs) <= TP_LOSS_TOL, \
            (layout, losses, ref_losses)
        ctx = tp_ctx(mesh, layout)
        moment_specs = (_leaf_specs(cfg, ctx, SP.opt_spec(
            cfg, ctx, None, zero1=True).m) if layout == "zero1" else None)
        cmp = _compare_params([r["sums"] for r in rs], cfg, ctx,
                              moment_specs=moment_specs)
        step_s = [max(r["step_s"][i] for r in rs) for i in range(TP_STEPS)]
        runs[layout] = {
            "ctx": {"dp": ["data"], "tp": "model",
                    "fsdp": list(ctx.fsdp), "zero1": layout == "zero1"},
            "ranks": [{k: r[k] for k in (
                "rank", "coords", "groups", "peak_memory_bytes",
                "stored_bytes", "moment_bytes", "staged_bytes_per_step",
                "step_s", "times")} for r in rs],
            "losses": losses, "loss_abs_diff": diffs, "params": cmp,
            "step_s": step_s, "warm_step_s": max(step_s[1:]),
            "peak_memory_bytes_max": max(r["peak_memory_bytes"]
                                         for r in rs),
            "staged_bytes_per_step_max": max(
                r["staged_bytes_per_step"]["collective"] for r in rs),
            "stored_bytes_equal_specs": "asserted in every rank",
            "launches_fwd": {k: sum(r["launches_fwd"][k] for r in rs)
                             for k in WRAPPERS},
            "launches_bwd": {k: sum(r["launches_bwd"][k] for r in rs)
                             for k in BWD_KERNELS},
            "shapes": _sum_shapes(rs)}
    torch.cuda.empty_cache()
    launches = {k: sum(runs[lo]["launches_fwd"][k] for lo in TP_LAYOUTS)
                for k in WRAPPERS}
    bwd = {k: sum(runs[lo]["launches_bwd"][k] for lo in TP_LAYOUTS)
           for k in BWD_KERNELS}
    shapes = {name: {} for name in WRAPPERS}
    for lo in TP_LAYOUTS:
        for name, by in runs[lo].pop("shapes").items():
            for key, n in by.items():
                shapes[name][key] = shapes[name].get(key, 0) + n
    seconds = time.perf_counter() - t_phase
    assert seconds <= TP_PHASE_S, ("tp_train_gpt_1_1b over its budget",
                                   seconds)
    fsdp = runs["fsdp"]
    line = {
        "phase": "tp_train_gpt_1_1b", "model": cfg.name,
        "cut": f"n_layers {TP_LAYERS} of 24 (full width: d {cfg.d_model}, "
               f"heads {cfg.n_heads} of {cfg.hd}, {cfg.n_heads // conf.tp} "
               f"a rank, d_ff {cfg.d_ff}, vocab {cfg.vocab_size})",
        "conf": {"pp": conf.pp, "tp": conf.tp, "dp": conf.dp,
                 "bs_micro": conf.bs_micro, "bs_global": conf.bs_global,
                 "n_mb": conf.n_mb},
        "mapping": TP_MAPPING, "axes": ["pipe", "model", "data"],
        "ctx": fsdp["ctx"],
        "processes": len(results), "backend": "gloo (host-staged)",
        "seq_len": PP_SEQ, "steps": TP_STEPS, "lr": TRAIN_LR,
        "dtype": cfg.dtype, "remat": True,
        "ranks": fsdp["ranks"],
        "losses": fsdp["losses"], "one_process_losses": ref_losses,
        "loss_abs_diff": fsdp["loss_abs_diff"],
        "tol": {"loss": TP_LOSS_TOL, "update_rel": TP_UPDATE_TOL,
                "moment_rel": TP_MOMENT_TOL},
        "params": fsdp["params"],
        "step_s": fsdp["step_s"], "warm_step_s": fsdp["warm_step_s"],
        "peak_memory_bytes_max": fsdp["peak_memory_bytes_max"],
        "zero1": {k: v for k, v in runs["zero1"].items()
                  if k not in ("launches_fwd", "launches_bwd")},
        "launches_fwd": launches, "launches_bwd": bwd,
        "launches_per_rank_formula": "tp_rank_launches: per microbatch 2 "
                                     "norms + 1 attention a layer, twice "
                                     "(remat), 1 backward each, and the "
                                     "final norm, at H / tp heads; the "
                                     "same in each layout (FSDP, then "
                                     "ZeRO-1)",
        "one_process_seconds": one_s, "spawn_seconds": spawn_s,
        "seconds": seconds,
    }
    return line, shapes


# ---------------------------------------------------------------------------
# the dry run on the layouts the parallel phases ran
# ---------------------------------------------------------------------------

def dryrun_vs_card(line_pp: dict, line_tp: dict) -> dict:
    """``dryrun_vs_card``: ``launch/dryrun.py``'s machinery (meta tensors,
    ``collectives.dry``) on exactly the layouts ``pp_train_gpt_1_1b`` and
    ``tp_train_gpt_1_1b`` just ran on the card — gpt-1.1b at
    ``PP_LAYERS`` / ``TP_LAYERS`` layers, the same batch, sequence,
    microbatches and mesh —
    one dry step as a rank of each stage (the pipeline's counts depend on
    the stage; the tensor-parallel ranks' on nothing), held to every rank
    of it: its collective bytes by kind must equal the bytes the rank
    counted staged through ``gloo`` a step (the same counter,
    ``collectives.STATS``), and the bytes of its parameters and optimizer
    state those the rank stored.  The dry peak (arguments and
    the step's live storage) is printed beside ``max_memory_allocated``,
    the dry FLOPs a rank beside ``model_flops`` over the ranks, and the
    card's ``total_memory`` beside the one ``fits_h100_80g`` takes."""
    from repro_torch.core import flops as F
    from repro_torch.launch import dryrun
    from repro_torch.optim.adamw import AdamW
    t0 = time.perf_counter()
    cfg = configs.get(PP_ARCH).replace(n_layers=PP_LAYERS)
    cfg_tp = configs.get(PP_ARCH).replace(n_layers=TP_LAYERS)
    opt = AdamW(lr=TRAIN_LR)

    def meta_tokens(shape):
        return {k: torch.empty(shape, dtype=torch.int64, device="meta")
                for k in ("tokens", "labels")}

    def compare(name, cfg, step, args, ranks, n_ranks, tokens, role):
        """One dry step for each value of ``role`` (a rank's coordinates
        that its counts depend on), held to every rank with that value."""
        rows = []
        model = F.model_flops(cfg, tokens, train=True) / n_ranks
        dry = {}
        for r in ranks:
            key = role(r["coords"])
            if key not in dry:
                dry[key] = dryrun.measure(step, args, rank=r["rank"])
            m = dry[key]
            stats = {k: float(v) for k, v in m["stats"].items()}
            assert stats == r["staged_bytes_per_step"], \
                (name, r["rank"], stats, r["staged_bytes_per_step"])
            stored = dryrun._tree_bytes(args[:2])
            assert stored == r["stored_bytes"], (name, r["rank"], stored,
                                                 r["stored_bytes"])
            rows.append({
                "rank": r["rank"], "coords": r["coords"],
                "collective_bytes_by_kind": m["stats"],
                "collective_bytes_by_op": m["ops"],
                "stored_bytes": stored,
                "dry_peak_bytes": m["argument_bytes"] + m["temp_bytes"],
                "card_peak_bytes": r["peak_memory_bytes"],
                "dry_flops": m["flops"], "model_flops_per_rank": model,
                "dry_hbm_bytes": m["hbm_bytes"],
                "kernel_calls": m["kernel_calls"],
                "dry_seconds": m["seconds"]})
        return {"run": name, "ranks": rows}

    runs = []
    conf = Conf(*PP_CONF)
    mesh = mesh_from_mapping(conf, np.asarray(PP_MAPPING))
    step, p_spec, o_spec, _ = make_pp_train_step(
        cfg, mesh, opt, pipe_axis="pipe", data_axis="data", n_mb=conf.n_mb,
        remat=True)
    params, state = dryrun.pp_meta_state(p_spec, o_spec, mesh)
    per = conf.bs_global // conf.n_mb // conf.dp
    batch = {k + "_mb": v for k, v in meta_tokens(
        (conf.n_mb, per, PP_SEQ)).items()}
    runs.append(compare("pp2_dp2", cfg, step, (params, state, batch),
                        line_pp["ranks"], mesh.size,
                        conf.bs_global * PP_SEQ, lambda c: c["pipe"]))
    conf = Conf(*TP_CONF)
    mesh = mesh_from_mapping(conf, np.asarray(TP_MAPPING))
    for layout in TP_LAYOUTS:
        ctx = tp_ctx(mesh, layout)
        zero1 = layout == "zero1"
        step = train_steps.make_train_step(cfg_tp, ctx, opt,
                                           n_micro=conf.n_mb, zero1=zero1)
        params, state = dryrun.train_meta_state(cfg_tp, ctx, mesh, zero1)
        batch = meta_tokens((conf.bs_global // conf.dp, PP_SEQ))
        ranks = line_tp["ranks"] if layout == "fsdp" else \
            line_tp["zero1"]["ranks"]
        runs.append(compare(f"tp2_dp2_{layout}", cfg_tp, step,
                            (params, state, batch), ranks, mesh.size,
                            conf.bs_global * PP_SEQ, lambda c: 0))
    return {"phase": "dryrun_vs_card", "model": cfg.name,
            "layers": {"pp": PP_LAYERS, "tp": TP_LAYERS}, "runs": runs,
            "total_memory": torch.cuda.get_device_properties(0).total_memory,
            "dryrun_total_memory": dryrun.H100_TOTAL_MEMORY,
            "checked": "every rank: dry collective bytes by kind == the "
                       "rank's staged bytes a step; dry stored bytes == "
                       "the rank's stored bytes",
            "seconds": time.perf_counter() - t0}


#: The bfloat16 working type's ragged cases (b, S, D, N): the reference's
#: chunk q = 1, 7, 65 and 100 (S 1, 7, 130, 200), D not a multiple of a
#: block's channels (8 forward, 32 backward), N at 16, 5 and 1; and
#: falcon-mamba-7b's training microbatch (the prefill's is FALCON_SCAN).
SCAN_BF16_RAGGED = [(2, 1, 24, 16), (1, 7, 9, 5), (2, 130, 45, 16),
                    (1, 200, 40, 1)]
FALCON_TRAIN_SCAN = (TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, 8192, 16)


def scan_bf16_on_card(device) -> dict:
    """``scan_bf16_on_card``: the fused scan with the bfloat16 working type
    (``scan_dtype="bfloat16"``) on the card.  Its forward instances
    (generation, and training: the one that keeps the state entering
    every chunk) at falcon-mamba-7b's prefill and training shapes and at
    ``SCAN_BF16_RAGGED`` in both input types, and its backward (with and
    without ``h0`` and ``dh_final`` at the ragged shapes), against their
    plain versions (the state within ``TOL_FUSED_STATE``, the gradients
    within ``TOL_BWD_BF16_WORK``; each backward relaunched and replayed
    from a CUDA graph for the same bits); the forward at the prefill
    shape relaunched and replayed for the same bits; and the gap that a
    wrong order — each chunk's prefix taken sequentially in bfloat16 —
    leaves in the final state against the plain tree, which must exceed
    the tolerance that the kernel meets."""
    t0 = time.perf_counter()
    b, s, d, n = FALCON_SCAN
    keys = [("fused_bf16", (b, s, d), n, "bfloat16"),
            ("fused_bf16_bound", FALCON_TRAIN_SCAN[:3], n, "bfloat16")]
    keys += [(form, (b_, s_, d_), n_, dt)
             for dt in ("float32", "bfloat16")
             for b_, s_, d_, n_ in SCAN_BF16_RAGGED
             for form in ("fused_bf16", "fused_bf16_bound")]
    fwd = [check_model_kernel("selective_scan", key, device, False)
           for key in keys]
    bwd_keys = [("fused_bf16_bwd", FALCON_TRAIN_SCAN[:3], n, "bfloat16")]
    bwd_keys += [("fused_bf16_bwd", (b_, s_, d_), n_, dt, with_h0, with_dhf)
                 for dt in ("float32", "bfloat16")
                 for b_, s_, d_, n_ in SCAN_BF16_RAGGED
                 for with_h0, with_dhf in SCAN_BWD_STARTS]
    bwd = [check_bwd_kernel("selective_scan_fused_bwd", key, device, False)
           for key in bwd_keys]
    torch.cuda.empty_cache()
    # the prefill instance's bits, relaunched and replayed from a graph
    args, _ = model_inputs("selective_scan", keys[0], device)
    first = fused_bf16_kernel(*args)
    again = fused_bf16_kernel(*args)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = fused_bf16_kernel(*args)
    graph.replay()
    torch.cuda.synchronize()
    bits = all(torch.equal(f, a) and torch.equal(f, r)
               for f, a, r in zip(first, again, replayed))
    assert bits, "the bfloat16 working type's forward changed its bits"
    # the tolerance tells the reference's order from a sequential one
    _, want_h = fused_bf16_plain(*args)

    def state_gap(h):
        return float(((h - want_h).abs() / (1 + want_h.abs())).max())

    kernel_gap = state_gap(first[1])
    wrong_gap = state_gap(sequential_bf16_state(*args))
    assert kernel_gap <= TOL_FUSED_STATE < wrong_gap, (kernel_gap,
                                                        wrong_gap)
    del graph, first, again, replayed, args
    torch.cuda.empty_cache()
    return {"phase": "scan_bf16_on_card", "kernels": fwd + bwd,
            "tol": {"state": TOL_FUSED_STATE,
                    "out": {"float32": 2e-4, "bfloat16": 2e-2},
                    "gradients": TOL_BWD_BF16_WORK},
            "prefill_repeat_and_graph_bits_equal": bits,
            "state_gap_at_prefill": {
                "kernel_vs_plain_tree": kernel_gap,
                "sequential_bf16_prefix_vs_plain_tree": wrong_gap,
                "tol": TOL_FUSED_STATE},
            "seconds": time.perf_counter() - t0}


def tp_models_rank(rank: int, world: int, refs: dict) -> dict:
    """One rank of ``tp_models_on_card``: each case of ``TPM_CASES`` in
    turn on its own mesh of the four processes (the same weights drawn
    whole from seed 0 and cut, its rows of a batch from one seed), the
    loss where the case asks, one ``make_train_step`` step, and its blocks
    after it against the one process's trees ``refs[arch]``
    (:func:`block_sums`; popped, as :func:`tp_rank` empties its list);
    its launches and shapes over both cases."""
    import torch.distributed as dist
    from repro_torch.models import sharding as sh
    from repro_torch.optim.adamw import AdamW
    t_start = time.perf_counter()
    device = _rank_setup()
    reset_launches()
    out = {"rank": rank, "cases": {},
           "setup_s": time.perf_counter() - t_start}
    for arch, case in TPM_CASES.items():
        t0 = time.perf_counter()
        cfg, mesh, ctx, batch = _tpm_setup(arch, case)
        full = init_params(cfg, seed=0, device=device)
        params = sh.shard_params(full, cfg, ctx, rank)
        del full
        torch.cuda.empty_cache()
        mine = train_steps.shard_batch(batch, ctx, rank)
        res = {"coords": mesh.coords(rank)}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for a in mesh.axis_names:       # the groups, made collectively
            mesh.group(a)
        dist.barrier()
        res.update(init_s=t1 - t0, groups_s=time.perf_counter() - t1)
        torch.cuda.reset_peak_memory_stats()
        collectives.reset_stats()
        t0 = time.perf_counter()
        if case["loss"]:
            with torch.no_grad():
                res["loss_only"] = float(M.loss_fn(params, cfg, ctx, {
                    k: torch.as_tensor(v, device=device).long()
                    for k, v in mine.items()})[0])
            res["loss_s"] = time.perf_counter() - t0
        opt = AdamW(lr=TRAIN_LR)
        step = train_steps.make_train_step(cfg, ctx, opt)
        params, state, m = step(params, opt.init(params), mine)
        res["loss"] = float(m["loss"])
        torch.cuda.synchronize()
        res.update(seconds=time.perf_counter() - t0,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   staged_bytes=dict(collectives.STATS))
        t0 = time.perf_counter()
        res["sums"] = block_sums(params, state.m, refs.pop(arch), cfg, ctx,
                                 rank)
        res["compare_s"] = time.perf_counter() - t0
        del params, state
        torch.cuda.empty_cache()
        out["cases"][arch] = res
    out.update(launches_fwd=read_launches(), launches_bwd=read_bwd_launches(),
               shapes=read_shapes())
    assert _build.last_build_seconds is None, "a rank ran nvcc"
    return out


def _tpm_setup(arch: str, case: dict) -> tuple:
    """``(cfg, mesh, ctx, global batch)`` of a ``tp_models_on_card``
    case."""
    from repro_torch.launch.mesh import Mesh
    cfg = configs.get(arch).replace(n_layers=case["layers"],
                                    dtype=case["dtype"])
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=float(cfg.n_experts
                                                // cfg.experts_per_token))
    mesh = Mesh(np.asarray(case["ranks"]), ("data", "model"))
    ctx = ShardCtx(mesh=mesh, dp=("data",), tp="model",
                   fsdp=("data",) if case["fsdp"] else ())
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, cfg.vocab_size, (case["batch"], TPM_SEQ + 1),
                        dtype=np.int64)
    return cfg, mesh, ctx, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def tp_models(device) -> tuple:
    """``tp_models_on_card``: each case in this process, then
    :func:`tp_models_rank` in four spawned processes, held to it; returns
    ``(line, shapes)`` with the ranks' summed shape counts."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cases, refs = {}, {}
    t0 = time.perf_counter()
    for arch, case in TPM_CASES.items():
        cfg, _, _, batch = _tpm_setup(arch, case)
        refs[arch] = _one_process_run(
            cfg, [batch], device, 1, TRAIN_LR,
            loss_batch=batch if case["loss"] else None)
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = collectives.spawn(tp_models_rank, 4,
                                ({a: r[:3] for a, r in refs.items()},),
                                timeout=TPM_SPAWN_S)
    spawn_s = time.perf_counter() - t0
    for arch, case in TPM_CASES.items():
        cfg, mesh, ctx, batch = _tpm_setup(arch, case)
        got = [r["cases"][arch] for r in results]
        for rank, r in enumerate(got):
            assert r["coords"] == mesh.coords(rank), (arch, rank, r)
        loss = got[0]["loss"]
        assert all(r["loss"] == loss for r in got), [r["loss"] for r in got]
        ref_losses, ref_loss0 = refs.pop(arch)[3:]
        tol = TP_LOSS_TOL if cfg.dtype == "bfloat16" else TPM_F32_LOSS_TOL
        assert abs(loss - ref_losses[0]) <= tol, (arch, loss, ref_losses)
        row = {"layers": f"{case['layers']} of "
                         f"{configs.get(arch).n_layers}",
               "dtype": cfg.dtype, "mesh": {"data": mesh.shape["data"],
                                            "model": mesh.shape["model"]},
               "ranks": case["ranks"], "fsdp": case["fsdp"],
               "batch": [case["batch"], TPM_SEQ],
               "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
               "attention": "sequence-sharded (q_offset)"
               if cfg.n_heads % mesh.shape["model"] else "heads",
               "loss": loss, "one_process_loss": ref_losses[0], "tol": tol}
        if case["loss"]:
            l0 = got[0]["loss_only"]
            assert all(r["loss_only"] == l0 for r in got)
            assert abs(l0 - ref_loss0) <= tol, (arch, l0, ref_loss0)
            row.update(loss_fn=l0, one_process_loss_fn=ref_loss0)
        if cfg.family == "moe":
            row.update(n_experts=cfg.n_experts,
                       capacity_factor=cfg.capacity_factor)
        row["params"] = _compare_params([r["sums"] for r in got], cfg, ctx)
        row["ranks_detail"] = [
            {"rank": i, **{k: r[k] for k in (
                "coords", "seconds", "peak_memory_bytes", "staged_bytes",
                "init_s", "groups_s", "compare_s", "loss_s") if k in r}}
            for i, r in enumerate(got)]
        cases[arch] = row
    torch.cuda.ipc_collect()            # the ranks' handles on refs are gone
    torch.cuda.empty_cache()
    launches = {k: sum(r["launches_fwd"][k] for r in results)
                for k in WRAPPERS}
    bwd = {k: sum(r["launches_bwd"][k] for r in results)
           for k in BWD_KERNELS}
    shapes = _sum_shapes(results)
    # the sequence-sharded attention ran at every rank's offset but the
    # first's (whose key has none)
    n = len(TPM_CASES["gpt-3.1b"]["ranks"][0])
    offsets = sorted({fa_key[5] for fa_key in shapes["flash_attention"]
                      if fa_key[0] != "bwd" and len(fa_key) > 5})
    assert offsets == [m * TPM_SEQ // n for m in range(1, n)], offsets
    seconds = time.perf_counter() - t_phase
    assert seconds <= TPM_PHASE_S, ("tp_models_on_card over its budget",
                                    seconds)
    return {"phase": "tp_models_on_card", "cases": cases,
            "launches_fwd": launches, "launches_bwd": bwd,
            "q_offsets_launched": [0] + offsets,
            "rank_setup_s": [r["setup_s"] for r in results],
            "one_process_seconds": one_s, "spawn_seconds": spawn_s,
            "seconds": seconds}, shapes


# ---------------------------------------------------------------------------
# the Mamba families, prefill and decode under an active ShardCtx
# ---------------------------------------------------------------------------

#: ``tp_train_mamba_on_card``: the Mamba families trained by
#: ``make_train_step`` under a context in four processes on the card, one
#: spawn, each case held to one process as ``tp_train_gpt_1_1b`` is (the
#: same tolerances).  falcon-mamba-7b (Mamba1, channel-parallel) at full
#: width and 4 of 64 layers, bf16, remat, for the Pipette configuration
#: ``conf`` (pp 1, tp 2, dp 2, bs_micro 2, bs_global 8) over a permuted
#: mapping with FSDP over data; zamba2-7b (Mamba2 head-parallel and its
#: weight-tied block, applied once, after layer 5) at full width and 6 of
#: 81 layers, bf16, remat, on (data 1, model 4) without FSDP, so that its
#: packed ``in_proj`` (14,448 columns) is cut at 3,612, inside a head.
#: ``TPMB_STEPS`` steps each.
TPMB_CASES = {
    "falcon-mamba-7b": {"layers": 4, "conf": (1, 2, 2, 2, 8),
                        "mapping": [[[2, 0], [1, 3]]], "fsdp": True},
    "zamba2-7b": {"layers": 6, "ranks": [[1, 3, 0, 2]], "fsdp": False,
                  "batch": 4, "n_micro": 2},
}
TPMB_STEPS, TPMB_SPAWN_S, TPMB_PHASE_S = 2, 300.0, 90.0
#: Its tolerances against one process: the loss ``TP_LOSS_TOL``; each
#: leaf's update and first moment, relative (:func:`_compare_params`),
#: set between the sound and the faulty readings of ``tools/tp_faults.py``
#: (sound up to 0.46 and 0.59; the Mamba1 faults 1.40 and more, Mamba2's
#: ``gated_norm_unsummed`` 1.23 / 1.68; PERF.md §6).  A Mamba layer's
#: gradients feel one bfloat16 rounding in another place far more than an
#: attention layer's: one process whose row-parallel products are summed
#: from ``tp`` bfloat16 blocks, as the model ranks sum them, reads 0.37 /
#: 0.40 (falcon-mamba-7b) and 0.44 / 0.53 (zamba2-7b) against the plain
#: one (``tools/tp_noise_floor.py``), where ``TP_*``'s 0.5 / 0.1 were set
#: for gpt-1.1b's 0.17 / 0.03.
TPMB_UPDATE_TOL, TPMB_MOMENT_TOL = 0.9, 0.9


def _tpmb_setup(arch: str, case: dict) -> tuple:
    """``(cfg, mesh, ctx, n_micro, global batches)`` of a
    ``tp_train_mamba_on_card`` case."""
    from repro_torch.launch.mesh import Mesh
    cfg = configs.get(arch).replace(n_layers=case["layers"])
    if "conf" in case:
        conf = Conf(*case["conf"])
        mesh = mesh_from_mapping(conf, np.asarray(case["mapping"]))
        rows, n_micro = conf.bs_global, conf.n_mb
    else:
        mesh = Mesh(np.asarray(case["ranks"]), ("data", "model"))
        rows, n_micro = case["batch"], case["n_micro"]
    ctx = ShardCtx(mesh=mesh, dp=("data",), tp="model",
                   fsdp=("data",) if case["fsdp"] else ())
    rng = np.random.default_rng(len(arch))
    batches = []
    for _ in range(TPMB_STEPS):
        toks = rng.integers(0, cfg.vocab_size, (rows, PP_SEQ + 1),
                            dtype=np.int64)
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return cfg, mesh, ctx, n_micro, batches


def _tpmb_split(cfg, tp: int) -> str:
    """How a case's Mamba layers split over a model axis of ``tp``."""
    if cfg.family == "ssm":
        return f"channel-parallel Mamba1, d_inner {cfg.d_inner // tp} a rank"
    width = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.n_ssm_heads
    return (f"head-parallel Mamba2, {cfg.n_ssm_heads // tp} SSD heads a "
            f"rank; packed in_proj {width} cut at {width // tp}")


def tp_mamba_rank_launches(cfg, tp: int, n_micro: int, steps: int,
                           mb: tuple) -> tuple:
    """``(forward launches, backward launches, shape keys)`` of one rank of
    a ``tp_train_mamba_on_card`` case, on its microbatch ``mb`` ``(b, S,
    d)``: :func:`train_launches`' count with a Mamba1 rank's scan on its
    ``d_inner / tp`` channels, and a hybrid rank's without the gated norm
    (its statistic is summed over the model axis in plain torch) and its
    shared block's attention on ``H / tp`` heads."""
    L, per, bf = cfg.n_layers, steps * n_micro, torch.bfloat16
    want = {k: 0 for k in WRAPPERS}
    want_bwd = {k: 0 for k in BWD_KERNELS}
    shapes = {k: {} for k in WRAPPERS}
    if cfg.family == "hybrid":
        apps = len(layer_plan(cfg)[1]["shared_at"])
        res_f, res_b = 2 * (L - 1) + 2 * apps, L - 1 + 2 * apps
        fa_key = ((mb[0], cfg.n_heads // tp, mb[1], cfg.hd),
                  (mb[0], cfg.n_kv_heads // tp, mb[1], cfg.hd), True, 0,
                  str(bf))
        want["flash_attention"] = want_bwd["flash_attention_bwd"] = \
            per * apps
        shapes["flash_attention"] = {fa_key: per * apps,
                                     ("bwd",) + fa_key: per * apps}
    else:
        res_f, res_b = 2 * (L - 1), L - 1
        x = (mb[0], mb[1], cfg.d_inner // tp)
        want["selective_scan"] = per * 2 * L
        want_bwd["selective_scan_fused_bwd"] = per * L
        shapes["selective_scan"] = {
            ("fused_bound", x, cfg.ssm_state, bf): per * 2 * L,
            ("fused_bwd", x, cfg.ssm_state, bf): per * L}
    want["rmsnorm"] = per * (3 + res_f)
    want_bwd["rmsnorm_bwd"] = per * (2 + res_b)
    shapes["rmsnorm"] = {(mb, bf, bf): per * 3,
                         ("add", mb, bf, bf): per * res_f,
                         ("bwd", mb, bf, bf): per * 2,
                         ("add_bwd", mb, bf, bf, True): per * res_b}
    return want, want_bwd, shapes


def tp_mamba_rank(rank: int, world: int, refs: dict) -> dict:
    """One rank of ``tp_train_mamba_on_card``: each case of
    ``TPMB_CASES`` in turn on its mesh (the weights drawn whole from seed
    0 and cut, its rows of the batches), ``TPMB_STEPS`` steps of
    ``make_train_step``, its launches, shapes and bytes by kind, and its
    blocks after the last step against the one process's trees
    ``refs[arch]`` (:func:`block_sums`; popped, as :func:`tp_rank`
    empties its list)."""
    import torch.distributed as dist
    from repro_torch.models import sharding as sh
    from repro_torch.optim.adamw import AdamW
    t_start = time.perf_counter()
    device = _rank_setup()
    out = {"rank": rank, "cases": {},
           "setup_s": time.perf_counter() - t_start}
    for arch, case in TPMB_CASES.items():
        t0 = time.perf_counter()
        cfg, mesh, ctx, n_micro, batches = _tpmb_setup(arch, case)
        full = init_params(cfg, seed=0, device=device)
        params = sh.shard_params(full, cfg, ctx, rank)
        del full
        torch.cuda.empty_cache()
        mine = [train_steps.shard_batch(b, ctx, rank, n_micro)
                for b in batches]
        res = {"coords": mesh.coords(rank)}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for a in mesh.axis_names:       # the groups, made collectively
            mesh.group(a)
        dist.barrier()
        res.update(init_s=t1 - t0, groups_s=time.perf_counter() - t1)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        collectives.reset_stats()
        opt = AdamW(lr=TRAIN_LR)
        state = opt.init(params)
        step = train_steps.make_train_step(cfg, ctx, opt, n_micro=n_micro)
        losses, step_s = [], []
        for batch in mine:
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        res.update(losses=losses, step_s=step_s,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   staged_bytes_per_step={
                       k: v / len(mine) for k, v in collectives.STATS.items()},
                   launches_fwd=read_launches(),
                   launches_bwd=read_bwd_launches(), shapes=read_shapes())
        t0 = time.perf_counter()
        res["sums"] = block_sums(params, state.m, refs.pop(arch), cfg, ctx,
                                 rank)
        res["compare_s"] = time.perf_counter() - t0
        del params, state
        torch.cuda.empty_cache()
        out["cases"][arch] = res
    assert _build.last_build_seconds is None, "a rank ran nvcc"
    return out


#: Mamba2's gated norm under a context (the statistic summed over the
#: model axis, ``mamba.split_gated_norm``) against the one-process
#: ``rmsnorm`` kernel, float32: the largest difference relative to the
#: largest output (a sum in another order, ``rsqrtf`` within 2 ulp).
GATED_NORM_TOL = 1e-5


def gated_norm_split_vs_kernel(device, cfg, tp: int) -> dict:
    """``split_gated_norm`` over ``tp`` channel blocks of a random float32
    ``(2, 512, d_inner)`` input with a bfloat16 weight, the blocks' sums
    added in one process, against the ``rmsnorm`` kernel's gated
    instance on the whole rows (a comparison, not a path launch)."""
    from repro_torch.models.mamba import split_gated_norm
    gen = torch.Generator(device=device).manual_seed(25)
    g = torch.randn((2, PP_SEQ, cfg.d_inner), generator=gen, device=device)
    w = (1 + 0.1 * torch.randn(cfg.d_inner, generator=gen,
                               device=device)).to(torch.bfloat16)
    want = rn.rmsnorm(g, w, cfg.norm_eps).float()
    dl = cfg.d_inner // tp
    got = split_gated_norm(torch.stack(g.split(dl, -1)),
                           w.view(tp, 1, 1, dl), cfg.d_inner, cfg.norm_eps,
                           lambda t: t.sum(0, keepdim=True))
    err = float((torch.cat(list(got), -1) - want).abs().max()
                / want.abs().max())
    assert err <= GATED_NORM_TOL, ("split gated norm", err)
    return {"shape": [2, PP_SEQ, cfg.d_inner], "blocks": tp,
            "max_rel_err": err, "tol": GATED_NORM_TOL}


def tp_train_mamba(device) -> tuple:
    """``tp_train_mamba_on_card``: each case's one-process run, then
    :func:`tp_mamba_rank` in four spawned processes, held to it (losses,
    the parameters' updates and AdamW's first moments, replicas
    bit-equal, launches against :func:`tp_mamba_rank_launches`); returns
    ``(line, shapes)`` with the ranks' summed launches and shape
    counts."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    refs, ref_losses = {}, {}
    t0 = time.perf_counter()
    for arch, case in TPMB_CASES.items():
        cfg, _, _, n_micro, batches = _tpmb_setup(arch, case)
        r = _one_process_run(cfg, batches, device, n_micro, TRAIN_LR)
        refs[arch], ref_losses[arch] = r[:3], r[3]
        del r
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = collectives.spawn(tp_mamba_rank, 4, (refs,),
                                timeout=TPMB_SPAWN_S)
    spawn_s = time.perf_counter() - t0
    del refs
    torch.cuda.ipc_collect()            # the ranks' handles are gone
    torch.cuda.empty_cache()
    cases, per_case = {}, []
    for arch, case in TPMB_CASES.items():
        cfg, mesh, ctx, n_micro, batches = _tpmb_setup(arch, case)
        got = [r["cases"][arch] for r in results]
        tp = mesh.shape["model"]
        rows = batches[0]["tokens"].shape[0] // mesh.shape["data"]
        mb = (rows // n_micro, PP_SEQ, cfg.d_model)
        want, want_bwd, want_shapes = tp_mamba_rank_launches(
            cfg, tp, n_micro, TPMB_STEPS, mb)
        for rank, r in enumerate(got):
            assert r["coords"] == mesh.coords(rank), (arch, rank, r)
            assert r["launches_fwd"] == want, (arch, rank, r["launches_fwd"])
            assert r["launches_bwd"] == want_bwd, (arch, rank,
                                                   r["launches_bwd"])
            for name, by in want_shapes.items():
                assert r["shapes"][name] == by, (arch, rank, name,
                                                 r["shapes"][name])
        losses = got[0]["losses"]
        assert all(r["losses"] == losses for r in got), \
            [r["losses"] for r in got]
        diffs = [abs(a - b) for a, b in zip(losses, ref_losses[arch])]
        assert all(np.isfinite(losses)) and max(diffs) <= TP_LOSS_TOL, \
            (arch, losses, ref_losses[arch])
        step_s = [max(r["step_s"][i] for r in got)
                  for i in range(TPMB_STEPS)]
        cases[arch] = {
            "layers": f"{case['layers']} of {configs.get(arch).n_layers}",
            "family": cfg.family, "dtype": cfg.dtype, "remat": cfg.remat,
            "mesh": dict(mesh.shape), "ranks": mesh.ranks.tolist(),
            "fsdp": case["fsdp"], "n_micro": n_micro,
            "microbatch": list(mb[:2]),
            **({"conf": dict(zip(("pp", "tp", "dp", "bs_micro",
                                  "bs_global"), case["conf"]))}
               if "conf" in case else {}),
            "split": _tpmb_split(cfg, tp),
            "losses": losses, "one_process_losses": ref_losses[arch],
            "loss_abs_diff": diffs,
            "params": _compare_params([r["sums"] for r in got], cfg, ctx,
                                      (TPMB_UPDATE_TOL, TPMB_MOMENT_TOL)),
            "step_s": step_s, "warm_step_s": max(step_s[1:]),
            "peak_memory_bytes_max": max(r["peak_memory_bytes"]
                                         for r in got),
            "staged_bytes_per_step_max": {
                k: max(r["staged_bytes_per_step"][k] for r in got)
                for k in got[0]["staged_bytes_per_step"]},
            "launches_per_rank": {"fwd": want, "bwd": want_bwd},
            "ranks_detail": [{"rank": i, **{k: r[k] for k in (
                "coords", "step_s", "peak_memory_bytes", "init_s",
                "groups_s", "compare_s")}} for i, r in enumerate(got)]}
        per_case += got
    launches = {k: sum(r["launches_fwd"][k] for r in per_case)
                for k in WRAPPERS}
    bwd = {k: sum(r["launches_bwd"][k] for r in per_case)
           for k in BWD_KERNELS}
    hybrid = next(_tpmb_setup(a, c) for a, c in TPMB_CASES.items()
                  if configs.get(a).family == "hybrid")
    norm = gated_norm_split_vs_kernel(device, hybrid[0],
                                      hybrid[1].shape["model"])
    seconds = time.perf_counter() - t_phase
    assert seconds <= TPMB_PHASE_S, ("tp_train_mamba_on_card over its "
                                     "budget", seconds)
    return {"phase": "tp_train_mamba_on_card", "cases": cases,
            "gated_norm_split_vs_kernel": norm,
            "tol": {"loss": TP_LOSS_TOL, "update_rel": TPMB_UPDATE_TOL,
                    "moment_rel": TPMB_MOMENT_TOL},
            "processes": len(results), "backend": "gloo (host-staged)",
            "seq_len": PP_SEQ, "steps": TPMB_STEPS, "lr": TRAIN_LR,
            "launches_fwd": launches, "launches_bwd": bwd,
            "rank_setup_s": [r["setup_s"] for r in results],
            "one_process_seconds": one_s, "spawn_seconds": spawn_s,
            "seconds": seconds}, _sum_shapes(per_case)


#: ``tp_generate_on_card``: prefill and greedy decode under
#: ``ShardCtx(mesh, dp=("data",), tp="model")`` (no FSDP: serving, as the
#: reference's ``launch/dryrun.py``) in four processes on the card, one
#: spawn, each model at full width and cut in depth, batch
#: ``TPG_BATCH``, prompt ``TPG_PROMPT``, ``TPG_TOKENS`` greedy tokens:
#: qwen2-7b on (data 2, model 2) (heads and KV heads cut), gpt-3.1b on
#: (data 1, model 4) (22 heads: the sequence-sharded prefill, replicated
#: heads in decode, the cache's sequence cut over (model, data)),
#: falcon-mamba-7b on (data 2, model 2) and zamba2-7b on (data 1, model
#: 4).  The ranks' prefill cache is gathered over its specs, grown by
#: ``TPG_TOKENS`` positions and cut again (phase glue: the reference's
#: ``generate.py`` has no context).  The ranks decode teacher-forced on
#: the one process's greedy tokens, so that every step's logits are held
#: to the one process's on the same inputs: within the slice checks'
#: ``SLICE_TOL_MAX`` / ``SLICE_TOL_MEAN`` (both sides bfloat16 on the same
#: kernels, after sums in another order), and each rank's greedy token
#: equal to the one process's, or within a margin of its largest logit
#: (a bfloat16 near-tie; :func:`tpg_tolerance`).
TPG_CASES = {
    "qwen2-7b": {"layers": 4, "ranks": [[2, 0], [3, 1]]},
    "gpt-3.1b": {"layers": 4, "ranks": [[1, 3, 0, 2]]},
    "falcon-mamba-7b": {"layers": 4, "ranks": [[3, 1], [0, 2]]},
    "zamba2-7b": {"layers": 6, "ranks": [[0, 2, 1, 3]]},
}
TPG_BATCH, TPG_PROMPT, TPG_TOKENS = 4, 512, 16
TPG_SPAWN_S, TPG_PHASE_S = 300.0, 60.0
#: The Mamba families' logit tolerance (largest, mean absolute) against
#: one process, in place of the slice checks': a Mamba layer's ``dt``,
#: ``B`` and ``C`` feed exponentials over the whole prompt, so one
#: bfloat16 rounding of a row-parallel sum in another place moves its
#: logits further than an attention layer's.  One process whose
#: row-parallel products are summed from ``tp`` bfloat16 blocks, as the
#: ranks sum them, reads falcon-mamba-7b's logits exactly as its ranks
#: do, 0.57 / 0.025 from the plain one, and zamba2-7b's 0.53 / 0.024
#: (``tools/tp_noise_floor.py``) where its ranks read 0.63 / 0.024; the
#: faults ``x_proj_unsummed``, ``gated_norm_unsummed`` and
#: ``conv_tail_miscut`` read 5.5 / 0.48 and more (``tools/tp_faults.py``).
#: Set between them.  The third number is the near-tie margin: the
#: largest by which the one process's logit of a token that the ranks
#: chose in its place may lie below its largest.  Sound ranks read at
#: most 0.094, the noise floor's one process 0.19, the faults up to 3.4
#: and more: set at 0.5 from the sound readings.  Attention models keep
#: the slice checks' tolerances, their near-tie margin ``SLICE_TOL_MAX``.
TPG_MAMBA_TOL = (2.0, 0.1, 0.5)


def tpg_tolerance(cfg) -> tuple:
    """``(largest, mean, near-tie margin)``: the absolute logit tolerances
    of a ``tp_generate_on_card`` model against one process, and the
    margin of a greedy token that differs."""
    if cfg.family in ATTENTION_FAMILIES:
        return SLICE_TOL_MAX, SLICE_TOL_MEAN, SLICE_TOL_MAX
    return TPG_MAMBA_TOL


def _tpg_setup(arch: str, case: dict) -> tuple:
    """``(cfg, mesh, ctx, prompt)`` of a ``tp_generate_on_card`` case."""
    from repro_torch.launch.mesh import Mesh
    cfg = configs.get(arch).replace(n_layers=case["layers"])
    mesh = Mesh(np.asarray(case["ranks"]), ("data", "model"))
    ctx = ShardCtx(mesh=mesh, dp=("data",), tp="model")
    rng = np.random.default_rng(len(arch) + 1)
    prompt = rng.integers(0, cfg.vocab_size, (TPG_BATCH, TPG_PROMPT),
                          dtype=np.int64)
    return cfg, mesh, ctx, prompt


def _one_process_generate(cfg, prompt, device) -> dict:
    """One process's prefill of ``prompt`` and greedy decode of
    ``TPG_TOKENS`` tokens (the first from the prefill) on the weights
    drawn whole from seed 0: its prefill logits, each step's logits and
    the tokens ``(b, TPG_TOKENS)``, on the card."""
    params = init_params(cfg, seed=0, device=device)
    ctx = ShardCtx()
    with torch.no_grad():
        logits, cache = M.prefill(params, cfg, ctx,
                                  torch.as_tensor(prompt, device=device))
        cache = gen_cli.grow_cache(cache, TPG_TOKENS)
        toks, steps = [torch.argmax(logits, -1)], []
        for j in range(TPG_TOKENS - 1):
            lg, cache = M.decode_step(params, cfg, ctx, toks[-1][:, None],
                                      cache, TPG_PROMPT + j)
            steps.append(lg)
            toks.append(torch.argmax(lg, -1))
    torch.cuda.synchronize()
    return {"prefill": logits, "steps": torch.stack(steps),
            "tokens": torch.stack(toks, 1)}


def tp_generate_launches(cfg, tp: int, rows: int, m: int) -> tuple:
    """``(launches, shape keys)`` of the rank at model coordinate ``m`` of
    a ``tp_generate_on_card`` case, computing ``rows`` rows: per prefill one plain norm over the
    sequence, ``n - 1`` residual ones and one plain norm of the last row;
    per step one plain and ``n`` residual norms (``n`` the norms a layer
    stack runs: 2 an attention layer, 1 a Mamba layer, 2 a shared-block
    application; the gated norm's statistic is plain torch under a
    context); the attention once a layer (an application) per prefill, on
    the rank's heads or its share of the rows (the kernel's ``q_offset``
    past the first share); the fused scan once a layer per prefill and
    per step on the rank's channels."""
    L, steps, bf = cfg.n_layers, TPG_TOKENS - 1, torch.bfloat16
    apps = len(layer_plan(cfg)[1]["shared_at"])
    attn = cfg.family in ATTENTION_FAMILIES
    n = 2 * L if attn else L + 2 * apps
    seq, last = (rows, TPG_PROMPT, cfg.d_model), (rows, 1, cfg.d_model)
    want = {k: 0 for k in WRAPPERS}
    shapes = {k: {} for k in WRAPPERS}
    want["rmsnorm"] = (n + 1) * (1 + steps)
    shapes["rmsnorm"] = {(seq, bf, bf): 1, ("add", seq, bf, bf): n - 1,
                         (last, bf, bf): 1 + steps,
                         ("add", last, bf, bf): n * steps}
    n_attn = L if attn else apps
    if n_attn:
        want["flash_attention"] = n_attn
        if cfg.n_heads % tp == 0:
            key = ((rows, cfg.n_heads // tp, TPG_PROMPT, cfg.hd),
                   (rows, cfg.n_kv_heads // tp, TPG_PROMPT, cfg.hd), True,
                   0, str(bf))
        else:                           # this rank's share of the rows
            share = TPG_PROMPT // tp
            key = ((rows, cfg.n_heads, share, cfg.hd),
                   (rows, cfg.n_kv_heads, (m + 1) * share, cfg.hd), True,
                   0, str(bf)) + ((m * share,) if m else ())
        shapes["flash_attention"] = {key: n_attn}
    if cfg.family == "ssm":
        x = cfg.d_inner // tp
        want["selective_scan"] = L * (1 + steps)
        shapes["selective_scan"] = {
            ("fused", (rows, TPG_PROMPT, x), cfg.ssm_state, bf, False): L,
            ("fused", (rows, 1, x), cfg.ssm_state, bf, True): L * steps}
    return want, shapes


def _regrow(cache: dict, cfg, ctx, batch: int, s_old: int,
            s_new: int) -> dict:
    """A rank's cache blocks for ``s_old`` positions (its prefill's) as
    blocks for ``s_new``: the full KV rows gathered over the axes of
    their sequence's spec (the minor axis first), grown, cut again."""
    import torch.distributed as dist
    from repro_torch.models import sharding as sh
    old = M.cache_specs(cfg, ctx, batch, s_old)
    new = M.cache_specs(cfg, ctx, batch, s_new)
    out = dict(cache)
    for key in ("k", "v"):
        if key in cache:
            t = cache[key]
            for a in reversed(sh.spec_axes(old[key][2])):
                t = collectives.all_gather(t, ctx.mesh, a, 2)
            t = gen_cli.grow_cache({key: t}, s_new - s_old)[key]
            out[key] = sh.shard_leaf(t, sh.P(None, None, new[key][2]),
                                     ctx.mesh, dist.get_rank()).contiguous()
            del t
    return out


def _logit_reading(got, want) -> dict:
    """A rank's logits block against the same block of the one
    process's: the largest and the summed absolute differences and
    their count."""
    d = (got.float() - want.float()).abs()
    return {"max_abs": float(d.max()),
            "sum_abs": float(d.sum(dtype=torch.float64)), "n": d.numel()}


#: The combined decode attention (``attention.py::combine_partials`` over
#: the sequence's blocks) against ``decode_attention`` over the cache
#: gathered whole, in bfloat16 steps at the largest value of each head's
#: output row (2^-7 of its binade): the two round float32 results that
#: differ only by sums in another order, so they lie at most one step of
#: the row apart.  (At each element's own value a near-zero element, a
#: sum of values that cancel, reads up to 22 steps on sound ranks.)
COMBINE_TOL_STEPS = 1.0


def bf16_steps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ``|got - want|`` in bfloat16 steps at the largest
    ``|want|`` of its row (the last dim)."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(w.abs().amax(-1, keepdim=True))
    step = torch.ldexp(torch.ones_like(e, dtype=w.dtype), e - 8)
    return float(((g - w).abs() / step).max())


class CombineWatch:
    """While active (a ``with`` block), every ``combine_partials`` of a
    decode step under a context is kept with the query, the cache blocks
    and the position it combined over.  :meth:`check`, after the step
    and outside its timing, gathers each block whole over the sequence's
    mesh axes (the minor first, as :func:`_regrow`) and reads the
    combined output against ``decode_attention`` over it
    (:func:`bf16_steps`); the gathers' bytes are kept out of
    ``collectives.STATS``.  A fault planted in ``M.combine_partials``
    before the block is what the watch calls and reads."""

    def __init__(self, cfg, ctx, batch: int, seq_len: int):
        specs = M.cache_specs(cfg, ctx, batch, seq_len)
        from repro_torch.models import sharding as sh
        self.axes = sh.spec_axes(specs["k"][2]) if "k" in specs else ()
        self.mesh = ctx.mesh
        self.calls, self.steps = [], []

    def __enter__(self):
        self._partial, self._combine = (M.decode_attention_partial,
                                        M.combine_partials)
        args = []

        def partial(q, k_block, v_block, pos, offset=0):
            args[:] = [q, k_block, v_block, pos]
            return self._partial(q, k_block, v_block, pos, offset)

        def combine(m, l, o, max_fn, sum_fn, dtype):
            out = self._combine(m, l, o, max_fn, sum_fn, dtype)
            self.calls.append((*args, out))
            return out
        M.decode_attention_partial, M.combine_partials = partial, combine
        return self

    def __exit__(self, *exc):
        M.decode_attention_partial, M.combine_partials = (self._partial,
                                                          self._combine)

    def check(self) -> None:
        """Read this step's combines (their largest distance joins
        ``steps``; none where the step combined nothing)."""
        from repro_torch.models.attention import decode_attention
        stats = dict(collectives.STATS)
        worst = []
        for q, k, v, pos, out in self.calls:
            for a in reversed(self.axes):
                k = collectives.all_gather(k, self.mesh, a, 1)
                v = collectives.all_gather(v, self.mesh, a, 1)
            worst.append(bf16_steps(out, decode_attention(q, k, v, pos)))
        collectives.STATS.update(stats)
        if worst:
            self.steps.append(max(worst))
        self.calls.clear()


def tp_generate_rank(rank: int, world: int, refs: dict) -> dict:
    """One rank of ``tp_generate_on_card``: each case of ``TPG_CASES`` in
    turn on its mesh (the weights drawn whole from seed 0 and cut, the
    prompt's rows it computes), ``make_prefill_step`` under the context
    (timed), the cache regrown, then ``TPG_TOKENS - 1`` teacher-forced steps of
    ``make_decode_step`` on the one process's tokens (each timed), every
    logits block and greedy token against the one process's ``refs[arch]``
    (CUDA tensors the parent shares; popped), its launches, shapes,
    bytes by kind and peak memory."""
    import torch.distributed as dist
    from repro_torch.models import sharding as sh
    t_start = time.perf_counter()
    device = _rank_setup()
    out = {"rank": rank, "cases": {},
           "setup_s": time.perf_counter() - t_start}
    for arch, case in TPG_CASES.items():
        t0 = time.perf_counter()
        cfg, mesh, ctx, prompt = _tpg_setup(arch, case)
        full = init_params(cfg, seed=0, device=device)
        torch.cuda.synchronize()
        t_draw = time.perf_counter()
        params = sh.shard_params(full, cfg, ctx, rank)
        del full
        torch.cuda.empty_cache()
        c = mesh.coords(rank)
        nd = mesh.shape["data"]
        per = TPG_BATCH // nd if TPG_BATCH % nd == 0 else TPG_BATCH
        rows = slice(c["data"] * per, (c["data"] + 1) * per) \
            if per != TPG_BATCH else slice(None)
        cut = M._vocab_cut(cfg, ctx)
        v0, nv = cut if cut is not None else (0, cfg.padded_vocab)
        ref = refs.pop(arch)
        res = {"coords": c, "rows": per}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for a in mesh.axis_names:       # the groups, made collectively
            mesh.group(a)
        dist.barrier()
        res.update(init_s=t1 - t0, draw_s=t_draw - t0,
                   groups_s=time.perf_counter() - t1)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        collectives.reset_stats()
        toks = torch.as_tensor(prompt[rows], device=device)
        ref_toks = ref["tokens"][rows]
        with torch.no_grad():
            t0 = time.perf_counter()
            logits, cache = make_prefill_step(cfg, ctx)(
                params, {"tokens": toks}, batch=TPG_BATCH)
            first = train_steps.greedy_token(logits, cfg, ctx)
            torch.cuda.synchronize()
            res["prefill_s"] = time.perf_counter() - t0
            res["prefill_bytes"] = dict(collectives.STATS)
            readings = [_logit_reading(logits, ref["prefill"][rows,
                                                              v0:v0 + nv])]
            greedy = [first[:, 0]]
            cache = _regrow(cache, cfg, ctx, TPG_BATCH, TPG_PROMPT,
                            TPG_PROMPT + TPG_TOKENS)
            collectives.reset_stats()
            step = make_decode_step(cfg, ctx)
            step_s = []
            watch = CombineWatch(cfg, ctx, TPG_BATCH,
                                 TPG_PROMPT + TPG_TOKENS)
            with watch:
                for j in range(TPG_TOKENS - 1):
                    t0 = time.perf_counter()
                    nxt, lg, cache = step(params, cache,
                                          ref_toks[:, j:j + 1],
                                          TPG_PROMPT + j, batch=TPG_BATCH,
                                          seq_len=TPG_PROMPT + TPG_TOKENS)
                    torch.cuda.synchronize()
                    step_s.append(time.perf_counter() - t0)
                    watch.check()
                    readings.append(_logit_reading(
                        lg, ref["steps"][j][rows, v0:v0 + nv]))
                    greedy.append(nxt[:, 0])
            res["decode_bytes_per_token"] = {
                k: v / (TPG_TOKENS - 1) for k, v in collectives.STATS.items()}
            greedy = torch.stack(greedy, 1)
            # where a token differs, how far the one process's logit of it
            # lies below its largest (a near-tie when within the tolerance)
            all_logits = torch.cat([ref["prefill"][None], ref["steps"]])
            margins = []
            for i, j in torch.nonzero(greedy != ref_toks).tolist():
                row = all_logits[j, rows][i].float()
                margins.append(float(row.max() - row[greedy[i, j]]))
        res.update(step_s=step_s, readings=readings,
                   combine_steps=watch.steps,
                   tokens_equal=int((greedy == ref_toks).sum()),
                   tokens=int(greedy.numel()), token_margins=margins,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   launches=read_launches(), shapes=read_shapes())
        del params, cache, ref, ref_toks, all_logits, logits
        torch.cuda.empty_cache()
        out["cases"][arch] = res
    assert _build.last_build_seconds is None, "a rank ran nvcc"
    return out


def tp_generate(device) -> tuple:
    """``tp_generate_on_card``: each case's one-process generate, then
    :func:`tp_generate_rank` in four spawned processes, held to it;
    returns ``(line, launches, shapes)`` with the ranks' summed launches
    and shape counts."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    refs = {}
    t0 = time.perf_counter()
    for arch, case in TPG_CASES.items():
        cfg, _, _, prompt = _tpg_setup(arch, case)
        refs[arch] = _one_process_generate(cfg, prompt, device)
        torch.cuda.empty_cache()
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = collectives.spawn(tp_generate_rank, 4, (refs,),
                                timeout=TPG_SPAWN_S)
    spawn_s = time.perf_counter() - t0
    del refs
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    cases, per_case, flash_keys = {}, [], {}
    for arch, case in TPG_CASES.items():
        cfg, mesh, ctx, _ = _tpg_setup(arch, case)
        got = [r["cases"][arch] for r in results]
        tp = mesh.shape["model"]
        keys = set()
        for rank, r in enumerate(got):
            assert r["coords"] == mesh.coords(rank), (arch, rank, r)
            want, want_shapes = tp_generate_launches(
                cfg, tp, r["rows"], r["coords"]["model"])
            assert r["launches"] == want, (arch, rank, r["launches"], want)
            for name, by in want_shapes.items():
                assert r["shapes"][name] == by, (arch, rank, name,
                                                 r["shapes"][name])
            keys |= set(r["shapes"]["flash_attention"])
            for m in r["token_margins"]:
                assert m <= tpg_tolerance(cfg)[2], (arch, rank,
                                                    r["token_margins"])
        if keys:
            flash_keys[arch] = sorted(keys, key=repr)
        reads = [x for r in got for x in r["readings"]]
        max_abs = max(x["max_abs"] for x in reads)
        mean_abs = sum(x["sum_abs"] for x in reads) / sum(x["n"]
                                                          for x in reads)
        slow = [max(r["step_s"][j] for r in got)
                for j in range(TPG_TOKENS - 1)]
        cases[arch] = {
            "layers": f"{case['layers']} of {configs.get(arch).n_layers}",
            "family": cfg.family, "mesh": dict(mesh.shape),
            "ranks": case["ranks"],
            "cache": {k: repr(v) for k, v in M.cache_specs(
                cfg, ctx, TPG_BATCH, TPG_PROMPT + TPG_TOKENS).items()},
            "prefill_s": max(r["prefill_s"] for r in got),
            "decode_ms_per_token": sum(slow) / len(slow) * 1e3,
            "decode_ms_per_token_warm": sum(slow[1:]) / len(slow[1:]) * 1e3,
            "peak_memory_bytes_max": max(r["peak_memory_bytes"]
                                         for r in got),
            "prefill_bytes_max": {k: max(r["prefill_bytes"][k] for r in got)
                                  for k in got[0]["prefill_bytes"]},
            "decode_bytes_per_token_max": {
                k: max(r["decode_bytes_per_token"][k] for r in got)
                for k in got[0]["decode_bytes_per_token"]},
            "logits_vs_one_process": {
                "max_abs": max_abs, "mean_abs": mean_abs,
                "max_abs_by_step": [max(r["readings"][j]["max_abs"]
                                        for r in got)
                                    for j in range(TPG_TOKENS)]},
            "tokens_equal": sum(r["tokens_equal"] for r in got),
            "tokens": sum(r["tokens"] for r in got),
            "token_margins": [m for r in got for m in r["token_margins"]],
            "ranks_detail": [{"rank": i, **{k: r[k] for k in (
                "coords", "rows", "prefill_s", "peak_memory_bytes",
                "init_s", "draw_s", "groups_s")}}
                for i, r in enumerate(got)]}
        tol_max, tol_mean, margin = tpg_tolerance(cfg)
        cases[arch]["tol"] = {"max_abs": tol_max, "mean_abs": tol_mean,
                              "tie_margin": margin}
        # every step of an attention model combines over the sequence's
        # blocks on every rank; a Mamba1 model combines nothing
        combined = [x for r in got for x in r["combine_steps"]]
        cases[arch]["combine_vs_gathered_cache"] = {
            "max_bf16_steps": max(combined, default=None),
            "steps_checked": len(combined), "tol_bf16_steps":
            COMBINE_TOL_STEPS}
        if cfg.family in ATTENTION_FAMILIES or cfg.hybrid_attn_period:
            assert len(combined) == len(got) * (TPG_TOKENS - 1), \
                (arch, len(combined))
            assert max(combined) <= COMBINE_TOL_STEPS, \
                (arch, "combine_partials against decode_attention over the "
                 "gathered cache", [r["combine_steps"] for r in got])
        else:
            assert not combined, (arch, combined)
        assert max_abs <= tol_max and mean_abs <= tol_mean, \
            (arch, cases[arch]["logits_vs_one_process"])
        per_case += got
    launches = {k: sum(r["launches"][k] for r in per_case) for k in WRAPPERS}
    seconds = time.perf_counter() - t_phase
    assert seconds <= TPG_PHASE_S, ("tp_generate_on_card over its budget",
                                    seconds)
    return {"phase": "tp_generate_on_card", "cases": cases,
            "batch": TPG_BATCH, "prompt_len": TPG_PROMPT,
            "tokens": TPG_TOKENS, "teacher_forced": True,
            "attention_keys": {a: [repr(k) for k in ks]
                               for a, ks in flash_keys.items()},
            "launches": launches,
            "rank_setup_s": [r["setup_s"] for r in results],
            "one_process_seconds": one_s, "spawn_seconds": spawn_s,
            "seconds": seconds}, launches, _sum_shapes(per_case)


def leaf_names(tree, prefix: str = "") -> list:
    """Dotted key paths of ``tree``'s leaves in ``_tree.leaves`` order
    (keys sorted, recursively: a hybrid's ``shared.wq``)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


# ---------------------------------------------------------------------------
# the build: ptxas report, and the launch path's stream read
# ---------------------------------------------------------------------------

def ptxas_spills(log: str) -> dict:
    """{kernel (mangled name): (spill store bytes, spill load bytes)} from
    a ``ptxas -v`` log."""
    spills, current = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and current is not None:
            spills[current] = (int(m.group(1)), int(m.group(2)))
            current = None
    return spills


def ptxas_table(log: str, label) -> dict:
    """{label(name): {"registers": r, "smem": bytes, "spill_bytes": [stores,
    loads]}} of every kernel in a ``ptxas -v`` log whose mangled name
    ``label`` maps to a string (to None: left out)."""
    out, current = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            current = label(m.group(1))
            if current is not None:
                out[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[current]["spill_bytes"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", ln)
        if m:                          # static shared memory, if any
            smem = re.search(r"(\d+) bytes smem", ln)
            out[current]["registers"] = int(m.group(1))
            out[current]["smem"] = int(smem.group(1)) if smem else 0
            current = None
    return out


def scan_ptxas(log: str) -> dict:
    """``ptxas_table`` of every instance of the scan kernel, keyed
    "<type> <form>": plain, fused, and fused_bound (the fused form's
    instance that keeps the chunk boundaries)."""
    forms = {"Lb0ELb0E": "plain", "Lb1ELb0E": "fused",
             "Lb1ELb1E": "fused_bound"}
    return ptxas_table(log, lambda name: (
        f"{'bf16' if 'bfloat16' in name else 'f32'} "
        f"{next(f for k, f in forms.items() if k in name)}")
        if "scan_kernel" in name else None)


def scan_bwd_ptxas(log: str) -> dict:
    """``ptxas_table`` of the scan backward's two kernels in both types,
    keyed "<type> <main|fold>"."""
    return ptxas_table(log, lambda name: (
        f"{'bf16' if 'bfloat16' in name else 'f32'} "
        f"{'main' if 'scan_bwd_kernel' in name else 'fold'}")
        if "scan_bwd_" in name else None)


def scan_bf16_ptxas(log: str) -> dict:
    """``ptxas_table`` of the bfloat16 working type's scan kernels in both
    input types, keyed "<type> <fwd|fwd_bound|bwd> <q128|q>": each in its
    compile-time instance for q = 128 and its instance for any q."""
    def label(name):
        if "scan_bf16_bwd_kernel" in name:
            form = "bwd"
        elif "scan_bf16_kernel" in name:
            form = "fwd_bound" if "Lb1E" in name else "fwd"
        else:
            return None
        q = "q128" if "Li128E" in name else "q"
        return f"{'bf16' if 'bfloat16' in name else 'f32'} {form} {q}"
    return ptxas_table(log, label)


#: The norm backward's type pairs, as its instances' mangled names begin.
RMS_BWD_TYPES = {"Iff": "f32/f32", "If13__nv_bfloat16": "f32/bf16",
                 "I13__nv_bfloat16f": "bf16/f32",
                 "I13__nv_bfloat16S1_": "bf16/bf16"}


def rmsnorm_bwd_ptxas(log: str) -> dict:
    """``ptxas_table`` of every instance of the norm backward, keyed "<x>/<w>
    vec <pack> groups <1|4> <ring|direct>"."""
    def label(name):
        m = re.search(r"norm_bwd(I\w*?)Li(\d+)ELi(\d+)ELb([01])E", name)
        if not m:
            return None
        return (f"{RMS_BWD_TYPES[m.group(1)]} vec {m.group(2)} groups "
                f"{m.group(3)} {'ring' if m.group(4) == '1' else 'direct'}")
    return ptxas_table(log, label)


def attention_fwd_ptxas(log: str) -> dict:
    """``ptxas_table`` of every instance of the bfloat16 tensor-core
    attention forward, keyed "D=<d>" (without the lse store) and "D=<d>
    lse"."""
    def label(name):
        m = re.search(r"flash_fwd_bf16_mmaILi(\d+)ELb([01])E", name)
        return None if m is None else \
            f"D={m.group(1)}{' lse' if m.group(2) == '1' else ''}"
    return ptxas_table(log, label)


def attention_f32_ptxas(log: str) -> dict:
    """``ptxas_table`` of every instance of the float32 attention kernels
    (CUDA cores), keyed "<pass> D=<d>": fwd and fwd_lse
    (``flash_fwd_f32_tiled``), delta, bwd (``bwd_dkv_dq_f32``, the dK/dV
    and dQ items in one kernel) and the fold's float32 instance."""
    def label(name):
        m = re.search(r"flash_fwd_f32_tiledILi(\d+)ELb([01])E", name)
        if m:
            return f"fwd{'_lse' if m.group(2) == '1' else ''} D={m.group(1)}"
        m = re.search(r"bwd_(delta)_f32ILi(\d+)E", name) or \
            re.search(r"(bwd)_dkv_dq_f32ILi(\d+)E", name) or \
            re.search(r"bwd_(fold)ILi(\d+)EfE", name)
        return None if m is None else f"{m.group(1)} D={m.group(2)}"
    return ptxas_table(log, label)


def attention_f32_instances(log: str) -> dict:
    """For every head dim of ``fa.HEAD_DIMS``: the float32 kernels'
    registers and spills, and for the forward (without its lse store) and
    the backward's dK/dV and dQ kernel their dynamic shared memory and
    blocks an SM (the CUDA runtime's occupancy calculator)."""
    f32 = attention_f32_ptxas(log)
    out = {}
    for d in fa.HEAD_DIMS:
        occ = fa.occupancy(d)
        out[f"D={d}"] = {
            p: {**f32[f"{p} D={d}"],
                **({"dynamic_smem": occ[f"{p}_f32"][0],
                    "blocks_per_sm": occ[f"{p}_f32"][1]}
                   if f"{p}_f32" in occ else {})}
            for p in ("fwd", "fwd_lse", "delta", "bwd", "fold")}
    return out


def attention_instances(log: str) -> dict:
    """For every head dim of ``fa.HEAD_DIMS``: the bfloat16 forward's and
    the backward's two tensor-core passes' registers, spills, dynamic
    shared memory and blocks an SM (the CUDA runtime's occupancy
    calculator)."""
    fwd, bwd = attention_fwd_ptxas(log), attention_bwd_ptxas(log)
    out = {}
    for d in fa.HEAD_DIMS:
        occ = fa.occupancy(d)
        out[f"D={d}"] = {
            "fwd": {**fwd[f"D={d}"], "dynamic_smem": occ["fwd"][0],
                    "blocks_per_sm": occ["fwd"][1]},
            "fwd_lse": fwd[f"D={d} lse"],
            "dkv": {**bwd[f"dkv D={d}"], "dynamic_smem": occ["dkv"][0],
                    "blocks_per_sm": occ["dkv"][1]},
            "dq": {**bwd[f"dq D={d}"], "dynamic_smem": occ["dq"][0],
                   "blocks_per_sm": occ["dq"][1]},
            "fold": bwd[f"fold D={d}"]}
    return out


def attention_bwd_ptxas(log: str) -> dict:
    """``ptxas_table`` of every instance of the bfloat16 tensor-core
    attention backward (``dkv``, ``dq``, ``fold``), keyed "<pass> D=<d>"."""
    def label(name):
        kind = re.search(r"bwd_(dkv_mma|dq_mma|fold)ILi(\d+)E"
                         r"(?!f)", name)
        return None if kind is None else \
            f"{kind.group(1).split('_')[0]} D={kind.group(2)}"
    return ptxas_table(log, label)


def launch_path_reads_us(n: int = 20000) -> dict:
    """Host microseconds of one read of the current stream's handle and of
    the current device's index: the public ``torch.cuda`` calls against
    the raw readers the wrappers' launch path uses."""
    index = torch.cuda.current_device()
    out = {}
    for what, pair in (
            ("stream", (("public", lambda: torch.cuda.current_stream(
                index).cuda_stream),
                        ("raw", lambda: _build.current_raw_stream(index)))),
            ("device", (("public", torch.cuda.current_device),
                        ("raw", _build.current_raw_device)))):
        assert pair[0][1]() == pair[1][1]()
        for name, fn in pair:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            out.setdefault(f"{what}_read_us", {})[f"{name}_us"] = \
                (time.perf_counter() - t0) / n * 1e6
    return out


#: Back-to-back calls of one wrapper (or library call) in each round of
#: ``host_cost``.
HOST_COST_CALLS = 2000


def host_us(fn, n: int = HOST_COST_CALLS) -> float:
    """Host microseconds of one call of ``fn``: ``n`` back-to-back calls
    timed by ``perf_counter``, after a warm-up and a synchronise.  The
    calls enqueue device work shorter than their own host time, so the
    card keeps up and the clock reads the host's share alone."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def host_cost(device, max_key: tuple) -> dict:
    """Host microseconds of one call of each redesigned wrapper and of the
    PyTorch call(s) it is set against: ``group_max`` in both forms at the
    tiered plan's gather key ``max_key`` (against ``amax`` of the gathered
    slowdowns), ``rmsnorm`` in both forms at the falcon-mamba-7b decode
    shape (against ``F.rms_norm``, and ``x + r`` then ``F.rms_norm``), and
    the fused scan at its decode-step shape (against the ATen sequence it
    replaced, its plain version)."""
    _, b, pp, nc, _ = max_key
    slow, perm, cw = max_gather_inputs(max_key, torch.float64, device)
    gathered = slow[perm.view(b, pp, nc)]
    shape, bf = (GEN_BATCH, 1, 4096), torch.bfloat16
    (x, r, w, eps), _ = model_inputs("rmsnorm", ("add", shape, bf, bf),
                                     device)
    d = shape[-1]
    rms_norm = torch.nn.functional.rms_norm
    b_, _, d_, n_ = FALCON_STEP
    scan_args, scan_kw = model_inputs(
        "selective_scan", ("fused", (b_, 1, d_), n_, bf, True), device)
    calls = {
        "group_max": (lambda: gr.group_max(gathered),
                      lambda: torch.amax(gathered, dim=-1)),
        "group_max_gather": (lambda: gr.group_max_gather(slow, perm, cw, nc),
                             lambda: torch.amax(gathered, dim=-1)),
        "rmsnorm": (lambda: rn.rmsnorm(x, w, eps),
                    lambda: rms_norm(x, (d,), w, eps)),
        "add_rmsnorm": (lambda: rn.add_rmsnorm(x, r, w, eps),
                        lambda: rms_norm(x + r, (d,), w, eps)),
        "selective_scan_fused": (
            lambda: ss.selective_scan_fused(*scan_args, **scan_kw),
            lambda: ss.selective_scan_fused_ref(*scan_args, **scan_kw)),
    }
    fns = {}
    for name, (wrapper, library) in calls.items():
        fns[name, "wrapper_us"] = wrapper
        fns[name, "library_us"] = library
    fns["add_rmsnorm", "aten_add_us"] = lambda: x + r
    # where a wrapper call's host time goes: its output allocations, the
    # ctypes call that launches the kernel (arguments prepared), and the
    # rest (checks, counters, the launch path's device and stream reads)
    stream = _build.current_raw_stream(x.get_device())
    s_, y_ = torch.empty_like(x), torch.empty_like(x)
    c_x, c_max = torch.empty_like(cw), cw.new_empty(b)
    scan_out = scan_args[0].new_empty(scan_args[0].shape)
    launches = {
        "rmsnorm": ("rmsnorm_fwd", (x.data_ptr(), w.data_ptr(),
                                    y_.data_ptr(), x.numel() // d, d, eps,
                                    3, stream), 1),
        "add_rmsnorm": ("add_rmsnorm_fwd", (
            x.data_ptr(), r.data_ptr(), w.data_ptr(), s_.data_ptr(),
            y_.data_ptr(), x.numel() // d, d, eps, 3, stream), 2),
        "group_max_gather": ("group_max_gather_f64", (
            slow.data_ptr(), perm.data_ptr(), cw.data_ptr(),
            c_x.data_ptr(), c_max.data_ptr(), b, pp, nc, stream), 2),
        "selective_scan_fused": ("selective_scan_fused_fwd", (
            *(scan_args[i].data_ptr() for i in (0, 1, 3, 4, 7, 5, 2, 6, 8)),
            scan_out.data_ptr(), scan_args[9].data_ptr(), None,
            *(v for t in (scan_args[0], scan_args[1], scan_args[3],
                          scan_args[4], scan_args[7])
              for v in t.stride()[:2]),
            b_, 1, d_, n_, 1, 1, stream), 1),
    }
    fns["empty_like", "us"] = lambda: torch.empty_like(x)
    for name, (fn_name, args, _) in launches.items():
        fn = _build._fns[fn_name]
        assert fn(*args) == 0
        fns[name, "ctypes_launch_us"] = lambda fn=fn, args=args: fn(*args)
    times = interleaved(host_us, fns)
    out = {}
    for (name, what), us in times.items():
        out.setdefault(name, {})[what] = us
    alloc_us = out.pop("empty_like")["us"]
    for name, (_, _, n_out) in launches.items():
        t = out[name]
        t.update(empty_like_us=alloc_us, n_outputs=n_out,
                 rest_us=t["wrapper_us"] - n_out * alloc_us
                 - t["ctypes_launch_us"])
    return {"phase": "host_cost", "calls": HOST_COST_CALLS,
            "group_max_key": list(max_key), "rmsnorm_shape": list(shape),
            "library": {"group_max": "torch.amax(gathered, -1)",
                        "group_max_gather": "torch.amax(gathered, -1)",
                        "rmsnorm": "F.rms_norm",
                        "add_rmsnorm": "x + r, then F.rms_norm",
                        "selective_scan_fused": "the ATen sequence it "
                        "replaced (selective_scan_fused_ref)"},
            "scan_key": ["fused", [b_, 1, d_], n_, "bfloat16", True],
            "host_us": out}


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the SA stage, a prefill and four decode "
                         "steps of each model, and a training step, with "
                         "torch.profiler and print the device's busy and "
                         "idle share and its top kernels")
    args = ap.parse_args()
    t_run = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script only runs on a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    # full float32 in products and convolutions (the defaults leave TF32
    # off for matmul and on for cuDNN convolutions)
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    global EXP_PER_S
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    EXP_PER_S = EXP_PER_SM_CLOCK * sms * clock_mhz * 1e6
    emit({"phase": "env", "device": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "nvidia_smi": smi, "sm_count": sms, "max_sm_clock_mhz": clock_mhz,
          "exp_per_s": EXP_PER_S})

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    # the tensor-core attention at the model's head dim keeps its
    # fragments in registers: no spill, with and without the lse store
    log = _build.build_log()
    spills = ptxas_spills(log)
    d128 = [v for k, v in spills.items()
            if "flash_fwd_bf16_mma" in k and "ILi128E" in k]
    assert d128 == [(0, 0)] * 2, ("bf16 D=128 attention spills", d128)
    scan_regs = scan_ptxas(log)
    assert len(scan_regs) == 2 * 3, scan_regs       # 2 types x 3 forms
    assert all(v["spill_bytes"] == [0, 0] for v in scan_regs.values()), \
        ("a scan instance spills", scan_regs)
    scan_bf16_regs = scan_bf16_ptxas(log)
    assert len(scan_bf16_regs) == 2 * 3 * 2, scan_bf16_regs   # types x 3 x q
    assert all(v["spill_bytes"] == [0, 0] for v in scan_bf16_regs.values()), \
        ("a bfloat16 working-type scan instance spills", scan_bf16_regs)
    # their instances at q = 128: shared memory (dynamic) and blocks an SM
    for t, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for form, key in (("fused_bf16", "fwd"), ("fused_bf16_bound",
                                                  "fwd_bound"),
                          ("fused_bf16_bwd", "bwd")):
            smem, blocks = ss.bwd_occupancy(dt, form)
            inst = scan_bf16_regs[f"{t} {key} q128"]
            inst["dynamic_smem"], inst["blocks_per_sm"] = smem, blocks
            assert blocks >= 1, (t, form, inst)
    scan_bwd_regs = scan_bwd_ptxas(log)
    assert len(scan_bwd_regs) == 2 * 2, scan_bwd_regs   # 2 types x 2 kernels
    assert scan_bwd_regs["bf16 main"]["spill_bytes"] == [0, 0], \
        ("the bf16 scan backward spills", scan_bwd_regs)
    # its main kernel: SCAN_BWD_BLOCKS_PER_SM blocks (16 warps) an SM, so
    # the training shape's 512 blocks run in one wave — by the registers
    # and the (dynamic) shared memory, and by the runtime's calculator
    scan_bwd_resident = {}
    for t, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        smem, blocks = ss.bwd_occupancy(dt)
        main_k = scan_bwd_regs[f"{t} main"]
        main_k["dynamic_smem"] = smem
        scan_bwd_resident[t] = {
            "by_registers_and_smem": resident_blocks(
                main_k["registers"], main_k["smem"] + smem,
                SCAN_BWD_THREADS),
            "cuda_occupancy": blocks}
    assert min(scan_bwd_resident["bf16"].values()) >= \
        SCAN_BWD_BLOCKS_PER_SM, ("the bf16 scan backward holds fewer "
                                 "blocks an SM", scan_bwd_resident,
                                 scan_bwd_regs)
    bwd_regs = attention_bwd_ptxas(log)
    assert len(bwd_regs) == 3 * len(fa.HEAD_DIMS), bwd_regs  # 3 passes a dim
    # and so does its backward at the model's head dim
    assert all(bwd_regs[f"{p} D=128"]["spill_bytes"] == [0, 0]
               for p in ("dkv", "dq", "fold")), ("bf16 D=128 attention "
                                                 "backward spills", bwd_regs)
    # the instances of the shipped head dims 96, 112 and 136 (a 144-wide
    # tile), forward and backward, spill nothing either, and every
    # instance fits at least one block an SM
    attention = attention_instances(log)
    for d in (96, 112, 136):
        for part, v in attention[f"D={d}"].items():
            assert v["spill_bytes"] == [0, 0], (d, part, v)
    assert all(v["blocks_per_sm"] >= 1 for inst in attention.values()
               for v in inst.values() if "blocks_per_sm" in v), attention
    # the float32 kernels (CUDA cores): no spill at the paths' head dim 64,
    # and every pass fits at least one block an SM
    attention_f32 = attention_f32_instances(log)
    assert all(v["spill_bytes"] == [0, 0]
               for v in attention_f32["D=64"].values()), attention_f32
    assert all(v["blocks_per_sm"] >= 1 for inst in attention_f32.values()
               for v in inst.values() if "blocks_per_sm" in v), attention_f32
    # the norm backward: 4 type pairs x (ring of four groups, of one group,
    # packed and element-wise without the ring), none spills
    rms_bwd_regs = rmsnorm_bwd_ptxas(log)
    assert len(rms_bwd_regs) == 4 * 4, rms_bwd_regs
    assert all(v["spill_bytes"] == [0, 0] for v in rms_bwd_regs.values()), \
        ("a norm backward instance spills", rms_bwd_regs)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled_now": _build.last_build_seconds is not None,
          "library": os.path.relpath(str(lib), ROOT),
          "sources": [os.path.relpath(str(s), ROOT)
                      for s in _build.sources()],
          "flags": list(_build.NVCC_FLAGS),
          "attention_bf16_d128_spill_bytes": list(d128[0]),
          "scan_ptxas": scan_regs,
          "scan_bwd_ptxas": scan_bwd_regs,
          "scan_bf16_work_ptxas": scan_bf16_regs,
          "rmsnorm_bwd_ptxas": rms_bwd_regs,
          "scan_bwd_resident_blocks_per_sm": scan_bwd_resident,
          "attention_bwd_bf16_ptxas": bwd_regs,
          "attention_bf16_instances": attention,
          "attention_f32_instances": attention_f32,
          **launch_path_reads_us(),
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if ln.startswith("==") or "Compiling entry" in ln
                    or "Used" in ln or "spill" in ln]})

    ragged = check_ragged(device)
    emit({"phase": "kernels", "kernels": ragged})

    line_u, launches_u, shapes_u, est = plan_uniform(device)
    emit(line_u)
    line_t, launches_t, shapes_t, tiered = plan_tiered(device)
    emit(line_t)

    others = [probe()]
    emit(others[-1])
    line_s, launches_s, shapes_s = serve_plan(est)
    others.append(line_s)
    emit(line_s)
    line_r, launches_r, shapes_r = replan(tiered)
    others.append(line_r)
    emit(line_r)
    line_c, launches_c, shapes_c = churn()
    others.append(line_c)
    emit(line_c)
    others_s = sum(o["seconds"] for o in others)
    assert others_s < OTHER_ENTRY_POINTS_S, others_s
    line_x, launches_x, shapes_x = examples_on_card(device)
    emit(line_x)
    assert line_x["seconds"] <= EXAMPLES_S, ("examples_on_card over its "
                                             "limit", line_x["seconds"])

    rows = check_path_shapes(device, {"plan_uniform": shapes_u,
                                      "plan_tiered": shapes_t,
                                      "serve_plan": shapes_s,
                                      "replan": shapes_r,
                                      "churn": shapes_c,
                                      "examples_on_card": shapes_x})
    emit({"phase": "kernels_at_path_shapes", "kernels": rows})
    if args.profile:
        emit(profile_sa(device))

    model_ragged = check_model_ragged(device)
    emit({"phase": "model_kernels", "kernels": model_ragged})
    bwd_phase = check_bwd_ragged(device)
    emit(bwd_phase)
    new_dims = check_new_head_dims(device)
    emit(new_dims)
    emit(check_flash_against_chunked(device))
    q_offset_phase = check_q_offset(device)
    emit(q_offset_phase)
    scan_rows = check_scan_at_falcon_shapes(device)
    emit({"phase": "scan_at_falcon_shapes", "kernels": scan_rows})
    emit(scan_by_batch(device, scan_regs))
    bf16_phase = scan_bf16_on_card(device)
    emit(bf16_phase)
    gen_launches, gen_shapes, gen_lines = {}, {}, {}
    for arch, name in GEN_ARCHS.items():
        line_g, gen_launches[name], gen_shapes[name] = run_generate(
            name, arch, device)
        gen_lines[name] = line_g
        emit({k: v for k, v in line_g.items() if k != "tokens"})
    # falcon-mamba-7b with the bfloat16 working type, on the same weights
    # and prompts (the same seed), beside the float32 figures
    name = GEN_ARCHS["falcon-mamba-7b"] + "_scan_bf16"
    line_g, gen_launches[name], gen_shapes[name] = run_generate(
        name, "falcon-mamba-7b", device, "bfloat16")
    f32_line = gen_lines[GEN_ARCHS["falcon-mamba-7b"]]
    same = np.asarray(line_g.pop("tokens")) == np.asarray(f32_line["tokens"])
    line_g["greedy_tokens_equal_to_float32"] = float(same.mean())
    line_g["float32_working_type"] = {k: f32_line[k] for k in (
        "prefill_s", "decode_ms_per_token", "peak_memory_bytes",
        "seconds")}
    emit(line_g)
    if args.profile:
        for arch in PROFILE_GEN_ARCHS:
            emit(profile_generate(
                "profile_" + GEN_ARCHS[arch], arch, device))
    for arch, name in SLICE_ARCHS.items():
        emit(slice_check(name, arch, device))
    emit(ssd_at_zamba2_shapes(device))
    train_lines, fwd_tr, bwd_tr = [line_x], {}, {}
    fwd_tr[line_x["phase"]] = {
        name: {k: n for k, n in by.items() if not is_bwd_key(k)}
        for name, by in shapes_x.items()}
    bwd_tr[line_x["phase"]] = {
        name: {k: n for k, n in by.items() if is_bwd_key(k)}
        for name, by in shapes_x.items()}
    for arch in TRAIN_ARCHS:
        line_tr, shapes_tr = run_train(device, arch)
        emit(line_tr)
        if args.profile:
            emit(profile_train(device, arch))
        emit(slice_check_train(device, arch))
        runs = [(line_tr, shapes_tr)]
        if arch == "falcon-mamba-7b":
            # the bfloat16 working type: one uninterrupted run on the same
            # weights and batches, beside the float32 figures
            line_b, shapes_b = run_train(device, arch, "bfloat16",
                                         resume=False)
            line_b["float32_working_type"] = {k: line_tr[k] for k in (
                "warm_step_s", "losses", "step_s", "peak_memory_bytes")}
            emit(line_b)
            emit(slice_check_train(device, arch, "bfloat16"))
            runs.append((line_b, shapes_b))
        for line_run, shapes_run in runs:
            train_lines.append(line_run)
            fwd_tr[line_run["phase"]] = {
                name: {k: n for k, n in by.items() if not is_bwd_key(k)}
                for name, by in shapes_run.items()}
            bwd_tr[line_run["phase"]] = {
                name: {k: n for k, n in by.items() if is_bwd_key(k)}
                for name, by in shapes_run.items()}
    line_pp, shapes_pp = pp_train()
    emit(line_pp)
    train_lines.append(line_pp)
    fwd_tr[line_pp["phase"]] = {
        name: {k: n for k, n in by.items() if not is_bwd_key(k)}
        for name, by in shapes_pp.items()}
    bwd_tr[line_pp["phase"]] = {
        name: {k: n for k, n in by.items() if is_bwd_key(k)}
        for name, by in shapes_pp.items()}
    for run in (lambda: tp_train(device),
                lambda: tp_models(device), lambda: tp_train_mamba(device)):
        line_x, shapes_x = run()
        emit(line_x)
        if line_x["phase"] == "tp_train_gpt_1_1b":
            emit(dryrun_vs_card(line_pp, line_x))
        train_lines.append(line_x)
        fwd_tr[line_x["phase"]] = {
            name: {k: n for k, n in by.items() if not is_bwd_key(k)}
            for name, by in shapes_x.items()}
        bwd_tr[line_x["phase"]] = {
            name: {k: n for k, n in by.items() if is_bwd_key(k)}
            for name, by in shapes_x.items()}
    line_tg, gen_launches["tp_generate_on_card"], \
        gen_shapes["tp_generate_on_card"] = tp_generate(device)
    emit(line_tg)
    model_rows = check_model_path_shapes(device, {**gen_shapes, **fwd_tr})
    emit({"phase": "model_kernels_at_path_shapes", "kernels": model_rows})
    bwd_rows = check_bwd_path_shapes(device, bwd_tr)
    emit({"phase": "bwd_kernels_at_path_shapes", "kernels": bwd_rows})
    emit(check_bwd_full_grid(device))
    emit(host_cost(device, max(shapes_t["group_max"],
                               key=shapes_t["group_max"].get)))

    main_path = {name: launches_u[name] + launches_t[name]
                 + launches_s[name] + launches_r[name] + launches_c[name]
                 + launches_x[name]
                 for name in PLAN_KERNELS}
    main_path.update({name: sum(g[name] for g in gen_launches.values())
                      + sum(t["launches_fwd"][name] for t in train_lines)
                      for name in MODEL_KERNELS})
    main_path.update({name: sum(t["launches_bwd"][name]
                                for t in train_lines)
                      for name in BWD_KERNELS})

    def launched(r):
        return sum(r["launches"].values())

    def summary(name):
        """One line per kernel: its launches on the main paths (the two
        plans, the planner's other entry points and the examples, or the
        generate, training and example phases), and the times at the
        shape the paths
        launched most often; ``forms`` has the same for each form's most
        launched shape, ``per_shape`` every shape, and for the attention
        ``new_head_dims`` its instances at 96, 112 and 136."""
        mine = [r for r in rows + model_rows + scan_rows
                if r["name"] == name]
        assert main_path[name] > 0, f"{name} was never launched"
        assert sum(launched(r) for r in mine) == main_path[name]
        top = max(mine, key=launched)
        forms = {}
        for r in mine:
            form = r.get("form", "plain")
            forms.setdefault(form, []).append(r)
        forms = {form: {"launches": sum(launched(r) for r in rs),
                        **{k: v for k, v in max(rs, key=launched).items()
                           if k in ("shape", "key", "ms", "device_ms",
                                    "plain_ms", "bound_ms", "library_ms",
                                    "unfused_ms")}}
                 for form, rs in forms.items()}
        return {"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": KERNELS[name],
                "shape": top.get("shape", top.get("key")),
                "launches": main_path[name],
                "max_abs_err": max(r["max_abs_err"]
                                   for r in mine + ragged + model_ragged
                                   + new_dims["kernels"]
                                   + q_offset_phase["kernels"]
                                   if r["name"] == name),
                "ms": top["ms"], "device_ms": top["device_ms"],
                "plain_ms": top["plain_ms"],
                "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                "library_ms": top["library_ms"],
                **({"unfused_ms": top["unfused_ms"]}
                   if "unfused_ms" in top else {}),
                "forms": forms, "per_shape": mine,
                **({"new_head_dims": [r for r in new_dims["kernels"]
                                      if r["name"] == name and "ms" in r]}
                   if name == "flash_attention" else {})}

    def summary_bound():
        """The fused scan's training forward in a line of its own: the
        instance that also keeps the chunk boundaries for the backward
        kernel (all of the training phases' forward launches of the
        scan), at its most launched shape, beside the generation
        instance on the same inputs (``without_bounds_*``)."""
        mine = [r for r in model_rows if r["name"] == "selective_scan"
                and r.get("form") == "fused_bound"]
        launches = sum(launched(r) for r in mine)
        assert launches == sum(
            n for by in fwd_tr.values()
            for k, n in by["selective_scan"].items()
            if k[0] == "fused_bound") > 0, "no boundary-keeping forward"
        top = max(mine, key=launched)
        return {"name": "selective_scan_fused_bound", "route": "cuda",
                "source": SOURCES["selective_scan"],
                "replaces": KERNELS["selective_scan"],
                "instance_of": "selective_scan, fused form over a sequence "
                               "(keeps the chunk boundaries that "
                               "selective_scan_fused_bwd reads)",
                "shape": top["key"], "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                **{k: top[k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "without_bounds_ms",
                    "without_bounds_device_ms")},
                "per_shape": mine}

    def summary_bwd(name):
        """One line per backward kernel: its launches in the training and
        example phases and the times at its most launched shape.  It replaces no
        TPU kernel: it is the backward of the kernel at ``replaces``,
        which the JAX package differentiates by autodiff of plain jnp."""
        wrapper = BWD_KERNELS[name]
        mine = [r for r in bwd_rows if r["name"] == name]
        assert main_path[name] > 0, f"{name} was never launched"
        assert sum(launched(r) for r in mine) == main_path[name]
        top = max(mine, key=launched)
        return {"name": name, "route": "cuda", "source": SOURCES[wrapper],
                "replaces": KERNELS[wrapper],
                "differentiates": f"{wrapper} (no TPU backward kernel)",
                "shape": top["key"], "launches": main_path[name],
                "max_abs_err": max(r["max_abs_err"] for r in
                                   mine + bwd_phase["kernels"]
                                   + new_dims["kernels"]
                                   + q_offset_phase["kernels"]
                                   if r["name"] == name),
                "ms": top["ms"], "device_ms": top["device_ms"],
                "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
                "bound_by": top["bound_by"],
                "library_ms": top["library_ms"], "per_shape": mine,
                **({"new_head_dims": [r for r in new_dims["kernels"]
                                      if r["name"] == name and "ms" in r]}
                   if name == "flash_attention_bwd" else {})}

    def summary_bf16(backward: bool):
        """The bfloat16 working type's forward (its generation and
        training instances) or backward in a line of its own: launches on
        the generation and training phases, the times at its most
        launched shape, and ``max_abs_err`` over those shapes and
        ``scan_bf16_on_card``'s."""
        forms = ("fused_bf16_bwd",) if backward else ("fused_bf16",
                                                      "fused_bf16_bound")
        pool = bwd_rows if backward else model_rows
        mine = [r for r in pool if r["key"][0] in forms]
        by_phase = bwd_tr if backward else {**gen_shapes, **fwd_tr}
        launches = sum(n for by in by_phase.values()
                       for k, n in by["selective_scan"].items()
                       if k[0] in forms)
        assert launches == sum(launched(r) for r in mine) > 0, \
            ("the bfloat16 working type's kernel was never launched", forms)
        top = max(mine, key=launched)
        checked = mine + [r for r in bf16_phase["kernels"]
                          if r["key"][0] in forms]
        return {"name": "selective_scan_fused_bf16"
                + ("_bwd" if backward else ""), "route": "cuda",
                "source": SOURCES["selective_scan"],
                "replaces": KERNELS["selective_scan"],
                "instance_of": ("the backward of " if backward else "")
                + "selective_scan, fused form over a sequence with the "
                  "bfloat16 working type (the reference computes it in "
                  "plain jnp: src/repro/models/mamba.py:59)",
                "shape": top["key"], "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in checked),
                **{k: top[k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")},
                "per_shape": mine}

    emit({"phase": "run", "seconds": time.perf_counter() - t_run})
    emit({"kernels": [summary(name) for name in KERNELS] + [summary_bound()]
          + [summary_bf16(False)]
          + [summary_bwd(name) for name in BWD_KERNELS]
          + [summary_bf16(True)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA package on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the planner's main path (``Planner.plan``: enumerate, memory prune,
profiles, pre-score, simulated-annealing dedication on the card) at full
size, builds the CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version, and proves that the main path
went through the kernels by their launch counts.  Needs a CUDA device and
``nvcc``; exits non-zero without them.  Every phase prints one JSON line;
any mismatch is a failed assertion (non-zero exit, no final line).

Phases: ``env``, ``build``, ``kernels`` (bit-equality at ragged shapes),
``plan_uniform`` (gpt-3.1b on 128 GPUs, estimator fitted on the card),
``plan_tiered`` (gpt-11.1b on a 1024-GPU mixed fleet, hierarchical search),
``kernels_at_path_shapes``.  Each plan is made twice — SA on the card
(``backend="torch"``) and on the host (``backend="numpy"``) — and the two
Plan JSONs must be byte-equal once the backend's name is dropped.  The
wrappers record every input shape the two plans hand them; the last kernel
phase checks bit-equality and takes the times at exactly those shapes.
Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and the final
``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

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
from repro_torch.core.cluster import A100_TIER, V100_TIER  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import group_reduce as gr  # noqa: E402

#: Published peaks of one H100 SXM used for the bounds: device-memory rate,
#: and the non-tensor-core float32 rate as an upper bound on the rate of
#: the float64 comparisons (so the operations bound is, if anything, low).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

#: Ragged shapes (groups or rows, m) checked besides the main path's own,
#: which are not listed here: the wrappers record every shape the two plan
#: phases hand them, and the kernels are checked and timed at exactly those.
RAGGED_MIN_SCALE = [(1, 2), (7, 4), (130, 2)]
RAGGED_MAX = [(1, 3), (9, 16), (257, 8)]
KERNELS = {
    "group_min_scale": "src/repro/kernels/group_reduce.py:60",
    "group_max": "src/repro/kernels/group_reduce.py:99",
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def reset_launches() -> None:
    for name in KERNELS:
        fn = getattr(gr, name)
        fn.launches = 0
        fn.shapes.clear()


def read_launches() -> dict:
    return {name: getattr(gr, name).launches for name in KERNELS}


def read_shapes() -> dict:
    """Per kernel, {input shape: launches} since the last reset."""
    return {name: dict(getattr(gr, name).shapes) for name in KERNELS}


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
    by CUDA events, after a warm-up.  The inputs (a few MB) stay in the
    L2 cache between calls — as they are for the engine, which gathers
    them just before each reduce."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
        row.update(ms=time_ms(lambda: kernel(x)),
                   device_ms=device_ms(lambda: kernel(x)),
                   plain_ms=time_ms(lambda: plain(x)),
                   library_ms=time_ms(lambda: library(x)),
                   bound_ms=b_ms, bound_by=b_by)
    return row


def check_ragged(device) -> list:
    rows = [check_kernel("group_min_scale", (n, m, m), device, False)
            for n, m in RAGGED_MIN_SCALE]
    rows += [check_kernel("group_max", (n, m), device, False)
             for n, m in RAGGED_MAX]
    # what the kernels do not take is refused, not routed elsewhere
    sub = make_input("group_min_scale", (2, 3, 4, 4), torch.float64, device)
    vals = make_input("group_max", (9, 16), torch.float64, device)
    for bad in (lambda: gr.group_min_scale(sub.to(torch.float16), REF_BW),
                lambda: gr.group_min_scale(sub[..., :3], REF_BW),
                lambda: gr.group_max(vals.T)):
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
    for name in KERNELS:
        seen = sorted({sh for by_kernel in shapes_by_phase.values()
                       for sh in by_kernel[name]})
        for shape in seen:
            row = check_kernel(name, shape, device, True)
            row["launches"] = {phase: by_kernel[name].get(shape, 0)
                               for phase, by_kernel
                               in shapes_by_phase.items()}
            rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# the main path: Planner.plan on the card, held against the host backend
# ---------------------------------------------------------------------------

def strip_backend(plan) -> str:
    d = plan.to_json_dict()
    d["provenance"]["budget"].pop("backend")
    return json.dumps(d, sort_keys=True)


def run_plan(name, workload, spec, space, budget_kw, estimator, device,
             must_launch) -> tuple:
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
    assert strip_backend(plan) == strip_backend(host_plan), \
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
    return line, launches, shapes


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
    line, launches, shapes = run_plan(
        "plan_uniform", w, spec, SearchSpace(),
        dict(sa_seconds=600.0, sa_iters=2000, n_chains=4, sa_topk=8),
        est, device, must_launch=("group_min_scale",))
    line["estimator"] = {"fit_s": fit_s, "steps": 3000,
                         "mape_on_fit_range_pct": fit_mape}
    return line, launches, shapes


def plan_tiered(device) -> tuple:
    """gpt-11.1b on a 1024-GPU half-A100 half-V100 fleet, hierarchical
    island search; the tiered score runs the per-stage max kernel."""
    spec = mixed_fleet_spec("smoke-mixed-128x8", 128,
                            (A100_TIER, V100_TIER), (0.5, 0.5),
                            gpus_per_node=8, seed=7)
    w = Workload(configs.get("gpt-11.1b"), 2048, 1024)
    return run_plan(
        "plan_tiered", w, spec, SearchSpace(max_tp=8, max_micro=4),
        dict(sa_seconds=600.0, sa_iters=200, n_chains=4, sa_topk=2,
             hierarchical=True),
        None, device, must_launch=("group_min_scale", "group_max"))


def profile_sa(device) -> dict:
    """Where the card's time goes in the SA stage: the uniform request
    (no estimator, 100 steps per chain) under ``torch.profiler``; device
    busy time is the sum of the device-side rows (kernels and copies)."""
    from torch.profiler import ProfilerActivity, profile
    spec = MID_RANGE
    w = Workload(configs.get("gpt-3.1b"), 2048, 512)
    bw, _ = profile_bandwidth(spec)
    req = PlanRequest(workload=w, spec=spec, space=SearchSpace(),
                      budget=Budget(sa_seconds=600.0, sa_iters=400,
                                    n_chains=4, sa_topk=8, backend="torch"),
                      seed=0)
    planner = Planner(PipetteStrategy(), device=device)
    planner.plan(req, bw)                               # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        plan = planner.plan(req, bw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # device-side rows only: an operator's row repeats its kernels' time
    on_card = torch.autograd.DeviceType.CUDA
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == on_card),
                  key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    assert busy > 0, "the profiler recorded no device time"
    return {"phase": "profile_sa", "wall_s": wall,
            "sa_s": plan.overhead.sa_s, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall,
            "device_kernel_launches": sum(e.count for e in rows),
            "top_by_device_time": [
                {"name": e.key[:80], "count": e.count,
                 "device_ms": e.self_device_time_total / 1e3}
                for e in rows[:10]]}


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the plan phases, trace the SA stage with "
                         "torch.profiler and print the device's busy and "
                         "idle share and its top kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script only runs on a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    assert not torch.backends.cuda.matmul.allow_tf32
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "env", "device": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "nvidia_smi": smi})

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled_now": _build.last_build_seconds is not None,
          "library": os.path.relpath(str(lib), ROOT),
          "sources": [os.path.relpath(str(s), ROOT)
                      for s in _build.sources()],
          "flags": list(_build.NVCC_FLAGS)})

    ragged = check_ragged(device)
    emit({"phase": "kernels", "kernels": ragged})

    line_u, launches_u, shapes_u = plan_uniform(device)
    emit(line_u)
    line_t, launches_t, shapes_t = plan_tiered(device)
    emit(line_t)

    rows = check_path_shapes(device, {"plan_uniform": shapes_u,
                                      "plan_tiered": shapes_t})
    emit({"phase": "kernels_at_path_shapes", "kernels": rows})
    if args.profile:
        emit(profile_sa(device))

    def summary(name):
        """One line per kernel: the counts of the two plans, and the times
        at the shape the plans launched most often (``per_shape`` has every
        shape)."""
        mine = [r for r in rows if r["name"] == name]
        assert sum(sum(r["launches"].values()) for r in mine) \
            == launches_u[name] + launches_t[name]
        top = max(mine, key=lambda r: sum(r["launches"].values()))
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/group_reduce.cu",
                "replaces": KERNELS[name], "shape": top["shape"],
                "launches": launches_u[name] + launches_t[name],
                "max_abs_err": max(r["max_abs_err"]
                                   for r in mine + ragged
                                   if r["name"] == name),
                "ms": top["ms"], "device_ms": top["device_ms"],
                "plain_ms": top["plain_ms"],
                "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                "library_ms": top["library_ms"],
                "per_shape": mine}

    emit({"kernels": [summary(name) for name in KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

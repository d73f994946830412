#!/usr/bin/env python3
"""Time the fused selective scan's kernels of two or more checkouts on one
NVIDIA GPU, in turns, in one process per checkout.

    python3 tools/scan_bwd_ab.py PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout (its ``src/repro_torch``); each
runs in a fresh process, which builds that checkout's kernels into its own
``build/`` and prints one JSON line: the ``ptxas`` report of the scan's
kernels, and by CUDA-graph replay (``device_ms``) the fused forward at
falcon-mamba-7b's prefill and decode-step shapes (generation: batch 4,
prompt 512), the fused forward at its training microbatch (x (2, 512,
8192), N 16, bf16) — and, where the checkout has it, the instance that
keeps the chunk boundaries — and the backward (main launch and fold
together), with the two launches' device time split by ``torch.profiler``.
The backward is also checked against its plain version there (bf16,
within 1e-2 of each gradient's largest magnitude).  The last line is
``nvidia-smi``'s name and power limit of the card.  Needs a CUDA device
and ``nvcc``.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

#: falcon-mamba-7b: d_inner, N, dt_rank; generation and training sizes.
D_INNER, N, RANK = 8192, 16, 256
PREFILL, STEP, TRAIN = (4, 512), (4, 1), (2, 512)


def _inputs(torch, b, s, seed):
    """The fused scan's inputs as ``mamba1_block`` hands them (``B, C``
    column slices of one projection, ``z`` half of ``xz``), bf16."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16

    def rnd(shape, scale=1.0, dt=bf):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)
    xz = rnd((b, s, 2 * D_INNER))
    x = torch.nn.functional.silu(xz[..., :D_INNER].float()).to(bf)
    proj = rnd((b, s, RANK + 2 * N))
    f32 = torch.float32
    a_log = (torch.log(torch.arange(1, N + 1, dtype=f32, device="cuda"))
             .expand(D_INNER, N) + rnd((D_INNER, N), 0.1, f32)).contiguous()
    return (x, rnd((b, s, D_INNER), 0.5), rnd((D_INNER,), 0.5, f32) - 2.0,
            proj[..., RANK:RANK + N], proj[..., RANK + N:], a_log,
            rnd((D_INNER,), 1.0, f32), xz[..., D_INNER:])


def _device_ms(torch, fn, reps=50, replays=5):
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


def _split_ms(torch, fn, calls=20):
    """Device ms of one call of each of this library's kernels that
    ``fn`` launches (``torch.profiler``, ``calls`` calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"namespace\)::(\w+)", e.key)
        if m and e.device_type == torch.autograd.DeviceType.CUDA:
            out[m.group(1)] = e.self_device_time_total / 1e3 / calls
    return out


def worker(root: str) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as ss
    _build.load_library()
    log = _build.build_log()
    ptxas, current = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            current = m.group(1) if "scan" in m.group(1) else None
            continue
        if current and ("Used" in ln or "spill" in ln):
            ptxas.setdefault(current, []).append(ln.strip())
    res = {"root": root, "torch": torch.__version__, "ptxas": ptxas}
    h = {}
    for name, (b, s) in (("prefill", PREFILL), ("step", STEP),
                         ("train", TRAIN)):
        args = _inputs(torch, b, s, 1)
        h0 = torch.randn((b, D_INNER, N), device="cuda")
        if name == "train":
            fwd = lambda: ss._fused_fwd_cuda(*args, None, None, False)  # noqa: E731
        else:
            fwd = lambda: ss._fused_fwd_cuda(*args, h0, h0, s == 1)  # noqa: E731
        res[f"fwd_{name}_device_ms"] = _device_ms(torch, fwd)
        h[name] = args
    args = h["train"]
    b, s = TRAIN
    gen = torch.Generator(device="cuda").manual_seed(2)
    dout = torch.randn((b, s, D_INNER), generator=gen,
                       device="cuda").to(torch.bfloat16)
    if hasattr(ss, "_bounds_for"):       # the forward keeps the boundaries
        bounds = ss._bounds_for(args[0], N)
        res["fwd_bound_train_device_ms"] = _device_ms(
            torch, lambda: ss._fused_fwd_cuda(*args, None, None, False,
                                              bounds))
        bwd = lambda: ss._bwd_cuda(*args, None, dout, None, bounds)  # noqa: E731
    else:
        bwd = lambda: ss._bwd_cuda(*args, None, dout, None)  # noqa: E731
    got = bwd()
    torch.cuda.synchronize()
    want = ss.selective_scan_fused_bwd_ref(*args, None, dout, None)
    errs = []
    for g, w in zip(got, want):
        if w is None:
            continue
        err = float((g.float() - w.float()).abs().max())
        scale = float(w.float().abs().max())
        assert err <= 1e-2 * max(scale, 1e-30), (err, scale)
        errs.append(err / max(scale, 1e-30))
    again = bwd()
    torch.cuda.synchronize()
    assert all(g is None or torch.equal(g, a) for g, a in zip(got, again))
    res["bwd_rel_err_max"] = max(errs)
    res["bwd_device_ms"] = _device_ms(torch, bwd)
    res["bwd_kernels_ms"] = _split_ms(torch, bwd)
    return res


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--worker":
        print(json.dumps(worker(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("scan_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    rc = 0
    for root in sys.argv[1:]:
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", root], capture_output=True,
                             text=True, timeout=900)
        sys.stderr.write(run.stderr[-4000:])
        print(run.stdout.strip() or json.dumps({"root": root,
                                                "rc": run.returncode}),
              flush=True)
        rc = rc or run.returncode
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: nothing", flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Time the attention kernels of two or more checkouts on one NVIDIA GPU,
in turns, in one process per checkout.

    python3 tools/attention_ab.py PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout (its ``src/repro_torch``); each
runs in a fresh process, which builds that checkout's kernels into its own
``build/`` and prints one JSON line: the ``ptxas`` registers and spills of
the bfloat16 tensor-core attention instances, and by CUDA-graph replay
(``device_ms``) the bfloat16 forward at the model shapes of the head dims
every checkout takes (16, 32, 64, 128, 256: batch 4, 512 tokens, the
configs' heads) and the backward (its four launches together) at the
training microbatch (batch 2, 512 tokens) of head dims 64, 128 and 256;
and, where the checkout takes them, the same at 96, 112 and 136.  Each
shape is first checked against the plain version (forward within 2e-2,
backward within 1e-2 of each gradient's largest magnitude).  The float32
kernels (CUDA cores) are timed the same way at the training paths' float32
shapes (``F32``: ``train_gpt --full``'s gpt-demo and granite's tensor-
parallel slice, forward and backward), each first checked at the float32
tolerances (2e-5 forward, 1e-4 backward), with the ``ptxas`` registers and
spills of the checkout's float32 instances and, where the checkout reports
them, the float32 passes' dynamic shared memory and blocks an SM at head
dim 64, and the backward's device µs by pass (``torch.profiler``).  The
model's ``(B, S, H, D)`` tensors go in as ``(B, H, S, D)`` views, as in
the models.  After the checkouts, one line of SDPA's times (CUDA events)
at the float32 shapes (the forward, and its backward by autograd on the
efficient backend, KV repeated to the query heads), a yardstick only.
The last line is ``nvidia-smi``'s name and power limit of the card.
Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

#: (q shape, k shape) of the bfloat16 forward (batch 4, 512 tokens):
#: qwen2-7b, granite-moe-3b-a800m, musicgen-large (MHA), gemma3-12b, and
#: two narrow heads; then gpt-1.1b, kimi-k2-1t-a32b, gpt-11.1b.
FWD = [((4, 28, 512, 128), (4, 4, 512, 128)),
       ((4, 24, 512, 64), (4, 8, 512, 64)),
       ((4, 32, 512, 64), (4, 32, 512, 64)),
       ((4, 16, 512, 256), (4, 8, 512, 256)),
       ((4, 32, 512, 32), (4, 8, 512, 32)),
       ((4, 32, 512, 16), (4, 8, 512, 16)),
       ((4, 20, 512, 96), (4, 20, 512, 96)),
       ((4, 64, 512, 112), (4, 8, 512, 112)),
       ((4, 32, 512, 136), (4, 32, 512, 136))]
#: The backward at the training microbatch (batch 2, 512 tokens).
BWD = [((2, 28, 512, 128), (2, 4, 512, 128)),
       ((2, 24, 512, 64), (2, 8, 512, 64)),
       ((2, 16, 512, 256), (2, 8, 512, 256)),
       ((2, 20, 512, 96), (2, 20, 512, 96)),
       ((2, 64, 512, 112), (2, 8, 512, 112)),
       ((2, 32, 512, 136), (2, 32, 512, 136))]
#: The float32 forward and backward at the training paths' float32 shapes:
#: gpt-demo (``train_gpt --full``, MHA) and granite's tensor-parallel slice
#: (12 query heads over 4 KV heads), both causal.
F32 = [((4, 12, 256, 64), (4, 12, 256, 64)),
       ((2, 12, 512, 64), (2, 4, 512, 64))]
#: The float32 instances' names in a ``ptxas`` report: this tree's, and the
#: CUDA-core kernels they replaced (to read a parent checkout's).
F32_KERNELS = (r"(flash_fwd_f32_tiled|flash_fwd_f32|bwd_dkv_dq_f32|"
               r"bwd_delta_f32|bwd_dkv|bwd_dq|bwd_delta|bwd_fold)ILi(\d+)E"
               r"(Lb[01]E|fE)?")


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


def _views(torch, qs, ks, seed, dtype=None):
    """q, k, v and a gradient of the output as the model hands them:
    ``(B, S, H, D)`` tensors viewed as ``(B, H, S, D)``, bf16 unless
    ``dtype`` says otherwise."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dtype = dtype or torch.bfloat16

    def view(b, n, s, d):
        return torch.randn((b, s, n, d), generator=gen, device="cuda").to(
            dtype).transpose(1, 2)
    return view(*qs), view(*ks), view(*ks), view(*qs)


def _ptxas(log: str, pattern: str) -> dict:
    """{"<kernel> D=<d>[ lse| f32]": ["Used ... registers", "... spill"]}
    of the instances whose mangled name ``pattern`` matches."""
    out, current = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            k = re.search(pattern, m.group(1))
            tail = {"Lb1E": " lse", "fE": " f32"}.get(
                k.group(3) if k else None, "")
            current = None if k is None or (
                k.group(1) == "bwd_fold" and not tail) else \
                f"{k.group(1)} D={k.group(2)}{tail}"
            continue
        if current and ("Used" in ln or "spill" in ln):
            out.setdefault(current, []).append(ln.strip())
    return out


def _event_ms(torch, fn, reps=50):
    """Device ms of one call by CUDA events around ``reps`` calls, after a
    warm-up (for library calls, which a graph may not capture)."""
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


def _split_us(torch, fn, calls=20) -> dict:
    """Device µs a call of each kernel that ``fn`` launches, by
    ``torch.profiler`` (CUPTI) over ``calls`` calls: what a multi-kernel
    call spends in each of its passes."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us:
            name = e.key.replace("(anonymous namespace)::", "")
            name = re.sub(r"^void ", "", name).split("(")[0]
            out[name] = out.get(name, 0.0) + us / calls
    return out


def _check_bwd(fa, q, k, v, out, lse, do, got, tol, what):
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do)
    for g, w in zip(got, want):
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= tol * scale, \
            what


def worker(root: str) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    _build.load_library()
    log = _build.build_log()
    ptxas = _ptxas(log, r"(flash_fwd_bf16_mma|bwd_dkv_mma|bwd_dq_mma)"
                        r"ILi(\d+)E(Lb[01]E)?")
    res = {"root": root, "build_s": _build.last_build_seconds,
           "head_dims": list(fa.HEAD_DIMS), "ptxas": ptxas,
           "f32_ptxas": _ptxas(log, F32_KERNELS),
           "fwd_device_ms": {}, "bwd_device_ms": {},
           "f32_fwd_device_ms": {}, "f32_bwd_device_ms": {}}
    occ = fa.occupancy(64) if hasattr(fa, "occupancy") else {}
    res["f32_occupancy_d64"] = {k: v for k, v in occ.items()
                                if k.endswith("_f32")}
    for i, (qs, ks) in enumerate(FWD):
        if qs[3] not in fa.HEAD_DIMS:
            continue
        q, k, v, _ = _views(torch, qs, ks, i)
        got = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        want = fa.flash_attention_ref(q, k, v).float()
        assert bool(((got.float() - want).abs()
                     <= 2e-2 * (1 + want.abs())).all()), qs
        res["fwd_device_ms"][str(qs)] = _device_ms(
            torch, lambda: fa.flash_attention(q, k, v))
    for i, (qs, ks) in enumerate(BWD):
        if qs[3] not in fa.HEAD_DIMS:
            continue
        q, k, v, do = _views(torch, qs, ks, 100 + i)
        lse = torch.empty(qs[:3], dtype=torch.float32, device="cuda")
        out = fa._fwd_cuda(q, k, v, True, 0, lse)
        bwd = lambda: fa._bwd_cuda(q, k, v, out, lse, do, True, 0)  # noqa: E731
        got = bwd()
        torch.cuda.synchronize()
        _check_bwd(fa, q, k, v, out, lse, do, got, 1e-2, qs)
        res["bwd_device_ms"][str(qs)] = _device_ms(torch, bwd)
    for i, (qs, ks) in enumerate(F32):
        q, k, v, do = _views(torch, qs, ks, 200 + i, torch.float32)
        got = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        want = fa.flash_attention_ref(q, k, v)
        assert bool(((got - want).abs() <= 2e-5 * (1 + want.abs())).all()), \
            ("f32 forward", qs)
        res["f32_fwd_device_ms"][str(qs)] = _device_ms(
            torch, lambda: fa.flash_attention(q, k, v))
        lse = torch.empty(qs[:3], dtype=torch.float32, device="cuda")
        out = fa._fwd_cuda(q, k, v, True, 0, lse)
        bwd = lambda: fa._bwd_cuda(q, k, v, out, lse, do, True, 0)  # noqa: E731
        got = bwd()
        torch.cuda.synchronize()
        _check_bwd(fa, q, k, v, out, lse, do, got, 1e-4,
                   ("f32 backward", qs))
        res["f32_bwd_device_ms"][str(qs)] = _device_ms(torch, bwd)
        res.setdefault("f32_bwd_split_us", {})[str(qs)] = _split_us(torch,
                                                                    bwd)
    return res


def sdpa_f32() -> dict:
    """SDPA's device ms (CUDA events) at the float32 shapes, as a
    yardstick: the forward (``is_causal``, ``enable_gqa``, the default
    backend) and its backward by autograd on the efficient backend with KV
    repeated to the query heads, on contiguous ``(B, H, S, D)`` copies of
    the same views."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    F = torch.nn.functional
    res = {"fwd_device_ms": {}, "bwd_device_ms": {}}
    for i, (qs, ks) in enumerate(F32):
        q, k, v, do = (t.contiguous() for t in _views(
            torch, qs, ks, 200 + i, torch.float32))
        res["fwd_device_ms"][str(qs)] = _event_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
        group = qs[1] // ks[1]
        ql = q.requires_grad_()
        kl, vl = (t.repeat_interleave(group, dim=1).requires_grad_()
                  for t in (k, v))
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        res["bwd_device_ms"][str(qs)] = _event_ms(
            torch, lambda: torch.autograd.grad(ol, (ql, kl, vl), do,
                                               retain_graph=True))
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
        print("attention_ab: no CUDA device", file=sys.stderr)
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
    print(json.dumps({"sdpa_f32": sdpa_f32()}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: nothing", flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

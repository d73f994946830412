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
backward within 1e-2 of each gradient's largest magnitude).  The model's
``(B, S, H, D)`` tensors go in as ``(B, H, S, D)`` views, as in the
models.  The last line is ``nvidia-smi``'s name and power limit of the
card.  Needs a CUDA device and ``nvcc``.
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


def _views(torch, qs, ks, seed):
    """q, k, v and a gradient of the output as the model hands them:
    ``(B, S, H, D)`` tensors viewed as ``(B, H, S, D)``, bf16."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def view(b, n, s, d):
        return torch.randn((b, s, n, d), generator=gen, device="cuda").to(
            torch.bfloat16).transpose(1, 2)
    return view(*qs), view(*ks), view(*ks), view(*qs)


def worker(root: str) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    _build.load_library()
    ptxas, current = {}, None
    for ln in _build.build_log().splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            k = re.search(r"(flash_fwd_bf16_mma|bwd_dkv_mma|bwd_dq_mma)"
                          r"ILi(\d+)E(Lb[01]E)?", m.group(1))
            lse = " lse" if k is not None and k.group(3) == "Lb1E" else ""
            current = None if k is None else \
                f"{k.group(1)} D={k.group(2)}{lse}"
            continue
        if current and ("Used" in ln or "spill" in ln):
            ptxas.setdefault(current, []).append(ln.strip())
    res = {"root": root, "head_dims": list(fa.HEAD_DIMS), "ptxas": ptxas,
           "fwd_device_ms": {}, "bwd_device_ms": {}}
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
        want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do)
        for g, w in zip(got, want):
            scale = float(w.float().abs().max())
            assert float((g.float() - w.float()).abs().max()) <= \
                1e-2 * scale, qs
        res["bwd_device_ms"][str(qs)] = _device_ms(torch, bwd)
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: nothing", flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

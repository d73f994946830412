#!/usr/bin/env python3
"""Time the RMSNorm backward kernel of two or more checkouts on one NVIDIA
GPU, in turns, in one process per checkout.

    python3 tools/rmsnorm_bwd_ab.py [--keys LOG] PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout (its ``src/repro_torch``); each
runs in a fresh process, which builds that checkout's kernels into its own
``build/`` and prints one JSON line: the ``ptxas`` report of the backward's
kernels, and for every shape key the kernel's ``device_ms`` (CUDA-graph
replay of 50 calls, five times), its bound (bytes over 3.35 TB/s, 11
operations an element, 12 with ``ds_in``, over 67 TFLOP/s float32), its
largest error against ``rmsnorm_bwd_ref`` relative to the largest
magnitude (1e-2 in bfloat16, 2e-5 in float32), whether a second launch
and a graph replay give the first launch's bits.  The shape keys are the
training paths' (``DEFAULT_KEYS``), or, with ``--keys``, every
``rmsnorm_bwd`` key of the ``bwd_kernels_at_path_shapes`` line of a
``chip_smoke.py`` output, with the launches it counted there.  The last
line is ``nvidia-smi``'s name and power limit of the card.  Needs a CUDA
device and ``nvcc``.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

EPS = 1e-5
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
#: ("bwd" | "add_bwd", x shape, x dtype, w dtype[, ds_in given]):
#: gpt-demo's residual form (train_gpt --full, float32), zamba2's gated
#: norm (float32 x, bfloat16 w), gpt-1.1b's pipeline and tensor-parallel
#: rows, qwen2-7b's and falcon-mamba-7b's training rows, both forms.
DEFAULT_KEYS = [
    ("add_bwd", (4, 256, 768), "float32", "float32", True),
    ("bwd", (2, 512, 7168), "float32", "bfloat16"),
    ("bwd", (1, 512, 1920), "bfloat16", "bfloat16"),
    ("add_bwd", (2, 512, 1920), "bfloat16", "bfloat16", True),
    ("bwd", (2, 512, 3584), "bfloat16", "bfloat16"),
    ("add_bwd", (2, 512, 3584), "bfloat16", "bfloat16", True),
    ("bwd", (2, 512, 4096), "bfloat16", "bfloat16"),
    ("add_bwd", (2, 512, 4096), "bfloat16", "bfloat16", True),
]


def keys_from_log(path: str) -> list:
    """``(key, launches)`` of every ``rmsnorm_bwd`` row of a
    ``chip_smoke.py`` output's ``bwd_kernels_at_path_shapes`` line."""
    out = []
    with open(path) as f:
        for ln in f:
            if '"bwd_kernels_at_path_shapes"' not in ln:
                continue
            for r in json.loads(ln)["kernels"]:
                if r["name"] == "rmsnorm_bwd":
                    k = r["key"]
                    dts = [str(t).replace("torch.", "") for t in k[2:4]]
                    key = (k[0], tuple(k[1]), *dts, *k[4:])
                    out.append((key, sum(r["launches"].values())))
    return out


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


def _case(torch, rn, key):
    """Seeded inputs of one key and the wrapper's call on them."""
    shape, xt, wt = key[1], getattr(torch, key[2]), getattr(torch, key[3])
    with_ds = key[0] == "add_bwd" and key[4]
    gen = torch.Generator(device="cuda").manual_seed(sum(shape) + len(key))

    def rnd(s, dt, scale=1.0):
        return (torch.randn(s, generator=gen, device="cuda") * scale).to(dt)
    x, w = rnd(shape, xt, 3.0), rnd(shape[-1:], wt)
    dy = rnd(shape, xt)
    ds = rnd(shape, xt) if with_ds else None
    tkey = (key[0], torch.Size(shape), xt, wt, *key[4:])
    return (x, w, dy, ds), (lambda: rn._rmsnorm_bwd_cuda(  # noqa: E731
        x, w, dy, EPS, ds, tkey))


def _ptxas(log: str) -> dict:
    """Registers, spills and static shared memory of each backward kernel
    of ``rmsnorm.cu``, by mangled name."""
    out, current, src = {}, None, None
    for ln in log.splitlines():
        if ln.startswith("== "):
            src = ln[3:].strip()
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            current = m.group(1) if src == "rmsnorm.cu" and "bwd" in \
                m.group(1) else None
            continue
        if current and ("Used" in ln or "spill" in ln):
            out.setdefault(current, []).append(ln.strip())
    return out


def worker(root: str, keys: list) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as rn
    _build.load_library()
    res = {"root": root, "torch": torch.__version__,
           "ptxas": _ptxas(_build.build_log()), "shapes": []}
    for key, launches in keys:
        (x, w, dy, ds), call = _case(torch, rn, key)
        got = call()
        torch.cuda.synchronize()
        want = rn.rmsnorm_bwd_ref(x, w, dy, EPS, ds)
        errs = []
        for g, t in zip(got, want):
            tol = 1e-2 if g.dtype == torch.bfloat16 else 2e-5
            err = float((g.float() - t.float()).abs().max())
            scale = max(float(t.float().abs().max()), 1e-30)
            assert err <= tol * scale, (key, err, scale)
            errs.append(err / scale)
        again = call()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = call()
        graph.replay()
        torch.cuda.synchronize()
        nbytes = sum(t.numel() * t.element_size()
                     for t in (x, w, dy, ds, *got) if t is not None)
        ops = (12 if ds is not None else 11) * x.numel()
        res["shapes"].append({
            "key": list(key), "launches": launches,
            "max_rel_err": max(errs),
            "repeat_bits_equal": all(torch.equal(a, b)
                                     for a, b in zip(got, again)),
            "graph_bits_equal": all(torch.equal(a, b)
                                    for a, b in zip(got, replayed)),
            "device_ms": _device_ms(torch, call),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                            ops / F32_OPS_PER_S) * 1e3})
        del graph, replayed
        torch.cuda.empty_cache()
    return res


def main() -> int:
    if len(sys.argv) >= 4 and sys.argv[1] == "--worker":
        keys = [(tuple(k[0:1]) + (tuple(k[1]),) + tuple(k[2:]), n)
                for k, n in json.loads(sys.argv[3])]
        print(json.dumps(worker(sys.argv[2], keys)), flush=True)
        return 0
    argv = sys.argv[1:]
    keys = [(k, None) for k in DEFAULT_KEYS]
    if argv[:1] == ["--keys"]:
        keys, argv = keys_from_log(argv[1]), argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("rmsnorm_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    rc = 0
    for root in argv:
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", root, json.dumps(keys)],
                             capture_output=True, text=True, timeout=900)
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

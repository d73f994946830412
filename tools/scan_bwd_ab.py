#!/usr/bin/env python3
"""Time the fused selective scan's kernels of two or more checkouts on one
NVIDIA GPU, in turns, in one process per checkout, and compare their
outputs.

    python3 tools/scan_bwd_ab.py [--out DIR] PARENT_DIR . . PARENT_DIR

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
within 1e-2 of each gradient's largest magnitude).

The same for the bfloat16 working type (``scan_dtype="bfloat16"``, keys
``bf16w_*``): its prefill forward, its training forward (the instance that
keeps the state entering every chunk) and its backward at those shapes,
the backward split by the profiler and checked against
``selective_scan_fused_bf16_bwd_ref`` alike, the kernels' shared
memory and blocks an SM where the checkout reports them.  Each worker
saves the working type's outputs at a fixed seed under ``DIR`` (default
``build/scan_ab``); after the runs one more JSON line compares every
checkout with the first: the final states and the chunk boundaries must be
bit-equal (the tool exits 1 otherwise), and the largest differences of
``out`` and of the nine gradients are printed.  The last line is
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


def _check_bwd(torch, got, want) -> float:
    """Largest error of the nine gradients against the plain backward's,
    relative to each one's largest magnitude (each within 1e-2)."""
    errs = []
    for g, w in zip(got, want):
        if w is None:
            continue
        err = float((g.float() - w.float()).abs().max())
        scale = float(w.float().abs().max())
        assert err <= 1e-2 * max(scale, 1e-30), (err, scale)
        errs.append(err / max(scale, 1e-30))
    return max(errs)


def worker(root: str, save: str) -> dict:
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
    res = {"root": root, "torch": torch.__version__, "ptxas": ptxas,
           "sass_instructions": sass_counts(str(_build.build()))}
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
    bounds = ss._bounds_for(args[0], N)
    res["fwd_bound_train_device_ms"] = _device_ms(
        torch, lambda: ss._fused_fwd_cuda(*args, None, None, False, bounds))
    bwd = lambda: ss._bwd_cuda(*args, None, dout, None, bounds)  # noqa: E731
    got = bwd()
    torch.cuda.synchronize()
    res["bwd_rel_err_max"] = _check_bwd(
        torch, got, ss.selective_scan_fused_bwd_ref(*args, None, dout, None))
    again = bwd()
    torch.cuda.synchronize()
    assert all(g is None or torch.equal(g, a) for g, a in zip(got, again))
    res["bwd_device_ms"] = _device_ms(torch, bwd)
    res["bwd_kernels_ms"] = _split_ms(torch, bwd)
    del got, again
    res.update(work_bf16(torch, ss, h["prefill"], args, dout, save))
    return res


def work_bf16(torch, ss, prefill, train, dout, save: str) -> dict:
    """The bfloat16 working type's three instances at falcon's prefill and
    training shapes: ``device_ms``, the backward split and checked, the
    outputs at a fixed seed saved to ``save``."""
    res = {}
    fwd = lambda: ss._fused_fwd_cuda(*prefill, None, None, False,  # noqa: E731
                                     work_bf16=True)
    out_p, h_p = fwd()
    res["bf16w_fwd_prefill_device_ms"] = _device_ms(torch, fwd)
    bounds = ss._bounds_for(train[0], N, True)
    fwd_t = lambda: ss._fused_fwd_cuda(*train, None, None, False,  # noqa: E731
                                       bounds, work_bf16=True)
    out_t, h_t = fwd_t()
    kept = bounds.clone()
    res["bf16w_fwd_train_device_ms"] = _device_ms(torch, fwd_t)
    bwd = lambda: ss._bwd_cuda(*train, None, dout, None, bounds,  # noqa: E731
                               work_bf16=True)
    got = bwd()
    torch.cuda.synchronize()
    res["bf16w_bwd_rel_err_max"] = _check_bwd(
        torch, got, ss.selective_scan_fused_bf16_bwd_ref(
            *train, None, dout, None, bounds=kept))
    again = bwd()
    torch.cuda.synchronize()
    res["bf16w_bwd_repeat_bits_equal"] = all(
        g is None or torch.equal(g, a) for g, a in zip(got, again))
    res["bf16w_bwd_device_ms"] = _device_ms(torch, bwd, reps=10)
    res["bf16w_bwd_kernels_ms"] = _split_ms(torch, bwd, calls=5)
    if "form" in ss.bwd_occupancy.__code__.co_varnames:
        res["bf16w_occupancy"] = {
            f"{t} {form}": ss.bwd_occupancy(dt, form)
            for t, dt in (("bf16", torch.bfloat16), ("f32", torch.float32))
            for form in ("fused_bf16", "fused_bf16_bound", "fused_bf16_bwd")}
    torch.save({"prefill_out": out_p.cpu(), "prefill_h": h_p.cpu(),
                "train_out": out_t.cpu(), "train_h": h_t.cpu(),
                "train_bounds": kept.cpu(),
                "grads": [None if g is None else g.cpu() for g in got]}, save)
    return res


def sass_counts(lib: str) -> dict:
    """Static SASS instructions of each of the library's scan kernels
    (``cuobjdump -sass``; a count of the code, not of what runs), or the
    error where the toolkit has no ``cuobjdump``."""
    exe = os.path.join(os.path.dirname(_nvcc_path()), "cuobjdump")
    try:
        text = subprocess.run([exe, "-sass", lib], capture_output=True,
                              text=True, timeout=300).stdout
    except OSError as e:
        return {"error": str(e)}
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1) if "scan" in m.group(1) else None
            continue
        if name and re.match(r"\s+/\*[0-9a-f]{4}\*/\s+\S", ln):
            out[name] = out.get(name, 0) + 1
    return out


def _nvcc_path() -> str:
    from repro_torch.kernels import _build
    return _build._nvcc()


GRADS = ("x", "dt", "dt_bias", "B", "C", "A_log", "D", "z", "h0")


def compare(torch, saves: list) -> dict:
    """Every checkout's saved outputs against the first's: bit-equality of
    the states and boundaries, the largest absolute difference of each
    output and gradient (relative to its largest magnitude beside it)."""
    first = torch.load(saves[0][1])
    out = {"against": saves[0][0], "runs": []}
    for root, path in saves[1:]:
        other = torch.load(path)
        run = {"root": root,
               "states_and_bounds_bit_equal": all(
                   torch.equal(first[k], other[k])
                   for k in ("prefill_h", "train_h", "train_bounds"))}
        for k in ("prefill_out", "train_out"):
            run[k + "_bit_equal"] = torch.equal(first[k], other[k])
            run[k + "_max_abs_diff"] = float(
                (first[k].float() - other[k].float()).abs().max())
        diffs = {}
        for name, g, w in zip(GRADS, other["grads"], first["grads"]):
            if w is None:
                continue
            d = float((g.float() - w.float()).abs().max())
            diffs[name] = [d, d / max(float(w.float().abs().max()), 1e-30),
                           float((g != w).float().mean())]
        run["grads_max_abs_rel_and_share_differing"] = diffs
        out["runs"].append(run)
    return out


def main() -> int:
    if len(sys.argv) >= 4 and sys.argv[1] == "--worker":
        print(json.dumps(worker(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    argv = sys.argv[1:]
    out_dir = os.path.join("build", "scan_ab")
    if argv[:1] == ["--out"]:
        out_dir, argv = argv[1], argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("scan_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(out_dir, exist_ok=True)
    rc, saves = 0, []
    for i, root in enumerate(argv):
        save = os.path.join(out_dir, f"run{i}.pt")
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", root, save], capture_output=True,
                             text=True, timeout=900)
        sys.stderr.write(run.stderr[-4000:])
        print(run.stdout.strip() or json.dumps({"root": root,
                                                "rc": run.returncode}),
              flush=True)
        rc = rc or run.returncode
        if run.returncode == 0:
            saves.append((root, save))
    if len(saves) > 1:
        cmp = compare(torch, saves)
        print(json.dumps({"compare": cmp}), flush=True)
        if not all(r["states_and_bounds_bit_equal"] for r in cmp["runs"]):
            rc = rc or 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: nothing", flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

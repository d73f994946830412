"""Builds the package's CUDA sources into one shared library at first use.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` into an object file —
one ``nvcc`` per source, all started together — and links the objects into
one library with a plain C interface, which :func:`load_library` opens with
``ctypes``.  No PyTorch headers are involved, so a build takes seconds.  The
library is written to ``build/repro_torch_kernels/`` at the root of the
source checkout, named by a digest of the sources and flags so an edited
source is never served by a stale binary.  The path is found from this
file's place under ``src/``, so the package is meant to be used from a
checkout (``PYTHONPATH=src`` or an editable install).  A failing build
raises.

Floating-point contraction is off for the whole library (``-fmad=false``):
the group-reduce kernels feed the annealing score, which must equal the host
engine's bit for bit, and one fused multiply-add ulp flips an accept
decision and diverges a chain.  A kernel that wants a fused multiply-add
(the attention dot products) asks for it with ``fmaf``.

``ptxas -v`` reports each kernel's registers, shared memory and spills; the
report is kept beside the library (:func:`build_log`).

:func:`launch` is the one call path of every wrapper, so it is kept lean:
each ``ctypes`` function is bound once, with its ``argtypes`` set, and the
current device index and the stream handle are read raw
(``torch._C._cuda_getDevice``, ``torch._C._cuda_getCurrentRawStream``)
rather than through ``torch.cuda.current_device()`` and a
``torch.cuda.Stream`` object, which cost microseconds more per call.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"

#: Flags of each per-source compile; the link adds ``-shared``.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_lib: Optional[ctypes.CDLL] = None
#: Each C entry point, bound once with its ``argtypes`` (filled by
#: :func:`load_library`).
_fns: dict = {}
#: Seconds the last real build took (None until one ran in this process).
last_build_seconds: Optional[float] = None


def build_dir() -> Path:
    """Directory the library is built into (created on demand)."""
    # src/repro_torch/kernels/_build.py -> the checkout root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH and /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _run_all(cmds: list) -> list:
    """Start every command at once; wait for all; raise with the output of
    every one that failed.  Returns each command's standard error."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    failed = [f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}\n{err}"
              for cmd, p, (out, err) in zip(cmds, procs, outs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return [err for _, err in outs]


def build() -> Path:
    """Compile the sources if their library is not there yet; returns the
    path of the shared library."""
    global last_build_seconds
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out_dir = build_dir()
    lib_path = out_dir / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    log_path = lib_path.with_suffix(".ptxas.log")
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [out_dir / f".{s.stem}.{tag}.o" for s in srcs]
    tmp = out_dir / f".{lib_path.name}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                         for s, o in zip(srcs, objs)])
        _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]])
        log = "\n".join(f"== {s.name}\n{err.strip()}"
                        for s, err in zip(srcs, logs))
        log_tmp = log_path.with_name(f".{log_path.name}.{os.getpid()}.tmp")
        log_tmp.write_text(log)
        os.replace(log_tmp, log_path)
        os.replace(tmp, lib_path)   # atomic: two concurrent builds both succeed
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    last_build_seconds = time.perf_counter() - t0
    return lib_path


def build_log() -> str:
    """``ptxas -v`` report of the library :func:`build` serves, one block
    per source (builds it first if needed)."""
    return build().with_suffix(".ptxas.log").read_text()


def load_library() -> ctypes.CDLL:
    """The built library with every function's ``argtypes`` set (pointers
    and the stream as ``c_void_p`` — ctypes would otherwise cut them to 32
    bits; element counts and strides as ``c_longlong``)."""
    global _lib, current_raw_device, current_raw_stream
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    vp, ll, ci, dbl = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_double)
    argtypes = {
        # group_reduce.cu: (sub, ref_bw, out, n_groups, m*m, stream)
        "group_min_scale_f64": [vp, dbl, vp, ll, ci, vp],
        "group_min_scale_f32": [vp, dbl, vp, ll, ci, vp],
        # (table, n_tab, perm, rows, width, ref_bw, out, n_groups, m,
        #  inner, outer, step, stream)
        "group_min_scale_gather_f64": [vp, ll, vp, ll, ll, dbl, vp]
        + [ci] * 5 + [vp],
        "group_min_scale_gather_f32": [vp, ll, vp, ll, ll, dbl, vp]
        + [ci] * 5 + [vp],
        # (vals, out, n_rows, m, stream)
        "group_max_f64": [vp, vp, ll, ci, vp],
        "group_max_f32": [vp, vp, ll, ci, vp],
        # (slow, perm, cw, c_x, c_max, rows, pp, nc, stream)
        "group_max_gather_f64": [vp] * 5 + [ll, ci, ci, vp],
        "group_max_gather_f32": [vp] * 5 + [ll, ci, ci, vp],
        # rmsnorm.cu: (x, w, y, rows, d, eps, types, stream) and
        # (x, r, w, s, y, rows, d, eps, types, stream)
        "rmsnorm_fwd": [vp, vp, vp, ll, ci, dbl, ci, vp],
        "add_rmsnorm_fwd": [vp] * 5 + [ll, ci, dbl, ci, vp],
        # (x, w, dy, ds, dx, dw, work, rows, d, eps, types, blocks, stream)
        "rmsnorm_bwd": [vp] * 7 + [ll, ci, dbl, ci, ci, vp],
        # flash_attention.cu: (q, k, v, o, lse, 4 x (batch, head, seq)
        #   strides, batch, heads, kv_heads, len_q, len_k, head_dim, scale,
        #   causal, window, q_offset, bf16, stream) and (q, k, v, o, dout,
        #   lse, delta, work, dq, dk, dv, 8 x (batch, head, seq) strides, the
        #   same sizes)
        "flash_attention_fwd": [vp] * 5 + [ll] * 12
        + [ci, ci, ci, ll, ll, ci, dbl, ci, ll, ll, ci, vp],
        "flash_attention_bwd": [vp] * 11 + [ll] * 24
        + [ci, ci, ci, ll, ll, ci, dbl, ci, ll, ll, ci, vp],
        # (head_dim, pass, &smem bytes, &blocks an SM): no launch, no stream
        "flash_attention_occupancy": [ci, ci, vp, vp],
        # selective_scan.cu: (x, dt, B, C, A, h0, y, h_out,
        #   4 x (batch, time) strides, batch, len, d, n, bf16, stream) and
        #   (x, dt, B, C, z, A_log, dt_bias, D, h0, out, h_out, bound,
        #   5 x (batch, time) strides, batch, len, d, n, bf16, step, stream)
        "selective_scan_fwd": [vp] * 8 + [ll] * 8
        + [ll, ll, ci, ci, ci, vp],
        "selective_scan_fused_fwd": [vp] * 12 + [ll] * 10
        + [ll, ll, ci, ci, ci, ci, vp],
        # (x, dt, B, C, z, A_log, dt_bias, D, h0, dout, dh_final, bound, dx,
        #  ddt, dB, dC, dz, ddt_bias, dD, dA_log, dh0, work, work elements,
        #  6 x (batch, time) strides, batch, len, d, n, chunk, channels,
        #  bf16, stream)
        "selective_scan_fused_bwd": [vp] * 22 + [ll] * 13
        + [ll, ll, ci, ci, ci, ci, ci, vp],
        # (bf16, &smem bytes, &blocks an SM): no launch, no stream
        "selective_scan_fused_bwd_occupancy": [ci, vp, vp],
        # the bfloat16 working type: the fused forward's arguments with
        # (q, bf16) for (bf16, step), the backward's with (q, bf16) for
        # (chunk, channels, bf16)
        "selective_scan_fused_bf16_fwd": [vp] * 12 + [ll] * 10
        + [ll, ll, ci, ci, ci, ci, vp],
        "selective_scan_fused_bf16_bwd": [vp] * 22 + [ll] * 13
        + [ll, ll, ci, ci, ci, ci, vp],
        # (bf16, kernel, &smem bytes, &blocks an SM): no launch, no stream
        "selective_scan_fused_bf16_occupancy": [ci, ci, vp, vp],
        # (a, b, out, pairs, stream)
        "selective_scan_bf16_ops_probe": [vp, vp, vp, ll, vp],
    }
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ci
        _fns[name] = fn
    current_raw_device = torch._C._cuda_getDevice
    current_raw_stream = torch._C._cuda_getCurrentRawStream
    _lib = lib
    return lib


#: ``torch._C._cuda_getDevice``: the current device's index, read without
#: ``torch.cuda.current_device()``'s lazy-initialisation check (only CUDA
#: builds of torch have it; bound by :func:`load_library`).
current_raw_device = None
#: ``torch._C._cuda_getCurrentRawStream``: the current stream's handle of a
#: device index, read without building a ``torch.cuda.Stream`` (bound by
#: :func:`load_library`, like :data:`current_raw_device`).
current_raw_stream = None


def refuse_grad(name: str, reason: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when grad mode is on and one of
    ``tensors`` requires a gradient: a kernel with no backward must not
    hand back a result cut from the autograd graph.  ``reason`` says where
    its backward comes from (or why none is needed)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel, so it cannot take a tensor that "
            f"requires a gradient on the card: {reason}")


def launch(fn_name: str, index: int, *args) -> None:
    """Call one C entry point on PyTorch's current stream of the CUDA
    device ``index`` (made current for the call when it is not), and raise
    on a refused launch."""
    fn = _fns.get(fn_name)
    if fn is None:
        load_library()
        fn = _fns[fn_name]
    if index == current_raw_device():
        rc = fn(*args, current_raw_stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, current_raw_stream(index))
    if rc != 0:
        raise RuntimeError(f"{fn_name}: kernel launch failed (cudaError "
                           f"{rc})")

"""Builds the package's CUDA sources into one shared library at first use.

``nvcc`` compiles ``csrc/*.cu`` for ``sm_90a`` into a library with a plain C
interface, which :func:`load_library` opens with ``ctypes`` — no PyTorch
headers are involved, so a build takes seconds.  The library is written to
``build/repro_torch_kernels/`` at the root of the source checkout, named by a
digest of the sources and flags so an edited source is never served by a stale
binary.  The path is found from this file's place under ``src/``, so the
package is meant to be used from a checkout (``PYTHONPATH=src`` or an editable
install).  A failing build raises.

Floating-point contraction is off for the whole library (``-fmad=false``):
the annealing score must equal the host engine's bit for bit, and one fused
multiply-add ulp flips an accept decision and diverges a chain.
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

CSRC = Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
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


def build() -> Path:
    """Compile the sources if their library is not there yet; returns the
    path of the shared library."""
    global last_build_seconds
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out_dir = build_dir()
    lib_path = out_dir / f"libgroup_reduce_{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{lib_path.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *[str(s) for s in srcs]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)      # atomic: two concurrent builds both succeed
    last_build_seconds = time.perf_counter() - t0
    return lib_path


def load_library() -> ctypes.CDLL:
    """The built library with every function's ``argtypes`` set (pointers
    and the stream as ``c_void_p`` — ctypes would otherwise cut them to 32
    bits)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    vp, ll, ci, dbl = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_double)
    for name in ("group_min_scale_f64", "group_min_scale_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, dbl, vp, ll, ci, vp]
        fn.restype = ci
    for name in ("group_max_f64", "group_max_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, ll, ci, vp]
        fn.restype = ci
    _lib = lib
    return lib

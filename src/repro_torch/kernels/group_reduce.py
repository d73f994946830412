"""Group-reduce kernels of the annealing engine, with their plain versions.

The batched annealing score reduces, for every chain of every candidate,
many small gathered sub-matrices: per communicator group the minimum link
bandwidth turned into a slowdown scale (TP / CP groups), and per pipeline
stage the maximum member compute slowdown.

``group_min_scale`` replaces the Pallas kernel ``group_min_scale``
(``_min_scale_kernel``) and ``group_max`` replaces ``group_max``
(``_max_kernel``) of the JAX package's ``kernels/group_reduce.py``.  Both
are CUDA C++ (``csrc/group_reduce.cu``).  Both are bound by bytes: every
input value is read once for one comparison, and one value per group is
written — ``(n_groups * m * m + n_groups) * itemsize`` bytes for the first,
``(n_rows * m + n_rows) * itemsize`` for the second.  The design therefore
only has to stream: one warp per group, lanes on neighbouring addresses, a
shuffle fold, no shared memory, and the leading batch axes flattened by the
wrapper so that one launch covers every chain of every candidate.

The plain versions (``*_ref``) compute the same values with ``torch.amin`` /
``torch.amax``; min and max are order-free and the divide is a correctly
rounded IEEE divide, so kernel and plain version agree bit for bit.  A
wrapper takes the plain version only for a tensor that lies on the CPU; for
a CUDA tensor it launches the kernel or raises.  Inputs must be NaN-free
(the engine's bandwidth and slowdown matrices are).
"""
from __future__ import annotations

from collections import Counter

import torch

from ._build import launch as _launch

_DTYPES = {torch.float64: "f64", torch.float32: "f32"}


# ---------------------------------------------------------------------------
# per-group min-bandwidth -> slowdown scale
# ---------------------------------------------------------------------------

def group_min_scale_ref(sub: torch.Tensor, ref_bw: float) -> torch.Tensor:
    """Per-group slowdown scales from gathered bandwidth sub-matrices.

    Args:
        sub: ``(..., m, m)`` pairwise link bandwidths of each communicator
            group (self links pre-masked to ``inf``).
        ref_bw: scalar bandwidth the profiled time was measured at.

    Returns:
        ``(...)`` scales: ``ref_bw / min(sub)`` where the group minimum is
        finite and positive, else 1.0 (the degenerate-link guard of
        ``latency._tp_scale``).
    """
    gbw = torch.amin(sub, dim=(-2, -1))
    ok = torch.isfinite(gbw) & (gbw > 0)
    # tensor / tensor is the IEEE divide; ``scalar / tensor`` is not (torch
    # evaluates it as ``tensor.reciprocal() * scalar``, one rounding more)
    return torch.where(ok, torch.full_like(gbw, ref_bw) / gbw,
                       torch.ones_like(gbw))


def _check(x: torch.Tensor, name: str, min_dim: int) -> str:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x)!r}")
    if x.dtype not in _DTYPES:
        raise TypeError(
            f"{name} must be float64 or float32, got {x.dtype}")
    if x.dim() < min_dim:
        raise ValueError(
            f"{name} needs at least {min_dim} dims, got shape "
            f"{tuple(x.shape)}")
    if x.shape[-1] < 1:
        raise ValueError(f"{name} has an empty reduce axis: "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return _DTYPES[x.dtype]


def group_min_scale(sub: torch.Tensor, ref_bw: float) -> torch.Tensor:
    """CUDA version of :func:`group_min_scale_ref` (bit-equal output).

    ``sub`` is ``(..., m, m)``, contiguous, float64 or float32; the leading
    dims are flattened so one launch reduces every group.  A CPU tensor
    goes through the plain version; a CUDA tensor launches the kernel or
    raises.
    """
    suffix = _check(sub, "sub", 3)
    if sub.shape[-1] != sub.shape[-2]:
        raise ValueError(
            f"sub must be (..., m, m), got shape {tuple(sub.shape)}")
    if sub.device.type == "cpu":
        return group_min_scale_ref(sub, ref_bw)
    if sub.device.type != "cuda":
        raise ValueError(f"unsupported device {sub.device}")
    lead = sub.shape[:-2]
    out = torch.empty(lead, dtype=sub.dtype, device=sub.device)
    n_groups = out.numel()
    if n_groups:
        _launch(f"group_min_scale_{suffix}", sub, sub.data_ptr(),
                float(ref_bw), out.data_ptr(), n_groups,
                sub.shape[-1] * sub.shape[-2])
        group_min_scale.launches += 1
        group_min_scale.shapes[tuple(sub.shape)] += 1
    return out


#: Number of kernel launches made by the wrapper (never the plain version),
#: and the same count split by the input's shape as the caller gave it.
group_min_scale.launches = 0
group_min_scale.shapes = Counter()


# ---------------------------------------------------------------------------
# per-stage max member slowdown
# ---------------------------------------------------------------------------

def group_max_ref(vals: torch.Tensor) -> torch.Tensor:
    """Row-wise max: ``(..., m) -> (...)`` (per-stage compute slowdown
    reduce of the tiered-cluster path)."""
    return torch.amax(vals, dim=-1)


def group_max(vals: torch.Tensor) -> torch.Tensor:
    """CUDA version of :func:`group_max_ref` (bit-equal output).

    ``vals`` is ``(..., m)``, contiguous, float64 or float32; the leading
    dims are flattened to rows of one launch.  A CPU tensor goes through
    the plain version; a CUDA tensor launches the kernel or raises.
    """
    suffix = _check(vals, "vals", 2)
    if vals.device.type == "cpu":
        return group_max_ref(vals)
    if vals.device.type != "cuda":
        raise ValueError(f"unsupported device {vals.device}")
    lead = vals.shape[:-1]
    out = torch.empty(lead, dtype=vals.dtype, device=vals.device)
    n_rows = out.numel()
    if n_rows:
        _launch(f"group_max_{suffix}", vals, vals.data_ptr(),
                out.data_ptr(), n_rows, vals.shape[-1])
        group_max.launches += 1
        group_max.shapes[tuple(vals.shape)] += 1
    return out


group_max.launches = 0
group_max.shapes = Counter()

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

The min-scale kernel has a second addressing, :func:`group_min_scale_gather`,
which the annealing engine calls: it reads each group's sub-matrix in place
from the ``(n, n)`` bandwidth table through the permutation, and folds each
permutation row's group scales into ``max(., 1.0)`` — one launch for what
was a gather, the sub-form kernel, ``amax`` and ``clamp_min``, and no
``sub`` in device memory.  It counts in ``group_min_scale.launches``.
``group_max`` has a gather form too, :func:`group_max_gather`, which the
tiered score calls: it reads each stage's member slowdowns through the
permutation, multiplies each stage's maximum by its stage weight and folds
the row's maximum — one launch for what was a gather, the row-max kernel, a
multiply and ``amax``.  It counts in ``group_max.launches``.

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
from ._build import refuse_grad

#: Why the group reduces refuse a tensor that requires a gradient.
NO_BACKWARD = "the planner's score is never differentiated"

_DTYPES = {torch.float64: "f64", torch.float32: "f32"}
_GATHER_FNS = {dt: f"group_min_scale_gather_{s}" for dt, s in _DTYPES.items()}
_MAX_GATHER_FNS = {dt: f"group_max_gather_{s}" for dt, s in _DTYPES.items()}


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
    if sub.requires_grad:
        refuse_grad("group_min_scale", NO_BACKWARD, sub)
    lead = sub.shape[:-2]
    out = torch.empty(lead, dtype=sub.dtype, device=sub.device)
    n_groups = out.numel()
    if n_groups:
        _launch(f"group_min_scale_{suffix}", sub.get_device(), sub.data_ptr(),
                float(ref_bw), out.data_ptr(), n_groups,
                sub.shape[-1] * sub.shape[-2])
        group_min_scale.launches += 1
        group_min_scale.shapes[tuple(sub.shape)] += 1
    return out


#: Number of kernel launches made by the wrappers of either addressing (never
#: the plain versions), and the same count split by the input's shape as the
#: caller gave it: ``sub.shape`` for the sub form,
#: ``("gather", rows, width, n_tab, m, inner, outer, step)`` for the gather
#: form.
group_min_scale.launches = 0
group_min_scale.shapes = Counter()


# ---------------------------------------------------------------------------
# the gather form: groups read in place through the permutation
# ---------------------------------------------------------------------------

def tp_geometry(tp: int) -> tuple:
    """``(m, inner, outer, step)`` of the TP groups of a flat permutation:
    ``perm.reshape(B, -1, tp)``."""
    return (tp, 1, tp, 1)


def cp_geometry(tp: int, cp: int) -> tuple:
    """``(m, inner, outer, step)`` of the CP groups of a flat permutation:
    ``perm.reshape(B, -1, cp, tp).transpose(2, 3).reshape(B, -1, cp)``."""
    return (cp, tp, cp * tp, tp)


def group_positions(width: int, m: int, inner: int, outer: int,
                    step: int) -> torch.Tensor:
    """``(width // m, m)`` int64 positions in a permutation row: group
    ``gi = (a, t)`` with ``a = gi // inner``, ``t = gi % inner`` has member
    ``j`` at ``a * outer + t + j * step``."""
    gi = torch.arange(width // m)
    j = torch.arange(m)
    return ((gi // inner) * outer + gi % inner)[:, None] + j[None, :] * step


def group_min_scale_gather_ref(table: torch.Tensor, perm: torch.Tensor,
                               ref_bw: float, m: int, inner: int, outer: int,
                               step: int) -> torch.Tensor:
    """Per permutation row, the largest group slowdown scale, at least 1.0.

    Args:
        table: ``(n, n)`` pairwise link bandwidths (self links ``inf``).
        perm: ``(rows, width)`` int64 permutation rows, entries in
            ``[0, n)``.
        ref_bw: scalar bandwidth the profiled time was measured at.
        m, inner, outer, step: group geometry (:func:`group_positions`;
            :func:`tp_geometry`, :func:`cp_geometry`).

    Returns:
        ``(rows,)``: ``clamp_min(amax(group_min_scale_ref(sub)), 1.0)``
        with ``sub = table[g[..., :, None], g[..., None, :]]`` for the
        members ``g`` of every group of the row — the engine's sequence.
    """
    pos = group_positions(perm.shape[1], m, inner, outer, step)
    g = perm[:, pos.to(perm.device)]
    sub = table[g[:, :, :, None], g[:, :, None, :]]
    return torch.clamp_min(group_min_scale_ref(sub, ref_bw).amax(dim=1), 1.0)


def group_min_scale_gather(table: torch.Tensor, perm: torch.Tensor,
                           ref_bw: float, m: int, inner: int, outer: int,
                           step: int) -> torch.Tensor:
    """CUDA version of :func:`group_min_scale_gather_ref` (bit-equal
    output): one launch per call, ``sub`` never materialised.

    ``table`` is ``(n, n)``, contiguous, float64 or float32; ``perm`` is
    ``(rows, width)``, contiguous int64 on the same device, and ``width`` a
    multiple of ``m`` whose groups all lie inside the row.  A CPU tensor
    goes through the plain version; a CUDA tensor launches the kernel or
    raises.
    """
    # the checks read only cheap tensor properties (no torch.device or
    # torch.Size objects on the card's path): this is called once per TP /
    # CP scale per annealing step
    if not isinstance(table, torch.Tensor) or \
            not isinstance(perm, torch.Tensor):
        raise TypeError("table and perm must be torch.Tensors")
    fn_name = _GATHER_FNS.get(table.dtype)
    if fn_name is None:
        raise TypeError(f"table must be float64 or float32, got "
                        f"{table.dtype}")
    if perm.dtype != torch.int64:
        raise TypeError(f"perm must be int64, got {perm.dtype}")
    if table.dim() != 2 or perm.dim() != 2:
        raise ValueError(f"want table (n, n) and perm (rows, width); got "
                         f"{tuple(table.shape)}, {tuple(perm.shape)}")
    n_tab, n_cols = table.shape
    rows, width = perm.shape
    if n_tab != n_cols:
        raise ValueError(f"table must be square, got {tuple(table.shape)}")
    if not (table.is_contiguous() and perm.is_contiguous()):
        raise ValueError("table and perm must be contiguous")
    if table.get_device() != perm.get_device():
        raise ValueError("table and perm lie on different devices")
    if min(m, inner, outer, step) < 1 or width < m or width % m \
            or (width // m) % inner \
            or (width // m // inner - 1) * outer + inner - 1 \
            + (m - 1) * step >= width or max(rows, width) >= 2 ** 31:
        raise ValueError(f"group geometry m={m}, inner={inner}, "
                         f"outer={outer}, step={step} does not tile a row "
                         f"of width {width}")
    if not table.is_cuda:
        if table.device.type != "cpu":
            raise ValueError(f"unsupported device {table.device}")
        return group_min_scale_gather_ref(table, perm, ref_bw, m, inner,
                                          outer, step)
    if table.requires_grad:
        refuse_grad("group_min_scale_gather", NO_BACKWARD, table)
    out = table.new_empty(rows)
    if rows:
        _launch(fn_name, table.get_device(), table.data_ptr(), n_tab,
                perm.data_ptr(), rows, width, float(ref_bw), out.data_ptr(),
                width // m, m, inner, outer, step)
        group_min_scale.launches += 1
        group_min_scale.shapes["gather", rows, width, n_tab, m, inner, outer,
                               step] += 1
    return out


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
    if not vals.is_cuda:
        if vals.device.type != "cpu":
            raise ValueError(f"unsupported device {vals.device}")
        return group_max_ref(vals)
    if vals.requires_grad:
        refuse_grad("group_max", NO_BACKWARD, vals)
    shape = vals.shape
    out = vals.new_empty(shape[:-1])
    n_rows = out.numel()
    if n_rows:
        _launch(f"group_max_{suffix}", vals.get_device(), vals.data_ptr(),
                out.data_ptr(), n_rows, shape[-1])
        group_max.launches += 1
        group_max.shapes[shape] += 1
    return out


#: Number of kernel launches made by the wrappers of either form (never the
#: plain versions), and the same count split by input: ``vals.shape`` for
#: :func:`group_max`, ``("gather", rows, pp, nc, n)`` for
#: :func:`group_max_gather`.
group_max.launches = 0
group_max.shapes = Counter()


# ---------------------------------------------------------------------------
# the gather form: stage members read through the permutation
# ---------------------------------------------------------------------------

def group_max_gather_ref(slow: torch.Tensor, perm: torch.Tensor,
                         cw: torch.Tensor, nc: int) -> tuple:
    """Per permutation row, the weighted per-stage compute slowdowns and
    their maximum.

    Args:
        slow: ``(n,)`` per-GPU compute slowdowns.
        perm: ``(rows, pp * nc)`` int64 permutation rows, entries in
            ``[0, n)``; stage ``s`` is ``perm[:, s * nc:(s + 1) * nc]``.
        cw: ``(rows, pp)`` stage weights, of ``slow``'s type.
        nc: members per stage.

    Returns:
        ``(c_x, c_max)``: ``c_x = cw * group_max_ref(slow[perm.reshape(rows,
        pp, nc)])`` ``(rows, pp)`` and ``c_max = c_x.amax(dim=1)``
        ``(rows,)`` — the engine's sequence.
    """
    c_x = cw * group_max_ref(slow[perm.reshape(cw.shape[0], cw.shape[1],
                                               nc)])
    return c_x, c_x.amax(dim=1)


def group_max_gather(slow: torch.Tensor, perm: torch.Tensor,
                     cw: torch.Tensor, nc: int) -> tuple:
    """CUDA version of :func:`group_max_gather_ref` (bit-equal outputs):
    one launch per call, the gathered slowdowns never materialised.

    ``slow`` is ``(n,)`` and ``cw`` ``(rows, pp)``, both of one type
    (float64 or float32); ``perm`` is ``(rows, pp * nc)`` int64; all
    contiguous and on one device.  A CPU tensor goes through the plain
    version; a CUDA tensor launches the kernel or raises.
    """
    if not (isinstance(slow, torch.Tensor) and isinstance(perm, torch.Tensor)
            and isinstance(cw, torch.Tensor)):
        raise TypeError("slow, perm and cw must be torch.Tensors")
    fn_name = _MAX_GATHER_FNS.get(slow.dtype)
    if fn_name is None or cw.dtype is not slow.dtype:
        raise TypeError(f"slow and cw must be both float64 or both float32, "
                        f"got {slow.dtype} and {cw.dtype}")
    if perm.dtype is not torch.int64:
        raise TypeError(f"perm must be int64, got {perm.dtype}")
    if slow.dim() != 1 or perm.dim() != 2 or cw.dim() != 2:
        raise ValueError(f"want slow (n,), perm (rows, width) and cw (rows, "
                         f"pp); got {tuple(slow.shape)}, "
                         f"{tuple(perm.shape)}, {tuple(cw.shape)}")
    rows, width = perm.shape
    pp = cw.shape[1]
    n = slow.shape[0]
    if nc < 1 or pp < 1 or n < 1 or width != pp * nc \
            or cw.shape[0] != rows or max(rows, width) >= 2 ** 31:
        raise ValueError(f"{pp} stages of nc={nc} members do not tile "
                         f"permutation rows {tuple(perm.shape)} with stage "
                         f"weights {tuple(cw.shape)} over {n} slowdowns")
    if not (slow.is_contiguous() and perm.is_contiguous()
            and cw.is_contiguous()):
        raise ValueError("slow, perm and cw must be contiguous")
    index = perm.get_device()
    if slow.get_device() != index or cw.get_device() != index:
        raise ValueError("slow, perm and cw lie on different devices")
    if not perm.is_cuda:
        if perm.device.type != "cpu":
            raise ValueError(f"unsupported device {perm.device}")
        return group_max_gather_ref(slow, perm, cw, nc)
    if slow.requires_grad or cw.requires_grad:
        refuse_grad("group_max_gather", NO_BACKWARD, slow, cw)
    c_x = torch.empty_like(cw)
    c_max = cw.new_empty(rows)
    if rows:
        _launch(fn_name, index, slow.data_ptr(), perm.data_ptr(),
                cw.data_ptr(), c_x.data_ptr(), c_max.data_ptr(), rows, pp,
                nc)
        group_max.launches += 1
        group_max.shapes["gather", rows, pp, nc, n] += 1
    return c_x, c_max

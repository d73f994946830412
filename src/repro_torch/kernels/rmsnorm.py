"""RMSNorm kernel of the model stack, with its plain versions.

``rmsnorm`` replaces the Pallas kernel ``rmsnorm`` (``_kernel``) of the JAX
package's ``kernels/rmsnorm.py``.  It is CUDA C++ (``csrc/rmsnorm.cu``): one
block per row, a float32 sum of squares folded with warp shuffles, then
``(x * rsqrt(mean + eps)) * w`` written in ``x``'s type.  It is bound by
bytes — each element is read and written once and takes four operations —
and the design only streams rows, in 16-byte packs where the row allows:
no row count has to divide a block, and a ragged count needs no masking
because every row is its own block.

The kernel has a second form, :func:`add_rmsnorm`, which the model's
residual stream goes through: ``s = x + r`` in ``x``'s type, stored, and
``rmsnorm(s)``, in one launch where an ATen add and the norm were two.
``s`` is bit-equal to PyTorch's ``x + r`` (float32 add, one rounding to
``x``'s type).  It counts in ``rmsnorm.launches``.

The plain versions (``*_ref``) compute the same functions in the order of
the reference (``models/layers.py::rms_norm``).  The kernel's sum runs in
another order and ``rsqrtf`` is within 2 ulp, so the norms agree to float32
rounding, not bit for bit.  A wrapper takes the plain version only for a
tensor that lies on the CPU; for a CUDA tensor it launches the kernel or
raises.  The wrappers' checks read only cheap tensor properties (no
``torch.device`` objects on the card's path): a decode step calls them
once per norm.
"""
from __future__ import annotations

from collections import Counter

import torch

from ._build import launch

#: Type code of the kernel: bit 0 for a bfloat16 ``x``, bit 1 for a
#: bfloat16 ``w``.
_X_CODE = {torch.float32: 0, torch.bfloat16: 1}
_W_CODE = {torch.float32: 0, torch.bfloat16: 2}


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x**2, -1) + eps) * w`` in float32, cast back to
    ``x.dtype``.  ``x`` is ``(..., d)``, ``w`` is ``(d,)``."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def add_rmsnorm_ref(x: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                    eps: float = 1e-5) -> tuple:
    """``(s, rmsnorm_ref(s, w, eps))`` with ``s = x + r``."""
    s = x + r
    return s, rmsnorm_ref(s, w, eps)


def _types(x, w) -> int:
    """The kernel's type code of ``x`` and ``w``; raises ``TypeError`` for
    anything else than float32 / bfloat16 tensors."""
    if not (isinstance(x, torch.Tensor) and isinstance(w, torch.Tensor)):
        raise TypeError(f"x and w must be torch.Tensors, got {type(x)!r} "
                        f"and {type(w)!r}")
    cx, cw = _X_CODE.get(x.dtype), _W_CODE.get(w.dtype)
    if cx is None or cw is None:
        raise TypeError(f"x and w must be float32 or bfloat16, got "
                        f"{x.dtype} and {w.dtype}")
    return cx | cw


def _width(shape, x, w) -> tuple:
    """``(d, index)``: the last axis of ``x`` (of shape ``shape``), which
    ``w`` must match, and the device index of both (-1 on the CPU); raises
    ``ValueError`` on a shape or device the kernel does not take."""
    d = shape[-1] if shape else 0
    if d < 1 or w.dim() != 1 or w.shape[0] != d:
        raise ValueError(f"rmsnorm needs x (..., d) and w (d,), d >= 1; got "
                         f"{tuple(shape)} and {tuple(w.shape)}")
    index = x.get_device()
    if w.get_device() != index:
        raise ValueError(f"x is on {x.device}, w on {w.device}")
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return d, index


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """CUDA version of :func:`rmsnorm_ref` (float32 and bfloat16, any mix of
    the two for ``x`` and ``w``).

    A non-contiguous ``x`` (the model's last-position slice ``x[:, -1:]``)
    is copied to a contiguous one first: the kernel reads rows of unit
    stride.  A CPU tensor goes through the plain version; a CUDA tensor
    launches the kernel or raises.
    """
    types = _types(x, w)
    shape = x.shape
    d, index = _width(shape, x, w)
    if not x.is_cuda:
        return rmsnorm_ref(x, w, eps)
    if not x.is_contiguous():
        x = x.contiguous()
    if not w.is_contiguous():
        w = w.contiguous()
    rows = x.numel() // d
    if rows >= 2 ** 31:
        raise ValueError(f"rmsnorm takes fewer than 2^31 rows, got {rows}")
    out = torch.empty_like(x)
    if rows:
        launch("rmsnorm_fwd", index, x.data_ptr(), w.data_ptr(),
               out.data_ptr(), rows, d, eps, types)
        rmsnorm.launches += 1
        rmsnorm.shapes[shape, x.dtype, w.dtype] += 1
    return out


def add_rmsnorm(x: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-5) -> tuple:
    """CUDA version of :func:`add_rmsnorm_ref`: returns ``(s, y)`` with
    ``s = x + r`` (bit-equal to PyTorch's add) and ``y = rmsnorm(s, w,
    eps)``, both new tensors.

    ``x`` and ``r`` must have one type (float32 or bfloat16) and one shape,
    and be contiguous: nothing is promoted or copied on the way.  ``w``
    may be of either type.  A CPU tensor goes through the plain version; a
    CUDA tensor launches the kernel or raises.
    """
    types = _types(x, w)
    if not isinstance(r, torch.Tensor) or r.dtype is not x.dtype:
        raise TypeError(f"r must be a tensor of x's type {x.dtype}, got "
                        f"{getattr(r, 'dtype', type(r))}")
    shape = x.shape
    if r.shape != shape:
        raise ValueError(f"x and r differ in shape: {tuple(shape)} and "
                         f"{tuple(r.shape)}")
    d, index = _width(shape, x, w)
    if not (x.is_contiguous() and r.is_contiguous()):
        raise ValueError("add_rmsnorm needs contiguous x and r")
    if r.get_device() != index:
        raise ValueError(f"r is on {r.device}, x on {x.device}")
    if not x.is_cuda:
        return add_rmsnorm_ref(x, r, w, eps)
    if not w.is_contiguous():
        w = w.contiguous()
    rows = x.numel() // d
    if rows >= 2 ** 31:
        raise ValueError(f"rmsnorm takes fewer than 2^31 rows, got {rows}")
    s = torch.empty_like(x)
    y = torch.empty_like(x)
    if rows:
        launch("add_rmsnorm_fwd", index, x.data_ptr(), r.data_ptr(),
               w.data_ptr(), s.data_ptr(), y.data_ptr(), rows, d, eps, types)
        rmsnorm.launches += 1
        rmsnorm.shapes["add", shape, x.dtype, w.dtype] += 1
    return s, y


#: Number of kernel launches made by either wrapper (never the plain
#: versions), and the same count split by input: ``(x.shape, x.dtype,
#: w.dtype)`` for :func:`rmsnorm`, ``("add", x.shape, x.dtype, w.dtype)``
#: for :func:`add_rmsnorm`.
rmsnorm.launches = 0
rmsnorm.shapes = Counter()

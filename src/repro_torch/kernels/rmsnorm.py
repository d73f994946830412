"""RMSNorm kernel of the model stack, with its plain version.

``rmsnorm`` replaces the Pallas kernel ``rmsnorm`` (``_kernel``) of the JAX
package's ``kernels/rmsnorm.py``.  It is CUDA C++ (``csrc/rmsnorm.cu``): one
block per row, a float32 sum of squares folded with warp shuffles, then
``(x * rsqrt(mean + eps)) * w`` written in ``x``'s type.  It is bound by
bytes — each element is read and written once and takes four operations —
and the design only streams rows: no row count has to divide a block, and a
ragged count needs no masking because every row is its own block.

The plain version :func:`rmsnorm_ref` computes the same function in the
order of the reference (``models/layers.py::rms_norm``).  The kernel's sum
runs in another order and ``rsqrtf`` is within 2 ulp, so the two agree to
float32 rounding, not bit for bit.  A wrapper takes the plain version only
for a tensor that lies on the CPU; for a CUDA tensor it launches the kernel
or raises.
"""
from __future__ import annotations

from collections import Counter

import torch

from ._build import launch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x**2, -1) + eps) * w`` in float32, cast back to
    ``x.dtype``.  ``x`` is ``(..., d)``, ``w`` is ``(d,)``."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """CUDA version of :func:`rmsnorm_ref` (float32 and bfloat16, any mix of
    the two for ``x`` and ``w``).

    A non-contiguous ``x`` (the model's last-position slice ``x[:, -1:]``)
    is copied to a contiguous one first: the kernel reads rows of unit
    stride.  A CPU tensor goes through the plain version; a CUDA tensor
    launches the kernel or raises.
    """
    for name, t in (("x", x), ("w", w)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)!r}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
    if x.dim() < 1 or w.shape != (x.shape[-1],) or x.shape[-1] < 1:
        raise ValueError(f"rmsnorm needs x (..., d) and w (d,), d >= 1; got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(f"x is on {x.device}, w on {w.device}")
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    w = w.contiguous()
    out = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d
    if rows >= 2 ** 31:
        raise ValueError(f"rmsnorm takes fewer than 2^31 rows, got {rows}")
    if rows:
        launch("rmsnorm_fwd", x, x.data_ptr(), w.data_ptr(), out.data_ptr(),
               rows, d, float(eps), _DTYPES[x.dtype], _DTYPES[w.dtype])
        rmsnorm.launches += 1
        rmsnorm.shapes[(tuple(x.shape), str(x.dtype), str(w.dtype))] += 1
    return out


#: Number of kernel launches made by the wrapper (never the plain version),
#: and the same count split by (input shape, x dtype, w dtype).
rmsnorm.launches = 0
rmsnorm.shapes = Counter()

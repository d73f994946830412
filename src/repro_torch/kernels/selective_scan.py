"""Mamba1 selective-scan kernel of the model stack, with its plain version.

``selective_scan`` replaces the Pallas kernel ``selective_scan``
(``_kernel``) of the JAX package's ``kernels/selective_scan.py``: the
recurrence ``h = exp(dt * A) * h + (dt * x) * B``, ``y = sum_N h * C``
over the sequence.  It is CUDA C++ (``csrc/selective_scan.cu``): one thread
per (batch, channel) holds its ``N`` state values in registers and walks the
sequence in order, so the ``(B, S, D, N)`` trajectory never reaches device
memory — the point of the Pallas kernel.  It is bound by bytes (one read of
``x, dt, B, C``, one write of ``y``); the design overlaps the loads of 16
steps at a time and keeps every access coalesced across channels.

The kernel takes the batch and time strides of ``x, dt, B, C`` (each must
have a unit-stride last axis), so the model's ``dt, B, C`` — column slices
of one projection — go in without a copy.  ``N`` is at most 16 (Mamba1's
state size).

The plain version :func:`selective_scan_ref` is the time-major recurrence of
``selective_scan_ref`` in the JAX package's ``kernels/ref.py``, with an
optional initial state.  A wrapper takes the plain version only for a tensor
that lies on the CPU; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import torch

from ._build import launch

N_MAX = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                       C: torch.Tensor, A: torch.Tensor,
                       h0: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-major recurrence in float32.

    ``x, dt`` are ``(b, S, D)``, ``B, C`` are ``(b, S, N)``, ``A`` is
    ``(D, N)``, ``h0`` is ``(b, D, N)`` or None (zeros).  Returns ``y``
    ``(b, S, D)`` and the final state ``(b, D, N)``, both float32.
    """
    xf, dtf, Bf, Cf, Af = (t.float() for t in (x, dt, B, C, A))
    b, s, d = x.shape
    h = (torch.zeros((b, d, A.shape[-1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    ys = []
    for t in range(s):
        a = torch.exp(dtf[:, t, :, None] * Af)                  # (b, D, N)
        h = a * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    return torch.stack(ys, dim=1), h


def _check(x, dt, B, C, A, h0) -> None:
    named = [("x", x), ("dt", dt), ("B", B), ("C", C), ("A", A)]
    if h0 is not None:
        named.append(("h0", h0))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)!r}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in named[:4]:
        if t.dtype != x.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"x, dt, B, C must share one type, float32 or "
                            f"bfloat16; {name} is {t.dtype}")
        if t.dim() != 3 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be 3-D with a unit-stride last "
                             f"axis, got shape {tuple(t.shape)} strides "
                             f"{t.stride()}")
    for name, t in named[4:]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    b, s, d = x.shape
    n = A.shape[-1] if A.dim() == 2 else -1
    if (dt.shape != x.shape or B.shape != (b, s, n) or C.shape != B.shape
            or A.shape != (d, n)
            or (h0 is not None and h0.shape != (b, d, n))):
        raise ValueError(
            f"want x, dt (b,S,D), B, C (b,S,N), A (D,N), h0 (b,D,N); got "
            f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(B.shape)}, "
            f"{tuple(C.shape)}, {tuple(A.shape)}, "
            f"{None if h0 is None else tuple(h0.shape)}")
    if not (1 <= n <= N_MAX) or min(b, s, d) < 1 or b >= 2 ** 16 \
            or s >= 2 ** 31 or d >= 2 ** 31:
        raise ValueError(f"unsupported sizes: b {b}, S {s}, D {d}, N {n} "
                         f"(N at most {N_MAX})")


def selective_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CUDA version of :func:`selective_scan_ref`: ``x, dt, B, C`` float32
    or bfloat16 (one type for all four), ``A`` and ``h0`` float32.

    A CPU tensor goes through the plain version; a CUDA tensor launches the
    kernel or raises.
    """
    _check(x, dt, B, C, A, h0)
    if x.device.type == "cpu":
        return selective_scan_ref(x, dt, B, C, A, h0)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, s, d = x.shape
    n = A.shape[-1]
    A = A.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty((b, s, d), dtype=torch.float32, device=x.device)
    h = torch.empty((b, d, n), dtype=torch.float32, device=x.device)
    launch("selective_scan_fwd", x.get_device(), x.data_ptr(), dt.data_ptr(),
           B.data_ptr(), C.data_ptr(), A.data_ptr(),
           None if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(),
           x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
           B.stride(0), B.stride(1), C.stride(0), C.stride(1),
           b, s, d, n, _DTYPES[x.dtype])
    selective_scan.launches += 1
    selective_scan.shapes[(tuple(x.shape), n, str(x.dtype))] += 1
    return y, h


#: Number of kernel launches made by the wrapper (never the plain version),
#: and the same count split by (x shape, N, dtype).
selective_scan.launches = 0
selective_scan.shapes = Counter()

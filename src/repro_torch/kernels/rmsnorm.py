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

Training differentiates both forms through a backward kernel of the same
source (``rmsnorm_bwd``), bound by :class:`RMSNormFn` and
:class:`AddRMSNormFn`.  It is one cooperative launch of at most 128 blocks
(:data:`BWD_MAX_BLOCKS`), each owning a run of consecutive rows
(:func:`bwd_runs`): the rows stream through a ring in shared memory filled
by TMA bulk copies, so ``x``, ``dy`` and ``ds_in`` cross HBM once; each
block leaves its ``dw`` sums as one float32 partial row of a ``(blocks,
d)`` workspace, and after a grid-wide sync the blocks fold the
partial rows in block order — no atomics, so the bits repeat.  A CUDA
wrapper handed an input that requires a gradient, with grad mode on, goes
through its Function; the backward launches count in
``rmsnorm.bwd_launches``.  The JAX package has no backward kernel (it
differentiates its plain norm by autodiff); :func:`rmsnorm_bwd_ref` is the
plain version of this one.

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
from typing import Optional

import torch

from . import _meta
from ._build import launch

#: Type code of the kernel: bit 0 for a bfloat16 ``x``, bit 1 for a
#: bfloat16 ``w``.
_X_CODE = {torch.float32: 0, torch.bfloat16: 1}
_W_CODE = {torch.float32: 0, torch.bfloat16: 2}


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or as it is in float64 (which no kernel takes:
    the plain versions accept it so that their gradients can be checked
    by finite differences)."""
    return t if t.dtype == torch.float64 else t.float()


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x**2, -1) + eps) * w`` in float32, cast back to
    ``x.dtype``.  ``x`` is ``(..., d)``, ``w`` is ``(d,)``."""
    x32 = _wide(x)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * _wide(w)).to(x.dtype)


def add_rmsnorm_ref(x: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                    eps: float = 1e-5) -> tuple:
    """``(s, rmsnorm_ref(s, w, eps))`` with ``s = x + r``."""
    s = x + r
    return s, rmsnorm_ref(s, w, eps)


def rmsnorm_bwd_ref(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-5,
                    ds_in: Optional[torch.Tensor] = None) -> tuple:
    """``(dx, dw)``, the gradient of :func:`rmsnorm_ref` at ``x`` for the
    output gradient ``dy``, in float32, cast to ``x``'s and ``w``'s types.

    With ``r = rsqrt(mean(x**2) + eps)``, ``x̂ = x r`` and ``g = w dy``:
    ``dx = r (g - x̂ mean(x̂ g))`` and ``dw = sum over rows of dy x̂``.
    ``ds_in``, the gradient that reaches the norm's input from elsewhere (the
    residual stream, for the residual form's stored sum ``s``), is added to
    ``dx`` before its one rounding."""
    x32, dy32 = _wide(x), _wide(dy)
    r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    xhat = x32 * r
    g = _wide(w) * dy32
    dx = r * (g - xhat * torch.mean(xhat * g, dim=-1, keepdim=True))
    if ds_in is not None:
        dx = dx + _wide(ds_in)
    dw = (dy32 * xhat).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw.to(w.dtype)


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
    if not x.is_cuda and x.device.type not in ("cpu", "meta"):
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
        if x.is_meta:
            return _meta_rmsnorm(x, w, eps)
        return rmsnorm_ref(x, w, eps)
    if (x.requires_grad or w.requires_grad) and torch.is_grad_enabled():
        return RMSNormFn.apply(x, w, eps)
    return _rmsnorm_cuda(x, w, eps, types, d, index)


def _rows(x: torch.Tensor, d: int) -> int:
    rows = x.numel() // d
    if rows >= 2 ** 31:
        raise ValueError(f"rmsnorm takes fewer than 2^31 rows, got {rows}")
    return rows


def _rmsnorm_cuda(x, w, eps, types, d, index) -> torch.Tensor:
    """One launch of the plain form on checked CUDA tensors."""
    shape = x.shape
    if not x.is_contiguous():
        x = x.contiguous()
    if not w.is_contiguous():
        w = w.contiguous()
    rows = _rows(x, d)
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
        if x.is_meta:
            return _meta_add_rmsnorm(x, r, w, eps)
        return add_rmsnorm_ref(x, r, w, eps)
    if (x.requires_grad or r.requires_grad or w.requires_grad) \
            and torch.is_grad_enabled():
        return AddRMSNormFn.apply(x, r, w, eps)
    return _add_rmsnorm_cuda(x, r, w, eps, types, d, index)


def _add_rmsnorm_cuda(x, r, w, eps, types, d, index) -> tuple:
    """One launch of the residual form on checked CUDA tensors."""
    shape = x.shape
    if not w.is_contiguous():
        w = w.contiguous()
    rows = _rows(x, d)
    s = torch.empty_like(x)
    y = torch.empty_like(x)
    if rows:
        launch("add_rmsnorm_fwd", index, x.data_ptr(), r.data_ptr(),
               w.data_ptr(), s.data_ptr(), y.data_ptr(), rows, d, eps, types)
        rmsnorm.launches += 1
        rmsnorm.shapes["add", shape, x.dtype, w.dtype] += 1
    return s, y


#: Most blocks of the backward kernel's grid: fewer than the H100's 132
#: SMs, so that its cooperative launch finds every block resident.
BWD_MAX_BLOCKS = 128


def bwd_runs(rows: int) -> list:
    """The backward kernel's split of ``rows`` rows over its blocks, as
    ``norm_bwd`` computes it from ``(rows, blocks)``: ``[(start, stop),
    ...]`` for ``blocks = min(rows, BWD_MAX_BLOCKS)`` blocks, each a run of
    ``rows // blocks`` consecutive rows, the first ``rows % blocks`` runs
    one row longer.  The split depends on the shape alone, never on the
    card, so the weight gradient's order of sums (and its bits) does not
    either."""
    blocks = min(rows, BWD_MAX_BLOCKS)
    base, extra = divmod(rows, blocks)
    starts = [b * base + min(b, extra) for b in range(blocks + 1)]
    return list(zip(starts[:-1], starts[1:]))


def _rmsnorm_bwd_cuda(x, w, dy, eps, ds_in, key) -> tuple:
    """One launch of the backward kernel: ``(dx, dw)`` for the norm's input
    ``x`` (contiguous, on the card), counted under the shape key ``key``."""
    types = _types(x, w)
    d = x.shape[-1]
    dy = dy.contiguous()
    if ds_in is not None:
        ds_in = ds_in.contiguous()
    if not w.is_contiguous():
        w = w.contiguous()
    rows = _rows(x, d)
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    if not rows:
        return dx, dw.zero_()
    blocks = min(rows, BWD_MAX_BLOCKS)     # as bwd_runs splits the rows
    # one float32 partial row of dw sums a block
    work = torch.empty(blocks * d, dtype=torch.float32, device=x.device)
    launch("rmsnorm_bwd", x.get_device(), x.data_ptr(), w.data_ptr(),
           dy.data_ptr(), None if ds_in is None else ds_in.data_ptr(),
           dx.data_ptr(), dw.data_ptr(), work.data_ptr(), rows, d, eps,
           types, blocks)
    rmsnorm.bwd_launches += 1
    rmsnorm.shapes[key] += 1
    return dx, dw


def _bwd(x, w, dy, eps, ds_in, key) -> tuple:
    """The backward kernel on the card, its plain version on the CPU, its
    shapes on the meta device (its bound's 11 operations an element, 12
    with ``ds_in``)."""
    if x.is_cuda:
        return _rmsnorm_bwd_cuda(x, w, dy, eps, ds_in, key)
    if x.is_meta:
        dx, dw = torch.empty_like(x), torch.empty_like(w)
        _meta.account("rmsnorm_bwd", (11 if ds_in is None else 12)
                      * x.numel(), (x, w, dy, ds_in), (dx, dw))
        return dx, dw
    return rmsnorm_bwd_ref(x, w, dy, eps, ds_in)


def _meta_rmsnorm(x, w, eps):
    """:func:`rmsnorm` on meta tensors: its Function under a gradient,
    else the output's shape, counted as its bound counts the kernel (4
    operations an element)."""
    if (x.requires_grad or w.requires_grad) and torch.is_grad_enabled():
        return RMSNormFn.apply(x, w, eps)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _meta.account("rmsnorm", 4 * x.numel(), (x, w), (y,))
    return y


def _meta_add_rmsnorm(x, r, w, eps):
    """:func:`add_rmsnorm` on meta tensors (5 operations an element)."""
    if (x.requires_grad or r.requires_grad or w.requires_grad) \
            and torch.is_grad_enabled():
        return AddRMSNormFn.apply(x, r, w, eps)
    s, y = torch.empty_like(x), torch.empty_like(x)
    _meta.account("rmsnorm", 5 * x.numel(), (x, r, w), (s, y))
    return s, y


class RMSNormFn(torch.autograd.Function):
    """:func:`rmsnorm` with its gradient: the forward kernel, then the
    backward kernel on the saved input (``r`` is recomputed there, in the
    forward's order).  On the CPU both sides are the plain versions,
    so the Function itself can be tested there."""

    @staticmethod
    def forward(ctx, x, w, eps):
        if x.is_cuda:
            x = x.contiguous()
            y = _rmsnorm_cuda(x, w, eps, _types(x, w), x.shape[-1],
                              x.get_device())
        elif x.is_meta:
            y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
            _meta.account("rmsnorm", 4 * x.numel(), (x, w), (y,))
        else:
            y = rmsnorm_ref(x, w, eps)
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _bwd(x, w, dy, ctx.eps, None,
                      ("bwd", x.shape, x.dtype, w.dtype))
        return dx, dw, None


class AddRMSNormFn(torch.autograd.Function):
    """:func:`add_rmsnorm` with its gradient.  The stored sum ``s`` is saved;
    its gradient from the residual stream (``ds``) enters the backward
    kernel as ``ds_in``, and ``dx = dr`` is the total gradient of ``s``."""

    @staticmethod
    def forward(ctx, x, r, w, eps):
        if x.is_cuda:
            s, y = _add_rmsnorm_cuda(x, r, w, eps, _types(x, w), x.shape[-1],
                                     x.get_device())
        elif x.is_meta:
            s, y = torch.empty_like(x), torch.empty_like(x)
            _meta.account("rmsnorm", 5 * x.numel(), (x, r, w), (s, y))
        else:
            s, y = add_rmsnorm_ref(x, r, w, eps)
        ctx.save_for_backward(s, w)
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        return s, y

    @staticmethod
    def backward(ctx, ds, dy):
        s, w = ctx.saved_tensors
        if dy is None:                    # only the sum was used
            return ds, ds, torch.zeros_like(w), None
        dx, dw = _bwd(s, w, dy, ctx.eps, ds,
                      ("add_bwd", s.shape, s.dtype, w.dtype, ds is not None))
        return dx, dx, dw, None


#: Number of forward kernel launches made by either wrapper (never the
#: plain versions), of backward launches (``bwd_launches``), and the same
#: counts split by input: ``(x.shape, x.dtype, w.dtype)`` for
#: :func:`rmsnorm`, ``("add", x.shape, x.dtype, w.dtype)`` for
#: :func:`add_rmsnorm`, ``("bwd", ...)`` and ``("add_bwd", ..., ds_in
#: given)`` for the backward of each.
rmsnorm.launches = 0
rmsnorm.bwd_launches = 0
rmsnorm.shapes = Counter()

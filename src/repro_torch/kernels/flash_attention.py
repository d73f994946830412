"""Flash-attention kernel of the model stack, with its plain version.

``flash_attention`` replaces the Pallas kernel ``flash_attention``
(``_kernel``) of the JAX package's ``kernels/flash_attention.py``: causal or
sliding-window softmax attention with grouped KV heads, forward only.  It is
CUDA C++ (``csrc/flash_attention.cu``), two kernels picked by the inputs'
type, both counted in ``flash_attention.launches``:

- bfloat16 (the model's type) runs on the tensor cores, in the manner of
  FlashAttention-2: one block of four warps per (64 query rows, head,
  batch), Q fragments held in registers, K and V tiles of 64 keys through a
  two-stage ``cp.async`` ring in swizzled shared memory, ``S = Q K^T`` and
  ``O += P V`` as ``mma.sync`` m16n8k16 products with float32 accumulators,
  and the online softmax on the accumulator fragments.  P is rounded to
  bfloat16 for ``P V`` while the row sums use the float32 weights; the
  error against the float32 plain version stays well inside the reference's
  bfloat16 tolerance of 2e-2.  16-byte copies need every row 16-byte
  aligned: the wrapper raises ``ValueError`` on a bfloat16 tensor whose
  pointer or whose batch, head or sequence stride is not a multiple of 8
  elements (the model's tensors always are).
- float32 stays on the CUDA cores, since tensor cores would mean TF32,
  which breaks the float32 tolerance of 2e-5: one block of 128 threads per
  (64 query rows, head, batch), K and V tiles through the same kind of
  ``cp.async`` ring, and both products as register-tiled outer products
  of ``fmaf`` (a thread owns 4 rows x 8 keys of ``S`` and the matching
  rows x columns of ``O``; ``P`` passes once through shared memory).  It
  takes a row of any alignment: 16-byte copies where every row is
  16-byte aligned, else 4-byte ones, picked at launch.

Both: a loop over key tiles in place of the TPU's sequential grid axis,
online softmax with the running maximum and sum in float32, GQA by indexing
(head ``h`` reads KV head ``h // (H // KV)``; no repeated KV is written),
and key tiles that no row of the block may see skipped.  Unlike the Pallas
wrapper, no length has to be a multiple of a block: the ragged tails of
``Sq`` and ``Sk`` are masked.  The kernels take the batch, head and
sequence strides of each tensor (the head dimension must have unit stride),
so the model hands them transposed views of its ``(B, S, H, D)``
activations without a copy, and the output keeps ``q``'s stride order.

Training differentiates it through :class:`FlashAttentionFn`: the forward
kernel also writes each row's log-sum-exp (``lse``, float32 ``(B, H, Sq)``,
``+inf`` for a row with no allowed key), and a backward kernel of the same
source recomputes ``P = exp(S - lse)`` and returns ``dq, dk, dv``, in the
manner of FlashAttention-2's backward (``delta = rowsum(dO O)``, a pass
for ``dK, dV`` and one for ``dQ``), with no atomics, so the bits repeat:

- in both types the ``dK, dV`` pass has one block per (key tile, query
  head, batch), so a KV group's heads run in parallel; with more than one
  head a group each block writes its head's float32 partials into a
  workspace ``(2, B, H, Sk, D)`` that this wrapper allocates, and a fold
  pass sums them in head order (and, for bfloat16, rounds once).
- bfloat16 runs on the tensor cores.  ``P`` and ``dS`` are rounded to
  bfloat16 as product operands; everything else is float32.  Rows of
  ``q``, ``k``, ``v`` must be 16-byte aligned (``ValueError`` otherwise);
  an ``out`` or ``dout`` whose rows are not is copied.
- float32 stays on the CUDA cores, all float32 inside, with the forward's
  register-tiled outer products and its row alignment rule.

The JAX package has no backward kernel; :func:`flash_attention_bwd_ref` is
this one's plain version.  A CUDA wrapper handed an input that requires a
gradient, with grad mode on, goes through the Function; its backward
launches count in ``flash_attention.bwd_launches``.

The plain version :func:`flash_attention_ref` is ``attention_ref`` of the
JAX package's ``kernels/ref.py`` with the Pallas kernel's one difference: a
row whose keys are all masked is 0, not the mean of V.  A wrapper takes the
plain version only for a tensor that lies on the CPU; for a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

from collections import Counter

import torch

from . import _meta
from ._build import launch

NEG_INF = -1e30
#: Head dims the CUDA kernels take (``by_head_dim`` in the source); 136
#: runs a 144-wide instance whose last 8 columns are zero-filled on load
#: and skipped on store
HEAD_DIMS = (16, 32, 64, 96, 112, 128, 136, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _allowed(sq: int, sk: int, causal: bool, window: int,
             device, q_offset: int = 0) -> torch.Tensor:
    """(sq, sk) mask of the keys each query row may see; row ``i`` sits at
    position ``q_offset + i``."""
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok &= q_pos >= k_pos
    if window > 0:
        ok &= q_pos - k_pos < window
    return ok


def allowed_pairs(sq: int, sk: int, causal: bool, window: int,
                  q_offset: int = 0) -> int:
    """The number of (query, key) pairs :func:`_allowed` lets through,
    counted row by row without making the mask."""
    import numpy as np
    pos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(pos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros(sq)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _meta_ops(q, k, causal, window, q_offset, per_pair: int) -> int:
    """``per_pair * B * H * D * pairs``: the bound's operations (4 a pair
    forward, 10 backward)."""
    b, h, sq, d = q.shape
    return per_pair * b * h * d * allowed_pairs(sq, k.shape[2], causal,
                                                window, q_offset)


def _meta_attention(q, k, v, causal, window, q_offset):
    """:func:`flash_attention` on meta tensors: its Function under a
    gradient, else the output's shape, counted as the kernel's bound."""
    if (q.requires_grad or k.requires_grad or v.requires_grad) \
            and torch.is_grad_enabled():
        return FlashAttentionFn.apply(q, k, v, bool(causal), window,
                                      q_offset)
    out = torch.empty_like(q)
    _meta.account("flash_attention",
                  _meta_ops(q, k, causal, window, q_offset, 4), (q, k, v),
                  (out,))
    return out


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or as it is in float64 (which no kernel takes:
    the plain versions accept it so that their gradients can be checked
    by finite differences)."""
    return t if t.dtype == torch.float64 else t.float()


def _scores(q, k, causal, window, q_offset=0):
    """``(s, ok)``: the scaled float32 scores ``(B, KV, G, Sq, Sk)`` (masked
    ones ``NEG_INF``) and the ``(Sq, Sk)`` mask, as the reference makes
    them (``q`` scaled first)."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    qf = _wide(q).reshape(b, kv, h // kv, sq, d) * (1.0 / (d ** 0.5))
    s = torch.einsum("bkgqd,bkcd->bkgqc", qf, _wide(k))
    ok = _allowed(sq, sk, causal, window, q.device, q_offset)
    return torch.where(ok, s, torch.full_like(s, NEG_INF)), ok


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        return_lse: bool = False, q_offset: int = 0):
    """O(S^2)-memory softmax attention in float32.

    ``q`` is ``(B, H, Sq, D)``, ``k`` and ``v`` are ``(B, KV, Sk, D)``;
    query row ``i`` sits at position ``q_offset + i`` (the reference's
    ``chunked_attention(q_offset=)``), key ``j`` at ``j``; the
    scale is ``1/sqrt(D)``; the result is ``(B, H, Sq, D)`` in ``q``'s type,
    with 0 in every row that has no allowed key.  With ``return_lse`` also
    each row's log-sum-exp of its scaled scores over the allowed keys,
    float32 ``(B, H, Sq)``, ``+inf`` for a row with none (as the kernel
    writes it for the backward).
    """
    b, h, sq, d = q.shape
    s, ok = _scores(q, k, causal, window, q_offset)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bkcd->bkgqd", p, _wide(v))
    o = torch.where(ok.any(dim=-1)[:, None], o, torch.zeros_like(o))
    out = o.reshape(b, h, sq, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(ok.any(dim=-1), torch.logsumexp(s, dim=-1),
                      torch.full((), float("inf"), device=q.device))
    return out, lse.reshape(b, h, sq)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                            window: int = 0, q_offset: int = 0) -> tuple:
    """``(dq, dk, dv)`` of :func:`flash_attention_ref` by the explicit
    formulas of the backward kernel, in float32, each cast to its input's
    type: ``P = exp(S - lse)`` on the allowed keys (0 elsewhere, and in a
    row with none, whose ``lse`` is ``+inf``), ``delta = rowsum(dO O)``,
    ``dV = P^T dO``, ``dS = P (dO V^T - delta)``, ``dQ = dS K scale`` and
    ``dK = dS^T Q scale``, ``dK`` and ``dV`` summed over a KV group's
    heads.  ``out`` is the forward's output as stored; query row ``i`` sits
    at position ``q_offset + i``."""
    b, h, sq, d = q.shape
    kv = k.shape[1]
    g = h // kv
    scale = 1.0 / (d ** 0.5)
    s, ok = _scores(q, k, causal, window, q_offset)
    lse5 = lse.to(s.dtype).reshape(b, kv, g, sq, 1)
    p = torch.where(ok, torch.exp(s - lse5), torch.zeros_like(s))
    do = _wide(dout).reshape(b, kv, g, sq, d)
    delta = (do * _wide(out).reshape(b, kv, g, sq, d)).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqc,bkgqd->bkcd", p, do)
    dp = torch.einsum("bkgqd,bkcd->bkgqc", do, _wide(v))
    ds = p * (dp - delta)
    dq = torch.einsum("bkgqc,bkcd->bkgqd", ds, _wide(k)) * scale
    dk = torch.einsum("bkgqc,bkgqd->bkcd", ds, _wide(q).reshape(
        b, kv, g, sq, d)) * scale
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check(q, k, v, window, q_offset=0) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)!r}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit-stride head dimension")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v differ in type: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"want q (B,H,Sq,D), k and v (B,KV,Sk,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    kv, sk = k.shape[1], k.shape[2]
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    if min(b, h, sq, sk, d) < 1:
        raise ValueError(f"empty sizes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be at least 0, got {q_offset}")


def _check_kernel(q, k, v, window, q_offset=0) -> None:
    """The limits of the CUDA kernels alone (the plain versions take any
    head dim and size): a head dim of :data:`HEAD_DIMS`, lengths, the
    window and the last query's position below 2**31, batch and heads
    below 2**16, and for bfloat16 every row of q, k, v 16-byte aligned."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if max(sq, sk, window, q_offset + sq) >= 2 ** 31 or b >= 2 ** 16 \
            or h >= 2 ** 16:
        raise ValueError(f"unsupported sizes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, window {window}, q_offset "
                         f"{q_offset}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_aligned(name, t)


def _misaligned(name: str, t: torch.Tensor):
    """Why some row of a bfloat16 tensor is not 16-byte aligned, or None:
    the pointer, and the stride of each of its batch, head and sequence
    axes longer than 1, must be a multiple of 8 elements."""
    if t.data_ptr() % 16:
        return (f"{name}: the bfloat16 kernel needs a 16-byte aligned "
                f"pointer, got offset {t.data_ptr() % 16}")
    for axis, what in enumerate(("batch", "head", "sequence")):
        if t.shape[axis] > 1 and t.stride(axis) % 8:
            return (f"{name}: the bfloat16 kernel needs a {what} stride "
                    f"that is a multiple of 8 elements, got "
                    f"{t.stride(axis)}")
    return None


def _check_aligned(name: str, t: torch.Tensor) -> None:
    """Raise ``ValueError`` unless every row of ``t`` is 16-byte aligned."""
    why = _misaligned(name, t)
    if why:
        raise ValueError(why)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """CUDA version of :func:`flash_attention_ref` (float32 or bfloat16;
    on the card the head dim is one of :data:`HEAD_DIMS`, on the CPU any).
    Query row ``i`` sits at position ``q_offset + i``: a share of a
    sequence's rows against the keys from its start (the model's
    sequence-sharded attention).

    The inputs' type picks the kernel: bfloat16 runs the tensor-core kernel
    (rows 16-byte aligned, else ``ValueError``), float32 the CUDA-core one
    (any row alignment).
    A CPU tensor goes through the plain version; a CUDA tensor launches a
    kernel or raises.
    """
    window, q_offset = int(window), int(q_offset)
    _check(q, k, v, window, q_offset)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    if q.device.type == "meta":
        return _meta_attention(q, k, v, causal, window, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_kernel(q, k, v, window, q_offset)
    if (q.requires_grad or k.requires_grad or v.requires_grad) \
            and torch.is_grad_enabled():
        return FlashAttentionFn.apply(q, k, v, bool(causal), window,
                                      q_offset)
    return _fwd_cuda(q, k, v, bool(causal), window, None, q_offset)


def _offset_key(q_offset: int) -> tuple:
    """A shape key's tail for a query offset: nothing at offset 0, so that
    the keys of whole-sequence launches keep their form."""
    return (q_offset,) if q_offset else ()


def _fwd_cuda(q, k, v, causal: bool, window: int, lse,
              q_offset: int = 0) -> torch.Tensor:
    """One launch of the forward kernel on checked CUDA tensors; writes
    each row's log-sum-exp into ``lse`` when it is given."""
    out = torch.empty_like(q)          # q's stride order when q is dense
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    launch("flash_attention_fwd", q.get_device(), q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(),
           None if lse is None else lse.data_ptr(),
           *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
           *out.stride()[:3], b, h, kv, sq, sk, d, 1.0 / (d ** 0.5),
           int(causal), window, q_offset, _DTYPES[q.dtype])
    flash_attention.launches += 1
    flash_attention.shapes[(tuple(q.shape), tuple(k.shape), causal,
                            window, str(q.dtype))
                           + _offset_key(q_offset)] += 1
    return out


def _bwd_workspace(q, k):
    """The backward's float32 ``(2, B, H, Sk, D)`` workspace (each query
    head's partial dK and dV, which the fold sums in head order) when a KV
    group has more than one head, in either type; else None."""
    b, h, _, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if h == kv:
        return None
    return torch.empty((2, b, h, sk, d), dtype=torch.float32,
                       device=q.device)


def _bwd_cuda(q, k, v, out, lse, dout, causal: bool, window: int,
              q_offset: int = 0) -> tuple:
    """One launch of the backward kernel: ``(dq, dk, dv)``, each in its
    input's shape, type and stride order.  In bfloat16, rows of ``q``,
    ``k``, ``v`` must be 16-byte aligned; ``out`` and ``dout`` are copied
    when theirs are not (or their last stride is not 1)."""
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_aligned(name, t)

    def aligned(t):
        if t.stride(-1) != 1 or bf16 and _misaligned("", t):
            return t.clone(memory_format=torch.contiguous_format)
        return t

    out, dout = aligned(out), aligned(dout)
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    work = _bwd_workspace(q, k)
    launch("flash_attention_bwd", q.get_device(), q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
           delta.data_ptr(), None if work is None else work.data_ptr(),
           dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
           *(st for t in (q, k, v, out, dout, dq, dk, dv)
             for st in t.stride()[:3]),
           b, h, kv, sq, sk, d, 1.0 / (d ** 0.5), int(causal), window,
           q_offset, _DTYPES[q.dtype])
    flash_attention.bwd_launches += 1
    flash_attention.shapes[("bwd", tuple(q.shape), tuple(k.shape), causal,
                            window, str(q.dtype))
                           + _offset_key(q_offset)] += 1
    return dq, dk, dv


#: The passes :func:`occupancy` reports, in the order of the C entry's
#: ``pass`` argument: the bfloat16 tensor-core forward, dK/dV and dQ
#: kernels, then the float32 forward and the float32 backward's one
#: kernel for dK/dV and dQ.
OCCUPANCY_PASSES = ("fwd", "dkv", "dq", "fwd_f32", "bwd_f32")


def occupancy(head_dim: int) -> dict:
    """``{pass: (dynamic shared memory bytes, blocks an SM)}`` for each of
    :data:`OCCUPANCY_PASSES` at ``head_dim`` on the current CUDA device, as
    the CUDA runtime's occupancy calculator gives them (each forward
    without its ``lse`` store).  Needs the card; launches nothing."""
    import ctypes
    from . import _build
    _build.load_library()
    out = {}
    for i, name in enumerate(OCCUPANCY_PASSES):
        smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
        rc = _build._fns["flash_attention_occupancy"](
            head_dim, i, ctypes.byref(smem), ctypes.byref(blocks))
        if rc != 0:
            raise RuntimeError(f"flash_attention_occupancy({head_dim}, "
                               f"{name}): cudaError {rc}")
        out[name] = (smem.value, blocks.value)
    return out


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` with its gradient: the forward kernel with its
    ``lse`` output, then the backward kernel on the saved ``q, k, v, out,
    lse``.  On the CPU both sides are the plain versions, so the Function
    itself can be tested there."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset=0):
        if q.is_cuda:
            b, h, sq, _ = q.shape
            lse = torch.empty((b, h, sq), dtype=torch.float32,
                              device=q.device)
            out = _fwd_cuda(q, k, v, causal, window, lse, q_offset)
        elif q.is_meta:
            b, h, sq, _ = q.shape
            out = torch.empty_like(q)
            lse = torch.empty((b, h, sq), dtype=torch.float32,
                              device=q.device)
            _meta.account("flash_attention",
                          _meta_ops(q, k, causal, window, q_offset, 4),
                          (q, k, v), (out, lse))
        else:
            out, lse = flash_attention_ref(q, k, v, causal=causal,
                                           window=window, return_lse=True,
                                           q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.is_cuda:
            dq, dk, dv = _bwd_cuda(q, k, v, out, lse, dout, ctx.causal,
                                   ctx.window, ctx.q_offset)
        elif q.is_meta:
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            _meta.account("flash_attention_bwd",
                          _meta_ops(q, k, ctx.causal, ctx.window,
                                    ctx.q_offset, 10),
                          (q, k, v, out, lse, dout), (dq, dk, dv))
        else:
            dq, dk, dv = flash_attention_bwd_ref(
                q, k, v, out, lse, dout, causal=ctx.causal, window=ctx.window,
                q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None


#: Number of forward kernel launches made by the wrapper (never the plain
#: version), of backward launches (``bwd_launches``), and the same counts
#: split by (q shape, k shape, causal, window, dtype), a backward's key
#: led by ``"bwd"``, and a launch with a query offset's key followed by
#: the offset.
flash_attention.launches = 0
flash_attention.bwd_launches = 0
flash_attention.shapes = Counter()

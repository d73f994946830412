"""Mamba1 selective-scan kernel of the model stack, with its plain versions.

``selective_scan`` replaces the Pallas kernel ``selective_scan``
(``_kernel``) of the JAX package's ``kernels/selective_scan.py``: the
recurrence ``h = exp(dt * A) * h + (dt * x) * B``, ``y = sum_N h * C``
over the sequence.  It is CUDA C++ (``csrc/selective_scan.cu``): each
channel's ``N`` states are split over four threads, which keep them in
registers and walk the sequence in order, so the ``(B, S, D, N)``
trajectory never reaches device memory — the point of the Pallas kernel.
It is bound by its ``b*S*D*N`` exponentials (the special function units'
rate), not by its bytes; the design stages the inputs of the next chunks
by ``cp.async`` while one is computed and spends one ``ex2`` and two fused
multiply-adds a state and step.

The kernel has a second form, :func:`selective_scan_fused`, which
``mamba1_block`` calls on both its branches (the sequence, and a decode
step): it takes ``dt`` before the bias and the softplus, ``A`` as
``A_log``, and the gate ``z``, and returns the gated output in ``x``'s type
— the bias add, softplus, ``-exp(A_log)``, the ``D`` skip, the gate and the
cast in the same launch as the scan, where they were some twenty ATen
launches.  It can write the final state into a given tensor, which may be
``h0`` itself (the decode cache, updated in place).  It counts in
``selective_scan.launches``.

Both take the batch and time strides of ``x, dt, B, C`` (and ``z``; each
must have a unit-stride last axis), so the model's ``dt, B, C`` — column
slices of one projection — and ``z`` — half of the input projection — go
in without a copy.  ``N`` is at most 16 (Mamba1's state size).

The plain versions (``*_ref``) are the time-major recurrence of
``selective_scan_ref`` in the JAX package's ``kernels/ref.py``, with an
optional initial state, and the ATen sequence of ``mamba1_block`` that the
fused form replaces, op for op.  A wrapper takes the plain version only for
a tensor that lies on the CPU; for a CUDA tensor it launches the kernel or
raises.

Training differentiates the fused form over a sequence through
:class:`SelectiveScanFusedFn`: on the card its forward is the fused
kernel's instance that also keeps the float32 state entering every
``BWD_CHUNK`` steps (``(b, ceil(S / 16), D, N)``, saved for the
backward; generation never launches it), and its backward a second
kernel of the same source (``selective_scan_fused_bwd``), which
recomputes the forward's states between those boundaries rather than
store the ``(b, S, D, N)`` trajectory: each block walks the chunks in
reverse, recomputes a chunk's states from its boundary with the
forward's arithmetic (the bfloat16 softplus replay, ``exp2`` of ``dt * A
* log2 e``), eight steps at a time, and runs the reverse recurrence
``dh_t = a_{t+1} dh_{t+1} + dy_t C_t`` over them.  Sums across blocks
(``dB, dC`` over the channels, ``dA_log, dD, dt_bias`` over the batch)
are float32 partials folded by a second launch in a fixed order, with no
atomics, so two launches give the same bits.  Its plain versions are
:func:`selective_scan_bounds_ref` (the boundaries) and
:func:`selective_scan_fused_bwd_ref`, the same reverse recurrence in
float32 torch with the same chunks, from those boundaries or from its own
forward walk; the JAX package has no backward kernel (it differentiates
its plain jnp).  Backward launches
count in ``selective_scan.bwd_launches``.  On the card a wrapper handed
an input that requires a gradient (grad mode on) goes through the
Function, or, for what no training path differentiates — the decode
step, a state written into ``h_out``, and the plain form — raises
``NotImplementedError`` naming the ROADMAP rather than return a result
cut from the graph.  On the CPU the plain versions differentiate.

The fused form over a sequence also runs with the bfloat16 working type
(``work_dtype=torch.bfloat16``, the model's ``scan_dtype``), which the JAX
package computes in plain jnp (``models/mamba.py::selective_scan``): in
chunks of ``q = _pick_chunk(S, 128)`` steps, ``a = exp(dt A)`` and ``u =
(dt x) B`` in float32 rounded to bfloat16, their chunk-local prefix by
``jax.lax.associative_scan``'s odd/even tree in bfloat16 (each product and
sum rounded on its own), then ``h_t = a_cum h + u_scan`` in float32 from
the float32 state carried across chunks.  On the card that is an instance
of its own of the fused kernel (``selective_scan_fused_bf16_fwd``),
counted under ``("fused_bf16", ...)`` keys, and under a gradient
:class:`SelectiveScanFusedBf16Fn`: the instance that keeps the state
entering every chunk (``("fused_bf16_bound", ...)``) and a backward kernel
(``selective_scan_fused_bf16_bwd``, ``("fused_bf16_bwd", ...)``) that
rebuilds each chunk's tree from its boundary and runs its transpose in
bfloat16.  Both split a lane's chunk over sixteen threads of a warp, eight
steps each in registers (the tree's lower levels inside a thread, the top
four between threads by shuffles), and run the tree's products and sums
natively on two lanes at once (``mul.rn.bf16x2``, ``add.rn.bf16x2``: each
rounds once, which for bfloat16 operands is the float32 operation rounded,
as the library's ``selective_scan_bf16_ops_probe`` entry shows on the
card); the backward takes its block's 32 channels two at a time and sums
dB, dC over them in shared memory.  Their plain versions are
:func:`selective_scan_chunked_ref` and
:func:`selective_scan_fused_bf16_bwd_ref`.  It is bound like the float32
form, by its ``b S D N`` exponentials (the tree adds some six bfloat16
operations a state and step).
"""
from __future__ import annotations

import functools
from collections import Counter
from typing import Optional, Tuple

import torch

from . import _meta
from ._build import launch, refuse_grad

N_MAX = 16
NO_BACKWARD = ("no training path differentiates the decode step, a state "
               "written into h_out or the plain form; their backward is "
               "ROADMAP Queue A 10c (the fused form over a sequence, with "
               "h_out=None, has one: SelectiveScanFusedFn)")
#: Time steps a chunk and channels a block of the backward kernel
#: (``kBwdChunk`` and ``kBwdChannels`` in ``csrc/selective_scan.cu``, which
#: refuses other values); the plain backward takes the same chunks.
BWD_CHUNK, BWD_CHANNELS = 16, 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The chunk length the reference's sequence scan aims at; a chunk is the
#: largest divisor of S not above it (:func:`selective_scan_chunked_ref`).
SCAN_CHUNK = 128


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it, and not
    ``F.softplus``, which returns ``x`` itself above 20.

    JAX's softplus is ``logaddexp(x, 0)``, which it spells
    ``max(x, 0) + log1p(exp(-|x|))`` with every op in ``x``'s type: in
    bfloat16 the ``exp``, the ``log1p`` and the sum each round.  This
    replays those roundings in ``x``'s type, and so equals it bit for bit
    on bfloat16.  float32 takes ``logaddexp`` in one op, which differs
    from JAX's by at most one ulp on some values."""
    if x.dtype == torch.float32:
        return torch.logaddexp(x, torch.zeros_like(x))
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


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


def selective_scan_step(x, dt, B, C, A, h):
    """One decode step.  ``x, dt`` ``(b, D)``; ``B, C`` ``(b, N)``; ``h``
    ``(b, D, N)`` float32.  Returns ``(y (b, D), h_new)``, float32."""
    a = torch.exp(dt.to(torch.float32)[..., None] * A.to(torch.float32))
    h_new = a * h + (dt * x).to(torch.float32)[..., None] \
        * B[:, None, :].to(torch.float32)
    y = torch.einsum("bdn,bn->bd", h_new, C.to(torch.float32))
    return y, h_new


def _pick_chunk(s: int, target: int) -> int:
    """The largest divisor of ``s`` not above ``target`` (the reference's
    ``models/mamba.py::_pick_chunk``)."""
    c = min(s, target)
    while s % c:
        c -= 1
    return c


def _combine(left, right):
    """The reference's combine of two recurrence segments, ``(a_l a_r,
    u_l a_r + u_r)``, each product and sum rounded to the inputs' type."""
    al, ul = left
    ar, ur = right
    return al * ar, ul * ar + ur


def associative_scan(a: torch.Tensor, u: torch.Tensor, dim: int = 1):
    """The inclusive scan of the segments ``(a, u)`` along ``dim`` under
    :func:`_combine`, in ``jax.lax.associative_scan``'s own order (the
    tree of its odd/even recursion: pairs combined, the half-length scan,
    then the even positions from the odd ones), so that in bfloat16 every
    partial product and sum rounds where the reference's does; a
    sequential prefix would round at other places."""
    n = a.shape[dim]
    if n < 2:
        return a, u

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.dim()
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    pairs = _combine((sl(a, 0, -1, 2), sl(u, 0, -1, 2)),
                     (sl(a, 1, None, 2), sl(u, 1, None, 2)))
    odd = associative_scan(*pairs, dim=dim)
    rest = (sl(a, 2, None, 2), sl(u, 2, None, 2))
    if n % 2 == 0:
        even = _combine((sl(odd[0], 0, -1), sl(odd[1], 0, -1)), rest)
    else:
        even = _combine(odd, rest)
    out = []
    for first, e, o in zip((a, u), even, odd):
        e = torch.cat([sl(first, 0, 1), e], dim=dim)
        t = first.new_empty(first.shape)
        idx = [slice(None)] * t.dim()
        idx[dim] = slice(0, None, 2)
        t[tuple(idx)] = e
        idx[dim] = slice(1, None, 2)
        t[tuple(idx)] = o
        out.append(t)
    return out[0], out[1]


def selective_scan_chunked_ref(x, dt, B, C, A, h0=None, *,
                               chunk: int = SCAN_CHUNK,
                               work_dtype: torch.dtype = torch.bfloat16,
                               bounds: bool = False):
    """The reference's chunked recurrence (``models/mamba.py::
    selective_scan`` with ``work_dtype``), for a working type other than
    float32: the sequence in chunks of ``_pick_chunk(S, chunk)`` steps;
    in each, ``a = exp(dt A)`` and ``u = (dt x) B`` computed in float32
    and rounded to ``work_dtype``, their chunk-local prefix by
    :func:`associative_scan` in that type, then ``h_t = a_cum h + u_scan``
    in float32 from the float32 state carried across chunks, and ``y_t =
    sum_N h_t C_t``.  Arguments and results as :func:`selective_scan_ref`'s
    (float32 ``y`` and final state); ``bounds`` adds a third output, the
    float32 state entering every chunk, ``(b, S / q, D, N)``."""
    f32 = torch.float32
    b, s, d = x.shape
    n = B.shape[-1]
    q = _pick_chunk(s, chunk)
    xf, dtf, Bf, Cf, Af = (t.to(f32) for t in (x, dt, B, C, A))
    h = (torch.zeros((b, d, n), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    ys, kept = [], []
    for c0 in range(0, s, q):
        kept.append(h)
        xq, dtq = xf[:, c0:c0 + q], dtf[:, c0:c0 + q]
        a = torch.exp(dtq[..., None] * Af).to(work_dtype)      # (b,q,d,n)
        u = ((dtq * xq)[..., None] * Bf[:, c0:c0 + q, None, :]
             ).to(work_dtype)
        a_cum, u_scan = associative_scan(a, u, dim=1)
        h_all = a_cum.to(f32) * h[:, None] + u_scan.to(f32)
        ys.append(torch.einsum("bqdn,bqn->bqd", h_all, Cf[:, c0:c0 + q]))
        h = h_all[:, -1]
    if bounds:
        return torch.cat(ys, dim=1), h, torch.stack(kept, dim=1)
    return torch.cat(ys, dim=1), h


@functools.lru_cache(maxsize=None)
def _tree_plan(q: int) -> tuple:
    """The combines of :func:`associative_scan` over ``q`` elements done in
    place, as the bfloat16 kernels replay them: ``(up, down)``, lists of
    ``(level, lefts, rights)``.  The up-sweep's level ``l`` puts level ``l
    + 1``'s element ``i``, the combine of level ``l``'s elements ``2i`` and
    ``2i + 1``, where the latter lay (``2^(l+1) (i + 1) - 1``); the
    down-sweep, from the top level, forms level ``l``'s even elements 2, 4,
    ... from the odd ones before them.  Within a level the combines are
    independent."""
    up, cnt, level = [], q, 0
    while cnt >= 2:
        half = 1 << level
        rights = list(range(2 * half - 1, (cnt // 2) * 2 * half, 2 * half))
        up.append((level, [r - half for r in rights], rights))
        cnt //= 2
        level += 1
    down = []
    for level in reversed(range(len(up))):
        half = 1 << level
        pos = [half * (k + 1) - 1 for k in range(2, q >> level, 2)]
        if pos:
            down.append((level, [p - half for p in pos], pos))
    return up, down


def _combine_at(a, u, lefts, rights) -> None:
    """:func:`_combine` of the elements ``lefts`` into ``rights`` along
    axis 1, in place."""
    a[:, rights], u[:, rights] = _combine((a[:, lefts], u[:, lefts]),
                                          (a[:, rights], u[:, rights]))


def _tree_scan(a: torch.Tensor, u: torch.Tensor) -> tuple:
    """:func:`associative_scan` along axis 1 in place, by
    :func:`_tree_plan`'s combines; returns copies of ``(a, u)`` as the
    up-sweep leaves them, which the backward reads."""
    up, down = _tree_plan(a.shape[1])
    for _, lefts, rights in up:
        _combine_at(a, u, lefts, rights)
    kept = a.clone(), u.clone()
    for _, lefts, rights in down:
        _combine_at(a, u, lefts, rights)
    return kept


def _tree_transpose(ga, gu, fa, fu, ua, uu, a0) -> None:
    """The transpose of :func:`_tree_scan` in place: ``ga, gu`` the
    gradients of its outputs become those of its inputs.  ``fa, fu`` are
    its outputs, ``ua, uu`` the up-sweep's values and ``a0`` its input
    ``a``.  The down-sweep's combines are undone from level 0 up, then the
    up-sweep's from the top down; a combine into ``r`` with the forward's
    ``a_l, u_l, a_r`` and gradients ``gA, gU`` at ``r`` adds ``gA a_r`` to
    ``ga[l]`` and ``gU a_r`` to ``gu[l]`` and sets ``ga[r] = gA a_l + gU
    u_l``, each product and sum rounded to the tensors' type.  An up-sweep
    combine's ``a_r`` on level ``l`` is rebuilt from ``a0`` by the
    forward's products with the values left of it."""
    up, down = _tree_plan(ga.shape[1])

    def uncombine(lefts, rights, al, ul, ar):
        gA, gU = ga[:, rights], gu[:, rights]
        ga[:, lefts] = ga[:, lefts] + gA * ar
        gu[:, lefts] = gu[:, lefts] + gU * ar
        ga[:, rights] = gA * al + gU * ul

    for _, lefts, pos in reversed(down):
        uncombine(lefts, pos, fa[:, lefts], fu[:, lefts], ua[:, pos])
    for level, lefts, rights in reversed(up):
        ar = a0[:, rights]
        for j in range(level):
            ar = ua[:, [r - (1 << j) for r in rights]] * ar
        uncombine(lefts, rights, ua[:, lefts], uu[:, lefts], ar)


def selective_scan_bounds_ref(x, dt, B, C, A, h0=None, *,
                              chunk: int = BWD_CHUNK):
    """:func:`selective_scan_ref` that also returns the float32 state
    entering every ``chunk`` steps, ``(b, ceil(S / chunk), D, N)`` — what
    the fused forward kernel stores for the backward — as a third
    output."""
    xf, dtf, Bf, Cf, Af = (t.float() for t in (x, dt, B, C, A))
    b, s, d = x.shape
    h = (torch.zeros((b, d, A.shape[-1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    ys, bounds = [], []
    for t in range(s):
        if t % chunk == 0:
            bounds.append(h)
        a = torch.exp(dtf[:, t, :, None] * Af)                  # (b, D, N)
        h = a * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    return torch.stack(ys, dim=1), h, torch.stack(bounds, dim=1)


def selective_scan_fused_ref(x, dt, dt_bias, B, C, A_log, D, z, h0=None,
                             h_out=None, *, step: bool = False,
                             scan=selective_scan_ref, bounds: bool = False):
    """The ATen sequence of ``mamba1_block`` from the bias add to the cast:
    ``softplus(dt + dt_bias)``, ``A = -exp(A_log)``, the scan (``scan``
    over the sequence, the one-step update when ``step``, which needs
    ``S == 1``), ``y + D * x``, the gate ``y * silu(z)`` and the cast to
    ``x``'s type.

    ``x, dt, z`` ``(b, S, D)`` and ``B, C`` ``(b, S, N)`` in one type;
    ``dt_bias, D`` ``(D,)`` and ``A_log`` ``(D, N)`` float32; ``h0``
    ``(b, D, N)`` float32 or None (zeros).  Returns ``(out (b, S, D), h)``;
    with ``h_out`` the final state is copied into it and ``h`` is
    ``h_out``.  ``bounds`` (over a sequence, with the plain scan) adds a
    third output, the state entering every ``BWD_CHUNK`` steps
    (:func:`selective_scan_bounds_ref`), which
    :func:`selective_scan_fused_bwd_ref` takes as ``bounds=``.
    """
    A = -torch.exp(A_log.to(torch.float32))
    dt = softplus(dt + dt_bias.to(dt.dtype))
    if bounds:
        if step or h_out is not None or scan is not selective_scan_ref:
            raise ValueError("bounds are kept over a sequence, with the "
                             "plain scan and no h_out")
        y, h, kept = selective_scan_bounds_ref(x, dt, B, C, A, h0)
        return _gate(y, x, D, z), h, kept
    if step:
        if h0 is None:
            h0 = torch.zeros((x.shape[0],) + A.shape, dtype=torch.float32,
                             device=x.device)
        y, h = selective_scan_step(x[:, 0], dt[:, 0], B[:, 0], C[:, 0], A,
                                   h0)
        y = y[:, None]
    else:
        y, h = scan(x, dt, B, C, A, h0)
    if h_out is not None:
        h = h_out.copy_(h)
    return _gate(y, x, D, z), h


def _gate(y, x, D, z):
    """``(y + D * x) * silu(z)`` in float32, cast to ``x``'s type."""
    y = y + D.to(torch.float32) * x.to(torch.float32)
    zf = z.to(torch.float32)
    y = y * (zf * torch.sigmoid(zf))
    return y.to(x.dtype)


def selective_scan_fused_bwd_ref(x, dt, dt_bias, B, C, A_log, D, z, h0,
                                 dout, dh_final=None, *,
                                 chunk: int = BWD_CHUNK,
                                 bounds: Optional[torch.Tensor] = None
                                 ) -> tuple:
    """Gradients of :func:`selective_scan_fused_ref` over a sequence (not a
    step): the explicit reverse recurrence in float32, not autograd.

    Inputs as the forward's (``h0`` may be None), ``dout`` ``(b, S, D)``
    the gradient of ``out`` and ``dh_final`` ``(b, D, N)`` that of the
    final state (None: zero).  ``bounds`` is the state entering every
    ``chunk`` steps, ``(b, ceil(S / chunk), D, N)`` float32, as the
    forward keeps it (:func:`selective_scan_bounds_ref`); without it, the
    sequence is walked forward once to find them.  Then, like the kernel,
    it walks the chunks in reverse, recomputing each chunk's states from
    its boundary, with ``a_t = exp(dt_t A)``, ``y_t = sum_N h_t C_t`` and
    ``dy = dout * silu(z)``:

    - ``dh_t = a_{t+1} dh_{t+1} + dy_t C_t`` from ``dh_final``;
    - ``dC_t = sum_D dy_t h_t``, ``dB_t = sum_D dh_t dt_t x_t``;
    - ``d(dt)_t = sum_N dh_t (A a_t h_{t-1} + x_t B_t)``,
      ``dx = dy D + dt sum_N dh_t B_t``;
    - ``dA_log = A sum_{b,t} dh_t dt_t a_t h_{t-1}``, ``dD = sum dy x``;
    - ``ddt_raw = d(dt) sigmoid(dt_raw + dt_bias)`` (the sum rounded to
      the inputs' type, as the forward's), ``ddt_bias`` its sum over
      ``(b, t)``; ``dz = dout (y + D x) silu'(z)``; ``dh0 = a_1 dh_1``.

    Returns ``(dx, ddt, ddt_bias, dB, dC, dA_log, dD, dz, dh0)`` in the
    forward's argument order: ``dx, ddt, dB, dC, dz`` in the inputs' type
    (rounded once), the rest float32, ``dh0`` None when ``h0`` is.
    """
    io, f32 = x.dtype, torch.float32
    b, s, d = x.shape
    n = A_log.shape[-1]
    xf, zf, Bf, Cf, gof = (t.to(f32) for t in (x, z, B, C, dout))
    A = -torch.exp(A_log.to(f32))
    raw = dt + dt_bias.to(io)
    dtf = softplus(raw).to(f32)
    sig = torch.sigmoid(raw.to(f32))
    dtx = dtf * xf
    Df = D.to(f32)
    sz = torch.sigmoid(zf)
    gate = zf * sz
    dgate = sz * (1 + zf * (1 - sz))                 # silu'(z)

    def step(h, t):
        a = torch.exp(dtf[:, t, :, None] * A)
        return a, a * h + dtx[:, t, :, None] * Bf[:, t, None, :]

    if bounds is None:
        kept = _walk_bounds(x, dt, dt_bias, B, A_log, h0, chunk).unbind(1)
    else:
        if bounds.shape != (b, -(-s // chunk), d, n):
            raise ValueError(f"bounds must be (b, ceil(S / {chunk}), D, N) "
                             f"= {(b, -(-s // chunk), d, n)}, got "
                             f"{tuple(bounds.shape)}")
        kept = bounds.to(f32).unbind(1)
    carry = (torch.zeros((b, d, n), dtype=f32, device=x.device)
             if dh_final is None else dh_final.to(f32))
    dx, ddt, dz = (torch.empty((b, s, d), dtype=f32, device=x.device)
                   for _ in range(3))
    dB, dC = (torch.empty((b, s, n), dtype=f32, device=x.device)
              for _ in range(2))
    dA = torch.zeros((b, d, n), dtype=f32, device=x.device)
    for k in reversed(range(len(kept))):
        t0, t1 = k * chunk, min(s, (k + 1) * chunk)
        hs, decay = [kept[k]], []
        for t in range(t0, t1):
            a, h = step(hs[-1], t)
            hs.append(h)
            decay.append(a)
        for t in reversed(range(t0, t1)):
            h_t, h_prev, a = hs[t - t0 + 1], hs[t - t0], decay[t - t0]
            y = torch.einsum("bdn,bn->bd", h_t, Cf[:, t])
            dy = gof[:, t] * gate[:, t]
            dz[:, t] = gof[:, t] * (y + Df * xf[:, t]) * dgate[:, t]
            g = dy[..., None] * Cf[:, t, None, :] + carry      # dL/dh_t
            dC[:, t] = torch.einsum("bd,bdn->bn", dy, h_t)
            dB[:, t] = torch.einsum("bdn,bd->bn", g, dtx[:, t])
            gB = torch.einsum("bdn,bn->bd", g, Bf[:, t])
            gha = g * h_prev * a
            dA += gha * dtf[:, t, :, None]
            ddt[:, t] = ((gha * A).sum(-1) + xf[:, t] * gB) * sig[:, t]
            dx[:, t] = dy * Df + dtf[:, t] * gB
            carry = a * g
    ddt_bias = ddt.sum((0, 1))
    dD = (gof * gate * xf).sum((0, 1))
    dA_log = A * dA.sum(0)
    return (dx.to(io), ddt.to(io), ddt_bias, dB.to(io), dC.to(io), dA_log,
            dD, dz.to(io), None if h0 is None else carry)


def _walk_bounds(x, dt, dt_bias, B, A_log, h0, chunk: int) -> torch.Tensor:
    """The plain backward's own forward walk when it is handed no
    boundaries: the float32 state entering every ``chunk`` steps, ``(b,
    ceil(S / chunk), D, N)``, by the recurrence it recomputes chunks
    with."""
    f32 = torch.float32
    b, s, d = x.shape
    A = -torch.exp(A_log.to(f32))
    dtf = softplus(dt + dt_bias.to(x.dtype)).to(f32)
    dtx = dtf * x.to(f32)
    Bf = B.to(f32)
    h = (torch.zeros((b, d, A.shape[-1]), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    kept = []
    for t in range(s):
        if t % chunk == 0:
            kept.append(h)
        a = torch.exp(dtf[:, t, :, None] * A)
        h = a * h + dtx[:, t, :, None] * Bf[:, t, None, :]
    return torch.stack(kept, dim=1)


def selective_scan_fused_bf16_ref(x, dt, dt_bias, B, C, A_log, D, z,
                                  h0=None) -> tuple:
    """The fused form over a sequence with the bfloat16 working type, as
    the training path's instance computes it: :func:`selective_scan_fused_ref`
    with :func:`selective_scan_chunked_ref` for the scan, and the float32
    state entering every chunk as a third output, ``(b, S / q, D, N)``,
    which :func:`selective_scan_fused_bf16_bwd_ref` takes as ``bounds=``."""
    A = -torch.exp(A_log.to(torch.float32))
    dt = softplus(dt + dt_bias.to(dt.dtype))
    y, h, kept = selective_scan_chunked_ref(x, dt, B, C, A, h0, bounds=True)
    return _gate(y, x, D, z), h, kept


def selective_scan_fused_bf16_bwd_ref(x, dt, dt_bias, B, C, A_log, D, z, h0,
                                      dout, dh_final=None, *,
                                      bounds: Optional[torch.Tensor] = None,
                                      chunk: int = SCAN_CHUNK) -> tuple:
    """Gradients of the fused form over a sequence with the bfloat16
    working type (:func:`selective_scan_fused_bf16_ref`), explicitly and
    in the backward kernel's order, not by autograd.

    Arguments and results as :func:`selective_scan_fused_bwd_ref`'s;
    ``bounds`` is the state entering every chunk of ``q =
    _pick_chunk(S, chunk)`` steps, ``(b, S / q, D, N)``, as the forward
    keeps it (without it, the forward is run to find them).  The chunks go
    in reverse; in each, from its boundary ``H``:

    - ``a = exp(dt A)`` and ``u = (dt x) B`` rounded to bfloat16, their
      tree (:func:`_tree_scan`, its up-sweep kept), ``h_t = a_cum_t H +
      u_scan_t`` and ``y_t = sum_N h_t C_t`` in float32;
    - ``g_t = dy_t C_t`` (``dy = dout silu(z)``), plus the carried
      gradient at the chunk's last step; ``dC_t = sum_D dy_t h_t``;
    - the gradients of ``a_cum`` and ``u_scan``, ``g H`` and ``g``, each
      rounded to bfloat16, the tree's transpose in bfloat16
      (:func:`_tree_transpose`), and the carry into the chunk before,
      ``sum_t g_t a_cum_t`` added in the order of ``t``;
    - ``ds = da exp(dt A)`` and ``w = du`` in float32: ``dA += ds dt``,
      ``d(dt) = sum_N ds A + x sum_N w B``, ``dx = dy D + dt sum_N w B``,
      ``dB_t = sum_D w dt x``, then the softplus' slope, ``dz``, ``dD``
      and ``d(dt_bias)`` as the float32 form's; ``dh0`` is the last
      carry.
    """
    io, f32, bf = x.dtype, torch.float32, torch.bfloat16
    b, s, d = x.shape
    n = A_log.shape[-1]
    q = _pick_chunk(s, chunk)
    A = -torch.exp(A_log.to(f32))
    raw = dt + dt_bias.to(io)
    dt_io = softplus(raw)
    dtf = dt_io.to(f32)
    sig = torch.sigmoid(raw.to(f32))
    xf, zf, Bf, Cf, gof = (t.to(f32) for t in (x, z, B, C, dout))
    dtx = dtf * xf
    Df = D.to(f32)
    sz = torch.sigmoid(zf)
    gate = zf * sz
    dgate = sz * (1 + zf * (1 - sz))                 # silu'(z)
    dy = gof * gate
    if bounds is None:
        _, _, bounds = selective_scan_chunked_ref(x, dt_io, B, C, A, h0,
                                                  chunk=chunk, bounds=True)
    elif bounds.shape != (b, s // q, d, n):
        raise ValueError(f"bounds must be (b, S / {q}, D, N) = "
                         f"{(b, s // q, d, n)}, got {tuple(bounds.shape)}")
    carry = (torch.zeros((b, d, n), dtype=f32, device=x.device)
             if dh_final is None else dh_final.to(f32))
    dx, ddt, dz = (torch.empty((b, s, d), dtype=f32, device=x.device)
                   for _ in range(3))
    dB, dC = (torch.empty((b, s, n), dtype=f32, device=x.device)
              for _ in range(2))
    dA = torch.zeros((b, d, n), dtype=f32, device=x.device)
    for k in reversed(range(s // q)):
        sl = slice(k * q, (k + 1) * q)
        H = bounds[:, k].to(f32)[:, None]                       # (b,1,d,n)
        dq, Cq = dtf[:, sl], Cf[:, sl]
        e = torch.exp(dq[..., None] * A)                        # (b,q,d,n)
        a = e.to(bf)
        a0 = a.clone()
        u = (dtx[:, sl][..., None] * Bf[:, sl, None, :]).to(bf)
        ua, uu = _tree_scan(a, u)
        a_cum = a.to(f32)
        h_all = a_cum * H + u.to(f32)
        y = torch.einsum("bqdn,bqn->bqd", h_all, Cq)
        g = dy[:, sl, :, None] * Cq[:, :, None, :]
        g[:, -1] = g[:, -1] + carry
        dC[:, sl] = torch.einsum("bqd,bqdn->bqn", dy[:, sl], h_all)
        ga, gu = (g * H).to(bf), g.to(bf)
        carry = torch.zeros_like(carry)
        for t in range(q):
            carry = carry + g[:, t] * a_cum[:, t]
        _tree_transpose(ga, gu, a, u, ua, uu, a0)
        ds = ga.to(f32) * e
        w = gu.to(f32)
        dA += (ds * dq[..., None]).sum(1)
        sb = torch.einsum("bqdn,bqn->bqd", w, Bf[:, sl])
        dB[:, sl] = torch.einsum("bqdn,bqd->bqn", w, dtx[:, sl])
        ddt[:, sl] = ((ds * A).sum(-1) + xf[:, sl] * sb) * sig[:, sl]
        dx[:, sl] = dy[:, sl] * Df + dq * sb
        dz[:, sl] = gof[:, sl] * (y + Df * xf[:, sl]) * dgate[:, sl]
    ddt_bias = ddt.sum((0, 1))
    dD = (dy * xf).sum((0, 1))
    dA_log = A * dA.sum(0)
    return (dx.to(io), ddt.to(io), ddt_bias, dB.to(io), dC.to(io), dA_log,
            dD, dz.to(io), None if h0 is None else carry)


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
    if min(b, s, d, n) < 1:
        raise ValueError(f"empty sizes: b {b}, S {s}, D {d}, N {n}")


def _check_kernel_sizes(b: int, s: int, d: int, n: int) -> None:
    """The limits of the CUDA kernels alone (the plain versions take any
    size): N at most :data:`N_MAX`, batch below 2**16, S and D below
    2**31."""
    if n > N_MAX or b >= 2 ** 16 or s >= 2 ** 31 or d >= 2 ** 31:
        raise ValueError(f"the CUDA kernel does not take b {b}, S {s}, "
                         f"D {d}, N {n} (N at most {N_MAX})")


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
    _check_kernel_sizes(b, s, d, n)
    refuse_grad("selective_scan", NO_BACKWARD, x, dt, B, C, A, h0)
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


def selective_scan_fused(x: torch.Tensor, dt: torch.Tensor,
                         dt_bias: torch.Tensor, B: torch.Tensor,
                         C: torch.Tensor, A_log: torch.Tensor,
                         D: torch.Tensor, z: torch.Tensor,
                         h0: Optional[torch.Tensor] = None,
                         h_out: Optional[torch.Tensor] = None, *,
                         step: bool = False,
                         work_dtype: torch.dtype = torch.float32
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CUDA version of :func:`selective_scan_fused_ref`: ``x, dt, B, C, z``
    views of one type (float32 or bfloat16) with a unit-stride last axis;
    ``dt_bias, A_log, D, h0, h_out`` float32.

    Returns ``(out, h)``: ``out`` ``(b, S, D)`` in ``x``'s type, ``h``
    ``(b, D, N)`` float32 — ``h_out`` when given (contiguous; it may be
    ``h0`` itself, which is then updated in place).  A CPU tensor goes
    through the plain version; a CUDA tensor launches the kernel or raises.

    ``work_dtype`` is the model's ``scan_dtype`` over a sequence:
    ``torch.bfloat16`` takes the reference's chunked recurrence with its
    prefix in bfloat16 — on the CPU its plain version
    (:func:`selective_scan_chunked_ref`), on the card the kernel's
    bfloat16 working-type instance, or :class:`SelectiveScanFusedBf16Fn`
    under a gradient.  A meta tensor returns the kernel's output shapes,
    its work counted in ``kernels/_meta.py``.
    """
    # plain attribute reads and comparisons: a decode step calls this once
    # a layer
    io, f32 = x.dtype, torch.float32
    code = _DTYPES.get(io)
    if (code is None or dt.dtype is not io or B.dtype is not io
            or C.dtype is not io or z.dtype is not io):
        raise TypeError(f"x, dt, B, C, z must share one type, float32 or "
                        f"bfloat16; got {x.dtype}, {dt.dtype}, {B.dtype}, "
                        f"{C.dtype}, {z.dtype}")
    if (dt_bias.dtype is not f32 or A_log.dtype is not f32
            or D.dtype is not f32
            or (h0 is not None and h0.dtype is not f32)
            or (h_out is not None and h_out.dtype is not f32)):
        raise TypeError("dt_bias, A_log, D, h0 and h_out must be float32")
    shape = x.shape
    b, s, d = shape if len(shape) == 3 else (0, 0, 0)
    n = A_log.shape[-1]
    seq, state = (b, s, n), (b, d, n)
    if (len(shape) != 3 or dt.shape != shape or z.shape != shape
            or B.shape != seq or C.shape != seq or A_log.shape != (d, n)
            or dt_bias.shape != (d,) or D.shape != (d,)
            or (h0 is not None and h0.shape != state)
            or (h_out is not None and h_out.shape != state)):
        raise ValueError(
            f"want x, dt, z (b,S,D), B, C (b,S,N), A_log (D,N), dt_bias, D "
            f"(D,), h0, h_out (b,D,N); got x {tuple(shape)}, dt "
            f"{tuple(dt.shape)}, z {tuple(z.shape)}, B {tuple(B.shape)}, C "
            f"{tuple(C.shape)}, A_log {tuple(A_log.shape)}, dt_bias "
            f"{tuple(dt_bias.shape)}, D {tuple(D.shape)}, h0 "
            f"{None if h0 is None else tuple(h0.shape)}, h_out "
            f"{None if h_out is None else tuple(h_out.shape)}")
    if work_dtype not in (torch.float32, torch.bfloat16) or (
            step and work_dtype is not torch.float32):
        raise ValueError(f"work_dtype must be float32 or bfloat16 (float32 "
                         f"for a step), got {work_dtype}")
    if min(b, s, d, n) < 1 or (step and s != 1):
        raise ValueError(f"unsupported sizes: b {b}, S {s}, D {d}, N {n} "
                         f"(S = 1 for a step)")
    if (x.stride(2) != 1 or dt.stride(2) != 1 or B.stride(2) != 1
            or C.stride(2) != 1 or z.stride(2) != 1):
        raise ValueError("x, dt, B, C, z need a unit-stride last axis")
    if h_out is not None and not h_out.is_contiguous():
        raise ValueError("h_out must be contiguous")
    index = x.get_device()
    if (dt.get_device() != index or B.get_device() != index
            or C.get_device() != index or z.get_device() != index
            or dt_bias.get_device() != index
            or A_log.get_device() != index or D.get_device() != index
            or (h0 is not None and h0.get_device() != index)
            or (h_out is not None and h_out.get_device() != index)):
        raise ValueError(f"all inputs must be on {x.device}")
    work_bf16 = work_dtype is torch.bfloat16
    if not x.is_cuda:
        if x.device.type not in ("cpu", "meta"):
            raise ValueError(f"unsupported device {x.device}")
        if x.is_meta:
            return _meta_fused(x, dt, dt_bias, B, C, A_log, D, z, h0, h_out,
                               step, work_bf16)
        if work_bf16:
            return selective_scan_fused_ref(
                x, dt, dt_bias, B, C, A_log, D, z, h0, h_out,
                scan=functools.partial(selective_scan_chunked_ref,
                                       work_dtype=work_dtype))
        return selective_scan_fused_ref(x, dt, dt_bias, B, C, A_log, D, z,
                                        h0, h_out, step=step)
    _check_kernel_sizes(b, s, d, n)
    if torch.is_grad_enabled() and (
            x.requires_grad or dt.requires_grad or dt_bias.requires_grad
            or B.requires_grad or C.requires_grad or A_log.requires_grad
            or D.requires_grad or z.requires_grad
            or (h0 is not None and h0.requires_grad)):
        if step or h_out is not None:
            refuse_grad("selective_scan_fused (decode step or h_out)",
                        NO_BACKWARD, x, dt, dt_bias, B, C, A_log, D, z, h0)
        if work_bf16:
            return SelectiveScanFusedBf16Fn.apply(x, dt, dt_bias, B, C, A_log,
                                                  D, z, h0)
        return SelectiveScanFusedFn.apply(x, dt, dt_bias, B, C, A_log, D, z,
                                          h0)
    return _fused_fwd_cuda(x, dt, dt_bias, B, C, A_log, D, z, h0, h_out,
                           step, work_bf16=work_bf16)


def _meta_fused_fwd(x, A_log, args, h_out, bounds: bool,
                    work_bf16: bool = False):
    """The fused forward on meta tensors: ``(out, h[, bounds])`` of the
    kernel's shapes, counted as its bound counts it (``7 b S D N + b S
    D`` operations; ``args`` the inputs read).  The bfloat16 working
    type's instance counts its tree's six bfloat16 operations a state and
    step too, under its own name, and keeps ``S / q`` boundaries."""
    b, s, d = x.shape
    n = A_log.shape[-1]
    out = torch.empty_like(x)
    h = (torch.empty((b, d, n), dtype=torch.float32, device=x.device)
         if h_out is None else h_out)
    outs = [out, h]
    if bounds:
        outs.append(_bounds_for(x, n, work_bf16))
    _meta.account("selective_scan_bf16" if work_bf16 else "selective_scan",
                  (13 if work_bf16 else 7) * x.numel() * n + x.numel(), args,
                  outs)
    return tuple(outs)


def _meta_fused(x, dt, dt_bias, B, C, A_log, D, z, h0, h_out, step,
                work_bf16: bool = False):
    """:func:`selective_scan_fused` on meta tensors: its Function under a
    gradient (over a sequence, without ``h_out``), else the outputs'
    shapes."""
    if torch.is_grad_enabled() and not step and h_out is None and any(
            t is not None and t.requires_grad
            for t in (x, dt, dt_bias, B, C, A_log, D, z, h0)):
        fn = SelectiveScanFusedBf16Fn if work_bf16 else SelectiveScanFusedFn
        return fn.apply(x, dt, dt_bias, B, C, A_log, D, z, h0)
    return _meta_fused_fwd(x, A_log, (x, dt, dt_bias, B, C, A_log, D, z, h0),
                           h_out, False, work_bf16)


def _fused_fwd_cuda(x, dt, dt_bias, B, C, A_log, D, z, h0, h_out,
                    step: bool, bounds: Optional[torch.Tensor] = None,
                    work_bf16: bool = False) -> tuple:
    """One launch of the fused forward kernel on checked CUDA tensors:
    ``(out, h)``, ``h`` being ``h_out`` when it is given.  ``bounds``, a
    contiguous float32 tensor of :func:`_bounds_for`'s shape (over a
    sequence only), launches the kernel's instance that also stores the
    state entering every chunk there; generation passes none.
    ``work_bf16`` launches the bfloat16 working type's instances (over a
    sequence)."""
    if not (dt_bias.is_contiguous() and A_log.is_contiguous()
            and D.is_contiguous()):
        dt_bias, A_log, D = (dt_bias.contiguous(), A_log.contiguous(),
                             D.contiguous())
    if h0 is not None and not h0.is_contiguous():
        h0 = h0.contiguous()
    shape, n = x.shape, A_log.shape[-1]
    b, s, d = shape
    out = x.new_empty(shape)
    if h_out is None:
        h_out = x.new_empty((b, d, n), dtype=torch.float32)
    args = (x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
            z.data_ptr(), A_log.data_ptr(), dt_bias.data_ptr(), D.data_ptr(),
            None if h0 is None else h0.data_ptr(), out.data_ptr(),
            h_out.data_ptr(), None if bounds is None else bounds.data_ptr(),
            x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
            B.stride(0), B.stride(1), C.stride(0), C.stride(1), z.stride(0),
            z.stride(1), b, s, d, n)
    if work_bf16:
        launch("selective_scan_fused_bf16_fwd", x.get_device(), *args,
               _pick_chunk(s, SCAN_CHUNK), _DTYPES[x.dtype])
    else:
        launch("selective_scan_fused_fwd", x.get_device(), *args,
               _DTYPES[x.dtype], int(step))
    selective_scan.launches += 1
    form = "fused_bf16" if work_bf16 else "fused"
    if bounds is not None:
        selective_scan.shapes[form + "_bound", shape, n, x.dtype] += 1
    elif work_bf16:
        selective_scan.shapes[form, shape, n, x.dtype] += 1
    else:
        selective_scan.shapes[form, shape, n, x.dtype, bool(step)] += 1
    return out, h_out


def _bound_chunks(s: int, work_bf16: bool) -> int:
    """The chunks whose entering state the training forward keeps:
    ``ceil(S / BWD_CHUNK)``, or ``S / q`` for the bfloat16 working type
    (the reference's chunks)."""
    if work_bf16:
        return s // _pick_chunk(s, SCAN_CHUNK)
    return -(-s // BWD_CHUNK)


def _bounds_for(x: torch.Tensor, n: int, work_bf16: bool = False
                ) -> torch.Tensor:
    """An empty float32 ``(b, chunks, D, N)`` tensor beside ``x``: where
    the fused forward kernel keeps the state entering every chunk for the
    backward (:func:`_fused_fwd_cuda`'s ``bounds``; chunks as
    :func:`_bound_chunks`)."""
    b, s, d = x.shape
    return x.new_empty((b, _bound_chunks(s, work_bf16), d, n),
                       dtype=torch.float32)


def _bwd_work_floats(b: int, s: int, d: int, n: int) -> int:
    """float32 elements of the backward kernel's workspace: the per-block
    partials of ``dB`` and ``dC`` ``(2, b, blocks, S, N)``, and the
    per-sequence partials of ``dA_log`` ``(b, D, N)`` and of ``ddt_bias,
    dD`` ``(2, b, D)``.  (The chunk boundaries come from the forward.)"""
    blocks = -(-d // BWD_CHANNELS)
    return 2 * b * blocks * s * n + b * d * n + 2 * b * d


def _bwd_cuda(x, dt, dt_bias, B, C, A_log, D, z, h0, dout, dh_final,
              bounds, work_bf16: bool = False) -> tuple:
    """One call of the backward kernel (a main launch and a fold) on the
    forward's checked CUDA inputs and the chunk boundaries its kernel
    kept (``bounds`` of :func:`_fused_fwd_cuda`): the nine gradients of
    :func:`selective_scan_fused_bwd_ref` (with ``work_bf16``, of
    :func:`selective_scan_fused_bf16_bwd_ref`), ``dh0`` None when ``h0``
    is.  ``dout``, the float32 parameters and the states are copied when
    their layout needs it."""
    b, s, d = x.shape
    n = A_log.shape[-1]
    want = (b, _bound_chunks(s, work_bf16), d, n)
    if (bounds.shape != want or bounds.dtype != torch.float32
            or not bounds.is_contiguous()):
        raise ValueError(f"bounds must be contiguous float32 {want} (b, "
                         f"chunks, D, N), got {tuple(bounds.shape)} "
                         f"{bounds.dtype}")
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    dt_bias, A_log, D, h0, dh_final = (
        t if t is None or t.is_contiguous() else t.contiguous()
        for t in (dt_bias, A_log, D, h0, dh_final))
    f32 = torch.float32
    dx, ddt, dz = (x.new_empty((b, s, d)) for _ in range(3))
    dB, dC = (x.new_empty((b, s, n)) for _ in range(2))
    ddt_bias, dD = (x.new_empty((d,), dtype=f32) for _ in range(2))
    dA_log = x.new_empty((d, n), dtype=f32)
    dh0 = None if h0 is None else x.new_empty((b, d, n), dtype=f32)
    work = x.new_empty((_bwd_work_floats(b, s, d, n),), dtype=f32)
    args = (x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
            z.data_ptr(), A_log.data_ptr(), dt_bias.data_ptr(), D.data_ptr(),
            None if h0 is None else h0.data_ptr(), dout.data_ptr(),
            None if dh_final is None else dh_final.data_ptr(),
            bounds.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), dz.data_ptr(), ddt_bias.data_ptr(), dD.data_ptr(),
            dA_log.data_ptr(), None if dh0 is None else dh0.data_ptr(),
            work.data_ptr(), work.numel(), x.stride(0), x.stride(1),
            dt.stride(0), dt.stride(1), B.stride(0), B.stride(1),
            C.stride(0), C.stride(1), z.stride(0), z.stride(1),
            dout.stride(0), dout.stride(1), b, s, d, n)
    if work_bf16:
        launch("selective_scan_fused_bf16_bwd", x.get_device(), *args,
               _pick_chunk(s, SCAN_CHUNK), _DTYPES[x.dtype])
    else:
        launch("selective_scan_fused_bwd", x.get_device(), *args, BWD_CHUNK,
               BWD_CHANNELS, _DTYPES[x.dtype])
    selective_scan.bwd_launches += 1
    form = "fused_bf16_bwd" if work_bf16 else "fused_bwd"
    selective_scan.shapes[form, x.shape, n, x.dtype] += 1
    return dx, ddt, ddt_bias, dB, dC, dA_log, dD, dz, dh0


#: The kernels :func:`bwd_occupancy` reads: the float32 working type's
#: backward, and the bfloat16 working type's forward, its training instance
#: and its backward (their instances for ``q = 128``).
OCCUPANCY_FORMS = ("fused_bwd", "fused_bf16", "fused_bf16_bound",
                   "fused_bf16_bwd")


def bwd_occupancy(dtype: torch.dtype, form: str = "fused_bwd"
                  ) -> Tuple[int, int]:
    """``(shared memory bytes, blocks an SM holds)`` of one of the scan's
    kernels (``form``, one of :data:`OCCUPANCY_FORMS`; by default the
    float32 backward's main kernel, whose design wants 4 blocks, 16 warps,
    an SM) for inputs of ``dtype`` on the current CUDA device, as the CUDA
    runtime's occupancy calculator gives them.  Needs the card."""
    import ctypes
    from . import _build
    if form not in OCCUPANCY_FORMS:
        raise ValueError(f"form must be one of {OCCUPANCY_FORMS}, got "
                         f"{form!r}")
    _build.load_library()
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    if form == "fused_bwd":
        name = "selective_scan_fused_bwd_occupancy"
        rc = _build._fns[name](_DTYPES[dtype], ctypes.byref(smem),
                               ctypes.byref(blocks))
    else:
        name = "selective_scan_fused_bf16_occupancy"
        rc = _build._fns[name](_DTYPES[dtype], OCCUPANCY_FORMS.index(form) - 1,
                               ctypes.byref(smem), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"{name}: cudaError {rc}")
    return smem.value, blocks.value


class SelectiveScanFusedFn(torch.autograd.Function):
    """:func:`selective_scan_fused` over a sequence (no step, no
    ``h_out``) with its gradient: the fused forward kernel's instance that
    keeps the state entering every ``BWD_CHUNK`` steps, then the backward
    kernel on the saved inputs and those boundaries (it recomputes the
    states in between).  On the CPU both sides are the plain versions,
    passing the boundaries the same way, so the Function itself can be
    tested there.  The gradients of ``out`` and of the final state may
    each be absent (None: zero)."""

    @staticmethod
    def forward(ctx, x, dt, dt_bias, B, C, A_log, D, z, h0):
        ctx.set_materialize_grads(False)
        if x.is_cuda:
            bounds = _bounds_for(x, A_log.shape[-1])
            out, h = _fused_fwd_cuda(x, dt, dt_bias, B, C, A_log, D, z, h0,
                                     None, False, bounds)
        elif x.is_meta:
            out, h, bounds = _meta_fused_fwd(
                x, A_log, (x, dt, dt_bias, B, C, A_log, D, z, h0), None,
                True)
        else:
            out, h, bounds = selective_scan_fused_ref(
                x, dt, dt_bias, B, C, A_log, D, z, h0, bounds=True)
        ctx.save_for_backward(x, dt, dt_bias, B, C, A_log, D, z, h0, bounds)
        return out, h

    @staticmethod
    def backward(ctx, dout, dh_final):
        x, dt, dt_bias, B, C, A_log, D, z, h0, bounds = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(x)
        if x.is_cuda:
            return _bwd_cuda(x, dt, dt_bias, B, C, A_log, D, z, h0, dout,
                             dh_final, bounds)
        if x.is_meta:
            grads = tuple(None if t is None else torch.empty_like(t)
                          for t in (x, dt, dt_bias, B, C, A_log, D, z, h0))
            # the bound's b S D N exponentials; the saved boundaries are
            # not an input of the function
            _meta.account("selective_scan_fused_bwd",
                          x.numel() * A_log.shape[-1],
                          (x, dt, dt_bias, B, C, A_log, D, z, h0, dout,
                           dh_final), grads)
            return grads
        return selective_scan_fused_bwd_ref(x, dt, dt_bias, B, C, A_log, D,
                                            z, h0, dout, dh_final,
                                            bounds=bounds)


class SelectiveScanFusedBf16Fn(torch.autograd.Function):
    """:class:`SelectiveScanFusedFn` with the bfloat16 working type: on
    the card the forward kernel's bfloat16 instance that keeps the state
    entering every chunk of ``q`` steps (``(b, S / q, D, N)``), then the
    bfloat16 backward kernel on the saved inputs and those boundaries
    (it rebuilds each chunk's tree); on the CPU the plain versions,
    :func:`selective_scan_fused_bf16_ref` and
    :func:`selective_scan_fused_bf16_bwd_ref`, passing the boundaries the
    same way; on the meta device their work is counted."""

    @staticmethod
    def forward(ctx, x, dt, dt_bias, B, C, A_log, D, z, h0):
        ctx.set_materialize_grads(False)
        if x.is_cuda:
            bounds = _bounds_for(x, A_log.shape[-1], True)
            out, h = _fused_fwd_cuda(x, dt, dt_bias, B, C, A_log, D, z, h0,
                                     None, False, bounds, work_bf16=True)
        elif x.is_meta:
            out, h, bounds = _meta_fused_fwd(
                x, A_log, (x, dt, dt_bias, B, C, A_log, D, z, h0), None,
                True, True)
        else:
            out, h, bounds = selective_scan_fused_bf16_ref(
                x, dt, dt_bias, B, C, A_log, D, z, h0)
        ctx.save_for_backward(x, dt, dt_bias, B, C, A_log, D, z, h0, bounds)
        return out, h

    @staticmethod
    def backward(ctx, dout, dh_final):
        x, dt, dt_bias, B, C, A_log, D, z, h0, bounds = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(x)
        if x.is_cuda:
            return _bwd_cuda(x, dt, dt_bias, B, C, A_log, D, z, h0, dout,
                             dh_final, bounds, work_bf16=True)
        if x.is_meta:
            grads = tuple(None if t is None else torch.empty_like(t)
                          for t in (x, dt, dt_bias, B, C, A_log, D, z, h0))
            # as the float32 backward counts: the bound's b S D N
            # exponentials, the saved boundaries not an input
            _meta.account("selective_scan_bf16_bwd",
                          x.numel() * A_log.shape[-1],
                          (x, dt, dt_bias, B, C, A_log, D, z, h0, dout,
                           dh_final), grads)
            return grads
        return selective_scan_fused_bf16_bwd_ref(
            x, dt, dt_bias, B, C, A_log, D, z, h0, dout, dh_final,
            bounds=bounds)


#: Number of forward kernel launches made by either wrapper (never the
#: plain versions), of backward calls (``bwd_launches``, one per call of
#: the backward kernel), and the same counts split by input: ``(x shape,
#: N, dtype name)`` for :func:`selective_scan`, ``("fused", x.shape, N,
#: x.dtype, step)`` for :func:`selective_scan_fused`, ``("fused_bound",
#: x.shape, N, x.dtype)`` for the forward of :class:`SelectiveScanFusedFn`
#: (the instance that keeps the chunk boundaries), ``("fused_bwd",
#: x.shape, N, x.dtype)`` for a backward; with the bfloat16 working type
#: ``("fused_bf16", ...)``, ``("fused_bf16_bound", ...)`` and
#: ``("fused_bf16_bwd", ...)``, keyed alike.
selective_scan.launches = 0
selective_scan.bwd_launches = 0
selective_scan.shapes = Counter()

"""The collectives of the pipeline and the expert-parallel MoE, on
``torch.distributed``, and the process launcher.

The reference runs one SPMD program that XLA partitions, and writes its
collectives inside ``shard_map``: ``ppermute`` between pipeline stages,
``psum`` / ``pmean`` over a mesh axis, ``all_gather`` of FSDP shards.  The
port runs one process per rank, and each of those is an explicit call
here, on the group of a :class:`~repro_torch.launch.mesh.Mesh` axis.

``gloo`` moves host memory.  A CUDA tensor crosses it staged through
pinned host memory (a copy out, the transfer, a copy back: bit-exact),
which also lets several ranks share one GPU, where NCCL refuses two ranks
on one device.  :data:`STATS` counts the bytes each kind of call moved
(on the card, every one of them staged through host memory).

The autograd collectives of tensor parallelism, in Megatron's terms:
:func:`copy_to` is the column-parallel ``f`` (identity forward, sum of
the cotangents backward), :func:`sum_over` the row-parallel ``g`` (sum
forward, identity backward), :func:`gather_over` the FSDP gather of a
weight (its cotangent summed, then this rank's block), :func:`gather_rows`
the gather of an activation whose consumers are replicated (this rank's
block of the cotangent, no sum), and :func:`max_over` the vocabulary's
max (no gradient, as the reference's ``logsumexp`` stops it).
:func:`reduce_scatter` is the ZeRO-1 and FSDP gradient reduction: the sum
over an axis, of which each rank keeps its block.

Inside :func:`dry` no process group is needed: every collective returns
a meta tensor of its result's shape and counts its bytes as on the card,
for one rank of a mesh of any size (``launch/dryrun.py``).

:func:`spawn` starts the ranks as processes, each with its group up
(:func:`init_group`, a ``file://`` store in a fresh temporary directory,
never a fixed port), joins them within a time limit, kills them all on
any failure and re-raises the first failing rank's traceback.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

#: Bytes moved since the last :func:`reset_stats` (a CUDA tensor's staged
#: through host memory): ``p2p`` by :func:`send` and :func:`recv`,
#: ``collective`` by the
#: reductions and gathers; the collective bytes again by what the call is
#: for (its ``kind``): ``fsdp`` the FSDP gathers of weights and their
#: backward, ``tp`` the tensor-parallel sums and gathers of activations
#: (and the gradient norm's partial sums over the model axis), ``vocab``
#: the vocabulary-parallel embedding's sum, the head's sum of input
#: cotangents and the loss's reductions, ``data`` the reductions over the
#: data axes (gradients, the gradient norm, the loss, its token count),
#: ``decode`` a decode step's gathers of q, k and v over the heads, its
#: partial attentions' combine over the cache's sequence blocks and the
#: greedy token's reductions over the vocabulary blocks.
#: ``zero1`` the all-gather of the parameter blocks that ZeRO-1's optimizer
#: updated (the reduce-scatter of their gradients counts under ``data``).
STATS: Dict[str, int] = {"p2p": 0, "collective": 0, "fsdp": 0, "tp": 0,
                         "vocab": 0, "data": 0, "decode": 0, "zero1": 0}
_KINDS = ("fsdp", "tp", "vocab", "data", "decode", "zero1")
#: The same calls' bytes by the reference's HLO op names, as its cost
#: model (``launch/hlo_cost.py``) counts them: an operand's bytes, twice
#: for an all-reduce (a ring's traffic); a P2P send is a
#: ``collective-permute``.
OPS: Dict[str, int] = {"all-reduce": 0, "all-gather": 0,
                       "reduce-scatter": 0, "all-to-all": 0,
                       "collective-permute": 0}
_RING_MULT = {"all-reduce": 2, "all-gather": 1, "reduce-scatter": 1,
              "all-to-all": 1, "collective-permute": 1}


def reset_stats() -> None:
    for d in (STATS, OPS):
        for k in d:
            d[k] = 0


def _count(nbytes: int, kind: str, op: str, operand: int) -> None:
    """Add a staged collective's bytes to ``collective`` and to ``kind``
    (one of :data:`_KINDS`, or ``""`` for none), and its operand's to
    :data:`OPS` under the reference's name ``op``."""
    STATS["collective"] += nbytes
    if kind:
        STATS[kind] += nbytes
    OPS[op] += _RING_MULT[op] * operand


class _Dry:
    """The state of :func:`dry`: the rank it stands for."""

    def __init__(self, rank: int):
        self.rank = rank


_DRY: Optional[_Dry] = None


@contextlib.contextmanager
def dry(rank: int):
    """Run collectives without a process group, as global rank ``rank`` of
    whatever mesh the caller names: every call counts its bytes in
    :data:`STATS` and :data:`OPS` exactly as it would on that rank, and
    returns meta tensors of its result's shape (a reduction leaves its
    tensors as they are).  Model code that asks for its rank
    (:func:`rank`) gets ``rank``."""
    global _DRY
    prev, _DRY = _DRY, _Dry(rank)
    try:
        yield _DRY
    finally:
        _DRY = prev


def is_dry() -> bool:
    return _DRY is not None


def rank() -> int:
    """This process's global rank: the rank :func:`dry` stands for inside
    it, else the process group's (0 when none is up)."""
    if _DRY is not None:
        return _DRY.rank
    return dist.get_rank() if dist.is_initialized() else 0


def init_group(rank: int, world: int, store_path: str,
               backend: str = "gloo", timeout: float = 60.0) -> None:
    """Join the default process group as ``rank`` of ``world`` through a
    ``file://`` store at ``store_path`` (a file that does not exist yet,
    the same for every rank), with ``timeout`` seconds for every
    collective."""
    dist.init_process_group(
        backend, init_method=f"file://{os.path.abspath(store_path)}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))


def _staged(t: torch.Tensor) -> bool:
    """Whether ``t`` crosses the backend through host memory."""
    return t.is_cuda and dist.is_initialized() and \
        dist.get_backend() == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of the CUDA tensor ``t`` (the copy waits for the
    device)."""
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


class _Pending:
    """An asynchronous send: its work handle and the buffer that must live
    until it completes."""

    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self) -> None:
        if self.work is not None:
            self.work.wait()
        self.buf = None


def send(t: torch.Tensor, dst: int) -> _Pending:
    """Start sending ``t`` to global rank ``dst``; ``.wait()`` the result
    before the end of the step."""
    nbytes = t.numel() * t.element_size()
    STATS["p2p"] += nbytes
    OPS["collective-permute"] += nbytes
    if _DRY is not None:
        return _Pending(None, None)
    buf = _host(t) if _staged(t) else t.contiguous()
    return _Pending(dist.isend(buf, dst), buf)


def recv(shape, dtype: torch.dtype, device, src: int) -> torch.Tensor:
    """Receive a tensor of ``shape`` and ``dtype`` from global rank
    ``src`` onto ``device``."""
    device = torch.device(device)
    if _DRY is not None:
        buf = torch.empty(tuple(shape), dtype=dtype, device=device)
        STATS["p2p"] += buf.numel() * buf.element_size()
        return buf
    staged = device.type == "cuda" and dist.get_backend() == "gloo"
    buf = torch.empty(tuple(shape), dtype=dtype, pin_memory=staged,
                      device="cpu" if staged else device)
    dist.recv(buf, src)
    STATS["p2p"] += buf.numel() * buf.element_size()
    return buf.to(device) if staged else buf


def wait_all(pending: List[_Pending]) -> None:
    for p in pending:
        p.wait()
    pending.clear()


def _reduce_host(buf: torch.Tensor, mesh, axis: str, op: str) -> None:
    """``buf`` (a host or non-staged tensor) summed, averaged or maxed
    over this rank's line of ``axis`` in place."""
    if op not in ("sum", "mean", "max"):
        raise ValueError(f"op must be 'sum', 'mean' or 'max', got {op!r}")
    n = mesh.shape[axis]
    if n > 1:
        red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        dist.all_reduce(buf, op=red, group=mesh.group(axis))
    if op == "mean":
        buf.div_(torch.full((), float(n), dtype=buf.dtype))


def all_reduce(tensors: Sequence[torch.Tensor], mesh, axis: str,
               op: str = "sum", kind: str = "") -> None:
    """Sum (``op="sum"``), average (``"mean"``: the sum, then divided by
    the axis size) or take the largest of (``"max"``) each tensor over
    this rank's line of ``axis``, in place.  The tensors of one type go as
    one flat bucket: one transfer per type.  Every rank of the line gets
    the same bits.  ``kind`` names what the call is for in
    :data:`STATS`."""
    if mesh.shape[axis] == 1:
        return
    by_type: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_type.setdefault(t.dtype, []).append(t)
    for ts in by_type.values():
        # the dry run makes the same tensors on its device, and skips the
        # transfer
        flat = torch.cat([t.reshape(-1) for t in ts])
        staged = _staged(flat)
        buf = _host(flat) if staged else flat
        _count(buf.numel() * buf.element_size(), kind, "all-reduce",
               buf.numel() * buf.element_size())
        if _DRY is None:
            _reduce_host(buf, mesh, axis, op)
        if staged:
            flat.copy_(buf)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int,
               kind: str = "") -> torch.Tensor:
    """The blocks of ``t`` of every rank of this rank's line of ``axis``,
    concatenated along ``dim`` in the mesh's coordinate order (the
    reference's ``all_gather(..., tiled=True)``)."""
    n = mesh.shape[axis]
    if n == 1:
        return t
    block = t.numel() * t.element_size()
    if _DRY is not None:
        # the blocks land on the device, then are joined: both on the
        # device at once, as on a rank
        _count(n * block, kind, "all-gather", block)
        return torch.cat(list(t.new_empty((n,) + tuple(t.shape)).unbind(0)),
                         dim=dim)
    group = mesh.group(axis)
    staged = _staged(t)
    src = _host(t) if staged else t.contiguous()
    if staged:
        # the blocks land in one pinned buffer, which goes to the card in
        # one copy
        buf = torch.empty((n,) + tuple(src.shape), dtype=src.dtype,
                          pin_memory=True)
        parts = list(buf.unbind(0))
    else:
        parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    _count(n * block, kind, "all-gather", block)
    if staged:
        parts = list(buf.to(t.device).unbind(0))
    # the group lists its ranks in ascending order; the mesh's order may
    # differ (a permuted mapping)
    me = dist.get_rank()
    line = mesh.axis_ranks(axis, me)
    by_rank = dict(zip(sorted(line), parts))
    return torch.cat([by_rank[r] for r in line], dim=dim)


def reduce_scatter(tensors: List[torch.Tensor], mesh, axis: str,
                   dims: Sequence[int], op: str = "sum",
                   kind: str = "") -> List[torch.Tensor]:
    """Each tensor summed (``op="sum"``) or averaged (``"mean"``) over this
    rank's line of ``axis``, and of that only this rank's block along its
    dim of ``dims`` (cut in the mesh's coordinate order), as new
    tensors: an :func:`all_reduce` then a cut, at a reduce-scatter's
    bytes.  ``gloo`` has no reduce-scatter of its own, so each rank sends
    every other rank its block of the input (one ``all_to_all`` per type,
    staged through pinned host memory on the card) and adds the blocks it
    receives in coordinate order, a left fold: on a line of two ranks the
    sum of two, which is :func:`all_reduce`'s bits.  Every dim must divide
    over the line.

    The list ``tensors`` is handed over: each entry is dropped (set to
    None) once its blocks are staged, so an input the caller keeps no
    other reference to is freed then, and no copy of the whole is made
    on the card."""
    n = mesh.shape[axis]
    if op not in ("sum", "mean"):
        raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")
    for t, d in zip(tensors, dims):
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not divide "
                             f"over {n} ranks of {axis!r}")
    if n == 1:
        return [t.clone() for t in tensors]
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_type: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_type.setdefault(t.dtype, []).append(i)
    for idx in by_type.values():
        # each tensor's moved shape (its dim first) and its block's columns
        moved = {i: tuple(tensors[i].movedim(dims[i], 0).shape)
                 for i in idx}
        cols = {i: tensors[i].numel() // n for i in idx}
        width = sum(cols.values())  # repro: noqa DET004 -- element counts are ints; integer addition is order-independent
        first = tensors[idx[0]]
        dtype, device, staged = first.dtype, first.device, _staged(first)
        nbytes = n * width * first.element_size()
        del first
        _count(nbytes, kind, "reduce-scatter", nbytes)
        if _DRY is not None:
            for i in idx:
                tensors[i] = None
            # the sum and one received row on the device at once, as on a
            # rank
            total = torch.empty((width,), dtype=dtype, device=device)
            total.add_(torch.empty_like(total))
        else:
            me = dist.get_rank()
            line = list(mesh.axis_ranks(axis, me))
            order = sorted(line)                  # the group's rank order
            send = torch.empty((n, width), dtype=dtype,
                               pin_memory=staged,
                               device="cpu" if staged else device)
            off = 0
            for i in idx:
                per = moved[i][0] // n
                src = tensors[i].movedim(dims[i], 0).unflatten(0, (n, per))
                for j, r in enumerate(order):     # rows in the group's order
                    send[j, off:off + cols[i]].view(
                        (per,) + moved[i][1:]).copy_(src[line.index(r)])
                off += cols[i]
                tensors[i] = src = None
            got = torch.empty_like(send)
            dist.all_to_all_single(got, send, group=mesh.group(axis))
            del send
            # row j came from the group's j-th rank; fold in mesh order
            rows = [got[order.index(r)] for r in line]
            total = rows[0].to(device, copy=True)
            for part in rows[1:]:
                total.add_(part.to(device))
            del rows, got
            if op == "mean":
                total.div_(torch.full((), float(n), dtype=total.dtype,
                                      device=total.device))
        off = 0
        for i in idx:                   # copies: the bucket is freed here
            per = moved[i][0] // n
            out[i] = total[off:off + cols[i]].view(
                (per,) + moved[i][1:]).movedim(0, dims[i]).clone(
                    memory_format=torch.contiguous_format)
            off += cols[i]
        del total
    return out


class _SumOver(torch.autograd.Function):
    """Forward: the sum over an axis.  Backward: the identity — the sum is
    replicated over the axis, so every rank holds the same cotangent of
    it."""

    @staticmethod
    def forward(ctx, x, mesh, axis, kind):
        y = x.clone()
        all_reduce([y], mesh, axis, "sum", kind)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _CopyTo(torch.autograd.Function):
    """Forward: the identity on a tensor replicated over an axis.
    Backward: the sum over the axis of every rank's partial cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, axis, kind):
        ctx.mesh, ctx.axis, ctx.kind = mesh, axis, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        all_reduce([g], ctx.mesh, ctx.axis, "sum", ctx.kind)
        return g, None, None, None


class _Gather(torch.autograd.Function):
    """Forward: :func:`all_gather` along ``dim``.  Backward: the
    cotangent summed over the axis, then this rank's block of it (with
    ``reduce`` false, this rank's block alone)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, kind, reduce):
        ctx.mesh, ctx.axis, ctx.dim, ctx.kind = mesh, axis, dim, kind
        ctx.size, ctx.reduce = x.shape[dim], reduce
        return all_gather(x, mesh, axis, dim, kind)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            g = g.contiguous().clone()
            all_reduce([g], ctx.mesh, ctx.axis, "sum", ctx.kind)
        me = rank()
        line = ctx.mesh.axis_ranks(ctx.axis, me)
        i = line.index(me)
        return (g.narrow(ctx.dim, i * ctx.size, ctx.size).contiguous(),
                None, None, None, None, None)


def sum_over(x: torch.Tensor, mesh, axis: str,
             kind: str = "tp") -> torch.Tensor:
    """``psum`` of a partial result whose sum is replicated over ``axis``
    (differentiable; the gradient passes through unchanged)."""
    return _SumOver.apply(x, mesh, axis, kind)


def copy_to(x: torch.Tensor, mesh, axis: str,
            kind: str = "tp") -> torch.Tensor:
    """Mark ``x`` as replicated over ``axis``: the identity, whose gradient
    is summed over the axis (each rank's use adds its part)."""
    return _CopyTo.apply(x, mesh, axis, kind)


def gather_over(x: torch.Tensor, mesh, axis: str, dim: int,
                kind: str = "fsdp") -> torch.Tensor:
    """Differentiable :func:`all_gather` (an FSDP weight gathered for
    use); the gradient of the gathered tensor is summed over the axis and
    this rank's block kept (an all-reduce then a cut: a reduce-scatter's
    result at twice its bytes)."""
    return _Gather.apply(x, mesh, axis, dim, kind, True)


def gather_rows(x: torch.Tensor, mesh, axis: str, dim: int,
                kind: str = "tp") -> torch.Tensor:
    """Differentiable :func:`all_gather` of an activation whose consumers
    are replicated over ``axis`` (the sequence-sharded attention's output
    rows): every rank then holds the same cotangent of the whole, and the
    gradient of ``x`` is this rank's block of it, not summed (a sum would
    multiply it by the axis size)."""
    return _Gather.apply(x, mesh, axis, dim, kind, False)


def max_over(x: torch.Tensor, mesh, axis: str,
             kind: str = "vocab") -> torch.Tensor:
    """The elementwise largest of ``x`` over ``axis``, detached: the
    stabiliser of a vocabulary-parallel ``logsumexp``, whose gradient the
    reference stops too (``jax.nn.logsumexp`` takes ``stop_gradient`` of
    its max; the result does not depend on it)."""
    with torch.no_grad():
        y = x.detach().clone()
        all_reduce([y], mesh, axis, "max", kind)
    return y


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------

class RankFailed(RuntimeError):
    """A rank raised (its traceback in the message), died, or the ranks
    outlived their time limit."""


def _child(fn, rank, world, store, backend, group_timeout, threads, args,
           results):
    try:
        if threads:
            torch.set_num_threads(threads)
        init_group(rank, world, store, backend, group_timeout)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                          # reported to the parent
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable[..., Any], world: int, args: tuple = (), *,
          timeout: float = 120.0, backend: str = "gloo",
          group_timeout: float = 60.0, threads: int = 0) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes (the
    ``spawn`` start method), each inside a process group of ``world``
    ranks (:func:`init_group` with ``group_timeout``), and return their
    results in rank order (they must pickle; ``fn`` must be importable).

    Every process is killed when a rank raises or dies, or when
    ``timeout`` seconds pass; then :class:`RankFailed` is raised, with the
    first failing rank's traceback.  ``threads`` sets each rank's
    ``torch.set_num_threads`` (0 leaves it)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_group_")
    store = os.path.join(tmp, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(
        fn, r, world, store, backend, group_timeout, threads, args,
        results), daemon=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    out: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RankFailed(f"ranks {sorted(set(range(world)) - set(out))}"
                                 f" did not finish within {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    # a last look for its report before calling it dead
                    try:
                        rank, ok, value = results.get(timeout=2.0)
                    except queue.Empty:
                        raise RankFailed(
                            f"rank {dead[0]} died with exit code "
                            f"{procs[dead[0]].exitcode}") from None
                else:
                    continue
            if not ok:
                raise RankFailed(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.pid is None:                      # never started
                continue
            if p.is_alive():
                p.kill()
            p.join(5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]

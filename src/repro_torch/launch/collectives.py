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
on one device.  :data:`STATS` counts the bytes each kind of call staged.

:func:`spawn` starts the ranks as processes, each with its group up
(:func:`init_group`, a ``file://`` store in a fresh temporary directory,
never a fixed port), joins them within a time limit, kills them all on
any failure and re-raises the first failing rank's traceback.
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence

import torch
import torch.distributed as dist

#: Bytes staged through host memory since the last :func:`reset_stats`:
#: ``p2p`` by :func:`send` and :func:`recv`, ``collective`` by the
#: reductions and gathers.
STATS: Dict[str, int] = {"p2p": 0, "collective": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


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
        self.work.wait()
        self.buf = None


def send(t: torch.Tensor, dst: int) -> _Pending:
    """Start sending ``t`` to global rank ``dst``; ``.wait()`` the result
    before the end of the step."""
    buf = _host(t) if _staged(t) else t.contiguous()
    if _staged(t):
        STATS["p2p"] += buf.numel() * buf.element_size()
    return _Pending(dist.isend(buf, dst), buf)


def recv(shape, dtype: torch.dtype, device, src: int) -> torch.Tensor:
    """Receive a tensor of ``shape`` and ``dtype`` from global rank
    ``src`` onto ``device``."""
    device = torch.device(device)
    staged = device.type == "cuda" and dist.get_backend() == "gloo"
    buf = torch.empty(tuple(shape), dtype=dtype, pin_memory=staged,
                      device="cpu" if staged else device)
    dist.recv(buf, src)
    if not staged:
        return buf
    STATS["p2p"] += buf.numel() * buf.element_size()
    return buf.to(device)


def wait_all(pending: List[_Pending]) -> None:
    for p in pending:
        p.wait()
    pending.clear()


def _reduce_host(buf: torch.Tensor, mesh, axis: str, op: str) -> None:
    """``buf`` (a host or non-staged tensor) summed, or averaged, over
    this rank's line of ``axis`` in place."""
    n = mesh.shape[axis]
    if n > 1:
        dist.all_reduce(buf, group=mesh.group(axis))
    if op == "mean":
        buf.div_(torch.full((), float(n), dtype=buf.dtype))
    elif op != "sum":
        raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")


def all_reduce(tensors: Sequence[torch.Tensor], mesh, axis: str,
               op: str = "sum") -> None:
    """Sum (``op="sum"``) or average (``"mean"``: the sum, then divided by
    the axis size) each tensor over this rank's line of ``axis``, in
    place.  The tensors of one type go as one flat bucket: one transfer
    per type.  Every rank of the line gets the same bits."""
    if mesh.shape[axis] == 1:
        return
    by_type: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_type.setdefault(t.dtype, []).append(t)
    for ts in by_type.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        staged = _staged(flat)
        buf = _host(flat) if staged else flat
        if staged:
            STATS["collective"] += buf.numel() * buf.element_size()
        _reduce_host(buf, mesh, axis, op)
        if staged:
            flat.copy_(buf)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The blocks of ``t`` of every rank of this rank's line of ``axis``,
    concatenated along ``dim`` in the mesh's coordinate order (the
    reference's ``all_gather(..., tiled=True)``)."""
    n = mesh.shape[axis]
    if n == 1:
        return t
    group = mesh.group(axis)
    staged = _staged(t)
    src = _host(t) if staged else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    if staged:
        STATS["collective"] += n * src.numel() * src.element_size()
    # the group lists its ranks in ascending order; the mesh's order may
    # differ (a permuted mapping)
    me = dist.get_rank()
    line = mesh.axis_ranks(axis, me)
    by_rank = dict(zip(sorted(line), parts))
    out = torch.cat([by_rank[r] for r in line], dim=dim)
    return out.to(t.device) if staged else out


class _SumOver(torch.autograd.Function):
    """Forward: the sum over an axis.  Backward: the identity — the sum is
    replicated over the axis, so every rank holds the same cotangent of
    it."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        y = x.clone()
        all_reduce([y], mesh, axis, "sum")
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    """Forward: the identity on a tensor replicated over an axis.
    Backward: the sum over the axis of every rank's partial cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        all_reduce([g], ctx.mesh, ctx.axis, "sum")
        return g, None, None


class _Gather(torch.autograd.Function):
    """Forward: :func:`all_gather` along ``dim``.  Backward: the
    cotangent summed over the axis, then this rank's block of it."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.size = x.shape[dim]
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce([g], ctx.mesh, ctx.axis, "sum")
        line = ctx.mesh.axis_ranks(ctx.axis, dist.get_rank())
        i = line.index(dist.get_rank())
        return (g.narrow(ctx.dim, i * ctx.size, ctx.size).contiguous(),
                None, None, None)


def sum_over(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``psum`` of a partial result whose sum is replicated over ``axis``
    (differentiable; the gradient passes through unchanged)."""
    return _SumOver.apply(x, mesh, axis)


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Mark ``x`` as replicated over ``axis``: the identity, whose gradient
    is summed over the axis (each rank's use adds its part)."""
    return _CopyTo.apply(x, mesh, axis)


def gather_over(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Differentiable :func:`all_gather` (an FSDP weight gathered for
    use); the gradient of the gathered tensor is reduce-scattered back."""
    return _Gather.apply(x, mesh, axis, dim)


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

"""Rank meshes: a Pipette mapping becomes ranks on GPUs.

Port of the JAX package's ``launch/mesh.py``.  The reference arranges
``jax.Device`` objects into a ``jax.sharding.Mesh``; the port arranges the
ranks of a ``torch.distributed`` process group.  The mapping **is** the
rank permutation: the rank at ``ranks[x, y, z]`` is GPU ``f(x, y, z)`` of
Pipette's worker dedication, so the mapping steers which links each axis
uses.  A :class:`Mesh` is a value (ranks, axis names, sizes) and needs no
process group; :meth:`Mesh.group` and :meth:`Mesh.device_mesh` need one.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


class Mesh:
    """``ranks`` (an int array shaped like the mesh) with ``axis_names``,
    one per dim; ``shape`` maps each name to its size, in axis order, as
    ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, ranks, axis_names: Sequence[str]):
        ranks = np.asarray(ranks, dtype=np.int64)
        axis_names = tuple(axis_names)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"{ranks.ndim}-d ranks with {len(axis_names)} "
                             f"axis names {axis_names}")
        self.ranks = ranks
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, ranks.shape))
        self._groups: Optional[Dict[str, tuple]] = None

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def __repr__(self) -> str:
        flat = self.ranks.reshape(-1).tolist()
        return f"Mesh({self.shape}, ranks={flat})"

    def coords(self, rank: int) -> Dict[str, int]:
        """``rank``'s coordinate along every axis."""
        where = np.argwhere(self.ranks == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not in {self!r}")
        return dict(zip(self.axis_names, (int(c) for c in where[0])))

    def axis_ranks(self, axis: str, rank: int) -> Tuple[int, ...]:
        """The ranks of ``rank``'s line along ``axis``, in coordinate
        order (the ranks that share its other coordinates)."""
        c = self.coords(rank)
        idx = tuple(slice(None) if a == axis else c[a]
                    for a in self.axis_names)
        return tuple(int(r) for r in self.ranks[idx])

    def group(self, axis: str):
        """This process's ``torch.distributed`` group along ``axis``.

        The first call makes the groups of every line of every axis, in one
        fixed order, so every rank of the process group must make it, at
        the same point of its program (``new_group`` is collective).  A
        group numbers its ranks in ascending global order; use
        :meth:`axis_ranks` for the mesh's order."""
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("Mesh.group needs a torch.distributed process "
                               "group; none is up (see launch/collectives."
                               "init_group)")
        if dist.get_world_size() < self.size:
            raise RuntimeError(f"a mesh of {self.size} ranks in a process "
                               f"group of {dist.get_world_size()}")
        if self._groups is None:
            me = dist.get_rank()
            groups = {}
            for i, a in enumerate(self.axis_names):
                lines = np.moveaxis(self.ranks, i, -1).reshape(
                    -1, self.ranks.shape[i])
                for line in lines:
                    members = [int(r) for r in line]
                    g = dist.new_group(members)
                    if me in members:
                        groups[a] = g
            self._groups = groups
        return self._groups[axis]

    def device_mesh(self, device_type: str):
        """``torch.distributed.device_mesh.DeviceMesh`` of these ranks and
        axis names (collective: every rank makes it)."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        if not dist.is_initialized() or dist.get_world_size() < self.size:
            raise RuntimeError(f"a DeviceMesh of {self.size} ranks needs a "
                               f"process group of at least as many")
        return DeviceMesh(device_type, torch.as_tensor(self.ranks),
                          mesh_dim_names=self.axis_names)


def _world_size() -> int:
    """The process group's size when one is up, else 1 (this process)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_production_mesh(*, multi_pod: bool = False,
                         ranks: Optional[Sequence[int]] = None) -> Mesh:
    """The production mesh's spec: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")``.
    Ranks in order unless ``ranks`` are given; no process group needed."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    r = np.arange(n) if ranks is None else np.asarray(ranks)
    return Mesh(r.reshape(shape), axes)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              permutation: Optional[np.ndarray] = None) -> Mesh:
    """A mesh of the first ``prod(shape)`` ranks, in order or permuted by
    ``permutation`` (a Pipette dedication)."""
    n = int(np.prod(shape))
    m = _world_size()
    if m < n:
        raise ValueError(f"need {n} devices, have {m}")
    ranks = np.arange(n)
    if permutation is not None:
        ranks = ranks[np.asarray(permutation).reshape(-1)]
    return Mesh(ranks.reshape(tuple(shape)), axes)


def mesh_from_mapping(conf, mapping: np.ndarray, axes=None) -> Mesh:
    """Pipette Map ``(pp, tp[, cp], dp)`` -> the mesh whose ``[x, y(, k),
    z]`` rank is GPU ``f(...)``.  ``axes`` defaults to ``("pipe",
    "model", "data")`` for a 3D mapping and ``("pipe", "model",
    "context", "data")`` for a 4D one."""
    mapping = np.asarray(mapping)
    if axes is None:
        axes = ("pipe", "model", "context", "data") if mapping.ndim == 4 \
            else ("pipe", "model", "data")
    ranks = np.arange(conf.n_gpus)
    return Mesh(ranks[mapping], tuple(axes))


def mesh_from_plan(plan, axes=None) -> Mesh:
    """The training mesh a configurator Plan prescribes (``Plan.load(path)``
    then this is the whole launch path; no re-search).

    Raises:
        ValueError: the plan is infeasible (its search found no runnable
            configuration, so there is nothing to build).
    """
    if plan.conf is None:
        raise ValueError(
            f"plan is infeasible (strategy {plan.provenance.strategy!r} "
            f"found no runnable configuration); nothing to build")
    return mesh_from_mapping(plan.conf, plan.mapping, axes=axes)

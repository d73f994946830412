"""Sharding context of the model functions, in its single-device form.

The JAX package's ``models/sharding.py`` threads a ``ShardCtx`` (mesh and
axis names) through every model function and constrains activations to
partition specs.  The port runs the model on one device, so only the
inactive context exists here: no mesh, and :meth:`ShardCtx.constrain` is
the identity.  Partition specs for a mesh (``param_spec``, ``tree_pspecs``)
wait for the launch and distribution slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    mesh: Optional[object] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "the PyTorch package runs the model on one device; a mesh "
                "comes with the launch and distribution slice (ROADMAP "
                "Queue A 11)")

    @property
    def active(self) -> bool:
        return False

    def constrain(self, x, spec=None):
        return x

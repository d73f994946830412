"""PowerSGD-style low-rank gradient compression with error feedback.

Port of the JAX package's ``optim/compression.py``.  Matrix-shaped gradient
blocks are factored ``G ~= P Q^T`` (rank ``r``) so a data-parallel
all-reduce would move ``r (m + n)`` values instead of ``m n``; the residual
is fed back into the next step so the compression error stays bounded.

Where the reference draws each leaf's random factor from a split JAX key,
the port draws it from an explicit ``torch.Generator`` — the two give
different numbers — or takes the factors from the caller (``q``), so that a
test can hand both packages the same ones.  The factorisation is invariant
to the signs of the orthonormal basis that the QR returns, so the
approximation and the new error agree across the packages given the same
``q``; the factors themselves may differ in the sign of a column.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch

from .._tree import flatten, leaves, tree_map, unflatten


@dataclass(frozen=True)
class Factors:
    """One compressed leaf: ``p`` ``(rows, r)`` and ``qt`` ``(cols, r)``
    float32, and the gradient's shape and type (a leaf of the tree, where
    the reference keeps a 4-tuple)."""
    p: torch.Tensor
    qt: torch.Tensor
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclass(frozen=True)
class PowerSGD:
    rank: int = 4
    min_compress_size: int = 65536   # small tensors ride uncompressed

    def _eligible(self, g: torch.Tensor) -> bool:
        return g.dim() >= 2 and g.numel() >= self.min_compress_size

    def init_error(self, params) -> Any:
        return tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
            if self._eligible(p) else torch.zeros((), dtype=torch.float32,
                                                  device=p.device), params)

    def compress(self, grads, errors,
                 generator: Optional[torch.Generator] = None,
                 q: Optional[Sequence[Optional[torch.Tensor]]] = None
                 ) -> Tuple[Any, Any]:
        """Returns ``(compressed-or-raw tree, new errors)``.  Each eligible
        leaf's random factor ``(cols, r)`` is ``q[i]`` (``i`` its index in
        the leaf order) when ``q`` is given, else a standard normal draw
        from ``generator``; one of the two is required."""
        if generator is None and q is None:
            raise ValueError("PowerSGD.compress needs a generator or the "
                             "random factors q")
        flat_g, treedef = flatten(grads)
        flat_e = leaves(errors)
        out_g, out_e = [], []
        for i, (g, e) in enumerate(zip(flat_g, flat_e)):
            if not self._eligible(g):
                out_g.append(g)
                out_e.append(e)
                continue
            m = g.reshape(g.shape[0], -1).float()
            if e.dim():
                m = m + e.reshape(m.shape)
            r = min(self.rank, *m.shape)
            if q is not None:
                qi = q[i].to(device=m.device, dtype=torch.float32)
            else:
                qi = torch.randn((m.shape[1], r), generator=generator,
                                 dtype=torch.float32, device=m.device)
            p = m @ qi                                 # (rows, r)
            p, _ = torch.linalg.qr(p)                  # orthonormal basis
            qt = m.T @ p                               # (cols, r)
            approx = p @ qt.T
            out_g.append(Factors(p, qt, tuple(g.shape), g.dtype))
            out_e.append((m - approx).reshape(g.shape))
        return unflatten(treedef, out_g), unflatten(treedef, out_e)

    def decompress(self, compressed) -> Any:
        def dec(leaf):
            if isinstance(leaf, Factors):
                return (leaf.p @ leaf.qt.T).reshape(leaf.shape).to(
                    leaf.dtype)
            return leaf
        return tree_map(dec, compressed)

    def roundtrip(self, grads, errors,
                  generator: Optional[torch.Generator] = None,
                  q: Optional[Sequence[Optional[torch.Tensor]]] = None):
        """compress -> decompress with error feedback; returns
        ``(approx_grads, new_errors)``.  The compressed factors are what the
        data-parallel all-reduce would carry."""
        comp, new_e = self.compress(grads, errors, generator, q)
        return self.decompress(comp), new_e

    def compression_ratio(self, params) -> float:
        full = comp = 0
        for p in leaves(params):
            full += p.numel()
            if self._eligible(p):
                rows = p.shape[0]
                cols = p.numel() // rows
                r = min(self.rank, rows, cols)
                comp += r * (rows + cols)
            else:
                comp += p.numel()
        return full / max(comp, 1)

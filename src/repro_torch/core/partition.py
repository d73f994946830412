"""Non-uniform pipeline partitions: the `Partition` artifact and the DP
balanced-partition solver.

The paper's Eq. 3-6 model (and the seed's whole stack) assumes a ceil/floor
uniform layer split per pipeline stage.  That is exactly wrong for the
model zoo this repo carries: kimi_k2 interleaves cheap routed-MoE layers
with a vocabulary GEMM ~2.5 layer-equivalents heavy at each end, and
zamba2/falcon_mamba hybrids apply a shared attention block every
``hybrid_attn_period``-th layer, making those layers several times more
expensive than their mamba neighbours.  This module turns the per-layer
cost vector (``core/flops.py``) into stage boundaries that minimize the
*heaviest* stage — the quantity the 1F1B steady state is paced by
(``_hetero_combine``'s ``c_max``).

Solver contract (locked by ``tests/test_partition.py``):

* exact DP over contiguous splits, O(pp * L^2) — minimizes the max stage
  cost, tie-broken by the minimal sum of squared stage costs;
* reconstruction walks left-to-right taking the *largest* stage size among
  optimal continuations, so a uniform cost vector (zero endpoint costs)
  degenerates to exactly the legacy ceil-first split of
  ``stage_work(n_layers, pp)``;
* ``head_cost`` / ``tail_cost`` model work pinned to the end stages (the
  embedding and LM-head GEMMs) that the uniform model amortized ``1/pp``.

Everything here is pure host-side NumPy/Python — deterministic by
construction, no RNG, no wall clock.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from . import flops as F
from ..models.config import ModelConfig

#: Schedule names a Conf can carry (``Conf.schedule``); the plan verifier's
#: PLN009 rule rejects anything else.
SCHEDULES = ("1f1b", "interleaved-1f1b")

#: Partition modes a SearchSpace can request.
PARTITION_MODES = ("uniform", "dp")


@dataclass(frozen=True)
class Partition:
    """A contiguous layer-to-stage assignment.

    ``boundaries`` are cumulative layer counts: stage ``x`` owns layers
    ``[boundaries[x-1], boundaries[x])`` (with an implicit leading 0), so
    ``len(boundaries) == pp`` and ``boundaries[-1] == n_layers``.
    """
    n_layers: int
    boundaries: Tuple[int, ...]

    def __post_init__(self):
        if self.n_layers <= 0:
            raise ValueError("n_layers must be positive")
        b = self.boundaries
        if not b or b[-1] != self.n_layers:
            raise ValueError("boundaries must cover exactly n_layers")
        if b[0] < 1 or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError("boundaries must be strictly increasing")

    @property
    def pp(self) -> int:
        return len(self.boundaries)

    @property
    def sizes(self) -> Tuple[int, ...]:
        """Per-stage layer counts."""
        prev, out = 0, []
        for b in self.boundaries:
            out.append(b - prev)
            prev = b
        return tuple(out)

    def stage_slices(self) -> Tuple[slice, ...]:
        prev, out = 0, []
        for b in self.boundaries:
            out.append(slice(prev, b))
            prev = b
        return tuple(out)

    def stage_sums(self, per_layer: np.ndarray) -> np.ndarray:
        """Sum a per-layer vector over each stage."""
        csum = np.concatenate(([0.0], np.cumsum(np.asarray(per_layer,
                                                           np.float64))))
        b = np.asarray((0,) + self.boundaries)
        return csum[b[1:]] - csum[b[:-1]]

    def is_uniform(self) -> bool:
        """True iff this is exactly the legacy ceil-first split."""
        return self == uniform_partition(self.n_layers, self.pp)

    def to_json_dict(self) -> dict:
        return {"n_layers": self.n_layers,
                "boundaries": list(self.boundaries)}

    @classmethod
    def from_json_dict(cls, d: dict) -> "Partition":
        return cls(n_layers=int(d["n_layers"]),
                   boundaries=tuple(int(x) for x in d["boundaries"]))


def uniform_partition(n_layers: int, pp: int) -> Partition:
    """The legacy ceil-first split: the first ``n_layers % pp`` stages get
    ``ceil(n_layers / pp)`` layers, the rest ``floor`` (matches
    ``stage_work``'s two-value convention)."""
    base, rem = divmod(n_layers, pp)
    sizes = [base + 1 if x < rem else base for x in range(pp)]
    return Partition(n_layers, tuple(np.cumsum(sizes).tolist()))


def balanced_partition(costs: Sequence[float], pp: int, *,
                       head_cost: float = 0.0,
                       tail_cost: float = 0.0) -> Partition:
    """Exact DP min-max contiguous partition of ``costs`` into ``pp``
    stages; ``head_cost``/``tail_cost`` are added to stage 0 / stage pp-1.

    Objective is lexicographic ``(max stage cost, sum of squared stage
    costs)``; among optimal splits the reconstruction prefers the largest
    leading stage, so uniform costs with zero endpoints return exactly
    ``uniform_partition`` (the degeneration contract)."""
    c = np.asarray(costs, dtype=np.float64)
    L = len(c)
    if not 1 <= pp <= L:
        raise ValueError(f"need 1 <= pp <= n_layers, got pp={pp}, L={L}")
    csum = np.concatenate(([0.0], np.cumsum(c)))

    def seg(i: int, j: int, s: int) -> float:
        cost = float(csum[j] - csum[i])
        if s == 0:
            cost += head_cost
        if s == pp - 1:
            cost += tail_cost
        return cost

    inf = float("inf")
    # f[s][i] = best (max, sumsq) splitting layers[i:] into stages s..pp-1
    f: list = [dict() for _ in range(pp + 1)]
    f[pp] = {L: (0.0, 0.0)}
    for s in range(pp - 1, -1, -1):
        lo = s                      # at least one layer per earlier stage
        hi = L - (pp - s)           # leave one layer per later stage
        for i in range(lo, hi + 1):
            best = (inf, inf)
            for j in range(i + 1, L - (pp - s - 1) + 1):
                nxt = f[s + 1].get(j)
                if nxt is None:
                    continue
                cost = seg(i, j, s)
                cand = (max(cost, nxt[0]), cost * cost + nxt[1])
                if cand < best:
                    best = cand
            f[s][i] = best

    bounds = []
    i = 0
    for s in range(pp):
        target = f[s][i]
        pick = None
        for j in range(i + 1, L - (pp - s - 1) + 1):
            nxt = f[s + 1].get(j)
            if nxt is None:
                continue
            cost = seg(i, j, s)
            if (max(cost, nxt[0]), cost * cost + nxt[1]) == target:
                pick = j            # keep scanning: largest j wins ties
        assert pick is not None, "DP reconstruction lost the optimum"
        bounds.append(pick)
        i = pick
    return Partition(L, tuple(bounds))


def make_partition(cfg: ModelConfig, pp: int, seq: int,
                   mode: str = "uniform") -> Partition:
    """Build the partition for one pipeline depth.

    ``"uniform"`` is the legacy ceil-first split; ``"dp"`` balances the
    per-layer cost vector with the embedding/LM-head GEMMs pinned to the
    end stages."""
    if mode not in PARTITION_MODES:
        raise ValueError(f"unknown partition mode {mode!r} "
                         f"(choose from {PARTITION_MODES})")
    if mode == "uniform":
        return uniform_partition(cfg.n_layers, pp)
    e = F.embed_cost_per_token(cfg)
    return balanced_partition(F.layer_cost_per_token(cfg, seq), pp,
                              head_cost=e, tail_cost=e)


def resolve_partition(cfg: ModelConfig, pp: int, seq: int,
                      mode: str = "uniform") -> Optional[Partition]:
    """``make_partition``, degenerated: returns None whenever the chosen
    boundaries equal the legacy ceil-first split, so every consumer can
    gate its bit-exact historical path on ``partition is None``."""
    if mode == "uniform" or pp <= 1:
        return None
    part = make_partition(cfg, pp, seq, mode)
    return None if part.is_uniform() else part


class PartitionCache:
    """Memoizes ``resolve_partition`` per pipeline depth (the partition
    depends only on ``pp`` for a fixed workload + mode)."""

    def __init__(self, cfg: ModelConfig, seq: int, mode: str = "uniform"):
        if mode not in PARTITION_MODES:
            raise ValueError(f"unknown partition mode {mode!r} "
                             f"(choose from {PARTITION_MODES})")
        self.cfg, self.seq, self.mode = cfg, seq, mode
        self._by_pp: Dict[int, Optional[Partition]] = {}

    def get(self, pp: int) -> Optional[Partition]:
        if pp not in self._by_pp:
            self._by_pp[pp] = resolve_partition(self.cfg, pp, self.seq,
                                                self.mode)
        return self._by_pp[pp]

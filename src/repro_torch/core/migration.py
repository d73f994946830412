"""Migration-cost model: what switching from one plan to another *costs*.

Elastic re-planning under churn cannot score candidate plans by step time
alone: a plan that is 3% faster but re-shards every checkpoint shard
across the cluster loses to a 1%-faster plan reachable by moving two
ranks.  This module prices the switch.

The unit of migration is a GPU's **resident state identity**: the set of
model layers whose parameter/optimizer shards it holds and its tensor-
parallel slice of them — ``(layers of its stage's chunks, tp rank, tp
degree)``.  dp and cp replicate that state (dp replicates weights across
minibatch shards, cp across sequence shards), so moving a GPU between dp
or cp positions of the same ``(stage, tp)`` slot is *free*: nothing has
to be re-fetched.  A GPU "moves" when its state identity under the new
plan differs from the old one — then it must fetch its new shard
(:func:`~repro_torch.core.memory.rank_state_bytes`) from surviving replicas or
the checkpoint before training resumes.

Downtime is modelled as a restart barrier (process re-spawn, collective
re-initialisation, data-loader reposition — paid once if *anything*
moved) plus the aggregate shard transfer through the cluster's inter-node
fabric (each healthy node contributes one ``inter_bw`` link of ingress).

:meth:`repro_torch.core.plan.Plan.diff` is the artifact-level entry point;
``python -m repro_torch.plan diff a.json b.json`` surfaces it on the CLI, and
a churn simulator integrates these
downtimes into whole-trace throughput.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..models.config import ModelConfig
from .memory import rank_state_bytes
from .partition import Partition, uniform_partition
from .simulator import Conf, mapping4

#: Default restart barrier seconds paid once whenever any rank moves:
#: process re-spawn + NCCL/collective re-init + checkpoint metadata load.
DEFAULT_RESTART_S = 10.0


@dataclass(frozen=True)
class PlanDiff:
    """What migrating from plan A (incumbent) to plan B costs.

    Attributes:
        ranks_total: GPUs participating in plan B.
        ranks_moved: GPUs present in both plans whose resident state
            identity changed — they must re-fetch their shard.
        ranks_added: GPUs in plan B that were not in plan A (node
            joins/returns); each fetches its full shard.
        ranks_removed: GPUs in plan A absent from plan B (preemptions);
            their state is simply abandoned, no transfer.
        bytes_migrated: total parameter+optimizer bytes fetched by moved
            and added ranks (their *new* shard sizes).
        downtime_s: estimated training stall for the switch (restart
            barrier + aggregate shard transfer).
        conf_changed: the parallelism configuration itself differs.
    """
    ranks_total: int
    ranks_moved: int
    ranks_added: int
    ranks_removed: int
    bytes_migrated: float
    downtime_s: float
    conf_changed: bool

    @property
    def is_noop(self) -> bool:
        """True when nothing moves: plan B resumes without a stall."""
        return self.ranks_moved == 0 and self.ranks_added == 0


def _stage_layer_sets(cfg: ModelConfig, conf: Conf,
                      partition: Optional[Partition]
                      ) -> Tuple[Tuple[int, ...], ...]:
    """Per physical stage, the sorted tuple of layer ids it hosts (its
    chunks ``x, x + pp, ...`` under the Megatron interleaved layout)."""
    part = partition if partition is not None \
        else uniform_partition(cfg.n_layers, conf.pp * conf.vpp)
    slices = part.stage_slices()
    out = []
    for x in range(conf.pp):
        layers = []
        for v in range(conf.vpp):
            s = slices[v * conf.pp + x]
            layers.extend(range(s.start, s.stop))
        out.append(tuple(sorted(layers)))
    return tuple(out)


def state_keys(cfg: ModelConfig, conf: Conf, mapping: np.ndarray,
               partition: Optional[Partition] = None
               ) -> Dict[int, Tuple]:
    """GPU id -> resident state identity ``(stage layers, tp rank, tp)``.

    Two GPUs (possibly the same GPU under two plans) hold byte-identical
    parameter/optimizer shards iff their keys are equal — the predicate
    behind :func:`diff_assignments`' moved-rank count.
    """
    m4 = mapping4(conf, mapping)
    layer_sets = _stage_layer_sets(cfg, conf, partition)
    keys: Dict[int, Tuple] = {}
    for x in range(conf.pp):
        key_base = layer_sets[x]
        for y in range(conf.tp):
            key = (key_base, y, conf.tp)
            for g in m4[x, y].reshape(-1):
                keys[int(g)] = key
    return keys


def _stage_of(cfg: ModelConfig, conf: Conf, mapping: np.ndarray
              ) -> Dict[int, int]:
    """GPU id -> physical stage index under ``mapping``."""
    m4 = mapping4(conf, mapping)
    return {int(g): x for x in range(conf.pp)
            for g in m4[x].reshape(-1)}


def diff_assignments(cfg: ModelConfig,
                     conf_a: Conf, mapping_a: np.ndarray,
                     conf_b: Conf, mapping_b: np.ndarray, *,
                     partition_a: Optional[Partition] = None,
                     partition_b: Optional[Partition] = None,
                     b_to_a: Optional[Sequence[int]] = None,
                     n_nodes: Optional[int] = None,
                     inter_bw: float = 12.5e9,
                     restart_s: float = DEFAULT_RESTART_S) -> PlanDiff:
    """Migration cost of switching from assignment A to assignment B.

    Args:
        cfg: model configuration (shared — shards are priced on it).
        conf_a / mapping_a / partition_a: the incumbent plan's
            configuration, worker mapping and chunk partition.
        conf_b / mapping_b / partition_b: the successor plan's.
        b_to_a: for fleets whose GPU id spaces differ (shrink/grow),
            entry ``i`` is plan-B GPU ``i``'s id in plan A's numbering, or
            ``-1`` for a brand-new GPU.  Default: identity on the common
            prefix (``with_nodes`` truncation semantics), new ids beyond
            plan A's range.
        n_nodes: healthy node count of plan B's fleet (aggregate ingress
            capacity of the transfer phase); inferred as ``ranks_total /
            8`` when omitted — pass it for non-default node widths.
        inter_bw: per-node inter-node bandwidth, bytes/s.
        restart_s: fixed restart barrier paid once if anything moved.

    Returns:
        :class:`PlanDiff`; ``diff(A, A)`` is exactly a no-op.
    """
    keys_a = state_keys(cfg, conf_a, mapping_a, partition_a)
    keys_b = state_keys(cfg, conf_b, mapping_b, partition_b)
    n_b = conf_b.n_gpus
    if b_to_a is None:
        b_to_a = [g if g < conf_a.n_gpus else -1 for g in range(n_b)]
    if len(b_to_a) != n_b:
        raise ValueError(
            f"b_to_a must map every plan-B GPU: expected {n_b} entries, "
            f"got {len(b_to_a)}")
    shard_b = rank_state_bytes(cfg, conf_b, partition_b)
    stage_b = _stage_of(cfg, conf_b, mapping_b)

    moved = added = 0
    fetch_bytes = []
    mapped_a = set()
    for g_b in range(n_b):
        g_a = int(b_to_a[g_b])
        bytes_g = float(shard_b[stage_b[g_b]])
        if g_a < 0 or g_a not in keys_a:
            added += 1
            fetch_bytes.append(bytes_g)
            continue
        mapped_a.add(g_a)
        if keys_a[g_a] != keys_b[g_b]:
            moved += 1
            fetch_bytes.append(bytes_g)
    removed = len([g for g in keys_a if g not in mapped_a])

    bytes_migrated = math.fsum(fetch_bytes)
    nodes = n_nodes if n_nodes is not None else max(1, n_b // 8)
    downtime = 0.0
    if moved + added:
        downtime = restart_s + bytes_migrated / (nodes * inter_bw)
    return PlanDiff(ranks_total=n_b, ranks_moved=moved, ranks_added=added,
                    ranks_removed=removed, bytes_migrated=bytes_migrated,
                    downtime_s=downtime,
                    conf_changed=conf_a != conf_b)


def resolve_model(name: str) -> ModelConfig:
    """A :class:`ModelConfig` from a Plan's recorded provenance name.

    Looks the name up in the architecture registry; ``<name>-smoke`` (the
    ``reduced()`` naming convention) resolves through the base config's
    :meth:`~repro_torch.models.config.ModelConfig.reduced`.  Raises ``KeyError``
    for names the registry cannot produce — callers with an out-of-registry
    config pass it explicitly instead.
    """
    from .. import configs
    try:
        return configs.get(name)
    except KeyError:
        if name.endswith("-smoke"):
            return configs.get(name[:-len("-smoke")]).reduced()
        raise

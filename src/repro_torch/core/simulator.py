"""Discrete-event simulator of 3D/4D-parallel training iterations.

This plays the role of the *real cluster* in the paper's evaluation
(DESIGN.md §2): configurations recommended by Pipette and the baselines are
"run" here, and both latency models (Pipette Eq. 3-6, AMP Eq. 1) are scored
against it.  It simulates the memory-efficient 1F1B schedule event-by-event
over the heterogeneous bandwidth matrix, including the effects the
first-order models do NOT capture — per-link p2p chains, fwd/bwd link
contention, per-op jitter and warmup transients — so estimator MAPEs are
meaningful.

Beyond the paper, :class:`Conf` carries a fourth, *context-parallel* degree
``cp`` (ring attention over sequence shards, Fujii et al. 2411.06465): each
cp rank holds ``seq / cp`` tokens and exchanges KV blocks around the cp ring
every layer.  ``cp == 1`` is a strict special case — every quantity below is
bit-identical to the historical 3D implementation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..models.config import ModelConfig
from . import flops as F
from .cluster import (ClusterSpec, compute_slowdowns, min_group_bw,
                      min_group_bw_batch, ring_allreduce_time)
from .partition import Partition, PartitionCache, uniform_partition


# ---------------------------------------------------------------------------
# configuration / workload
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Conf:
    """A 4D parallelism configuration: (pp, tp, cp, dp) plus microbatching.

    ``cp`` (context parallelism: ring attention over sequence shards)
    defaults to 1, which reproduces the paper's 3D search space exactly —
    every historical ``Conf(pp, tp, dp, bs_micro, bs_global)`` call keeps
    its meaning.

    ``vpp`` is the interleaved-1F1B virtual-pipeline factor (Megatron-LM's
    ``virtual_pipeline_model_parallel_size``): each physical stage hosts
    ``vpp`` non-adjacent model chunks, shrinking the fill/drain bubble by
    ``~1/vpp`` at the price of ``vpp``× the inter-stage traffic.  ``vpp ==
    1`` is plain 1F1B — the bit-exact historical schedule.
    """
    pp: int
    tp: int
    dp: int
    bs_micro: int
    bs_global: int
    cp: int = 1
    vpp: int = 1

    @property
    def n_gpus(self) -> int:
        return self.pp * self.tp * self.cp * self.dp

    @property
    def bs_mini(self) -> int:
        return self.bs_global // self.dp

    @property
    def n_mb(self) -> int:
        return self.bs_mini // self.bs_micro

    def valid(self) -> bool:
        """Divisibility and an explicit non-empty-schedule check.

        ``n_mb == 0`` (a microbatch larger than the minibatch) is rejected
        here rather than relying on every caller to notice that Eq. 3-6
        degenerate at zero microbatches.
        """
        return (min(self.pp, self.tp, self.cp, self.dp,
                    self.bs_micro, self.vpp) >= 1 and
                self.bs_global % self.dp == 0 and
                self.bs_mini % self.bs_micro == 0 and
                self.n_mb >= 1)

    def schedulable(self) -> bool:
        """True when the schedule can fill the pipeline: memory-efficient
        1F1B needs at least ``pp`` microbatches, otherwise the Eq. 3-6
        exposure count ``n_mb / pp`` drops below one and the model scores a
        schedule that cannot exist (see ``enumerate_confs``'s strict gate).
        Interleaved-1F1B (``vpp > 1``) additionally requires ``pp > 1`` and
        ``n_mb % pp == 0`` (Megatron-LM's interleaving constraint); the
        ``n_layers >= pp * vpp`` chunking bound is checked where the model
        is known (``enumerate_confs``).
        """
        ok = self.valid() and self.n_mb >= self.pp
        if self.vpp > 1:
            ok = ok and self.pp > 1 and self.n_mb % self.pp == 0
        return ok

    @property
    def schedule(self) -> str:
        """The pipeline schedule this configuration runs (PLN009 names)."""
        return "interleaved-1f1b" if self.vpp > 1 else "1f1b"

    def __str__(self):
        cp = f"·cp{self.cp}" if self.cp > 1 else ""
        vpp = f"·vpp{self.vpp}" if self.vpp > 1 else ""
        return (f"pp{self.pp}·tp{self.tp}{cp}{vpp}·dp{self.dp}"
                f"·mb{self.bs_micro}(n_mb={self.n_mb})")


@dataclass(frozen=True)
class Workload:
    cfg: ModelConfig
    seq: int
    bs_global: int
    grad_bytes: int = 4            # fp32 main grads (Megatron default)


def default_mapping(conf: Conf) -> np.ndarray:
    """Identity (node-major) worker dedication: tp contiguous, then cp,
    then dp, then pp — the standard Megatron-LM order extended with the
    context axis between tp and dp.

    Args:
        conf: parallelism configuration.

    Returns:
        ``(pp, tp, dp)`` integer mapping with GPU ids ``0..n_gpus-1`` when
        ``cp == 1`` (the historical shape), else ``(pp, tp, cp, dp)``.
    """
    g = np.arange(conf.n_gpus)
    if conf.cp == 1:
        # worker (x, y, z) -> gpu x*(dp*tp) + z*tp + y
        return g.reshape(conf.pp, conf.dp, conf.tp).transpose(0, 2, 1)
    # worker (x, y, k, z) -> gpu x*(dp*cp*tp) + z*(cp*tp) + k*tp + y
    return g.reshape(conf.pp, conf.dp, conf.cp,
                     conf.tp).transpose(0, 3, 2, 1)


def mapping4(conf: Conf, mapping: np.ndarray) -> np.ndarray:
    """Canonical ``(pp, tp, cp, dp)`` view of a worker mapping.

    Accepts the legacy 3D ``(pp, tp, dp)`` shape (valid only when
    ``cp == 1``, where it is the same memory layout) as well as the 4D
    shape or anything reshapeable to it; every mapping consumer in
    ``latency``/``simulator``/``dedication`` normalizes through here.
    """
    return np.asarray(mapping, dtype=np.intp).reshape(
        conf.pp, conf.tp, conf.cp, conf.dp)


def stage_work(n_layers: int, pp: int) -> Tuple[float, ...]:
    """Relative per-stage compute work, normalised to the heaviest stage.

    The contiguous layer split gives the first ``n_layers % pp`` stages
    ``ceil(n_layers / pp)`` layers and the rest one fewer; the profiled
    per-microbatch compute (:func:`build_profile`) is priced at the heaviest
    stage, so entry ``x`` is ``layers_x / ceil(n_layers / pp)`` — all 1.0
    when ``pp`` divides ``n_layers``.

    This is the *uniform-split* special case of ``Profile.stage_work``:
    non-uniform partitions (``build_profile(..., partition=...)``) replace
    it with per-stage cost fractions from the per-layer cost vector, and
    the same consumers (``_hetero_combine``, ``DedicationEngine``,
    ``torch_engine``, the simulator) price arbitrary per-stage work.  The
    homogeneous *uniform* model keeps the paper's single-scalar
    formulation bit-for-bit.
    """
    full = -(-n_layers // pp)
    base, rem = n_layers // pp, n_layers % pp
    return tuple((base + 1 if x < rem else base) / full for x in range(pp))


def ring_kv_block_bytes(cfg: ModelConfig, bs_micro: int, seq: int,
                        cp: int) -> float:
    """Bytes of the K+V block one cp rank passes per ring-attention step
    (bf16): ``2 (K and V) * bs_micro * seq/cp * kv_dim * 2 bytes``.

    The single source of the block-size formula — both the latency/profile
    side (:func:`_profile_dynamic`) and the memory ground truth
    (``memory._ring_kv_bytes``) must price the same message, or estimator
    MAPEs silently drift.
    """
    kv_dim = max(cfg.n_kv_heads, 1) * cfg.hd if cfg.n_heads else cfg.d_model
    return 2 * bs_micro * (seq / cp) * kv_dim * 2.0


# ---------------------------------------------------------------------------
# profiled per-microbatch quantities (Alg. 1 uses these as inputs)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Profile:
    c_fwd: float                   # per-microbatch fwd compute seconds
    c_bwd: float
    t_tp_fwd: float                # per-microbatch TP all-reduce seconds, fwd
    t_tp_bwd: float
    msg_pp: float                  # bytes of one inter-stage activation
    msg_dp: float                  # per-GPU gradient bytes (stage share)
    stage_params: float            # params on the largest stage
    tp_ref_bw: float = 300e9       # bandwidth T_tp was profiled at
    # --- context parallelism (all exactly 0 / unused when cp == 1) ---
    t_cp_fwd: float = 0.0          # per-microbatch ring KV-exchange s, fwd
    t_cp_bwd: float = 0.0
    msg_cp: float = 0.0            # bytes of one KV block sent per ring step
    cp_ref_bw: float = 300e9       # bandwidth T_cp was profiled at
    # --- heterogeneous compute / non-uniform partitions ---
    # per-stage relative work; the uniform split's layer-count ratios
    # (:func:`stage_work`) or, with a partition, per-stage cost fractions
    # normalised to the heaviest stage.  None (legacy direct
    # constructions) means uniform stages
    stage_work: Optional[Tuple[float, ...]] = None
    # --- non-uniform pipeline partition / interleaved-1F1B ---
    # cumulative chunk boundaries (``pp * vpp`` entries; == stage
    # boundaries for plain 1F1B).  None = the legacy uniform split, the
    # trigger for every consumer's bit-exact historical path
    partition: Optional[Tuple[int, ...]] = None
    # per virtual-chunk work fractions, same normalisation as
    # ``stage_work`` (chunks of one stage sum to its stage_work entry);
    # only set when vpp > 1
    chunk_work: Optional[Tuple[float, ...]] = None


def _profile_static(w: Workload, spec: ClusterSpec,
                    conf: Conf) -> Tuple[float, float, float, tuple]:
    """The :class:`Profile` fields that depend only on ``(pp, tp)``.

    ``stage_params``, ``msg_dp``, ``tp_ref_bw`` and the per-stage work
    vector are independent of ``bs_micro`` (and of ``dp``), so
    :class:`ProfileCache` shares them across every microbatch variant of a
    parallelism shape.

    Returns:
        ``(stage_params, msg_dp, tp_ref_bw, stage_work)``.
    """
    cfg = w.cfg
    tp_ref_bw = spec.intra_bw if conf.tp <= spec.gpus_per_node \
        else spec.inter_bw
    p_total = F.param_count(cfg)
    stage_params = (p_total - 2 * cfg.vocab_size * cfg.d_model) / conf.pp \
        + 2 * cfg.vocab_size * cfg.d_model / min(conf.pp, 2)
    msg_dp = stage_params / conf.tp * w.grad_bytes
    return stage_params, msg_dp, tp_ref_bw, stage_work(cfg.n_layers, conf.pp)


def _profile_nonuniform(w: Workload, spec: ClusterSpec, conf: Conf,
                        static: Tuple[float, float, float, tuple],
                        partition: Optional[Partition]) -> Profile:
    """:func:`_profile_dynamic` for non-uniform partitions and/or
    interleaved-1F1B: per-chunk costs from the per-layer cost vector, the
    compute scalar priced at the heaviest *physical* stage, and the
    embedding/LM-head GEMMs pinned to the end chunks instead of amortized
    ``1/pp``.  ``partition`` is at chunk granularity (``pp * vpp``
    boundaries); None means uniform chunking."""
    cfg = w.cfg
    stage_params, msg_dp, tp_ref_bw, _ = static
    pp, vpp = conf.pp, conf.vpp
    n_chunks = pp * vpp
    part = partition if partition is not None \
        else uniform_partition(cfg.n_layers, n_chunks)
    if part.pp != n_chunks:
        raise ValueError(f"partition has {part.pp} stages; conf {conf} "
                         f"needs pp*vpp = {n_chunks}")
    if part.n_layers != cfg.n_layers:
        raise ValueError(f"partition covers {part.n_layers} layers; "
                         f"model has {cfg.n_layers}")
    tokens_mb = conf.bs_micro * w.seq / conf.cp     # per cp-rank tokens
    ftok = part.stage_sums(F.layer_cost_per_token(cfg, w.seq))
    e = F.embed_cost_per_token(cfg)
    ftok[0] += e                                    # embedding
    ftok[-1] += e                                   # LM head
    # physical stage x runs chunks x, x+pp, ... (Megatron interleaving)
    stage_ftok = ftok.reshape(vpp, pp).sum(axis=0)
    f_max = float(stage_ftok.max())
    eff_mb = conf.bs_micro / (conf.bs_micro + 1.0)
    thru = spec.gpu_flops * spec.efficiency * 1.25 * eff_mb * conf.tp
    c_fwd = f_max * tokens_mb / thru
    c_bwd = 2.0 * c_fwd
    stage_w = tuple((stage_ftok / f_max).tolist())
    chunk_w = tuple((ftok / f_max).tolist()) if vpp > 1 else None

    # comm terms priced at the heaviest physical stage's layer count
    sizes = np.asarray(part.sizes).reshape(vpp, pp).sum(axis=0)
    layers_stage = int(sizes.max())
    msg_tp = conf.bs_micro * w.seq * cfg.d_model * 2 / conf.cp
    t_ar = ring_allreduce_time(msg_tp, tp_ref_bw, conf.tp)
    t_tp = 2 * layers_stage * t_ar
    msg_pp = conf.bs_micro * w.seq * cfg.d_model * 2.0 / conf.cp
    if conf.cp > 1:
        msg_cp = ring_kv_block_bytes(cfg, conf.bs_micro, w.seq, conf.cp)
        cp_ref_bw = spec.intra_bw if conf.tp * conf.cp <= spec.gpus_per_node \
            else spec.inter_bw
        t_cp_fwd = layers_stage * (conf.cp - 1) * msg_cp / cp_ref_bw
        t_cp_bwd = 2.0 * t_cp_fwd
    else:
        msg_cp, t_cp_fwd, t_cp_bwd, cp_ref_bw = 0.0, 0.0, 0.0, tp_ref_bw
    return Profile(c_fwd, c_bwd, t_tp, 2 * t_tp, msg_pp, msg_dp,
                   stage_params, tp_ref_bw, t_cp_fwd, t_cp_bwd, msg_cp,
                   cp_ref_bw, stage_w, tuple(part.boundaries), chunk_w)


def _profile_dynamic(w: Workload, spec: ClusterSpec, conf: Conf,
                     static: Tuple[float, float, float, tuple],
                     partition: Optional[Partition] = None) -> Profile:
    """The ``(bs_micro, cp)``-dependent remainder of :func:`build_profile`.

    Context parallelism shards every per-microbatch quantity over the
    sequence axis: each cp rank computes/communicates ``1 / cp`` of the
    tokens (``tokens_mb / cp`` is an exact float at ``cp == 1``, so the 3D
    numbers are reproduced bit-for-bit), and a ring KV-exchange term
    appears (``cp - 1`` steps per layer, Fujii et al. 2411.06465).

    A non-uniform ``partition`` (or ``conf.vpp > 1``) routes to
    :func:`_profile_nonuniform`; the default path below is the bit-exact
    legacy uniform-split formulation.
    """
    if partition is not None or conf.vpp > 1:
        return _profile_nonuniform(w, spec, conf, static, partition)
    cfg = w.cfg
    stage_params, msg_dp, tp_ref_bw, stage_w = static
    layers_stage = -(-cfg.n_layers // conf.pp)
    tokens_mb = conf.bs_micro * w.seq / conf.cp     # per cp-rank tokens
    n_active = F.active_param_count(cfg)
    body = n_active - 2 * cfg.vocab_size * cfg.d_model
    body = max(body, int(0.5 * n_active))
    stage_flops_fwd = 2.0 * (body * layers_stage / cfg.n_layers) * tokens_mb
    # ring attention: seq/cp local queries attend over the full sequence
    stage_flops_fwd += 2.0 * F.attention_flops(cfg, w.seq, tokens_mb, train=False) \
        * layers_stage / cfg.n_layers / 2
    # embedding + head flops live on first/last stage; fold in evenly
    stage_flops_fwd += 2.0 * 2 * cfg.vocab_size * cfg.d_model * tokens_mb / conf.pp
    # GEMM batch-efficiency: small microbatches underutilise the GPU
    # (this is why AMP-style memory-blind searches drift toward large
    # bs_micro and recommend OOM configs — §VI / Fig. 5b)
    eff_mb = conf.bs_micro / (conf.bs_micro + 1.0)
    thru = spec.gpu_flops * spec.efficiency * 1.25 * eff_mb * conf.tp
    c_fwd = stage_flops_fwd / thru
    c_bwd = 2.0 * c_fwd

    # Megatron TP: 2 all-reduces per layer per direction.  When a TP group
    # cannot fit inside a node, its ring bottlenecks on the (nominal)
    # inter-node link — visible to every configurator.
    msg_tp = conf.bs_micro * w.seq * cfg.d_model * 2 / conf.cp
    t_ar = ring_allreduce_time(msg_tp, tp_ref_bw, conf.tp)
    t_tp = 2 * layers_stage * t_ar
    msg_pp = conf.bs_micro * w.seq * cfg.d_model * 2.0 / conf.cp

    # Ring-attention KV exchange: cp-1 steps per layer, each passing the
    # local K+V block (bf16) around the cp ring; backward additionally
    # returns dK/dV.  Zero when cp == 1 so the 3D path is untouched.
    if conf.cp > 1:
        msg_cp = ring_kv_block_bytes(cfg, conf.bs_micro, w.seq, conf.cp)
        cp_ref_bw = spec.intra_bw if conf.tp * conf.cp <= spec.gpus_per_node \
            else spec.inter_bw
        t_cp_fwd = layers_stage * (conf.cp - 1) * msg_cp / cp_ref_bw
        t_cp_bwd = 2.0 * t_cp_fwd
    else:
        msg_cp, t_cp_fwd, t_cp_bwd, cp_ref_bw = 0.0, 0.0, 0.0, tp_ref_bw
    return Profile(c_fwd, c_bwd, t_tp, 2 * t_tp, msg_pp, msg_dp,
                   stage_params, tp_ref_bw, t_cp_fwd, t_cp_bwd, msg_cp,
                   cp_ref_bw, stage_w)


def build_profile(w: Workload, spec: ClusterSpec, conf: Conf,
                  partition: Optional[Partition] = None) -> Profile:
    """Derive the profiled per-microbatch quantities for one configuration.

    Stands in for the paper's on-cluster profiling stage: per-microbatch
    fwd/bwd compute (with the GEMM batch-efficiency penalty for tiny
    microbatches), per-microbatch TP all-reduce time at the nominal group
    bandwidth, and the inter-stage / data-parallel message sizes.

    Args:
        w: workload (model config, sequence length, global batch).
        spec: cluster description.
        conf: parallelism configuration being profiled.
        partition: optional non-uniform chunk partition (``pp * vpp``
            boundaries).  None keeps the bit-exact legacy uniform split
            (unless ``conf.vpp > 1``, which needs per-chunk pricing).

    Returns:
        :class:`Profile` consumed by the latency estimators and simulator.
    """
    return _profile_dynamic(w, spec, conf, _profile_static(w, spec, conf),
                            partition)


class ProfileCache:
    """Memoized :func:`build_profile` for one ``(workload, spec)`` pair.

    A :class:`Profile` is fully determined by ``(pp, tp, cp, bs_micro, vpp,
    partition)`` — it does not depend on ``dp`` — so the configurator's
    enumeration (which yields many ``dp``/microbatch variants per shape)
    hits the cache heavily.  The cache key includes the *partition
    identity* (the resolved chunk boundaries, or None for the uniform
    split): two partition modes producing different boundaries at the same
    ``(pp, tp, cp, bs_micro)`` can never alias a stale profile.  The
    ``(pp, tp)``-only fields (:func:`_profile_static`) are additionally
    shared across microbatch and context-parallel variants; the
    ``(bs_micro, cp)``-dependent remainder is built lazily on first use.
    Returned profiles are bit-identical to :func:`build_profile`.

    Example:
        >>> cache = ProfileCache(w, spec)
        >>> cache.get(conf) == build_profile(w, spec, conf)
        True
    """

    def __init__(self, w: Workload, spec: ClusterSpec,
                 partition: str = "uniform"):
        self.w = w
        self.spec = spec
        self._parts = PartitionCache(w.cfg, w.seq, partition)
        self._static: Dict[Tuple[int, int],
                           Tuple[float, float, float, tuple]] = {}
        self._full: Dict[tuple, Profile] = {}

    def partition_for(self, conf: Conf) -> Optional[Partition]:
        """The resolved chunk partition for ``conf`` (None = uniform)."""
        return self._parts.get(conf.pp * conf.vpp)

    def get(self, conf: Conf) -> Profile:
        """The :class:`Profile` for ``conf``, computed at most once per
        ``(pp, tp, cp, bs_micro, vpp, partition boundaries)``."""
        part = self.partition_for(conf)
        key = (conf.pp, conf.tp, conf.cp, conf.bs_micro, conf.vpp,
               None if part is None else part.boundaries)
        prof = self._full.get(key)
        if prof is None:
            skey = key[:2]
            static = self._static.get(skey)
            if static is None:
                static = self._static[skey] = \
                    _profile_static(self.w, self.spec, conf)
            prof = self._full[key] = \
                _profile_dynamic(self.w, self.spec, conf, static, part)
        return prof


# ---------------------------------------------------------------------------
# 1F1B schedule simulation
# ---------------------------------------------------------------------------

def _one_f_one_b_order(pp: int, s: int, n_mb: int):
    warm = min(pp - s, n_mb)
    ops = [("f", m) for m in range(warm)]
    nf = warm
    for m in range(n_mb):
        ops.append(("b", m))
        if nf < n_mb:
            ops.append(("f", nf))
            nf += 1
    return ops


def hier_allreduce_batch(ids: np.ndarray, bw: np.ndarray, msg_bytes: float,
                         spec: ClusterSpec) -> np.ndarray:
    """Batched hierarchical-ring all-reduce time for many groups at once.

    Each row of ``ids`` is one data-parallel communicator group.  The
    hierarchical schedule is the reference one: a phases=4 reduce-scatter /
    all-gather ring inside every node-local sub-group (bottlenecked by that
    sub-group's slowest link), then a phases=2 ring across one representative
    GPU per node (the first group member on each node).

    Args:
        ids: ``(n_groups, m)`` GPU ids, one communicator group per row.
        bw: ``(G, G)`` bandwidth matrix in bytes/s.
        msg_bytes: gradient bytes each rank contributes.
        spec: cluster description (for the GPU -> node map).

    Returns:
        ``(n_groups,)`` seconds, bit-identical to the scalar reference
        (``dp_allreduce_times_ref``'s inner loop) applied per row.
    """
    ids = np.asarray(ids, dtype=np.intp)
    n_groups, m = ids.shape
    if m <= 1:
        return np.zeros(n_groups)
    sub = bw[ids[:, :, None], ids[:, None, :]]            # (n_groups, m, m)
    node = ids // spec.gpus_per_node
    same = node[:, :, None] == node[:, None, :]
    eye = np.eye(m, dtype=bool)[None, :, :]
    off = same & ~eye
    # Per-member min over same-node links in both directions; the member that
    # attains its node-cluster's global min reproduces the reference ring time
    # exactly (the ring coefficient is constant inside a cluster).
    masked = np.where(off, sub, np.inf)
    member_min = np.minimum(masked.min(axis=2), masked.min(axis=1))
    counts = same.sum(axis=2)                              # (n_groups, m)
    with np.errstate(divide="ignore", invalid="ignore"):
        intra_vals = 4 * (counts - 1) / counts * msg_bytes / member_min
    intra_t = np.where(counts > 1, intra_vals, 0.0).max(axis=1)

    # Representatives: first group member on each node (insertion order of the
    # reference dict) — membership matters because rep-to-rep links differ.
    j_lt_i = np.arange(m)[None, None, :] < np.arange(m)[None, :, None]
    is_rep = ~(same & j_lt_i).any(axis=2)
    n_reps = is_rep.sum(axis=1)
    pair = is_rep[:, :, None] & is_rep[:, None, :] & ~eye
    rep_min = np.where(pair, sub, np.inf).min(axis=(1, 2))
    with np.errstate(divide="ignore", invalid="ignore"):
        inter_vals = 2 * (n_reps - 1) / n_reps * msg_bytes / rep_min
    inter_t = np.where(n_reps > 1, inter_vals, 0.0)
    return intra_t + inter_t


def dp_allreduce_times(conf: Conf, mapping: np.ndarray, bw: np.ndarray,
                       prof: Profile, spec: ClusterSpec) -> np.ndarray:
    """Hierarchical-ring DP all-reduce seconds per pipeline stage (Eq. 6
    structure, evaluated on an arbitrary bandwidth matrix).

    Vectorized: all ``pp * tp * cp`` data-parallel groups are gathered and
    reduced in one batch (see :func:`hier_allreduce_batch`); per stage the
    slowest (tp, cp) slice wins.  Matches :func:`dp_allreduce_times_ref`
    bit-for-bit.

    Args:
        conf: parallelism configuration.
        mapping: ``(pp, tp, dp)`` or ``(pp, tp, cp, dp)`` worker -> GPU
            dedication.
        bw: ``(G, G)`` bandwidth matrix in bytes/s.
        prof: profiled per-microbatch quantities (uses ``msg_dp``).
        spec: cluster description.

    Returns:
        ``(pp,)`` all-reduce seconds per pipeline stage.
    """
    ids = mapping4(conf, mapping).reshape(conf.pp * conf.tp * conf.cp,
                                          conf.dp)
    t = hier_allreduce_batch(ids, np.asarray(bw), prof.msg_dp, spec)
    return np.maximum(t.reshape(conf.pp, conf.tp * conf.cp).max(axis=1), 0.0)


def dp_allreduce_times_ref(conf: Conf, mapping: np.ndarray, bw: np.ndarray,
                           prof: Profile, spec: ClusterSpec) -> np.ndarray:
    """Reference (pure-Python loop) implementation of
    :func:`dp_allreduce_times`; kept as the equivalence/benchmark oracle."""
    m4 = mapping4(conf, mapping)
    out = np.zeros(conf.pp)
    for x in range(conf.pp):
        worst = 0.0
        for y in range(conf.tp):
            for k in range(conf.cp):
                group = [int(m4[x, y, k, z]) for z in range(conf.dp)]
                nodes: Dict[int, list] = {}
                for gpu in group:
                    nodes.setdefault(spec.node_of(gpu), []).append(gpu)
                intra_t = 0.0
                for gs in nodes.values():
                    if len(gs) > 1:
                        t = ring_allreduce_time(prof.msg_dp,
                                                min_group_bw(bw, gs),
                                                len(gs), phases=4)
                        intra_t = max(intra_t, t)
                reps = [gs[0] for gs in nodes.values()]
                inter_t = 0.0
                if len(reps) > 1:
                    inter_t = ring_allreduce_time(prof.msg_dp,
                                                  min_group_bw(bw, reps),
                                                  len(reps), phases=2)
                worst = max(worst, intra_t + inter_t)
        out[x] = worst
    return out


def simulate_iteration(conf: Conf, mapping: np.ndarray, bw: np.ndarray,
                       prof: Profile, spec: ClusterSpec, *,
                       jitter: float = 0.015, contention: float = 0.05,
                       seed: int = 0) -> Dict:
    """Event-driven 1F1B iteration on an arbitrary bandwidth matrix.

    Models what the first-order estimators do not: per-link p2p chains,
    fwd/bwd link contention, per-op jitter and warmup transients.  With
    ``conf.cp > 1`` every forward/backward op additionally carries the ring
    KV-exchange time of its slowest cp group, evaluated on the true links.
    On a tiered spec every op plays back at its ranks' *true* speed: the
    (stage, replica) compute time stretches by the slowest member GPU's
    :func:`~repro_torch.core.cluster.compute_slowdowns` factor and shrinks by the
    stage's relative layer work (``prof.stage_work``) — so compute-aware
    dedication wins are measurable here, not just in the model.

    Args:
        conf: parallelism configuration.
        mapping: ``(pp, tp, dp)`` or ``(pp, tp, cp, dp)`` worker -> GPU
            dedication.
        bw: bandwidth matrix to "run" on (usually the ground truth).
        prof: profiled per-microbatch quantities.
        spec: cluster description.
        jitter: per-op lognormal-ish duration noise.
        contention: fractional slowdown of contended steady-state hops.
        seed: RNG seed for the jitter.

    Returns:
        Dict with ``total`` seconds plus per-stage/per-link breakdowns
        (``stage_finish``, ``t_dp``, ``t_pp``).
    """
    if conf.vpp > 1:
        return _simulate_interleaved(conf, mapping, bw, prof, spec,
                                     jitter=jitter, contention=contention,
                                     seed=seed)
    pp, tp, cp, dp, n_mb = conf.pp, conf.tp, conf.cp, conf.dp, conf.n_mb
    rng = np.random.default_rng(seed * 131071 + conf.n_gpus)

    m4 = mapping4(conf, mapping)

    # per-replica p2p link times between adjacent stages (slowest tp/cp pair)
    t_pp = np.zeros((dp, max(pp - 1, 1)))
    if pp > 1:
        link = bw[m4[:-1], m4[1:]].reshape(pp - 1, tp * cp, dp).min(axis=1)
        t_pp = (prof.msg_pp / link).T

    # actual TP time uses true intra-group links (model uses nominal);
    # per (stage, replica) the slowest cp slice wins
    groups = m4.transpose(0, 2, 3, 1).reshape(pp * cp * dp, tp)
    gbw = min_group_bw_batch(bw, groups)
    scale = np.where(np.isfinite(gbw) & (gbw > 0), prof.tp_ref_bw / gbw, 1.0)
    t_tpf = (prof.t_tp_fwd * scale).reshape(pp, cp, dp).max(axis=1).T

    # ring KV-exchange time on the true cp-group links (worst tp slice)
    t_cpf = np.zeros((dp, pp))
    if cp > 1:
        cgroups = m4.transpose(0, 1, 3, 2).reshape(pp * tp * dp, cp)
        cgbw = min_group_bw_batch(bw, cgroups)
        cscale = np.where(np.isfinite(cgbw) & (cgbw > 0),
                          prof.cp_ref_bw / cgbw, 1.0)
        t_cpf = (prof.t_cp_fwd * cscale).reshape(pp, tp, dp).max(axis=1).T

    # per-(replica, stage) compute at each rank's true speed: the slowest
    # (tp, cp) member sets the stage's GEMM time (the work is evenly
    # sharded, so everyone waits on it), lighter stages do less work.
    # Homogeneous specs fill these with the profiled scalars exactly.
    slow = compute_slowdowns(spec)
    c_fwd_zs = np.full((dp, pp), prof.c_fwd)
    c_bwd_zs = np.full((dp, pp), prof.c_bwd)
    if slow is not None:
        sw = np.asarray(prof.stage_work if prof.stage_work is not None
                        else np.ones(pp))
        stage_slow = slow[m4].reshape(pp, tp * cp, dp).max(axis=1)
        c_scale = (stage_slow * sw[:, None]).T          # (dp, pp)
        c_fwd_zs = prof.c_fwd * c_scale
        c_bwd_zs = prof.c_bwd * c_scale
    elif prof.partition is not None:
        # non-uniform partition on a homogeneous fleet: stages still do
        # different amounts of work (the legacy np.full path above stays
        # untouched for partition-None profiles)
        sw = np.asarray(prof.stage_work if prof.stage_work is not None
                        else np.ones(pp))
        c_fwd_zs = prof.c_fwd * np.broadcast_to(sw, (dp, pp))
        c_bwd_zs = prof.c_bwd * np.broadcast_to(sw, (dp, pp))

    finish_stage = np.zeros((dp, pp))
    for z in range(dp):
        orders = [_one_f_one_b_order(pp, s, n_mb) for s in range(pp)]
        ptr = [0] * pp
        t_stage = [0.0] * pp
        done_f: Dict[Tuple[int, int], float] = {}
        done_b: Dict[Tuple[int, int], float] = {}
        remaining = sum(len(o) for o in orders)
        while remaining:
            progressed = False
            for s in range(pp):
                while ptr[s] < len(orders[s]):
                    op, m = orders[s][ptr[s]]
                    if op == "f":
                        if s == 0:
                            ready = 0.0
                        else:
                            dep = done_f.get((s - 1, m))
                            if dep is None:
                                break
                            cont = 1.0 + (contention if m >= pp else 0.0)
                            ready = dep + t_pp[z, s - 1] * cont
                        dur = c_fwd_zs[z, s] + t_tpf[z, s] + t_cpf[z, s]
                    else:
                        if s == pp - 1:
                            dep = done_f.get((s, m))
                        else:
                            dep = done_b.get((s + 1, m))
                        if dep is None:
                            break
                        ready = dep if s == pp - 1 else dep + t_pp[z, s] * (1 + contention)
                        dur = c_bwd_zs[z, s] + 2 * t_tpf[z, s] + 2 * t_cpf[z, s]
                    if m == 0:
                        dur *= 1.03          # warmup transient
                    dur *= 1.0 + jitter * rng.standard_normal()
                    start = max(t_stage[s], ready)
                    end = start + max(dur, 0.0)
                    if op == "f":
                        done_f[(s, m)] = end
                    else:
                        done_b[(s, m)] = end
                    t_stage[s] = end
                    ptr[s] += 1
                    remaining -= 1
                    progressed = True
            if not progressed:
                raise RuntimeError("1F1B schedule deadlock (invalid order)")
        finish_stage[z] = t_stage

    t_dp = dp_allreduce_times(conf, mapping, bw, prof, spec)
    stage_finish = finish_stage.max(axis=0)          # DP sync couples replicas
    total = float((stage_finish + t_dp).max())
    return {"total": total, "stage_finish": stage_finish, "t_dp": t_dp,
            "t_pp": t_pp}


def _simulate_interleaved(conf: Conf, mapping: np.ndarray, bw: np.ndarray,
                          prof: Profile, spec: ClusterSpec, *,
                          jitter: float, contention: float,
                          seed: int) -> Dict:
    """Event-driven interleaved-1F1B (``conf.vpp > 1``) iteration.

    The schedule is plain 1F1B over the *virtual* pipeline of depth
    ``P = pp * vpp``; virtual stage ``s`` runs on physical stage
    ``s % pp`` (Megatron-LM's chunk layout), so all ``vpp`` chunks hosted
    on one physical stage share that stage's serial compute clock.  Each
    hop between consecutive virtual stages is a real p2p transfer — the
    wrap hop ``pp-1 -> 0`` included — which is where interleaving pays
    ``vpp``× the inter-stage traffic for its ``~1/vpp`` bubble.
    """
    pp, tp, cp, dp, n_mb = conf.pp, conf.tp, conf.cp, conf.dp, conf.n_mb
    vpp = conf.vpp
    P = pp * vpp
    rng = np.random.default_rng(seed * 131071 + conf.n_gpus)

    m4 = mapping4(conf, mapping)

    # per-replica p2p hop times leaving each physical stage; column pp-1 is
    # the wrap hop pp-1 -> 0 carrying chunk-boundary activations
    t_hop = np.zeros((dp, pp))
    if pp > 1:
        link = bw[m4[:-1], m4[1:]].reshape(pp - 1, tp * cp, dp).min(axis=1)
        t_hop[:, :pp - 1] = (prof.msg_pp / link).T
    wlink = bw[m4[-1], m4[0]].reshape(tp * cp, dp).min(axis=0)
    t_hop[:, pp - 1] = prof.msg_pp / wlink

    # TP/cp comm per *chunk*: the profiled per-microbatch terms cover the
    # heaviest stage's full layer count, split across its vpp chunks
    groups = m4.transpose(0, 2, 3, 1).reshape(pp * cp * dp, tp)
    gbw = min_group_bw_batch(bw, groups)
    scale = np.where(np.isfinite(gbw) & (gbw > 0), prof.tp_ref_bw / gbw, 1.0)
    t_tpf = (prof.t_tp_fwd * scale).reshape(pp, cp, dp).max(axis=1).T / vpp

    t_cpf = np.zeros((dp, pp))
    if cp > 1:
        cgroups = m4.transpose(0, 1, 3, 2).reshape(pp * tp * dp, cp)
        cgbw = min_group_bw_batch(bw, cgroups)
        cscale = np.where(np.isfinite(cgbw) & (cgbw > 0),
                          prof.cp_ref_bw / cgbw, 1.0)
        t_cpf = (prof.t_cp_fwd * cscale).reshape(pp, tp, dp).max(axis=1).T \
            / vpp

    # per-(replica, virtual chunk) compute; tiered fleets stretch each
    # chunk by its physical stage's slowest member
    cw = np.asarray(prof.chunk_work if prof.chunk_work is not None
                    else [1.0 / vpp] * P)
    phys_of = np.arange(P) % pp
    c_f = np.broadcast_to(prof.c_fwd * cw, (dp, P)).copy()
    c_b = np.broadcast_to(prof.c_bwd * cw, (dp, P)).copy()
    slow = compute_slowdowns(spec)
    if slow is not None:
        stage_slow = slow[m4].reshape(pp, tp * cp, dp).max(axis=1)  # (pp, dp)
        c_f *= stage_slow[phys_of].T
        c_b *= stage_slow[phys_of].T

    finish_stage = np.zeros((dp, pp))
    for z in range(dp):
        orders = [_one_f_one_b_order(P, s, n_mb) for s in range(P)]
        ptr = [0] * P
        t_phys = [0.0] * pp          # shared serial clock per physical stage
        done_f: Dict[Tuple[int, int], float] = {}
        done_b: Dict[Tuple[int, int], float] = {}
        remaining = sum(len(o) for o in orders)
        while remaining:
            progressed = False
            for s in range(P):
                phys = phys_of[s]
                while ptr[s] < len(orders[s]):
                    op, m = orders[s][ptr[s]]
                    if op == "f":
                        if s == 0:
                            ready = 0.0
                        else:
                            dep = done_f.get((s - 1, m))
                            if dep is None:
                                break
                            cont = 1.0 + (contention if m >= P else 0.0)
                            ready = dep + t_hop[z, phys_of[s - 1]] * cont
                        dur = c_f[z, s] + t_tpf[z, phys] + t_cpf[z, phys]
                    else:
                        if s == P - 1:
                            dep = done_f.get((s, m))
                        else:
                            dep = done_b.get((s + 1, m))
                        if dep is None:
                            break
                        ready = dep if s == P - 1 \
                            else dep + t_hop[z, phys] * (1 + contention)
                        dur = c_b[z, s] + 2 * t_tpf[z, phys] \
                            + 2 * t_cpf[z, phys]
                    if m == 0:
                        dur *= 1.03          # warmup transient
                    dur *= 1.0 + jitter * rng.standard_normal()
                    start = max(t_phys[phys], ready)
                    end = start + max(dur, 0.0)
                    if op == "f":
                        done_f[(s, m)] = end
                    else:
                        done_b[(s, m)] = end
                    t_phys[phys] = end
                    ptr[s] += 1
                    remaining -= 1
                    progressed = True
            if not progressed:
                raise RuntimeError("interleaved-1F1B schedule deadlock "
                                   "(invalid order)")
        finish_stage[z] = t_phys

    t_dp = dp_allreduce_times(conf, mapping, bw, prof, spec)
    stage_finish = finish_stage.max(axis=0)          # DP sync couples replicas
    total = float((stage_finish + t_dp).max())
    return {"total": total, "stage_finish": stage_finish, "t_dp": t_dp,
            "t_pp": t_hop}


def measure(conf: Conf, mapping: np.ndarray, w: Workload, spec: ClusterSpec,
            bw_true: np.ndarray, *, seed: int = 0,
            partition: Optional[Partition] = None) -> float:
    """'Run' one training iteration on the simulated cluster.

    Args:
        conf: parallelism configuration.
        mapping: ``(pp, tp, dp)`` or ``(pp, tp, cp, dp)`` worker -> GPU
            dedication.
        w: workload (profiled on the fly via :func:`build_profile`).
        spec: cluster description.
        bw_true: ground-truth bandwidth matrix.
        seed: simulator jitter seed.
        partition: optional non-uniform chunk partition, forwarded to
            :func:`build_profile`.

    Returns:
        Measured seconds for the iteration.
    """
    prof = build_profile(w, spec, conf, partition=partition)
    return simulate_iteration(conf, mapping, bw_true, prof, spec,
                              seed=seed)["total"]

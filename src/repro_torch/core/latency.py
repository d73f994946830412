"""Latency estimators.

``pipette_latency`` — the paper's refined critical-path model (Eq. 3-6):
memory-efficient 1F1B exposes the inter-stage P2P hidden critical path
(n_mb/pp) times, the DP all-reduce of the *first* stage is the only one on
the critical path, and every communication term is evaluated on the
*profiled* bandwidth matrix.  4D configurations add a per-microbatch ring
KV-exchange term scaled by the slowest context-parallel group
(``_cp_scale``); at ``cp == 1`` the term is exactly zero.  The hot path is fully vectorized (batched
NumPy group gathers + axis reductions); the original pure-Python loop
implementation is kept as ``pipette_latency_ref`` and is the bit-exact
oracle for the equivalence tests and benchmarks.

``amp_latency`` — the prior art's model (Eq. 1): GPipe-flavoured critical
path (P2P counted once) with document-specified nominal bandwidths.
"""
from __future__ import annotations

import numpy as np

from typing import Optional, Sequence

from .cluster import (ClusterSpec, compute_slowdowns, min_group_bw,
                      min_group_bw_batch, ring_allreduce_time)
from .simulator import (Conf, Profile, default_mapping, dp_allreduce_times,
                        dp_allreduce_times_ref, mapping4)


def _tp_scale(conf: Conf, mapping: np.ndarray, bw: np.ndarray,
              spec: ClusterSpec, ref_bw: float) -> float:
    """Profiled slowdown of the slowest tensor-parallel group vs the nominal
    intra-node bandwidth the per-microbatch T_tp was profiled at.  Keeps the
    estimator honest when a mapping strands a TP group across nodes.

    Vectorized: all ``pp * cp * dp`` TP groups are gathered into one
    ``(pp*cp*dp, tp, tp)`` bandwidth tensor and min-reduced at once.

    Args:
        conf: parallelism configuration.
        mapping: ``(pp, tp, dp)`` or ``(pp, tp, cp, dp)`` worker -> GPU
            dedication.
        bw: ``(G, G)`` profiled bandwidth matrix, bytes/s.
        spec: cluster description (unused beyond the signature contract).
        ref_bw: bandwidth the per-microbatch T_tp was profiled at.

    Returns:
        Scale >= 1.0 to apply to the profiled T_tp.
    """
    if conf.tp == 1:
        return 1.0
    groups = mapping4(conf, mapping).transpose(0, 2, 3, 1) \
        .reshape(conf.pp * conf.cp * conf.dp, conf.tp)
    gbw = min_group_bw_batch(bw, groups)
    ok = np.isfinite(gbw) & (gbw > 0)
    with np.errstate(divide="ignore"):
        scales = np.where(ok, ref_bw / gbw, 1.0)
    return float(max(1.0, scales.max()))


def _tp_scale_ref(conf: Conf, mapping: np.ndarray, bw: np.ndarray,
                  spec: ClusterSpec, ref_bw: float) -> float:
    """Reference loop implementation of :func:`_tp_scale` (oracle)."""
    if conf.tp == 1:
        return 1.0
    m4 = mapping4(conf, mapping)
    worst = 1.0
    for x in range(conf.pp):
        for k in range(conf.cp):
            for z in range(conf.dp):
                group = [int(m4[x, y, k, z]) for y in range(conf.tp)]
                gbw = min_group_bw(bw, group)
                if np.isfinite(gbw) and gbw > 0:
                    worst = max(worst, ref_bw / gbw)
    return worst


def _cp_scale(conf: Conf, mapping: np.ndarray, bw: np.ndarray,
              ref_bw: float) -> float:
    """Profiled slowdown of the slowest context-parallel (ring KV-exchange)
    group vs the bandwidth T_cp was profiled at — the cp analogue of
    :func:`_tp_scale`.

    Vectorized: all ``pp * tp * dp`` cp groups are gathered into one
    ``(pp*tp*dp, cp, cp)`` bandwidth tensor and min-reduced at once.

    Args:
        conf: parallelism configuration (``cp > 1`` expected; 1.0 otherwise).
        mapping: worker -> GPU dedication (any mapping4-compatible shape).
        bw: ``(G, G)`` profiled bandwidth matrix, bytes/s.
        ref_bw: bandwidth the per-microbatch T_cp was profiled at.

    Returns:
        Scale >= 1.0 to apply to the profiled T_cp.
    """
    if conf.cp == 1:
        return 1.0
    groups = mapping4(conf, mapping).transpose(0, 1, 3, 2) \
        .reshape(conf.pp * conf.tp * conf.dp, conf.cp)
    gbw = min_group_bw_batch(bw, groups)
    ok = np.isfinite(gbw) & (gbw > 0)
    with np.errstate(divide="ignore"):
        scales = np.where(ok, ref_bw / gbw, 1.0)
    return float(max(1.0, scales.max()))


def _cp_scale_ref(conf: Conf, mapping: np.ndarray, bw: np.ndarray,
                  ref_bw: float) -> float:
    """Reference loop implementation of :func:`_cp_scale` (oracle)."""
    if conf.cp == 1:
        return 1.0
    m4 = mapping4(conf, mapping)
    worst = 1.0
    for x in range(conf.pp):
        for y in range(conf.tp):
            for z in range(conf.dp):
                group = [int(m4[x, y, k, z]) for k in range(conf.cp)]
                gbw = min_group_bw(bw, group)
                if np.isfinite(gbw) and gbw > 0:
                    worst = max(worst, ref_bw / gbw)
    return worst


def _pp_hop_bw(conf: Conf, mapping: np.ndarray, bw: np.ndarray) -> np.ndarray:
    """Hop bandwidths of every pipeline chain: ``(pp-1, tp*cp*dp)`` gather.

    Pure function of the mapping and bandwidth matrix (no profile), so
    callers scoring many microbatch variants of one shape can cache it.
    """
    m = mapping4(conf, mapping)
    n_chains = conf.tp * conf.cp * conf.dp
    src = m[:-1].reshape(conf.pp - 1, n_chains)
    dst = m[1:].reshape(conf.pp - 1, n_chains)
    return bw[src, dst]


def _t_pp_from_hops(conf: Conf, hop: np.ndarray, msg_pp: float) -> float:
    """Eq. 5 accumulation over pre-gathered hop bandwidths; the per-chain
    sum runs hop by hop in the reference's left-to-right order so results
    are bit-identical to :func:`_t_pp_chain_ref`."""
    t = np.zeros(conf.tp * conf.cp * conf.dp)
    for x in range(conf.pp - 1):
        t = t + 2.0 * msg_pp / hop[x]
    return float(max(0.0, t.max()))


def _t_pp_chain(conf: Conf, mapping: np.ndarray, bw: np.ndarray,
                prof: Profile) -> float:
    """Eq. 5: slowest end-to-end pipeline chain, fwd+bwd message per hop.

    Vectorized: hop bandwidths for all ``tp * dp`` chains are gathered as a
    ``(pp-1, tp*dp)`` tensor (:func:`_pp_hop_bw`), then accumulated by
    :func:`_t_pp_from_hops`.

    Args:
        conf: parallelism configuration.
        mapping: ``(pp, tp, dp)`` worker -> GPU dedication.
        bw: ``(G, G)`` profiled bandwidth matrix, bytes/s.
        prof: profiled quantities (uses ``msg_pp``).

    Returns:
        Seconds of the slowest chain; 0.0 when ``pp == 1``.
    """
    if conf.pp == 1:
        return 0.0
    return _t_pp_from_hops(conf, _pp_hop_bw(conf, mapping, bw), prof.msg_pp)


def _t_pp_chain_ref(conf: Conf, mapping: np.ndarray, bw: np.ndarray,
                    prof: Profile) -> float:
    """Reference loop implementation of :func:`_t_pp_chain` (oracle)."""
    if conf.pp == 1:
        return 0.0
    m4 = mapping4(conf, mapping)
    worst = 0.0
    for z in range(conf.dp):
        for k in range(conf.cp):
            for y in range(conf.tp):
                t = 0.0
                for x in range(conf.pp - 1):
                    b = bw[int(m4[x, y, k, z]), int(m4[x + 1, y, k, z])]
                    t += 2.0 * prof.msg_pp / b
                worst = max(worst, t)
    return worst


def _t_dp_first_stage(conf: Conf, mapping: np.ndarray, bw: np.ndarray,
                      prof: Profile, spec: ClusterSpec) -> float:
    """Eq. 6: hierarchical-ring all-reduce of stage 1, slowest tp group."""
    return float(dp_allreduce_times(conf, mapping, bw, prof, spec)[0])


def _stage_compute_scale(conf: Conf, mapping: np.ndarray,
                         spec: ClusterSpec) -> Optional[np.ndarray]:
    """Per-stage compute slowdown of a mapping on a tiered cluster.

    Stage ``x``'s GEMM work is evenly sharded over its ``tp * cp * dp``
    member GPUs, so its per-microbatch compute time stretches by the
    *slowest* member's :func:`~repro_torch.core.cluster.compute_slowdowns` factor
    (Megatron-LM's observation that the slowest rank sets stage time).
    Returns ``None`` for compute-uniform specs — the signal to take the
    historical scalar Eq. 3-4 path bit-for-bit.

    Args:
        conf: parallelism configuration.
        mapping: any mapping4-compatible worker -> GPU dedication.
        spec: cluster description (tier table consulted).

    Returns:
        ``(pp,)`` max member slowdown per stage, or ``None``.
    """
    slow = compute_slowdowns(spec)
    if slow is None:
        return None
    return slow[mapping4(conf, mapping)].reshape(conf.pp, -1).max(axis=1)


def _hetero_combine(conf: Conf, prof: Profile, t_cm: float, t_pp: float,
                    t_dp: float, stage_scale: np.ndarray) -> float:
    """Eq. 3-4 generalised to per-stage compute times.

    Per-stage compute ``c_x = (c_fwd + c_bwd) * stage_work_x * scale_x``;
    the steady state is throughput-bound by the slowest stage (``c_max``)
    while the fill/drain pays every stage once (``sum c_x``):

        T = (pp * (c_max + t_cm) + t_pp) * (n_mb / pp)
            + (sum_x c_x - c_max) + (pp - 1) * t_cm + t_dp

    With uniform stages (``c_x == c``) this reduces *algebraically* to the
    scalar formula — but compute-uniform specs never reach here (they take
    the scalar branch), so homogeneous results stay bit-identical.  This
    is what the dedication engine exploits: herding slow GPUs into few
    (and light) stages shrinks ``sum c_x`` and ``c_max``.

    Interleaved-1F1B (``conf.vpp > 1``) shrinks the fill/drain terms by
    ``1/vpp`` — each warmup slot is one *chunk*, not a full stage — while
    paying the inter-stage hop ``vpp`` times per microbatch:

        T = (pp * (c_max + t_cm) + vpp * t_pp) * (n_mb / pp)
            + (sum_x c_x - c_max) / vpp + (pp - 1) * t_cm / vpp + t_dp
    """
    c = prof.c_fwd + prof.c_bwd
    w = (np.asarray(prof.stage_work) if prof.stage_work is not None
         else np.ones(conf.pp))
    c_x = c * w * stage_scale
    c_max = float(c_x.max())
    c_sum = float(c_x.sum())  # repro: noqa DET003 -- this IS the reference pairwise reduction: np_pairwise_sum replays ndarray.sum's association order element for element, pinned bit-exact in tests/test_torch_engine.py
    if conf.vpp == 1:
        t_bubble = conf.pp * (c_max + t_cm) + t_pp
        return (t_bubble * (conf.n_mb / conf.pp) + (c_sum - c_max)
                + (conf.pp - 1) * t_cm + t_dp)
    t_bubble = conf.pp * (c_max + t_cm) + conf.vpp * t_pp
    return (t_bubble * (conf.n_mb / conf.pp)
            + (c_sum - c_max) / conf.vpp
            + (conf.pp - 1) * t_cm / conf.vpp + t_dp)


def _combine_eq34(conf: Conf, prof: Profile, tp_scale: float, t_pp: float,
                  t_dp: float, cp_scale: float = 1.0,
                  stage_scale: Optional[np.ndarray] = None) -> float:
    """Eq. 3-4 scalar combination shared by every scorer of this model:
    ``T = T_bubble * (n_mb / pp) + T_straggler + T_dp``.

    The per-microbatch communication folds the TP all-reduce and (for 4D
    configurations) the ring KV-exchange of context parallelism; at
    ``cp == 1`` the profiled ``t_cp_*`` terms are exactly 0, so the 3D
    value is reproduced bit-for-bit.  ``stage_scale`` (tiered clusters
    only) switches to the per-stage :func:`_hetero_combine`; a non-uniform
    partition or interleaved schedule on a homogeneous fleet takes that
    path too, with unit scales (per-stage work still differs)."""
    c = prof.c_fwd + prof.c_bwd
    t_tp = (prof.t_tp_fwd + prof.t_tp_bwd) * tp_scale
    t_cm = t_tp + (prof.t_cp_fwd + prof.t_cp_bwd) * cp_scale
    if stage_scale is None and (prof.partition is not None or conf.vpp > 1):
        stage_scale = np.ones(conf.pp)
    if stage_scale is not None:
        return _hetero_combine(conf, prof, t_cm, t_pp, t_dp, stage_scale)
    t_bubble = conf.pp * (c + t_cm) + t_pp
    t_straggler = (conf.pp - 1) * (c + t_cm)
    return t_bubble * (conf.n_mb / conf.pp) + t_straggler + t_dp


def pipette_latency(conf: Conf, mapping: np.ndarray, bw: np.ndarray,
                    prof: Profile, spec: ClusterSpec) -> float:
    """Eq. 3-4: T = T_bubble * (n_mb / pp) + T_straggler + T_dp.

    Args:
        conf: parallelism configuration (pp, tp, cp, dp, microbatching).
        mapping: ``(pp, tp, dp)`` or ``(pp, tp, cp, dp)`` worker -> GPU
            dedication.
        bw: ``(G, G)`` profiled bandwidth matrix, bytes/s.
        prof: profiled per-microbatch quantities (:class:`Profile`).
        spec: cluster description.

    Returns:
        Estimated seconds per training iteration.  Uses the vectorized
        group reductions; bit-identical to :func:`pipette_latency_ref`.
        On tiered specs the compute term additionally prices each stage at
        its slowest member GPU (:func:`_stage_compute_scale`).
    """
    scale = _tp_scale(conf, mapping, bw, spec, prof.tp_ref_bw)
    cscale = _cp_scale(conf, mapping, bw, prof.cp_ref_bw)
    t_pp = _t_pp_chain(conf, mapping, bw, prof)
    t_dp = _t_dp_first_stage(conf, mapping, bw, prof, spec)
    sscale = _stage_compute_scale(conf, mapping, spec)
    return _combine_eq34(conf, prof, scale, t_pp, t_dp, cscale, sscale)


def default_mapping_latencies(confs: Sequence[Conf],
                              profiles: Sequence[Profile], bw: np.ndarray,
                              spec: ClusterSpec) -> np.ndarray:
    """Eq. 3-6 latency of every candidate's *default* (node-major) mapping
    in one cached pass.

    The mapping-dependent bandwidth reductions — the TP-group slowdown, the
    inter-stage hop-bandwidth gather (:func:`_pp_hop_bw`), and the stage-0
    DP all-reduce (whose ``msg_dp`` is a ``(pp, tp)``-only quantity) —
    depend only on the ``(pp, tp, dp)`` shape under the default mapping, so
    they are computed once per shape and reused across every microbatch
    variant.  Only the Eq. 5 hop accumulation (whose ``msg_pp`` varies with
    ``bs_micro``) and the Eq. 3-4 scalar combination (:func:`_combine_eq34`)
    run per candidate.  Each output is bit-identical to
    ``pipette_latency(conf, default_mapping(conf), ...)``.

    Precondition (asserted): profiles within one ``(pp, tp, cp, dp)`` shape
    share ``tp_ref_bw``, ``cp_ref_bw`` and ``msg_dp`` — true of
    :func:`~repro_torch.core.simulator.build_profile` output for a single
    workload, where all three are shape-only quantities.

    Args:
        confs: candidate configurations.
        profiles: ``profiles[i]`` is the :class:`Profile` of ``confs[i]``.
        bw: ``(G, G)`` profiled bandwidth matrix, bytes/s.
        spec: cluster description.

    Returns:
        ``(len(confs),)`` array of estimated seconds per iteration.
    """
    bw = np.asarray(bw)
    out = np.empty(len(confs))
    cache = {}
    for i, (conf, prof) in enumerate(zip(confs, profiles)):
        # vpp is part of the shape key: stage_work/partition differ across
        # vpp variants of the same (pp, tp, cp, dp)
        shape = (conf.pp, conf.tp, conf.cp, conf.dp, conf.vpp)
        entry = cache.get(shape)
        if entry is None:
            m = default_mapping(conf)
            scale = _tp_scale(conf, m, bw, spec, prof.tp_ref_bw)
            cscale = _cp_scale(conf, m, bw, prof.cp_ref_bw)
            hop = _pp_hop_bw(conf, m, bw) if conf.pp > 1 else None
            t_dp = float(dp_allreduce_times(conf, m, bw, prof, spec)[0])
            sscale = _stage_compute_scale(conf, m, spec)
            entry = cache[shape] = (scale, cscale, hop, t_dp, sscale,
                                    (prof.tp_ref_bw, prof.cp_ref_bw,
                                     prof.msg_dp, prof.stage_work,
                                     prof.partition, prof.chunk_work))
        scale, cscale, hop, t_dp, sscale, src_fields = entry
        assert (prof.tp_ref_bw, prof.cp_ref_bw, prof.msg_dp,
                prof.stage_work, prof.partition,
                prof.chunk_work) == src_fields, \
            f"profiles vary within shape {shape}; per-shape cache invalid"
        t_pp = 0.0 if conf.pp == 1 \
            else _t_pp_from_hops(conf, hop, prof.msg_pp)
        out[i] = _combine_eq34(conf, prof, scale, t_pp, t_dp, cscale, sscale)
    return out


def pipette_latency_ref(conf: Conf, mapping: np.ndarray, bw: np.ndarray,
                        prof: Profile, spec: ClusterSpec) -> float:
    """Pure-Python reference scorer (the pre-vectorization implementation).

    Kept as the oracle for equivalence tests and the moves/sec benchmark
    baseline; semantics identical to :func:`pipette_latency` (including the
    per-stage compute path on tiered specs, recomputed here with explicit
    loops).
    """
    c = prof.c_fwd + prof.c_bwd
    t_tp = (prof.t_tp_fwd + prof.t_tp_bwd) * _tp_scale_ref(
        conf, mapping, bw, spec, prof.tp_ref_bw)
    t_cm = t_tp + (prof.t_cp_fwd + prof.t_cp_bwd) * _cp_scale_ref(
        conf, mapping, bw, prof.cp_ref_bw)
    t_pp = _t_pp_chain_ref(conf, mapping, bw, prof)
    t_dp = float(dp_allreduce_times_ref(conf, mapping, bw, prof, spec)[0])
    slow = compute_slowdowns(spec)
    if slow is not None:
        m4 = mapping4(conf, mapping)
        scale = np.empty(conf.pp)
        for x in range(conf.pp):
            scale[x] = max(float(slow[int(g)]) for g in m4[x].flat)
        return _hetero_combine(conf, prof, t_cm, t_pp, t_dp, scale)
    if prof.partition is not None or conf.vpp > 1:
        return _hetero_combine(conf, prof, t_cm, t_pp, t_dp,
                               np.ones(conf.pp))
    t_bubble = conf.pp * (c + t_cm) + t_pp
    t_straggler = (conf.pp - 1) * (c + t_cm)
    return t_bubble * (conf.n_mb / conf.pp) + t_straggler + t_dp


def amp_latency(conf: Conf, mapping: np.ndarray, spec: ClusterSpec,
                prof: Profile) -> float:
    """Eq. 1 with nominal (document-specified) bandwidths.

    Args:
        conf: parallelism configuration.
        mapping: unused (AMP is mapping-blind); kept for signature parity.
        spec: cluster description (nominal ``inter_bw`` is used).
        prof: profiled per-microbatch quantities.

    Returns:
        Estimated seconds per iteration under the GPipe-flavoured model.
    """
    c = prof.c_fwd + prof.c_bwd
    t_tp = prof.t_tp_fwd + prof.t_tp_bwd
    # nominal uniform matrix: intra for same node, inter otherwise
    t_pp_hop = 2.0 * prof.msg_pp / spec.inter_bw
    t_pp = (conf.pp - 1) * t_pp_hop
    # nominal flat ring over dp
    t_dp = ring_allreduce_time(prof.msg_dp, spec.inter_bw, conf.dp)
    return (conf.n_mb - 1) * (c + t_tp) + conf.pp * (c + t_tp) + t_pp + t_dp


def varuna_latency(conf: Conf, spec: ClusterSpec, prof: Profile) -> float:
    """Varuna-style estimate: pipeline-only focus, nominal bandwidths,
    memory-unaware (used to rank its candidate configs).

    Args:
        conf: parallelism configuration (tp is assumed 1 by the caller).
        spec: cluster description (nominal ``inter_bw`` is used).
        prof: profiled per-microbatch quantities.

    Returns:
        Estimated seconds per iteration.
    """
    c = prof.c_fwd + prof.c_bwd
    t_pp_hop = 2.0 * prof.msg_pp / spec.inter_bw
    bubble = (conf.pp - 1) * (c + t_pp_hop)
    steady = conf.n_mb * c
    t_dp = ring_allreduce_time(prof.msg_dp, spec.inter_bw, conf.dp)
    return steady + bubble + t_dp

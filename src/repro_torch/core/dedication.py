"""Fine-grained worker dedication (§IV): simulated annealing over the 1:1
logical-worker -> GPU mapping.

Moves (paper §IV): *migration* (remove one element, reinsert at a random
position), *swap* (exchange two elements) and *reverse* (reverse a
substring — exploits the near-symmetric bidirectional bandwidths).
Temperature decay alpha = 0.999; the budget is wall-clock seconds with an
iteration cap so tests stay fast.

The hot loop is driven by :class:`DedicationEngine`, an incremental
vectorized scorer: the three SA moves touch a known set of permutation
positions, and only the TP groups / pipeline chains / first-stage DP groups
(and, for 4D configurations, the context-parallel ring groups; on tiered
clusters, the pipeline stages whose compute-slowness changed) containing
those positions are re-gathered and re-reduced — everything else
comes from per-group caches.  Scores are bit-identical to the full
:func:`repro_torch.core.latency.pipette_latency` (and its pure-Python reference).
:func:`anneal_multistart` adds best-of-``n_chains`` restarts on top.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .cluster import ClusterSpec, compute_slowdowns
from .latency import _hetero_combine, pipette_latency
from .simulator import Conf, Profile


def perm_to_mapping(perm: np.ndarray, conf: Conf) -> np.ndarray:
    """Flat permutation -> (pp, tp[, cp], dp) worker mapping.

    Flattening keeps tp fastest (then cp, then dp, then pp) so contiguous
    GPUs (same node) serve one tensor-parallel group in the identity
    permutation.

    Args:
        perm: ``(n_gpus,)`` permutation of GPU ids; position ``p`` holds the
            GPU serving logical worker ``(x, y, k, z)`` with
            ``p = x*dp*cp*tp + z*cp*tp + k*tp + y`` (``k = 0`` collapses to
            the historical 3D layout when ``cp == 1``).
        conf: parallelism configuration.

    Returns:
        ``(pp, tp, dp)`` integer mapping array when ``cp == 1`` (the
        historical shape), else ``(pp, tp, cp, dp)``.
    """
    if conf.cp == 1:
        return perm.reshape(conf.pp, conf.dp, conf.tp).transpose(0, 2, 1)
    return perm.reshape(conf.pp, conf.dp, conf.cp,
                        conf.tp).transpose(0, 3, 2, 1)


def mapping_to_perm(mapping: np.ndarray) -> np.ndarray:
    """Inverse of :func:`perm_to_mapping`: worker mapping -> flat permutation.

    Round-trips exactly (``mapping_to_perm(perm_to_mapping(p, conf)) == p``)
    for both the 3D ``(pp, tp, dp)`` and 4D ``(pp, tp, cp, dp)`` shapes.
    This is how a saved Plan's best mapping becomes a
    ``Budget.warm_start`` seed permutation for a neighbouring request —
    the flat GPU ordering is shape-agnostic, so it can warm-start SA on
    any candidate configuration of the same fleet.
    """
    m = np.asarray(mapping)
    if m.ndim == 3:
        return np.ascontiguousarray(m.transpose(0, 2, 1)).reshape(-1)
    if m.ndim == 4:
        return np.ascontiguousarray(m.transpose(0, 3, 2, 1)).reshape(-1)
    raise ValueError(
        f"mapping must be 3D (pp, tp, dp) or 4D (pp, tp, cp, dp), "
        f"got ndim={m.ndim}")


def project_perm(perm: np.ndarray, survivors: Sequence[int],
                 n_new: int) -> np.ndarray:
    """Project an incumbent permutation onto a resized fleet.

    The elastic warm-start rule: keep the incumbent's *relative* GPU
    ordering over the GPUs that survived the churn event, renumber them
    into the new fleet's contiguous id space, and append any brand-new
    GPUs in id order at the tail (they have no incumbent position).  The
    result is a valid ``(n_new,)`` permutation usable as
    ``Budget.warm_start`` for any candidate configuration of the new
    fleet.

    Args:
        perm: incumbent flat permutation over the old fleet's GPU ids.
        survivors: old GPU ids still present, in new-id order — new GPU
            ``i`` (for ``i < len(survivors)``) is old GPU
            ``survivors[i]``.  Must be unique and within the old fleet.
        n_new: GPU count of the new fleet (``>= len(survivors)``).

    Returns:
        ``(n_new,)`` int permutation of ``0..n_new-1``.
    """
    perm = np.asarray(perm)
    survivors = np.asarray(list(survivors), dtype=np.int64)
    n_old = perm.shape[0]
    if survivors.size and (survivors.min() < 0 or survivors.max() >= n_old):
        raise ValueError(
            f"survivors must be old GPU ids in [0, {n_old}), "
            f"got {survivors.tolist()}")
    if np.unique(survivors).size != survivors.size:
        raise ValueError(f"duplicate survivor ids: {survivors.tolist()}")
    if n_new < survivors.size:
        raise ValueError(
            f"n_new={n_new} smaller than {survivors.size} survivors")
    # old id -> new id (or -1 for a departed GPU); vectorised so the
    # output order is the incumbent's, never a set-iteration order.
    old_to_new = np.full(n_old, -1, dtype=np.int64)
    old_to_new[survivors] = np.arange(survivors.size)
    kept = old_to_new[perm]
    kept = kept[kept >= 0]
    fresh = np.arange(survivors.size, n_new, dtype=np.int64)
    return np.concatenate([kept, fresh])


@dataclass
class SAResult:
    """Outcome of one (or a multi-start batch of) annealing run(s).

    Attributes:
        mapping: best ``(pp, tp, dp)`` worker -> GPU dedication found.
        perm: the flat permutation behind ``mapping``.
        latency: estimated seconds/iteration of ``mapping``.
        iters: total SA iterations executed (summed over chains).
        seconds: total wall-clock seconds spent annealing.
        trace: ``[(iter, best_so_far), ...]`` of the winning chain.
        chain_latencies: per-chain best latencies (multi-start only).
        accepted: accepted moves, summed over chains.
        accepted_to_best: accepted moves the winning chain needed to first
            reach its best value (0 = the initial permutation was never
            improved on) — the warm-start economy metric: a chain seeded
            from a good incumbent reaches the same quality in strictly
            fewer accepted moves than a cold chain.

    Example:
        >>> res = anneal(conf, bw, prof, spec, time_limit_s=0.5, seed=0)
        >>> res.latency <= pipette_latency(conf, default_mapping(conf),
        ...                                bw, prof, spec)
        True
        >>> res.mapping.shape == (conf.pp, conf.tp, conf.dp)
        True
    """
    mapping: np.ndarray
    perm: np.ndarray
    latency: float
    iters: int
    seconds: float
    trace: list
    chain_latencies: Optional[List[float]] = None
    accepted: int = 0
    accepted_to_best: int = 0


# ---------------------------------------------------------------------------
# moves
# ---------------------------------------------------------------------------

def _move_span(perm: np.ndarray,
               rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """One SA move plus the positions it touched.

    Returns:
        ``(new_perm, touched)`` where ``touched`` is the array of permutation
        positions whose GPU changed (a superset is allowed; migration and
        reverse report the contiguous affected span, swap exactly two).
    """
    n = len(perm)
    p = perm.copy()
    kind, i, j = (int(v) for v in rng.integers((3, n, n - 1)))
    if j >= i:
        j += 1
    if i > j:
        i, j = j, i
    if kind == 0:          # migration: remove at i, reinsert at j % (n-1)
        jj = j % (n - 1)
        el = p[i]
        if jj >= i:
            p[i:jj] = p[i + 1:jj + 1].copy()
            p[jj] = el
            touched = np.arange(i, jj + 1)
        else:
            p[jj + 1:i + 1] = p[jj:i].copy()
            p[jj] = el
            touched = np.arange(jj, i + 1)
    elif kind == 1:        # swap
        p[i], p[j] = p[j], p[i]
        touched = np.array((i, j))
    else:                  # reverse
        p[i:j + 1] = p[i:j + 1][::-1]
        touched = np.arange(i, j + 1)
    return p, touched


def _move(perm: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """One SA move (migration / swap / reverse); returns the new permutation."""
    return _move_span(perm, rng)[0]


# ---------------------------------------------------------------------------
# incremental vectorized scoring engine
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GroupIndex:
    """Precomputed permutation-position tensors for a (pp, tp, cp, dp)
    shape.

    Positions follow the :func:`perm_to_mapping` layout
    ``p = x*dp*cp*tp + z*cp*tp + k*tp + y``; the tensors depend only on the
    shape, never on the permutation or bandwidth, so
    :func:`repro_torch.core.search.configure` shares one instance across every
    microbatch variant of a parallelism shape.

    Attributes:
        pos_tp: ``(pp*cp*dp, tp)`` positions of each tensor-parallel group.
        pos_pp_src / pos_pp_dst: ``(pp-1, tp*cp*dp)`` positions of the
            sender / receiver of every inter-stage hop, one column per
            chain.
        pos_dp0: ``(tp*cp, dp)`` positions of the stage-0 data-parallel
            groups (the only DP groups on the Eq. 6 critical path).
        pos_cp: ``(pp*tp*dp, cp)`` positions of each context-parallel (ring
            KV-exchange) group; ``None`` when ``cp == 1``.
        cp_group_of: ``(n_gpus,)`` position -> cp-group-row lookup used by
            the incremental move re-scorer; ``None`` when ``cp == 1``.
    """
    pp: int
    tp: int
    dp: int
    pos_tp: np.ndarray
    pos_pp_src: np.ndarray
    pos_pp_dst: np.ndarray
    pos_dp0: np.ndarray
    cp: int = 1
    pos_cp: Optional[np.ndarray] = None
    cp_group_of: Optional[np.ndarray] = None

    @staticmethod
    def build(conf: Conf) -> "GroupIndex":
        """Construct the index tensors for ``conf``'s (pp, tp, cp, dp)
        shape."""
        pp, tp, cp, dp = conf.pp, conf.tp, conf.cp, conf.dp
        nc = tp * cp * dp                      # positions per stage
        base = (np.arange(pp)[:, None] * (dp * cp) +
                np.arange(dp * cp)[None, :]) * tp
        pos_tp = base.reshape(-1, 1) + np.arange(tp)[None, :]
        chains = np.arange(nc)
        stages = np.arange(max(pp - 1, 1))[:, None] * nc
        pos_pp_src = stages + chains[None, :]
        pos_pp_dst = pos_pp_src + nc
        pos_dp0 = np.arange(dp)[None, :] * (tp * cp) \
            + np.arange(tp * cp)[:, None]
        pos_cp = cp_group_of = None
        if cp > 1:
            # cp group row g = (x*dp + z)*tp + y holds positions
            # p(k) = x*dp*cp*tp + z*cp*tp + k*tp + y
            xz = (np.arange(pp)[:, None] * dp +
                  np.arange(dp)[None, :]) * (cp * tp)
            gbase = xz.reshape(-1, 1) + np.arange(tp)[None, :]
            pos_cp = gbase.reshape(-1, 1) + np.arange(cp)[None, :] * tp
            pos = np.arange(pp * nc)
            cp_group_of = (pos // (dp * cp * tp) * dp
                           + pos % (dp * cp * tp) // (cp * tp)) * tp \
                + pos % tp
        return GroupIndex(pp, tp, dp, pos_tp, pos_pp_src, pos_pp_dst,
                          pos_dp0, cp, pos_cp, cp_group_of)


@dataclass(frozen=True)
class PairCache:
    """Configuration-independent GPU-pair matrices shared across engines.

    All ``(G, G)`` tensors an engine gathers from depend only on the
    profiled bandwidth matrix and the node width — never on the candidate
    configuration — so one instance serves every engine of a search (every
    microbatch/shape variant, and the torch engine's host-side mirror).  At
    10k GPUs each matrix is ~800 MB; building them once instead of per
    candidate is the difference between seconds and minutes of planning
    time.

    Attributes:
        bw: the bandwidth matrix as contiguous float64 (the canonical copy
            every sharing engine gathers from).
        bw_noself: ``bw`` with the diagonal forced to ``inf`` (masks
            self-links out of group-min reductions).
        sym_intra: ``min(bw[i,j], bw[j,i])`` on distinct same-node pairs,
            ``inf`` elsewhere — finite exactly where the hierarchical
            all-reduce intra-node term applies.
        gpus_per_node: node width the same-node blocks were built for.
    """
    bw: np.ndarray
    bw_noself: np.ndarray
    sym_intra: np.ndarray
    gpus_per_node: int

    @classmethod
    def build(cls, bw: np.ndarray, gpus_per_node: int) -> "PairCache":
        """Build the shared matrices with O(G^2) *memory passes*, not
        O(G^2) boolean-mask algebra: ``bw_noself`` is a copy plus a
        diagonal fill, and ``sym_intra`` only ever has finite values in
        the per-node diagonal blocks, so it is an ``inf`` canvas with
        ``n_nodes`` tiny ``gpn x gpn`` block writes.  Values are
        bit-identical to the historical full-matrix ``np.where`` /
        transpose construction."""
        bw64 = np.ascontiguousarray(bw, dtype=float)
        g = bw64.shape[0]
        bw_noself = bw64.copy()
        np.fill_diagonal(bw_noself, np.inf)
        sym_intra = np.full((g, g), np.inf)
        for a in range(0, g, gpus_per_node):
            b = min(a + gpus_per_node, g)
            blk = np.minimum(bw64[a:b, a:b], bw64[a:b, a:b].T)
            np.fill_diagonal(blk, np.inf)
            sym_intra[a:b, a:b] = blk
        return cls(bw64, bw_noself, sym_intra, gpus_per_node)


class DedicationEngine:
    """Vectorized pipette-latency scorer with incremental move re-scoring.

    ``score()`` evaluates a permutation from scratch and fills per-group
    caches (TP-group slowdowns, pipeline-chain times, stage-0 DP all-reduce
    times, and — on tiered clusters — per-stage compute slowdowns).
    ``propose()`` re-gathers only the groups containing positions a
    move touched and combines them with the cached remainder; ``commit()``
    promotes a proposal to the new committed state.  All values are
    bit-identical to :func:`repro_torch.core.latency.pipette_latency` on the
    corresponding mapping.  ``compute_aware=False`` ignores device tiers
    (every GPU priced at reference speed) — the compute-blind baseline the
    heterogeneous evaluation compares against.

    Example:
        >>> eng = DedicationEngine(conf, bw, prof, spec)
        >>> cur = eng.score(np.arange(conf.n_gpus))
        >>> cand, touched = _move_span(np.arange(conf.n_gpus), rng)
        >>> val, pending = eng.propose(cand, touched)
        >>> eng.commit(pending)          # accept the move
    """

    def __init__(self, conf: Conf, bw: np.ndarray, prof: Profile,
                 spec: ClusterSpec, index: Optional[GroupIndex] = None,
                 compute_aware: bool = True,
                 pairs: Optional[PairCache] = None):
        if index is not None and \
                (index.pp, index.tp, index.cp, index.dp) != \
                (conf.pp, conf.tp, conf.cp, conf.dp):
            raise ValueError("GroupIndex shape mismatch")
        self.conf = conf
        self.prof = prof
        self.spec = spec
        self.idx = index if index is not None else GroupIndex.build(conf)
        # Heterogeneous compute: per-GPU slowdowns (None on compute-uniform
        # specs — the scalar Eq. 3-4 path, bit-exact with history).
        # ``compute_aware=False`` forces the blind path even on tiered
        # specs: the ablation/baseline that prices every GPU at reference
        # speed (the comparison point for the compute-aware win).
        self._slow = compute_slowdowns(spec) if compute_aware else None
        # Non-uniform partitions / interleaved schedules need the per-stage
        # combination even on homogeneous fleets (unit compute scales, but
        # stage_work varies); mirrors latency._combine_eq34's trigger.
        self._uniform_stage_scale = (
            np.ones(conf.pp)
            if self._slow is None and (prof.partition is not None
                                       or conf.vpp > 1)
            else None)
        # Pair matrices (the only O(G^2) state): shared via ``pairs`` when
        # the caller scores many candidates against one fleet, else built
        # here.  The cache must have been built from this same ``bw`` and
        # node width — ``dedicate_candidates`` owns that invariant.
        if pairs is None:
            pairs = PairCache.build(bw, spec.gpus_per_node)
        elif pairs.gpus_per_node != spec.gpus_per_node or \
                pairs.bw.shape != np.shape(bw):
            raise ValueError("PairCache does not match bw/spec")
        self.bw = pairs.bw
        self._bw_noself = pairs.bw_noself
        self._sym_intra = pairs.sym_intra
        # Per-conf move-loop constants (all O(dp), built per engine):
        #   _hopf — 2 * msg_pp, the per-hop pipeline numerator (the divide
        #     by the gathered link bandwidth happens in _chain_times)
        #   _intra/_inter_coef — ring coefficients phases*(n-1)/n*msg by
        #     integer group size, computed with the reference op order
        if conf.pp > 1:
            self._hopf = 2.0 * prof.msg_pp
        self._jlt_dp = (np.arange(conf.dp)[None, :] <
                        np.arange(conf.dp)[:, None])
        self._intra_coef = np.array(
            [4 * (c - 1) / c * prof.msg_dp if c else 0.0
             for c in range(conf.dp + 1)])
        self._inter_coef = np.array(
            [2 * (c - 1) / c * prof.msg_dp if c else 0.0
             for c in range(conf.dp + 1)])
        self._tp_vals: Optional[np.ndarray] = None
        self._chain_vals: Optional[np.ndarray] = None
        self._dp0_vals: Optional[np.ndarray] = None
        self._cp_vals: Optional[np.ndarray] = None
        self._stage_vals: Optional[np.ndarray] = None

    # -- per-group recomputation (vectorized gathers over a group subset) --

    def _tp_scales(self, perm: np.ndarray, gsel) -> np.ndarray:
        ids = perm[self.idx.pos_tp[gsel]]
        gbw = self._bw_noself[ids[:, :, None], ids[:, None, :]].min(axis=(1, 2))
        # same degenerate-link guard as latency._tp_scale (scale 1.0 when a
        # group's min link is 0 or non-finite, e.g. user-supplied matrices)
        ok = np.isfinite(gbw) & (gbw > 0)
        return np.divide(self.prof.tp_ref_bw, gbw,
                         out=np.ones_like(gbw), where=ok)

    def _cp_scales(self, perm: np.ndarray, gsel) -> np.ndarray:
        # ring KV-exchange slowdown per cp group — the cp analogue of
        # _tp_scales, gathered over the GroupIndex.pos_cp rows
        ids = perm[self.idx.pos_cp[gsel]]
        gbw = self._bw_noself[ids[:, :, None], ids[:, None, :]].min(axis=(1, 2))
        ok = np.isfinite(gbw) & (gbw > 0)
        return np.divide(self.prof.cp_ref_bw, gbw,
                         out=np.ones_like(gbw), where=ok)

    def _chain_times(self, perm: np.ndarray, csel) -> np.ndarray:
        # gather the hop links, then divide — elementwise identical to the
        # historical full (G, G) ``2*msg_pp/bw`` precompute, without the
        # O(G^2) pass (and 800 MB at 10k GPUs) per engine
        src = perm[self.idx.pos_pp_src[:, csel]]
        dst = perm[self.idx.pos_pp_dst[:, csel]]
        with np.errstate(divide="ignore"):
            t = self._hopf / self.bw[src[0], dst[0]]
            for x in range(1, self.conf.pp - 1):
                t = t + self._hopf / self.bw[src[x], dst[x]]
        return t

    def _stage_scales(self, perm: np.ndarray, xsel) -> np.ndarray:
        # max member-GPU compute slowdown per pipeline stage — stage x owns
        # the contiguous position block [x*nc, (x+1)*nc), so the gather is
        # a plain reshape (same values as latency._stage_compute_scale's
        # mapping4 gather: max over the same member set)
        nc = self.conf.tp * self.conf.cp * self.conf.dp
        ids = perm.reshape(self.conf.pp, nc)[xsel]
        return self._slow[ids].max(axis=1)

    def _dp0_times(self, perm: np.ndarray, ysel) -> np.ndarray:
        # Specialised hier_allreduce_batch with pair matrices and ring
        # coefficients hoisted to __init__; arithmetic is identical (see that
        # function for the derivation).  Size-1 node clusters / single-node
        # groups fall out as coef 0 / inf bandwidth -> 0 seconds.
        ids = perm[self.idx.pos_dp0[ysel]]
        ii, jj = ids[:, :, None], ids[:, None, :]
        sym = self._sym_intra[ii, jj]
        member_min = sym.min(axis=2)
        # sym is finite exactly on distinct same-node pairs, so the same-node
        # mask falls out of the float gather (+1 restores the self member)
        same = np.isfinite(sym)
        counts = same.sum(axis=2) + 1  # repro: noqa DET003 -- boolean mask count: integer reduction, exact in any association order
        intra = (self._intra_coef[counts] / member_min).max(axis=1)
        is_rep = ~(same & self._jlt_dp).any(axis=2)
        n_reps = is_rep.sum(axis=1)  # repro: noqa DET003 -- boolean mask count: integer reduction, exact in any association order
        pair = is_rep[:, :, None] & is_rep[:, None, :]
        rep_min = np.where(pair, self._bw_noself[ii, jj], np.inf) \
            .min(axis=(1, 2))
        inter = self._inter_coef[n_reps] / rep_min
        return intra + inter

    # -- scoring --

    def _combine(self, tp_vals, chain_vals, dp0_vals, cp_vals,
                 stage_vals=None) -> float:
        conf, prof = self.conf, self.prof
        c = prof.c_fwd + prof.c_bwd
        scale = 1.0 if conf.tp == 1 else float(max(1.0, tp_vals.max()))
        t_tp = (prof.t_tp_fwd + prof.t_tp_bwd) * scale
        cscale = 1.0 if conf.cp == 1 else float(max(1.0, cp_vals.max()))
        t_cm = t_tp + (prof.t_cp_fwd + prof.t_cp_bwd) * cscale
        t_pp = 0.0 if conf.pp == 1 else float(max(0.0, chain_vals.max()))
        t_dp = float(max(0.0, dp0_vals.max()))
        if stage_vals is None:
            stage_vals = self._uniform_stage_scale
        if stage_vals is not None:
            # tiered cluster (or non-uniform partition / vpp > 1 with unit
            # scales): shared per-stage combination (bit-identical to
            # pipette_latency via the same _hetero_combine arithmetic)
            return _hetero_combine(conf, prof, t_cm, t_pp, t_dp, stage_vals)
        t_bubble = conf.pp * (c + t_cm) + t_pp
        t_straggler = (conf.pp - 1) * (c + t_cm)
        return t_bubble * (conf.n_mb / conf.pp) + t_straggler + t_dp

    def score(self, perm: np.ndarray) -> float:
        """Full evaluation of ``perm``; (re)initialises the caches.

        Returns the same value as
        ``pipette_latency(conf, perm_to_mapping(perm, conf), bw, prof, spec)``.
        """
        conf = self.conf
        perm = np.asarray(perm, dtype=np.intp)
        self._tp_vals = (self._tp_scales(perm, slice(None))
                         if conf.tp > 1 else np.ones(1))
        self._chain_vals = (self._chain_times(perm, slice(None))
                            if conf.pp > 1 else np.zeros(1))
        self._dp0_vals = self._dp0_times(perm, slice(None))
        self._cp_vals = (self._cp_scales(perm, slice(None))
                         if conf.cp > 1 else np.ones(1))
        self._stage_vals = (self._stage_scales(perm, slice(None))
                            if self._slow is not None else None)
        return self._combine(self._tp_vals, self._chain_vals,
                             self._dp0_vals, self._cp_vals,
                             self._stage_vals)

    def propose(self, cand: np.ndarray, touched: np.ndarray):
        """Score candidate ``cand`` that differs from the committed
        permutation only at positions ``touched``.

        Only the groups intersecting ``touched`` are re-gathered; the rest
        come from the caches filled by the last ``score()``/``commit()``.

        Returns:
            ``(value, pending)`` — ``value`` is the candidate's latency and
            ``pending`` the cache state to pass to :meth:`commit` if the move
            is accepted.
        """
        conf = self.conf
        tp, tpc = conf.tp, conf.tp * conf.cp
        nc = tpc * conf.dp           # positions per pipeline stage
        lo, hi, n_t = int(touched[0]), int(touched[-1]), len(touched)
        span = hi - lo + 1 == n_t    # contiguous (migration/reverse) or swap

        tp_vals = self._tp_vals
        if tp > 1:
            if span:
                gidx = slice(lo // tp, hi // tp + 1)
            else:                    # swap: at most two groups
                gi, gj = lo // tp, hi // tp
                gidx = np.array((gi,) if gi == gj else (gi, gj))
            tp_vals = self._tp_vals.copy()
            tp_vals[gidx] = self._tp_scales(cand, gidx)

        chain_vals = self._chain_vals
        if conf.pp > 1:
            if span:
                if n_t >= nc:
                    cidx = slice(None)
                elif lo // nc == hi // nc:     # span inside one stage block
                    cidx = slice(lo % nc, hi % nc + 1)
                else:       # a span shorter than nc has distinct residues
                    cidx = touched % nc
            else:
                ci, cj = lo % nc, hi % nc
                cidx = np.array((ci,) if ci == cj else (ci, cj))
            chain_vals = self._chain_vals.copy()
            chain_vals[cidx] = self._chain_times(cand, cidx)

        dp0_vals = self._dp0_vals
        if lo < nc:                  # move touches stage-0 positions
            # stage-0 DP group of position p is p % tpc (blocks of tp*cp)
            if span:
                hi0 = min(hi, nc - 1)
                if hi0 - lo + 1 >= tpc:
                    ysel = slice(None)
                elif lo // tpc == hi0 // tpc:  # span inside one tp*cp block
                    ysel = slice(lo % tpc, hi0 % tpc + 1)
                else:
                    ysel = np.arange(lo, hi0 + 1) % tpc
            else:
                yi = lo % tpc
                if hi < nc:
                    yj = hi % tpc
                    ysel = np.array((yi,) if yi == yj else (yi, yj))
                else:
                    ysel = np.array((yi,))
            dp0_vals = self._dp0_vals.copy()
            dp0_vals[ysel] = self._dp0_times(cand, ysel)

        cp_vals = self._cp_vals
        if conf.cp > 1:
            # cp groups interleave with stride tp, so a span does not map to
            # contiguous group rows; the O(|touched|) lookup + unique is
            # still tiny next to the gathers it saves
            gsel = np.unique(self.idx.cp_group_of[touched])
            cp_vals = self._cp_vals.copy()
            cp_vals[gsel] = self._cp_scales(cand, gsel)

        stage_vals = self._stage_vals
        if self._slow is not None:
            # stage of position p is p // nc; a move touches at most the
            # [lo // nc, hi // nc] stage range (contiguous by construction)
            xi, xj = lo // nc, hi // nc
            xsel = slice(xi, xj + 1) if span else \
                np.array((xi,) if xi == xj else (xi, xj))
            stage_vals = self._stage_vals.copy()
            stage_vals[xsel] = self._stage_scales(cand, xsel)

        val = self._combine(tp_vals, chain_vals, dp0_vals, cp_vals,
                            stage_vals)
        return val, (tp_vals, chain_vals, dp0_vals, cp_vals, stage_vals)

    def commit(self, pending) -> None:
        """Promote a :meth:`propose` result to the committed state."""
        (self._tp_vals, self._chain_vals, self._dp0_vals,
         self._cp_vals, self._stage_vals) = pending


# ---------------------------------------------------------------------------
# annealing routines
# ---------------------------------------------------------------------------

def anneal(conf: Conf, bw: np.ndarray, prof: Profile, spec: ClusterSpec, *,
           objective: Optional[Callable[[np.ndarray], float]] = None,
           time_limit_s: float = 2.0, max_iters: int = 20_000,
           alpha: float = 0.999, seed: int = 0,
           init_perm: Optional[np.ndarray] = None,
           engine: Optional[DedicationEngine] = None,
           compute_aware: bool = True) -> SAResult:
    """Simulated-annealing worker dedication (Algorithm 1, line 7).

    Args:
        conf: parallelism configuration to dedicate workers for.
        bw: ``(G, G)`` profiled bandwidth matrix, bytes/s.
        prof: profiled per-microbatch quantities.
        spec: cluster description.
        objective: optional custom ``perm -> cost``; when given, the generic
            (non-incremental) path is used.  Default scores with the
            incremental :class:`DedicationEngine` — same values, ~10-100x
            more moves/sec.
        time_limit_s: wall-clock budget.
        max_iters: iteration cap (keeps tests fast).
        alpha: geometric temperature decay per move.
        seed: RNG seed; runs are deterministic given (seed, inputs).
        init_perm: starting permutation (identity when ``None``).
        engine: reuse a pre-built engine (e.g. shared index tensors).
        compute_aware: forwarded to :class:`DedicationEngine` when one is
            built here; ``False`` anneals compute-blind on tiered specs
            (ignored when ``engine`` is given).

    Returns:
        :class:`SAResult` with the best mapping found and its trace.
    """
    rng = np.random.default_rng(seed)
    n = conf.n_gpus
    perm = np.arange(n) if init_perm is None else init_perm.copy()

    use_engine = objective is None
    if use_engine:
        if engine is None:
            engine = DedicationEngine(conf, bw, prof, spec,
                                      compute_aware=compute_aware)
        cur = engine.score(perm)
    else:
        cur = objective(perm)

    best_perm, best = perm.copy(), cur
    # initial temperature from the spread of a few random proposals
    probes = []
    for _ in range(8):
        cand, touched = _move_span(perm, rng)
        val = engine.propose(cand, touched)[0] if use_engine \
            else objective(cand)
        probes.append(abs(val - cur))
    temp = max(max(probes), cur * 1e-3, 1e-12)

    t0 = time.perf_counter()
    it = 0
    acc = acc_best = 0
    trace = [(0, best)]
    while it < max_iters and (time.perf_counter() - t0) < time_limit_s:
        cand, touched = _move_span(perm, rng)
        if use_engine:
            val, pending = engine.propose(cand, touched)
        else:
            val = objective(cand)
        delta = val - cur
        if delta <= 0 or rng.random() < math.exp(-delta / max(temp, 1e-15)):
            perm, cur = cand, val
            acc += 1
            if use_engine:
                engine.commit(pending)
            if cur < best:
                best_perm, best = perm.copy(), cur
                acc_best = acc
                trace.append((it, best))
        temp *= alpha
        it += 1
    return SAResult(perm_to_mapping(best_perm, conf), best_perm, best, it,
                    time.perf_counter() - t0, trace,
                    accepted=acc, accepted_to_best=acc_best)


def anneal_multistart(conf: Conf, bw: np.ndarray, prof: Profile,
                      spec: ClusterSpec, *, n_chains: int = 4,
                      time_limit_s: float = 2.0, max_iters: int = 20_000,
                      alpha: float = 0.999, seed: int = 0,
                      init_perm: Optional[np.ndarray] = None,
                      engine: Optional[DedicationEngine] = None,
                      compute_aware: bool = True) -> SAResult:
    """Best-of-``n_chains`` independent annealing restarts.

    The budgets are split across chains so the total cost matches a single
    :func:`anneal` call with the same budgets — *exactly*: with
    ``base, rem = divmod(max_iters, n_chains)``, chain ``k`` runs
    ``base + 1`` iterations when ``k < rem`` else ``base`` (the historical
    ``max(1, max_iters // n_chains)`` silently ran up to ``n_chains - 1``
    extra iterations, and a full ``n_chains`` extra when
    ``n_chains > max_iters``).  Edge cases are defined, not accidental:
    a chain whose share is zero iterations runs no moves and contributes
    its initial permutation's score; ``time_limit_s = 0`` gives every
    chain a zero wall-clock budget, so all chains are score-only and the
    result is the initial permutation.  Chain ``k`` runs with seed
    ``seed * 100003 + k``, making the whole routine deterministic in
    ``seed``.

    Returns:
        :class:`SAResult` of the winning chain, with ``iters``/``seconds``
        summed over all chains and ``chain_latencies`` listing every chain's
        best.
    """
    if n_chains < 1:
        raise ValueError("n_chains must be >= 1")
    if engine is None:
        engine = DedicationEngine(conf, bw, prof, spec,
                                  compute_aware=compute_aware)
    per_t = time_limit_s / n_chains
    base_it, rem_it = divmod(max_iters, n_chains)
    best: Optional[SAResult] = None
    iters, seconds, lats, acc = 0, 0.0, [], 0
    for k in range(n_chains):
        res = anneal(conf, bw, prof, spec, time_limit_s=per_t,
                     max_iters=base_it + (1 if k < rem_it else 0),
                     alpha=alpha,
                     seed=seed * 100003 + k, init_perm=init_perm,
                     engine=engine)
        iters += res.iters
        seconds += res.seconds
        lats.append(res.latency)
        acc += res.accepted
        if best is None or res.latency < best.latency:
            best = res
    return SAResult(best.mapping, best.perm, best.latency, iters, seconds,
                    best.trace, chain_latencies=lats, accepted=acc,
                    accepted_to_best=best.accepted_to_best)

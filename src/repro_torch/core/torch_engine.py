"""PyTorch dedication scorer and batched multi-chain annealer.

This is the ``backend="torch"`` execution engine of the unified SA core
(``repro_torch.core.annealing``): the Eq. 3-6 mapping score is a function
of a ``(B, n)`` batch of flat permutations, where the leading axis runs
over every chain of every same-shape candidate configuration
(``B = candidates x chains``).  The move-propose / score / accept loop is a
host loop of ``T`` steps that enqueues tensor operations and never reads a
value back, so one pass advances every chain of every candidate without a
host synchronisation inside.

Bit-parity with the NumPy engine is a hard contract, not a tolerance: the
score mirrors :class:`repro_torch.core.dedication.DedicationEngine`
reduction by reduction (min/max reductions are order-insensitive; the
pipeline-chain hop accumulation replays the host engine's left-to-right
fold; the tiered per-stage sum replays NumPy's pairwise summation order via
:func:`np_pairwise_sum`), everything is float64, and every multiply and add
is its own elementwise operation — nothing here uses a fused
multiply-add (``addcmul``/``addcdiv``/``lerp``), because one contracted ulp
flips an SA accept decision and diverges a whole chain.  For the same reason
every divide has a tensor on both sides: with a Python scalar as one operand
torch may multiply by a reciprocal instead (``scalar / tensor`` always, and
``tensor / scalar`` on a CUDA device), which rounds twice.

The group-reduce inner step (per-group min-bandwidth scales, per-stage max
compute slowdown) goes through :mod:`repro_torch.kernels.group_reduce`: on
a CUDA device these are the hand-written CUDA kernels, one launch for the
whole batch; on the CPU the wrappers use their plain versions.  Each TP or
CP scale is one launch of the gather form of ``group_min_scale``, which
reads every group's bandwidths from ``bw_noself`` through the permutation
and returns the clamped per-row maximum; the tiered per-stage compute term
is one launch of the gather form of ``group_max``, which reads each stage's
member slowdowns through the permutation and returns the weighted stage
maxima and their per-row maximum.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..kernels.group_reduce import (cp_geometry, group_max_gather,
                                    group_min_scale_gather, tp_geometry)
from .cluster import ClusterSpec, compute_slowdowns
from .dedication import PairCache
from .simulator import Conf, Profile


def np_pairwise_sum(x, n: int):
    """Sum ``x[..., :n]`` over the last axis in exactly NumPy's
    pairwise-summation order.

    ``np.sum`` on a contiguous float64 vector is *not* a left fold: it runs
    an 8-accumulator blocked pairwise scheme, so ``torch.sum`` differs from
    it in the last bits for almost any ``n >= 3``.  The tiered-cluster
    combine (``latency._hetero_combine``) sums the per-stage compute vector
    with ``np.sum``, so the batched scorer replays the same association
    order element by element.  Works on NumPy arrays and tensors alike, with
    any leading batch axes (the loop structure is host-side Python over a
    static length).
    """
    def pw(lo, m):
        if m < 8:
            res = 0.0
            for i in range(m):
                res = res + x[..., lo + i]
            return res
        if m <= 128:
            r = [x[..., lo + k] for k in range(8)]
            i = 8
            while i + 8 <= m:
                for k in range(8):
                    r[k] = r[k] + x[..., lo + i + k]
                i += 8
            res = ((r[0] + r[1]) + (r[2] + r[3])) + \
                ((r[4] + r[5]) + (r[6] + r[7]))
            while i < m:
                res = res + x[..., lo + i]
                i += 1
            return res
        m2 = (m // 2) - ((m // 2) % 8)
        return pw(lo, m2) + pw(lo + m2, m - m2)

    return pw(0, n)


def _apply_move(perm: torch.Tensor, pos: torch.Tensor, kind: torch.Tensor,
                pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """One SA move per batch row as an index remap (all three variants are
    computed and ``kind`` selects — cheap O(n) selects, no dynamic shapes).

    ``perm`` is ``(B, n)``, ``pos`` is ``arange(n)``, ``kind``/``pa``/``pb``
    are ``(B,)``.  Semantics (shared with ``annealing._move_numpy``): with
    ``i = min(pa, pb)``, ``j = max(pa, pb)`` — migration (kind 0) removes
    the element at ``i`` and reinserts it at ``j``; swap (kind 1) exchanges
    positions ``i`` and ``j``; reverse (kind 2) reverses the span
    ``[i, j]``.
    """
    i = torch.minimum(pa, pb)[:, None]
    j = torch.maximum(pa, pb)[:, None]
    kind = kind[:, None]
    pos = pos[None, :]
    mig = torch.where((pos >= i) & (pos < j), pos + 1,
                      torch.where(pos == j, i, pos))
    swp = torch.where(pos == i, j, torch.where(pos == j, i, pos))
    rev = torch.where((pos >= i) & (pos <= j), i + j - pos, pos)
    src = torch.where(kind == 0, mig, torch.where(kind == 1, swp, rev))
    return torch.gather(perm, 1, src)


class TorchDedicationEngine:
    """Batched PyTorch scorer + multi-chain SA for one (pp, tp, cp, dp, vpp)
    shape.

    One engine serves every same-shape candidate (microbatch variants):
    the shape-only tensors (pair-bandwidth matrices, ring coefficients,
    device slowdowns) are shared device tensors, while the per-candidate
    profile scalars are gathered per batch row.  ``score()`` is the full
    evaluator (bit-identical to ``DedicationEngine.score``, pinned by the
    equivalence suite); :meth:`anneal` runs the chains-x-candidates loop.

    Args:
        confs: same-shape candidate configurations.
        profs: ``profs[i]`` is the profile of ``confs[i]``; the shape-only
            fields (``tp_ref_bw``/``cp_ref_bw``/``msg_dp``/``stage_work``)
            must agree across candidates (asserted — true of
            ``build_profile`` output for one workload).
        bw: ``(G, G)`` profiled bandwidth matrix.
        spec: cluster description.
        compute_aware: ``False`` prices every GPU at reference speed even
            on tiered specs (the compute-blind ablation), mirroring
            ``DedicationEngine``.
        pairs: optional prebuilt
            :class:`~repro_torch.core.dedication.PairCache` for this
            ``(bw, spec)`` — skips the host-side O(G^2) construction when
            the caller already built one.
        device_pairs: optional ``.device_pairs`` of a sibling engine built
            for the *same* ``(bw, spec, compute_aware, device)`` — shares
            the three (G, G) float64 device tensors across shape groups
            instead of copying them to the device once per group.
        device: where the tensors live; ``None`` is the CUDA device and
            raises without one (see :mod:`repro_torch._device`).
    """

    def __init__(self, confs: Sequence[Conf], profs: Sequence[Profile],
                 bw: np.ndarray, spec: ClusterSpec, *,
                 compute_aware: bool = True,
                 pairs: Optional[PairCache] = None,
                 device_pairs: Optional[dict] = None,
                 device: DeviceLike = None):
        self.device = dev = resolve_device(device)
        conf = confs[0]
        shape = (conf.pp, conf.tp, conf.cp, conf.dp, conf.vpp)
        for c in confs[1:]:
            if (c.pp, c.tp, c.cp, c.dp, c.vpp) != shape:
                raise ValueError(
                    "TorchDedicationEngine needs same-shape confs")
        p0 = profs[0]
        for p in profs[1:]:
            assert (p.tp_ref_bw, p.cp_ref_bw, p.msg_dp, p.stage_work,
                    p.partition, p.chunk_work) == \
                (p0.tp_ref_bw, p0.cp_ref_bw, p0.msg_dp, p0.stage_work,
                 p0.partition, p0.chunk_work), \
                "profiles vary within shape; shared tensors invalid"
        self.confs = list(confs)
        self.pp, self.tp, self.cp, self.dp, self.vpp = shape
        self.n = conf.n_gpus
        self.nc = self.tp * self.cp * self.dp
        self.tpc = self.tp * self.cp
        self._tp_ref = float(p0.tp_ref_bw)
        self._cp_ref = float(p0.cp_ref_bw)

        # host-side constants: the (G, G) pair matrices come from the same
        # PairCache construction the NumPy engine shares (bit-identical by
        # design), the small per-shape tensors are built here
        jlt = (np.arange(self.dp)[None, :] < np.arange(self.dp)[:, None])
        intra_coef = np.array(
            [4 * (c - 1) / c * p0.msg_dp if c else 0.0
             for c in range(self.dp + 1)])
        inter_coef = np.array(
            [2 * (c - 1) / c * p0.msg_dp if c else 0.0
             for c in range(self.dp + 1)])
        slow = compute_slowdowns(spec) if compute_aware else None
        self.tiered = slow is not None
        # Non-uniform partitions / interleaved schedules need the per-stage
        # combination even without device tiers (latency._combine_eq34's
        # trigger, mirrored here so both backends stay bit-identical).
        self.nonuniform = p0.partition is not None or conf.vpp > 1

        # per-candidate profile scalars (gathered per batch row); all
        # arithmetic on host NumPy f64 so the values equal the NumPy
        # engine's
        w = (np.asarray(p0.stage_work) if p0.stage_work is not None
             else np.ones(self.pp))
        c_arr = np.array([p.c_fwd + p.c_bwd for p in profs])
        sc = {
            "c": c_arr,
            "tsum_tp": np.array([p.t_tp_fwd + p.t_tp_bwd for p in profs]),
            "tsum_cp": np.array([p.t_cp_fwd + p.t_cp_bwd for p in profs]),
            "hopf": np.array([2.0 * p.msg_pp for p in profs]),
            "r": np.array([c.n_mb / c.pp for c in confs]),
            "cw": (c_arr[:, None] * w[None, :]
                   if self.tiered or self.nonuniform else None),
        }

        def f64(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float64),
                                   device=dev)

        if device_pairs is None:
            if pairs is None:
                pairs = PairCache.build(bw, spec.gpus_per_node)
            device_pairs = {
                "bw": f64(pairs.bw),
                "bw_noself": f64(pairs.bw_noself),
                "sym_intra": f64(pairs.sym_intra),
                "slow": None if slow is None else f64(slow),
            }
        elif device_pairs["bw"].device != dev:
            raise ValueError("device_pairs live on another device")
        self.device_pairs = device_pairs
        self._env = {
            **device_pairs,
            "jlt": torch.as_tensor(jlt, device=dev),
            "intra_coef": f64(intra_coef),
            "inter_coef": f64(inter_coef),
            "vpp": f64(float(self.vpp)),
        }
        self._sc = {k: (None if v is None else f64(v))
                    for k, v in sc.items()}

    # -- the batched scoring function -------------------------------------

    def _score(self, perm: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
        """Full Eq. 3-6 evaluation of a ``(B, n)`` int64 batch of
        permutations; row ``b`` is priced with the profile scalars of
        candidate ``cand[b]``.  Every reduction mirrors
        ``DedicationEngine`` (see module docstring for why the result is
        bit-identical, not merely close).  Returns ``(B,)`` float64."""
        pp, tp, cp, dp = self.pp, self.tp, self.cp, self.dp
        nc, tpc = self.nc, self.tpc
        env = self._env
        B = perm.shape[0]
        sc = {k: (None if v is None else v[cand])
              for k, v in self._sc.items()}

        # max over the TP (CP) groups of the row of ref_bw / min link,
        # clamped below at 1.0: one launch each on the card
        if tp > 1:
            tp_scale = group_min_scale_gather(env["bw_noself"], perm,
                                              self._tp_ref, *tp_geometry(tp))
        else:
            tp_scale = 1.0

        if cp > 1:
            cp_scale = group_min_scale_gather(env["bw_noself"], perm,
                                              self._cp_ref,
                                              *cp_geometry(tp, cp))
        else:
            cp_scale = 1.0

        if pp > 1:
            src = perm[:, :(pp - 1) * nc].reshape(B, pp - 1, nc)
            dst = perm[:, nc:].reshape(B, pp - 1, nc)
            hop = sc["hopf"][:, None, None] / env["bw"][src, dst]
            t = hop[:, 0]
            for x in range(1, pp - 1):       # reference left-to-right fold
                t = t + hop[:, x]
            t_pp = torch.clamp_min(t.amax(dim=1), 0.0)
        else:
            t_pp = 0.0

        # stage-0 DP hierarchical all-reduce (Eq. 6); the only DP groups on
        # the critical path — mirrors DedicationEngine._dp0_times
        ids = perm[:, :nc].reshape(B, dp, tpc).transpose(1, 2)  # (B,tpc,dp)
        ii, jj = ids[:, :, :, None], ids[:, :, None, :]
        sym = env["sym_intra"][ii, jj]
        member_min = sym.amin(dim=3)
        same = torch.isfinite(sym)
        counts = torch.count_nonzero(same, dim=3) + 1  # integer, exact
        intra = (env["intra_coef"][counts] / member_min).amax(dim=2)
        is_rep = ~(same & env["jlt"]).any(dim=3)
        n_reps = torch.count_nonzero(is_rep, dim=2)  # integer, exact
        pair = is_rep[:, :, :, None] & is_rep[:, :, None, :]
        inf = torch.full((), float("inf"), dtype=torch.float64,
                         device=perm.device)
        rep_min = torch.where(pair, env["bw_noself"][ii, jj],
                              inf).amin(dim=(2, 3))
        inter = env["inter_coef"][n_reps] / rep_min
        t_dp = torch.clamp_min((intra + inter).amax(dim=1), 0.0)

        t_tp = sc["tsum_tp"] * tp_scale
        t_cm = t_tp + sc["tsum_cp"] * cp_scale
        if self.tiered or self.nonuniform:
            if self.tiered:
                # cw * (max member slowdown of each stage) and its row max:
                # one launch on the card
                c_x, c_max = group_max_gather(env["slow"], perm, sc["cw"], nc)
            else:
                # homogeneous fleet, non-uniform stage_work: the NumPy
                # engine's stage scales are all 1.0, and cw * 1.0 == cw
                # exactly, so using cw directly preserves bit parity
                c_x = sc["cw"]
                c_max = c_x.amax(dim=1)
            c_sum = np_pairwise_sum(c_x, pp)
            if self.vpp == 1:
                t_bubble = float(pp) * (c_max + t_cm) + t_pp
                return ((t_bubble * sc["r"] + (c_sum - c_max))
                        + float(pp - 1) * t_cm) + t_dp
            # interleaved-1F1B: mirrors _hetero_combine's vpp branch in
            # NumPy's left-to-right association order
            t_bubble = float(pp) * (c_max + t_cm) + float(self.vpp) * t_pp
            return ((t_bubble * sc["r"] + (c_sum - c_max) / env["vpp"])
                    + float(pp - 1) * t_cm / env["vpp"]) + t_dp
        t_bubble = float(pp) * (sc["c"] + t_cm) + t_pp
        t_straggler = float(pp - 1) * (sc["c"] + t_cm)
        return (t_bubble * sc["r"] + t_straggler) + t_dp

    # -- public scoring (tests / coarse assignment) -----------------------

    def _perms(self, perms) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(perms, np.int64),
                               device=self.device)

    def score(self, perm: np.ndarray, cand: int = 0) -> float:
        """Full evaluation of ``perm`` for candidate ``cand`` — the same
        value as ``DedicationEngine(confs[cand], ...).score(perm)``,
        bitwise.  One host synchronisation (the returned float)."""
        return float(self.score_batch(np.asarray(perm)[None], cand)[0])

    def score_batch(self, perms: np.ndarray, cand: int = 0) -> np.ndarray:
        """Score a ``(R, n)`` batch of permutations in one pass.

        Element ``r`` equals ``score(perms[r], cand)`` bitwise — every
        operation of the score is independent per batch row.
        """
        p = self._perms(perms)
        c = torch.full((p.shape[0],), int(cand), dtype=torch.int64,
                       device=self.device)
        with torch.no_grad():
            return self._score(p, c).cpu().numpy()

    # -- the batched multi-chain annealer ---------------------------------

    @torch.no_grad()
    def anneal(self, init_perms: np.ndarray, pas: np.ndarray,
               pbs: np.ndarray, kinds: np.ndarray, thresh: np.ndarray,
               valid: np.ndarray, probe_pas: np.ndarray,
               probe_pbs: np.ndarray, probe_kinds: np.ndarray, *,
               alpha: float = 0.999):
        """Advance every chain of every candidate, step by step, with no
        host synchronisation until the results are read back.

        Args:
            init_perms: ``(C, n)`` start permutation per candidate.
            pas / pbs: ``(C, K, T)`` absolute move positions (island
                offsets already applied per candidate).
            kinds: ``(K, T)`` move kinds, shared across candidates.
            thresh: ``(K, T)`` precomputed ``-log(u)`` accept thresholds.
            valid: ``(K, T)`` per-chain iteration mask (False iterations
                are no-ops — chains may have unequal budgets).
            probe_pas / probe_pbs: ``(C, K, P)`` temperature-probe moves.
            probe_kinds: ``(K, P)``.
            alpha: geometric temperature decay.

        Returns:
            ``(bests, best_perms, finals, accepted, accepted_to_best)``
            NumPy arrays of shapes ``(C, K)``, ``(C, K, n)``, ``(C, K)``,
            ``(C, K)``, ``(C, K)`` — the last two are each chain's total
            accepted moves and the accepted-move count at which it first
            reached its best (0 = never improved on the init), matching
            :func:`~repro_torch.core.annealing._run_chain_numpy` exactly.
        """
        dev = self.device
        C, n = np.shape(init_perms)
        K, T = np.shape(kinds)
        P = np.shape(probe_kinds)[1]
        B = C * K

        def steps_first(a, per_cand: bool, dtype):
            """``(C, K, S)`` or ``(K, S)`` host schedule -> ``(S, B)``
            device tensor, batch rows candidate-major."""
            a = np.asarray(a)
            if not per_cand:
                a = np.broadcast_to(a[None], (C,) + a.shape)
            a = np.ascontiguousarray(a.reshape(B, -1).T)
            return torch.as_tensor(a, device=dev).to(dtype)

        i64, f64 = torch.int64, torch.float64
        pas_t = steps_first(pas, True, i64)
        pbs_t = steps_first(pbs, True, i64)
        kinds_t = steps_first(kinds, False, i64)
        thr_t = steps_first(thresh, False, f64)
        ok_t = steps_first(valid, False, torch.bool)
        ppas_t = steps_first(probe_pas, True, i64)
        ppbs_t = steps_first(probe_pbs, True, i64)
        pkinds_t = steps_first(probe_kinds, False, i64)

        cand = torch.arange(C, device=dev).repeat_interleave(K)
        init = self._perms(init_perms)[cand]               # (B, n)
        pos = torch.arange(n, device=dev)

        cur0 = self._score(init, cand)
        # temperature probes: max |delta| over P trial moves from the init
        # (max is order-free, so the fold order is immaterial)
        mx = torch.zeros_like(cur0)
        for p in range(P):
            val = self._score(
                _apply_move(init, pos, pkinds_t[p], ppas_t[p], ppbs_t[p]),
                cand)
            mx = torch.maximum(mx, (val - cur0).abs())
        temp = torch.clamp_min(torch.maximum(mx, cur0 * 1e-3), 1e-12)

        perm, cur = init, cur0
        best, bperm = cur0, init
        acc = torch.zeros(B, dtype=i64, device=dev)
        accb = torch.zeros(B, dtype=i64, device=dev)
        for t in range(T):
            ok = ok_t[t]
            new = _apply_move(perm, pos, kinds_t[t], pas_t[t], pbs_t[t])
            val = self._score(new, cand)
            delta = val - cur
            accept = ok & ((delta <= 0) | (delta < temp * thr_t[t]))
            perm = torch.where(accept[:, None], new, perm)
            cur = torch.where(accept, val, cur)
            acc = acc + accept.to(i64)
            imp = accept & (val < best)
            best = torch.where(imp, val, best)
            bperm = torch.where(imp[:, None], new, bperm)
            accb = torch.where(imp, acc, accb)
            temp = torch.where(ok, temp * alpha, temp)

        return (best.reshape(C, K).cpu().numpy(),
                bperm.reshape(C, K, n).cpu().numpy(),
                cur.reshape(C, K).cpu().numpy(),
                acc.reshape(C, K).cpu().numpy(),
                accb.reshape(C, K).cpu().numpy())

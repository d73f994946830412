"""Backend-selectable multi-chain SA core with hierarchical island search.

This is the unified dedication routine behind ``Budget(backend=...)``:
the full move schedule of every chain — move kinds, positions, accept
thresholds, per-chain iteration budgets — is precomputed on the host as a
:class:`MovePlan`, and then *executed* by one of two interchangeable
engines:

* ``backend="numpy"`` — the incremental
  :class:`~repro_torch.core.dedication.DedicationEngine`, one Python loop per
  chain (fast at small fleets, where per-move work is tiny);
* ``backend="torch"`` —
  :class:`~repro_torch.core.torch_engine.TorchDedicationEngine`, a step
  loop batched across chains *and* same-shape candidate configurations on
  the CUDA device (meant for large fleets, where the vectorized full
  re-score amortises and per-move host dispatch would dominate).

Because the RNG stream lives entirely in the MovePlan and both engines
score bit-identically (float64 everywhere, matching reduction order), the
two backends produce **byte-identical plans** chain for chain — pinned by
``tests/test_torch_annealing.py`` and ``tests/test_torch_plan.py``.  ``backend=None`` (the default) is
not handled here at all: ``run_search`` keeps the historical per-candidate
``anneal``/``anneal_multistart`` path, bit-exact with its regression
fixtures.

Scale comes from the *hierarchical* mode layered on top: nodes are
clustered into tier/bandwidth islands (:func:`build_islands`), the
inter-island arrangement is solved coarsely (:func:`coarse_assign` scores
a few whole-island orderings), and the SA chains then refine *within*
islands — every move draws its two positions inside one island, so the
move schedule stays valid under any island ordering and the refined
solution can never be worse than the coarse one (SA tracks
best-so-far starting from the coarse permutation).  A single-island
decomposition degenerates to the flat path bit-exactly: the identity
ordering is the only coarse candidate and the MovePlan draws identical
streams (the island-selection draw is skipped when there is only one).

Budget split across chains (also the :func:`~repro_torch.core.dedication.
anneal_multistart` contract after the fix shipped with this module): with
``base, rem = divmod(sa_iters, n_chains)``, chain ``k`` runs
``base + 1`` iterations if ``k < rem`` else ``base`` — totals are exact,
and chains beyond ``sa_iters`` run zero moves, contributing the initial
permutation's score.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .._device import DeviceLike, resolve_device
from .cluster import ClusterSpec, compute_slowdowns
from .dedication import (DedicationEngine, GroupIndex, PairCache, SAResult,
                         perm_to_mapping)
from .simulator import Conf, Profile

#: ``Budget.hierarchical=None`` resolves to hierarchical search at and
#: above this fleet size (flat SA mixing time degrades far earlier, but
#: below this the flat path is still competitive and simpler to audit).
HIER_AUTO_GPUS = 2048

#: Temperature probes per chain (the initial-temperature estimate of
#: ``dedication.anneal``, kept at the same count).
N_PROBES = 8

#: Island size cap in GPUs: islands are chunks of whole same-tier nodes
#: with at most this many GPUs (capacity re-expressed in nodes, >= 1).
MAX_ISLAND_GPUS = 256

_ALPHA = 0.999


# ---------------------------------------------------------------------------
# host-precomputed move schedule
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MovePlan:
    """The complete, backend-agnostic move schedule of every SA chain.

    All randomness of the unified routine lives here: chain ``k`` draws from
    ``np.random.default_rng(seed * 100003 + k)`` (the historical
    multi-start chain-seed convention) in a fixed order — probe draws
    first, then the iteration draws, each as whole-array calls:
    island (skipped when there is a single island), kind, first position,
    second position, accept uniform.  Positions are *island-relative*
    (``isl``/``oa``/``ob``); the executing backend adds the per-candidate
    island offsets of the coarse arrangement.  Accept thresholds are stored
    as ``-log(u)`` so the device loop needs no transcendentals: the
    Metropolis test ``u < exp(-delta/temp)`` becomes
    ``delta < temp * thresh``.

    Attributes:
        island_sizes: sizes of the islands the plan was drawn for (every
            size >= 2 — a move needs two distinct positions).
        chain_iters: ``(K,)`` per-chain iteration budgets (exact divmod
            split of ``max_iters``; see module docstring).
        kind / isl / oa / ob / thresh: ``(K, T)`` iteration draws, where
            ``T = chain_iters.max()`` — rows are padded, ``valid`` masks
            the pad.
        valid: ``(K, T)`` boolean execution mask.
        probe_kind / probe_isl / probe_oa / probe_ob: ``(K, P)``
            temperature-probe draws.
    """
    island_sizes: Tuple[int, ...]
    chain_iters: np.ndarray
    kind: np.ndarray
    isl: np.ndarray
    oa: np.ndarray
    ob: np.ndarray
    thresh: np.ndarray
    valid: np.ndarray
    probe_kind: np.ndarray
    probe_isl: np.ndarray
    probe_oa: np.ndarray
    probe_ob: np.ndarray

    @property
    def n_chains(self) -> int:
        return len(self.chain_iters)

    @property
    def n_probes(self) -> int:
        return self.probe_kind.shape[1]


def make_move_plan(island_sizes: Sequence[int], max_iters: int,
                   n_chains: int, seed: int,
                   n_probes: int = N_PROBES) -> MovePlan:
    """Draw the full move schedule for ``n_chains`` chains.

    Deterministic in ``seed``; independent of backend, candidate and
    coarse island ordering (positions are island-relative).
    """
    sizes = np.asarray(island_sizes, dtype=np.int64)
    if sizes.size == 0 or (sizes < 2).any():
        raise ValueError("every island needs >= 2 positions to draw moves")
    if n_chains < 1:
        raise ValueError("n_chains must be >= 1")
    base, rem = divmod(max(max_iters, 0), n_chains)
    chain_iters = base + (np.arange(n_chains) < rem).astype(np.int64)
    t_max = int(chain_iters.max())
    multi = sizes.size > 1

    def draw(rng, count):
        isl = (rng.integers(sizes.size, size=count) if multi
               else np.zeros(count, dtype=np.int64))
        kind = rng.integers(3, size=count)
        length = sizes[isl]
        oa = rng.integers(length)
        ob = rng.integers(length - 1)
        ob += (ob >= oa)          # second position distinct from the first
        return isl, kind, oa, ob

    shape_t, shape_p = (n_chains, t_max), (n_chains, n_probes)
    kind = np.zeros(shape_t, np.int64)
    isl = np.zeros(shape_t, np.int64)
    oa = np.zeros(shape_t, np.int64)
    ob = np.ones(shape_t, np.int64)
    thresh = np.zeros(shape_t)
    p_kind = np.zeros(shape_p, np.int64)
    p_isl = np.zeros(shape_p, np.int64)
    p_oa = np.zeros(shape_p, np.int64)
    p_ob = np.ones(shape_p, np.int64)
    for k in range(n_chains):
        rng = np.random.default_rng(seed * 100003 + k)
        p_isl[k], p_kind[k], p_oa[k], p_ob[k] = draw(rng, n_probes)
        isl[k], kind[k], oa[k], ob[k] = draw(rng, t_max)
        with np.errstate(divide="ignore"):
            thresh[k] = -np.log(rng.random(t_max))
    valid = np.arange(t_max)[None, :] < chain_iters[:, None]
    return MovePlan(tuple(int(s) for s in sizes), chain_iters, kind, isl,
                    oa, ob, thresh, valid, p_kind, p_isl, p_oa, p_ob)


# ---------------------------------------------------------------------------
# island decomposition + coarse inter-island assignment
# ---------------------------------------------------------------------------

def build_islands(spec: ClusterSpec, *, hierarchical: bool,
                  max_island_gpus: int = MAX_ISLAND_GPUS) -> List[np.ndarray]:
    """Partition the GPU ids ``0..n-1`` into refinement islands.

    Islands are chunks of whole nodes sharing a device tier (tiers are the
    dominant compute/bandwidth discontinuity of a mixed fleet), capped at
    ``max_island_gpus`` GPUs; islands that end up with fewer than two
    positions are merged into a neighbour.  ``hierarchical=False`` (the
    flat path) returns the single island ``[0..n-1]``.  The islands are
    always an exact *partition* of ``0..n-1`` in whole nodes (sorting the
    concatenation round-trips to ``arange(n)``), but same-tier nodes are
    grouped together, so with interleaved tiers the concatenation order
    differs from id order (pinned by ``tests/test_hierarchical_search``).
    """
    n = spec.n_gpus
    if not hierarchical:
        return [np.arange(n, dtype=np.int64)]
    gpn = spec.gpus_per_node
    tiers = spec.node_tiers if spec.node_tiers else (0,) * spec.n_nodes
    cap = max(1, max_island_gpus // gpn)
    islands: List[np.ndarray] = []
    for t in sorted(set(tiers)):
        nodes = [u for u, tu in enumerate(tiers) if tu == t]
        for s in range(0, len(nodes), cap):
            islands.append(np.concatenate(
                [np.arange(u * gpn, (u + 1) * gpn, dtype=np.int64)
                 for u in nodes[s:s + cap]]))
    merged: List[np.ndarray] = []
    for isl in islands:
        if merged and (len(isl) < 2 or len(merged[-1]) < 2):
            merged[-1] = np.concatenate([merged[-1], isl])
        else:
            merged.append(isl)
    return merged


def coarse_orderings(islands: List[np.ndarray],
                     spec: ClusterSpec) -> List[Tuple[int, ...]]:
    """Candidate whole-island arrangements for the coarse solve.

    Identity, plus the islands sorted by their max member compute slowdown
    ascending and descending (on tiered fleets, putting same-speed islands
    into the same pipeline stages is the dominant coarse decision — the
    per-stage straggler term of Eq. 4).  Deduplicated; identity only for a
    single island.
    """
    k = len(islands)
    if k == 1:
        return [(0,)]
    slow = compute_slowdowns(spec)
    key = ([0.0] * k if slow is None
           else [float(slow[isl].max()) for isl in islands])
    cands = [tuple(range(k)),
             tuple(sorted(range(k), key=lambda i: (key[i], i))),
             tuple(sorted(range(k), key=lambda i: (-key[i], i)))]
    out: List[Tuple[int, ...]] = []
    for o in cands:
        if o not in out:
            out.append(o)
    return out


def coarse_assign(engine, islands: List[np.ndarray],
                  orderings: List[Tuple[int, ...]]):
    """Pick the best whole-island arrangement for one candidate conf.

    Scores each candidate ordering with ``engine.score`` — each backend
    uses its own scorer here (the NumPy engine, or a
    :class:`_TorchCandScorer` wrapping the shared torch engine); the scores
    are bit-identical, so both backends pick identical initial
    permutations — and keeps the strictly-best, first wins on ties.

    Returns:
        ``(init_perm, offsets, value)`` — the coarse permutation, the
        position offset of each island under the chosen ordering
        (``offsets[i] + local`` maps an island-relative draw to an
        absolute position), and the coarse score.
    """
    best = None
    for o in orderings:
        perm = np.concatenate([islands[i] for i in o])
        val = engine.score(perm)
        if best is None or val < best[0]:
            best = (val, perm, o)
    val, perm, order = best
    offsets = np.zeros(len(islands), dtype=np.int64)
    pos = 0
    for i in order:
        offsets[i] = pos
        pos += len(islands[i])
    return perm, offsets, val


# ---------------------------------------------------------------------------
# NumPy execution of a MovePlan
# ---------------------------------------------------------------------------

def _move_numpy(perm: np.ndarray, kind: int, pa: int,
                pb: int) -> Tuple[np.ndarray, np.ndarray]:
    """Apply one scheduled move; returns ``(new_perm, touched)``.

    Shared semantics with ``torch_engine._apply_move`` (see there): with
    ``i = min(pa, pb) < j = max(pa, pb)`` — migration (0) removes the
    element at ``i`` and reinserts it at ``j``, swap (1) exchanges ``i``
    and ``j``, reverse (2) reverses ``[i, j]``.
    """
    i, j = (pa, pb) if pa < pb else (pb, pa)
    p = perm.copy()
    if kind == 0:
        el = p[i]
        p[i:j] = p[i + 1:j + 1].copy()
        p[j] = el
        touched = np.arange(i, j + 1)
    elif kind == 1:
        p[i], p[j] = p[j], p[i]
        touched = np.array((i, j))
    else:
        p[i:j + 1] = p[i:j + 1][::-1]
        touched = np.arange(i, j + 1)
    return p, touched


def _run_chain_numpy(engine: DedicationEngine, init_perm: np.ndarray,
                     offsets: np.ndarray, plan: MovePlan, k: int,
                     alpha: float):
    """Execute chain ``k`` of ``plan`` with the incremental NumPy engine.

    Bit-for-bit the computation ``TorchDedicationEngine.anneal`` performs for
    the same chain: same probes, same ``temp0 = max(max|delta|,
    cur*1e-3, 1e-12)``, same accept rule ``delta <= 0 or
    delta < temp * thresh``, same best-so-far tracking.
    """
    iters_k = int(plan.chain_iters[k])
    perm = init_perm.copy()
    cur = engine.score(perm)
    best, best_perm = cur, perm.copy()
    if iters_k == 0:        # zero-budget chain: init score only
        return best, best_perm, 0, 0, 0
    mx = 0.0
    for p in range(plan.n_probes):
        off = offsets[plan.probe_isl[k, p]]
        cand, touched = _move_numpy(perm, int(plan.probe_kind[k, p]),
                                    int(off + plan.probe_oa[k, p]),
                                    int(off + plan.probe_ob[k, p]))
        val, _ = engine.propose(cand, touched)
        mx = max(mx, abs(val - cur))
    temp = max(mx, cur * 1e-3, 1e-12)
    acc = acc_best = 0
    for t in range(iters_k):
        off = offsets[plan.isl[k, t]]
        cand, touched = _move_numpy(perm, int(plan.kind[k, t]),
                                    int(off + plan.oa[k, t]),
                                    int(off + plan.ob[k, t]))
        val, pending = engine.propose(cand, touched)
        delta = val - cur
        if delta <= 0 or delta < temp * plan.thresh[k, t]:
            perm, cur = cand, val
            engine.commit(pending)
            acc += 1
            if cur < best:
                best, best_perm = cur, perm.copy()
                acc_best = acc
        temp *= alpha
    return best, best_perm, iters_k, acc, acc_best


# ---------------------------------------------------------------------------
# the unified routine
# ---------------------------------------------------------------------------

class _TorchCandScorer:
    """``coarse_assign``-compatible view of one candidate of a
    :class:`~repro_torch.core.torch_engine.TorchDedicationEngine` — lets
    the torch backend solve the coarse arrangement without ever building
    the NumPy engines (whose O(G^2) setup grows with the fleet)."""

    def __init__(self, teng, cand: int):
        self._teng, self._cand = teng, cand

    def score(self, perm: np.ndarray) -> float:
        return self._teng.score(perm, self._cand)


def _abs_positions(plan: MovePlan, offsets: np.ndarray):
    """Island-relative draws -> absolute positions for one candidate's
    coarse island ordering: ``(pas, pbs, probe_pas, probe_pbs)``."""
    pas = offsets[plan.isl] + plan.oa
    pbs = offsets[plan.isl] + plan.ob
    ppas = offsets[plan.probe_isl] + plan.probe_oa
    ppbs = offsets[plan.probe_isl] + plan.probe_ob
    return pas, pbs, ppas, ppbs


def dedicate_candidates(survivors: Sequence[Conf],
                        profiles: Sequence[Profile],
                        sa_idx: Sequence[int], bw: np.ndarray,
                        spec: ClusterSpec, budget, seed: int, *,
                        compute_aware: bool = True,
                        device: DeviceLike = None) -> Dict[int, SAResult]:
    """Stage-5 dedication through the unified backend-selectable core.

    Runs SA dedication for the survivor indices in ``sa_idx`` and returns
    ``{index: SAResult}``.  Candidates are grouped by (pp, tp, cp, dp, vpp)
    shape; the ``"torch"`` backend advances every chain of every candidate
    in a group with one batched step loop on ``device`` (``None`` = the
    CUDA device, an error without one; the ``"numpy"`` backend ignores
    it), the ``"numpy"`` backend loops —
    both execute the identical :class:`MovePlan`, so results are
    byte-identical (see module docstring).

    ``budget.sa_seconds`` is a per-candidate wall-clock guard on the NumPy
    backend (chains still pending when it expires contribute the coarse
    permutation's score, like the historical per-candidate loop); the
    torch backend is iteration-bound only — the step loop never reads the
    clock — so
    byte-parity across backends holds whenever the time guard does not
    bite (use iteration-bound budgets for reproducible plans, as the
    golden tests do).

    ``budget.warm_start`` (a flat GPU permutation, e.g. recovered from a
    cached neighbour Plan via :func:`~repro_torch.core.dedication.
    mapping_to_perm`) seeds every candidate's chains from the incumbent
    arrangement instead of the coarse assignment whenever the incumbent
    scores strictly better — the same comparison on both backends (their
    scorers are bit-identical), so warm-started plans keep byte parity
    too.  SA tracks best-so-far from the chosen init, so a warm-started
    candidate can never score worse than its seed permutation.
    """
    backend = budget.backend
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unified annealing needs backend numpy|torch, "
                         f"got {backend!r}")
    if backend == "torch":
        device = resolve_device(device)
    hier = budget.hierarchical
    if hier is None:
        hier = spec.n_gpus >= HIER_AUTO_GPUS
    islands = build_islands(spec, hierarchical=hier)
    plan = make_move_plan([len(i) for i in islands], budget.sa_iters,
                          budget.n_chains, seed)
    orderings = coarse_orderings(islands, spec)
    warm = getattr(budget, "warm_start", None)
    warm_perm = (None if warm is None
                 else np.asarray(warm, dtype=np.int64))

    def pick_init(scorer, coarse):
        """Coarse assignment vs warm incumbent — strictly-better wins,
        coarse on ties (identical branch on both backends)."""
        init_perm, offsets, cval = coarse
        if warm_perm is not None:
            wval = scorer.score(warm_perm)
            if wval < cval:
                return warm_perm, offsets, wval
        return init_perm, offsets, cval

    # vpp joins the shape key: vpp variants of one (pp, tp, cp, dp) carry
    # different stage_work/partition profiles, which the engines share
    # per group
    groups: Dict[Tuple[int, int, int, int, int], List[int]] = {}
    for i in sa_idx:
        c = survivors[i]
        groups.setdefault((c.pp, c.tp, c.cp, c.dp, c.vpp), []).append(i)

    # The O(G^2) pair matrices depend only on (bw, spec): build them once
    # and share across every engine of every shape group (the torch groups
    # additionally share the big device tensors via ``device_pairs``).
    pairs = PairCache.build(bw, spec.gpus_per_node)
    device_pairs = None

    results: Dict[int, SAResult] = {}
    for shape, idxs in groups.items():
        t0 = time.perf_counter()
        if backend == "torch":
            from .torch_engine import TorchDedicationEngine
            teng = TorchDedicationEngine([survivors[i] for i in idxs],
                                         [profiles[i] for i in idxs], bw,
                                         spec, compute_aware=compute_aware,
                                         pairs=pairs,
                                         device_pairs=device_pairs,
                                         device=device)
            device_pairs = teng.device_pairs
            coarse = {i: pick_init(_TorchCandScorer(teng, ci),
                                   coarse_assign(_TorchCandScorer(teng, ci),
                                                 islands, orderings))
                      for ci, i in enumerate(idxs)}
            init = np.stack([coarse[i][0] for i in idxs])
            abs_pos = [_abs_positions(plan, coarse[i][1]) for i in idxs]
            pas = np.stack([a[0] for a in abs_pos])
            pbs = np.stack([a[1] for a in abs_pos])
            ppas = np.stack([a[2] for a in abs_pos])
            ppbs = np.stack([a[3] for a in abs_pos])
            bests, best_perms, _, accs, accbs = teng.anneal(
                init, pas, pbs, plan.kind, plan.thresh, plan.valid,
                ppas, ppbs, plan.probe_kind, alpha=_ALPHA)
            elapsed = time.perf_counter() - t0
            iters = int(plan.chain_iters.sum())
            for ci, i in enumerate(idxs):
                lats = [float(v) for v in bests[ci]]
                win = int(np.argmin(lats))     # strict <, first occurrence
                results[i] = _to_result(survivors[i], best_perms[ci][win],
                                        lats[win], coarse[i][2], iters,
                                        elapsed / len(idxs), lats,
                                        int(accs[ci].sum()),
                                        int(accbs[ci][win]))
        else:
            gidx = GroupIndex.build(survivors[idxs[0]])
            engines = {i: DedicationEngine(survivors[i], bw, profiles[i],
                                           spec, index=gidx,
                                           compute_aware=compute_aware,
                                           pairs=pairs)
                       for i in idxs}
            coarse = {i: pick_init(engines[i],
                                   coarse_assign(engines[i], islands,
                                                 orderings))
                      for i in idxs}
            for i in idxs:
                tc = time.perf_counter()
                deadline = tc + budget.sa_seconds
                init_perm, offsets, cval = coarse[i]
                lats, perms, iters, accs, accbs = [], [], 0, [], []
                for k in range(plan.n_chains):
                    if time.perf_counter() >= deadline and lats:
                        break                  # out of wall-clock budget
                    b, p, it, ac, ab = _run_chain_numpy(
                        engines[i], init_perm, offsets, plan, k, _ALPHA)
                    lats.append(b)
                    perms.append(p)
                    iters += it
                    accs.append(ac)
                    accbs.append(ab)
                win = int(np.argmin(lats))
                results[i] = _to_result(survivors[i], perms[win],
                                        float(lats[win]), cval, iters,
                                        time.perf_counter() - tc,
                                        [float(v) for v in lats],
                                        sum(accs), accbs[win])  # repro: noqa DET004 -- accepted-move counters are ints; integer addition is order-independent
    return results


def _to_result(conf: Conf, perm: np.ndarray, latency: float, coarse: float,
               iters: int, seconds: float, chain_lats: List[float],
               accepted: int = 0, accepted_to_best: int = 0) -> SAResult:
    perm = np.asarray(perm, dtype=np.int64)
    return SAResult(perm_to_mapping(perm, conf), perm, latency, iters,
                    seconds, trace=[(0, float(coarse)), (iters, latency)],
                    chain_latencies=(chain_lats if len(chain_lats) > 1
                                     else None),
                    accepted=accepted, accepted_to_best=accepted_to_best)

"""Cluster description, heterogeneous bandwidth matrices and profiling.

The paper's key observation (§IV, Fig. 3) is that attained link bandwidth in
real clusters is heterogeneous and drifts over time, even when nominal specs
are identical.  On real hardware ``profile_bandwidth`` would time p2p
transfers (as NCCL-tests / mpiGraph do) — :func:`profile_bandwidth_live`
does that on the visible CUDA devices; without a cluster at hand
we generate *measured-like* matrices whose spread is calibrated to Fig. 3
(≈2-3x between slowest and fastest inter-node pairs, near-symmetric
bidirectional rates, day-to-day drift).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class DeviceTier:
    """One device class in a heterogeneous fleet.

    A tier is an *absolute* description (attainable FLOP/s, memory bytes,
    GEMM efficiency) of one GPU generation / health state — e.g. the A100
    and V100 tiers of a mixed fleet, or the "healthy" and "degraded" tiers
    of a partially-throttled cluster.  Nodes are whole-tier: every GPU on a
    node belongs to the node's tier (mixed fleets are procured per node,
    and a thermally-degraded host throttles all of its GPUs).

    Attributes:
        flops: attainable tensor FLOP/s of one GPU of this tier.
        mem: device memory in bytes.
        efficiency: fraction of ``flops`` reached by real GEMMs.
        name: label for provenance / reports ("a100", "degraded", ...).
    """
    flops: float
    mem: float
    efficiency: float = 0.45
    name: str = ""

    def __post_init__(self):
        if not (self.flops > 0 and self.mem > 0 and 0 < self.efficiency <= 1):
            raise ValueError(
                f"DeviceTier needs flops > 0, mem > 0, 0 < efficiency <= 1; "
                f"got flops={self.flops!r}, mem={self.mem!r}, "
                f"efficiency={self.efficiency!r}")

    @property
    def throughput(self) -> float:
        """Attained GEMM throughput (``flops * efficiency``), FLOP/s."""
        return self.flops * self.efficiency


@dataclass(frozen=True)
class ClusterSpec:
    """Cluster description: sizes, interconnect, and per-GPU compute/memory.

    The scalar ``gpu_flops`` / ``gpu_mem`` / ``efficiency`` fields describe
    a *homogeneous* fleet — and double as the **reference device** (the one
    profiling runs on) when the optional tier table is set.  Heterogeneous
    compute is expressed with ``tiers`` (a table of :class:`DeviceTier`)
    plus ``node_tiers`` (one tier index per node); the seeded generators
    :func:`mixed_fleet_spec` and :func:`degraded_host_spec` build such
    specs with the reference scalars pinned to the fastest tier, so
    per-GPU slowdowns are >= 1.  A spec whose tiers all match the reference
    scalars is *indistinguishable* from a scalar spec everywhere
    (:func:`compute_slowdowns` returns ``None`` and every consumer takes
    the historical bit-exact path).

    All fields are validated on construction — a bad spec fails here with
    a named field, not deep inside the bandwidth generator.
    """
    name: str
    n_nodes: int
    gpus_per_node: int = 8
    intra_bw: float = 300e9          # bytes/s (NVLink)
    inter_bw: float = 12.5e9         # bytes/s (IB EDR 100 Gb/s)
    gpu_flops: float = 112e12        # attainable tensor FLOP/s
    gpu_mem: float = 32e9            # bytes
    efficiency: float = 0.45         # fraction of peak reached by GEMMs
    heterogeneity: float = 0.28      # lognormal sigma of inter-node factors
    slow_frac: float = 0.08          # fraction of node pairs that straggle
    seed: int = 0
    # --- heterogeneous compute (empty = homogeneous, the historical case) ---
    tiers: Tuple[DeviceTier, ...] = ()
    node_tiers: Tuple[int, ...] = ()   # node -> index into ``tiers``

    def __post_init__(self):
        # normalise list inputs so the spec stays hashable
        if not isinstance(self.tiers, tuple):
            object.__setattr__(self, "tiers", tuple(self.tiers))
        if not isinstance(self.node_tiers, tuple):
            object.__setattr__(self, "node_tiers", tuple(self.node_tiers))
        if self.n_nodes < 1:
            raise ValueError(f"n_nodes must be >= 1, got {self.n_nodes}")
        if self.gpus_per_node < 1:
            raise ValueError(
                f"gpus_per_node must be >= 1, got {self.gpus_per_node}")
        for field in ("intra_bw", "inter_bw", "gpu_flops", "gpu_mem"):
            v = getattr(self, field)
            if not v > 0:
                raise ValueError(f"{field} must be > 0, got {v!r}")
        if not 0 < self.efficiency <= 1:
            raise ValueError(
                f"efficiency must be in (0, 1], got {self.efficiency!r}")
        if self.heterogeneity < 0 or not 0 <= self.slow_frac <= 1:
            raise ValueError(
                "heterogeneity must be >= 0 and slow_frac in [0, 1]; got "
                f"heterogeneity={self.heterogeneity!r}, "
                f"slow_frac={self.slow_frac!r}")
        if bool(self.tiers) != bool(self.node_tiers):
            raise ValueError(
                "tiers and node_tiers must be given together (a tier table "
                "without a node assignment, or vice versa, is ambiguous)")
        if self.tiers:
            if len(self.node_tiers) != self.n_nodes:
                raise ValueError(
                    f"node_tiers must assign every node: expected "
                    f"{self.n_nodes} entries, got {len(self.node_tiers)}")
            bad = [t for t in self.node_tiers
                   if not 0 <= int(t) < len(self.tiers)]
            if bad:
                raise ValueError(
                    f"node_tiers out of range [0, {len(self.tiers)}): {bad}")

    @property
    def n_gpus(self) -> int:
        return self.n_nodes * self.gpus_per_node

    def node_of(self, g: int) -> int:
        return g // self.gpus_per_node

    def with_nodes(self, n: int) -> "ClusterSpec":
        """Resize to ``n`` nodes.  A tiered spec keeps its tier *pattern*:
        the node -> tier assignment is truncated when shrinking and cycled
        when growing (so a half-A100/half-V100 fleet stays mixed on both
        the shrink and the grow path — a joined node inherits the tier the
        pattern assigns to its slot)."""
        nt = self.node_tiers
        if self.tiers:
            reps = -(-n // len(nt))
            nt = (nt * reps)[:n]
        return dataclasses.replace(self, n_nodes=n, node_tiers=nt)

    def with_node_subset(self, nodes: Sequence[int]) -> "ClusterSpec":
        """The spec containing exactly ``nodes`` (ids in *this* spec), in
        the given order.

        This is the event-stream mutation behind churn simulation:
        preempting node 3 of 16 keeps nodes ``[0..2, 4..15]`` *with their
        own tiers* — unlike :meth:`with_nodes`, which models a planned
        resize by truncating/extending the tier pattern.  A returning node
        re-enters by reappearing in ``nodes``.

        Args:
            nodes: surviving node ids — non-empty, unique, each in
                ``[0, n_nodes)``.

        Returns:
            A validated spec with ``len(nodes)`` nodes; node ``i`` of the
            result is node ``nodes[i]`` of ``self`` (tier kept).
        """
        nodes = [int(i) for i in nodes]
        if not nodes:
            raise ValueError("with_node_subset needs at least one node")
        bad = [i for i in nodes if not 0 <= i < self.n_nodes]
        if bad:
            raise ValueError(
                f"node ids out of range [0, {self.n_nodes}): {bad}")
        if len(set(nodes)) != len(nodes):
            raise ValueError(f"duplicate node ids: {nodes}")
        nt = self.node_tiers
        if self.tiers:
            nt = tuple(self.node_tiers[i] for i in nodes)
        return dataclasses.replace(self, n_nodes=len(nodes), node_tiers=nt)

    def with_compute_factors(self,
                             factors: Sequence[float]) -> "ClusterSpec":
        """Scale each node's compute by a factor (stragglers / throttling).

        Node ``i``'s attainable FLOP/s is multiplied by ``factors[i]``
        (``1.0`` = healthy; a 0.5 straggler runs at half speed).  The
        result is a tiered spec whose tier table holds one entry per
        distinct (base tier, factor) pair — the reference scalars are
        untouched, so per-GPU slowdowns stay >= 1 for factors <= 1.  All
        factors exactly 1.0 return ``self`` unchanged (the bit-exact
        scalar path for compute-uniform fleets).
        """
        factors = [float(f) for f in factors]
        if len(factors) != self.n_nodes:
            raise ValueError(
                f"need one factor per node: expected {self.n_nodes}, "
                f"got {len(factors)}")
        if any(not f > 0 for f in factors):
            raise ValueError(f"factors must be > 0, got {factors}")
        if all(f == 1.0 for f in factors):  # repro: noqa DET005 -- 1.0 is the exact "healthy, untouched" sentinel callers pass literally; only that exact value may take the unchanged-spec path
            return self
        table: list = []
        index: dict = {}
        node_tiers = []
        for i, f in enumerate(factors):
            base = self.tiers[self.node_tiers[i]] if self.tiers else \
                DeviceTier(self.gpu_flops, self.gpu_mem, self.efficiency,
                           name="base")
            key = (base.flops, base.mem, base.efficiency, base.name, f)
            t = index.get(key)
            if t is None:
                t = index[key] = len(table)
                healthy = f == 1.0  # repro: noqa DET005 -- 1.0 is the exact healthy sentinel (see above); factor-1 nodes keep the base tier name
                name = base.name if healthy else \
                    f"{base.name or 'base'}*{f:g}"
                table.append(DeviceTier(base.flops * f, base.mem,
                                        base.efficiency, name=name))
            node_tiers.append(t)
        return dataclasses.replace(self, tiers=tuple(table),
                                   node_tiers=tuple(node_tiers))

    def node_gpus(self, node: int) -> Tuple[int, ...]:
        """The flat GPU ids hosted on ``node``."""
        lo = node * self.gpus_per_node
        return tuple(range(lo, lo + self.gpus_per_node))

    # -- per-GPU device views (scalar-backed when no tiers are set) --------

    @property
    def has_tiers(self) -> bool:
        return bool(self.tiers)

    def tier_of(self, g: int) -> DeviceTier:
        """The :class:`DeviceTier` of GPU ``g`` (a scalar-backed pseudo-tier
        for homogeneous specs)."""
        if not self.tiers:
            return DeviceTier(self.gpu_flops, self.gpu_mem, self.efficiency)
        return self.tiers[self.node_tiers[self.node_of(g)]]

    def _per_gpu(self, values: Sequence[float], scalar: float) -> np.ndarray:
        if not self.tiers:
            return np.full(self.n_gpus, scalar)
        per_node = np.asarray(values)[np.asarray(self.node_tiers, np.intp)]
        return np.repeat(per_node, self.gpus_per_node)

    def per_gpu_flops(self) -> np.ndarray:
        """``(n_gpus,)`` attainable FLOP/s per GPU."""
        return self._per_gpu([t.flops for t in self.tiers], self.gpu_flops)

    def per_gpu_mem(self) -> np.ndarray:
        """``(n_gpus,)`` device-memory bytes per GPU."""
        return self._per_gpu([t.mem for t in self.tiers], self.gpu_mem)

    def per_gpu_throughput(self) -> np.ndarray:
        """``(n_gpus,)`` attained GEMM FLOP/s (``flops * efficiency``)."""
        return self._per_gpu([t.throughput for t in self.tiers],
                             self.gpu_flops * self.efficiency)

    @property
    def mem_floor(self) -> float:
        """The tightest per-GPU memory capacity — what a single cluster-wide
        memory budget must respect when every GPU hosts a worker.  Exactly
        ``gpu_mem`` for homogeneous specs."""
        if not self.tiers:
            return self.gpu_mem
        return min(self.tiers[t].mem for t in set(self.node_tiers))


def compute_slowdowns(spec: ClusterSpec) -> Optional[np.ndarray]:
    """Per-GPU compute slowdown vs the spec's reference device, or ``None``.

    The reference is the scalar ``gpu_flops * efficiency`` the profiles are
    priced at; GPU ``g``'s slowdown is ``reference / throughput_g`` (> 1 for
    slower tiers).  Returns ``None`` — the signal every consumer uses to
    take the historical scalar path, bit-for-bit — when the spec has no
    tier table *or* when every tier matches the reference exactly (a
    single-tier spec built from the scalars degenerates here by design).
    """
    if not spec.tiers:
        return None
    slow = (spec.gpu_flops * spec.efficiency) / spec.per_gpu_throughput()
    if np.all(slow == 1.0):  # repro: noqa DET005 -- designed degeneration test: a tier built from the reference scalars divides to exactly 1.0, and only that exact case may take the scalar path
        return None
    return slow


def tier_table_fingerprint(tiers, node_tiers) -> str:
    """SHA-256 of a raw tier table + node assignment.

    One hash recipe shared by :func:`tier_fingerprint` (live specs) and
    the static plan verifier (serialized provenance) — each entry is a
    ``(flops, mem, efficiency, name)`` tuple, hashed in table order,
    followed by the node -> tier index tuple."""
    h = hashlib.sha256()
    for flops, mem, efficiency, name in tiers:
        h.update(repr((flops, mem, efficiency, name)).encode())
    h.update(repr(tuple(int(t) for t in node_tiers)).encode())
    return h.hexdigest()


def tier_fingerprint(spec: ClusterSpec) -> Optional[str]:
    """SHA-256 digest of the tier table + node assignment (``None`` for
    homogeneous specs).  Recorded in Plan provenance so a plan can be
    matched against the fleet composition it was computed for."""
    if not spec.tiers:
        return None
    return tier_table_fingerprint(
        [(t.flops, t.mem, t.efficiency, t.name) for t in spec.tiers],
        spec.node_tiers)


def mixed_fleet_spec(name: str, n_nodes: int,
                     tiers: Sequence[DeviceTier],
                     fractions: Optional[Sequence[float]] = None, *,
                     gpus_per_node: int = 8, intra_bw: float = 300e9,
                     inter_bw: float = 12.5e9, heterogeneity: float = 0.28,
                     slow_frac: float = 0.08, seed: int = 0) -> ClusterSpec:
    """Seeded mixed-generation fleet: nodes drawn from ``tiers``.

    Node counts follow ``fractions`` (equal split by default, remainders to
    the leading tiers) and the assignment order is a seeded permutation —
    mixed fleets rarely rack their generations contiguously.  The reference
    scalars (``gpu_flops``/``gpu_mem``/``efficiency``) are pinned to the
    highest-throughput tier, so every per-GPU slowdown is >= 1.

    Args:
        name: spec name.
        n_nodes: fleet size in nodes.
        tiers: device classes present in the fleet.
        fractions: fraction of nodes per tier (normalised; default equal).
        gpus_per_node / intra_bw / inter_bw / heterogeneity / slow_frac /
            seed: as on :class:`ClusterSpec` (``seed`` also drives the
            node-assignment shuffle).

    Returns:
        A validated heterogeneous :class:`ClusterSpec`.
    """
    tiers = tuple(tiers)
    if not tiers:
        raise ValueError("mixed_fleet_spec needs at least one tier")
    if fractions is None:
        fractions = [1.0 / len(tiers)] * len(tiers)
    if len(fractions) != len(tiers) or any(f < 0 for f in fractions):
        raise ValueError("fractions must be non-negative, one per tier")
    # fsum: the normalizer must not depend on the order the caller lists
    # tiers in (a left-fold sum would round differently per permutation)
    total = math.fsum(fractions)
    if total <= 0:
        raise ValueError("fractions must sum to a positive value")
    counts = [int(f / total * n_nodes) for f in fractions]
    # remainder nodes go to the leading tiers the caller actually asked
    # for — a tier with fraction 0.0 must stay absent from the fleet
    present = [i for i, f in enumerate(fractions) if f > 0]
    for k in range(n_nodes - sum(counts)):  # repro: noqa DET004 -- counts are ints; integer sum is exact in any order
        counts[present[k % len(present)]] += 1
    assignment = np.repeat(np.arange(len(tiers)), counts)
    rng = np.random.default_rng(seed * 999983 + 7)
    rng.shuffle(assignment)
    ref = max(tiers, key=lambda t: t.throughput)
    return ClusterSpec(name, n_nodes, gpus_per_node=gpus_per_node,
                       intra_bw=intra_bw, inter_bw=inter_bw,
                       gpu_flops=ref.flops, gpu_mem=ref.mem,
                       efficiency=ref.efficiency,
                       heterogeneity=heterogeneity, slow_frac=slow_frac,
                       seed=seed, tiers=tiers,
                       node_tiers=tuple(int(t) for t in assignment))


def degraded_host_spec(base: ClusterSpec, *, degraded_frac: float = 0.25,
                       flops_factor: float = 0.5, mem_factor: float = 1.0,
                       seed: int = 0) -> ClusterSpec:
    """Seeded partially-degraded fleet: ``base`` with a fraction of its
    hosts throttled (thermal issues, a dying HBM stack, MIG leftovers).

    Tier 0 is the healthy base device; tier 1 scales its flops by
    ``flops_factor`` and its memory by ``mem_factor``.  The degraded node
    set is a seeded choice, at least one node when ``degraded_frac > 0``.

    Args:
        base: homogeneous spec to degrade (must not already carry tiers).
        degraded_frac: fraction of nodes to throttle.
        flops_factor / mem_factor: multipliers applied to the degraded tier.
        seed: drives the degraded-node choice.

    Returns:
        A heterogeneous :class:`ClusterSpec` named ``<base.name>-degraded``.
    """
    if base.tiers:
        raise ValueError("degraded_host_spec expects a homogeneous base")
    if not 0 < degraded_frac <= 1:
        raise ValueError(f"degraded_frac must be in (0, 1], got "
                         f"{degraded_frac!r}")
    healthy = DeviceTier(base.gpu_flops, base.gpu_mem, base.efficiency,
                         name="healthy")
    degraded = DeviceTier(base.gpu_flops * flops_factor,
                          base.gpu_mem * mem_factor, base.efficiency,
                          name="degraded")
    n_deg = max(1, int(round(degraded_frac * base.n_nodes)))
    rng = np.random.default_rng(seed * 424243 + 1)
    deg_nodes = set(int(i) for i in
                    rng.choice(base.n_nodes, size=n_deg, replace=False))
    node_tiers = tuple(1 if i in deg_nodes else 0
                       for i in range(base.n_nodes))
    return dataclasses.replace(base, name=f"{base.name}-degraded",
                               tiers=(healthy, degraded),
                               node_tiers=node_tiers)


# The paper's two evaluation environments (Table I).
MID_RANGE = ClusterSpec("mid-range", n_nodes=16, intra_bw=300e9,
                        inter_bw=12.5e9, gpu_flops=112e12, gpu_mem=32e9,
                        seed=11)
HIGH_END = ClusterSpec("high-end", n_nodes=16, intra_bw=600e9,
                       inter_bw=25e9, gpu_flops=280e12, gpu_mem=80e9,
                       seed=23)

# TPU-pod flavoured cluster: "nodes" are ICI neighbourhoods, the inter-node
# tier is the slower multi-hop/DCN path (DESIGN.md §2 hardware adaptation).
TPU_POD = ClusterSpec("tpu-v5e-pod", n_nodes=16, gpus_per_node=16,
                      intra_bw=50e9, inter_bw=25e9, gpu_flops=197e12,
                      gpu_mem=16e9, efficiency=0.55, seed=31)

# Device tiers of the mixed-fleet presets: the A100 tier matches HIGH_END's
# per-GPU numbers, the V100 tier MID_RANGE's — so the mixed fleet sits
# exactly between the paper's two evaluation environments.
A100_TIER = DeviceTier(flops=280e12, mem=80e9, efficiency=0.45, name="a100")
V100_TIER = DeviceTier(flops=112e12, mem=32e9, efficiency=0.45, name="v100")

# 16-node mixed-generation fleet, half A100 / half V100 nodes in a seeded
# shuffle — the headline heterogeneous-compute scenario (compute-aware
# dedication must beat compute-blind assignment here, see
# tests/test_hetero_dedication.py and benchmarks/bench_configure.py).
MIXED_A100_V100 = mixed_fleet_spec("mixed-a100-v100", 16,
                                   (A100_TIER, V100_TIER), (0.5, 0.5),
                                   intra_bw=300e9, inter_bw=12.5e9, seed=47)

# MID_RANGE with a quarter of its hosts thermally throttled to half speed —
# the degraded-host preset (examples/configure_cluster.py demos it).
MID_RANGE_DEGRADED = degraded_host_spec(MID_RANGE, degraded_frac=0.25,
                                        flops_factor=0.5, seed=53)


def true_bandwidth_matrix(spec: ClusterSpec, day: int = 0) -> np.ndarray:
    """Ground-truth attained bandwidth (bytes/s) between every GPU pair.

    Inter-node factors are near-symmetric lognormals with a straggler tail;
    intra-node links jitter mildly.  ``day`` shifts the realisation to model
    the temporal drift of Fig. 3.

    Args:
        spec: cluster description (sizes, nominal bandwidths, heterogeneity).
        day: realisation index modelling day-to-day drift.

    Returns:
        ``(n_gpus, n_gpus)`` bytes/s matrix; the diagonal (self-transfer) is
        effectively free.
    """
    rng = np.random.default_rng(spec.seed * 1000003 + day)
    g = spec.n_gpus
    nn = spec.n_nodes
    # per-node-pair factor
    f = np.exp(rng.normal(0.0, spec.heterogeneity, (nn, nn)))
    f = np.clip(f, 0.35, 1.15)
    slow = rng.random((nn, nn)) < spec.slow_frac
    f = np.where(slow, f * 0.5, f)
    f = np.minimum(f, f.T * rng.uniform(0.96, 1.04, (nn, nn)))  # ~symmetric
    np.fill_diagonal(f, 1.0)

    bw = np.empty((g, g))
    node = np.arange(g) // spec.gpus_per_node
    same = node[:, None] == node[None, :]
    intra_jit = rng.uniform(0.92, 1.0, (g, g))
    bw = np.where(same, spec.intra_bw * intra_jit,
                  spec.inter_bw * f[node[:, None], node[None, :]])
    np.fill_diagonal(bw, spec.intra_bw * 4)     # self: effectively free
    return bw


def profile_bandwidth(spec: ClusterSpec, day: int = 0,
                      noise: float = 0.01) -> tuple[np.ndarray, float]:
    """'network_profile()' of Algorithm 1 line 1.

    Args:
        spec: cluster description.
        day: realisation index (see :func:`true_bandwidth_matrix`).
        noise: relative measurement noise (~1% default).

    Returns:
        ``(measured_matrix, profiling_wall_seconds)``.  The cost model is
        calibrated to the paper's Table II (58 s @ 8 nodes, 239 s @ 16
        nodes — all-pairs mpiGraph grows with n_nodes^2).
    """
    rng = np.random.default_rng(spec.seed * 7919 + day + 1)
    truth = true_bandwidth_matrix(spec, day)
    measured = truth * rng.normal(1.0, noise, truth.shape)
    cost_s = 0.934 * spec.n_nodes ** 2
    return measured, cost_s


def profile_bandwidth_live(devices=None,
                           msg_bytes: int = 1 << 20) -> np.ndarray:
    """Time device-to-device copies of ``msg_bytes`` between ``devices``.

    Args:
        devices: ``torch.device`` values or strings; ``None`` means every
            visible CUDA device and raises when there is none.  The CPU
            is profiled only when named (``["cpu"]`` gives the 1x1
            ``inf`` matrix).
        msg_bytes: bytes of each copy.

    Returns:
        ``(n, n)`` bytes/s matrix, ``bw[i, j]`` the rate of a copy from
        device ``i`` to device ``j``, ``inf`` on the diagonal.  A copy
        from a CUDA device is timed with CUDA events on that device,
        after one untimed copy (peer setup); from the host, by the
        monotonic clock.
    """
    import time

    import torch

    from .._device import resolve_device

    if devices is None:
        resolve_device(None)                 # raises without a CUDA device
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    n = len(devs)
    bw = np.zeros((n, n))
    for i, di in enumerate(devs):
        xi = torch.ones(msg_bytes // 4, dtype=torch.float32, device=di)
        for j, dj in enumerate(devs):
            if i == j:
                bw[i, j] = float("inf")
                continue
            if di.type == "cuda":
                with torch.cuda.device(di):
                    xi.to(dj)                           # untimed: peer setup
                    torch.cuda.synchronize(di)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    xi.to(dj, non_blocking=True)
                    end.record()
                    end.synchronize()
                    dt = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                y = xi.to(dj)
                if dj.type == "cuda":
                    torch.cuda.synchronize(dj)
                del y
                dt = time.perf_counter() - t0
            bw[i, j] = msg_bytes / max(dt, 1e-9)
    return bw


def ring_allreduce_time(msg_bytes: float, group_bw: float, n: int,
                        phases: int = 2) -> float:
    """Thakur et al. ring all-reduce: phases * (n-1)/n * msg / bw.

    Args:
        msg_bytes: bytes contributed by each rank.
        group_bw: bottleneck link bandwidth of the ring, bytes/s.  Must be
            finite and positive for real rings (``n > 1``): the ``inf``
            that :func:`min_group_bw` returns for singleton groups would
            otherwise silently price a 0-second collective for a ring that
            supposedly spans multiple GPUs.
        n: ring size.  ``n == 1`` (and 0) is an explicit early-out: a
            single rank performs no communication, so the result is exactly
            0.0 *before* ``group_bw`` is touched — pairing this with a
            singleton :func:`min_group_bw` (``inf``) is therefore safe.
        phases: 2 for reduce-scatter + all-gather over one message pass,
            4 for the hierarchical intra-node stage.

    Returns:
        Seconds for the collective.

    Raises:
        ValueError: ``n > 1`` with a non-finite or non-positive
            ``group_bw`` (a singleton-group bandwidth leaking into a real
            ring).
    """
    if n <= 1:
        return 0.0
    if not np.isfinite(group_bw) or group_bw <= 0:
        raise ValueError(
            f"ring of {n} ranks needs a finite positive bottleneck "
            f"bandwidth, got {group_bw!r} (singleton-group inf leaking in?)")
    return phases * (n - 1) / n * msg_bytes / group_bw


def min_group_bw(bw: np.ndarray, gpus) -> float:
    """Slowest pairwise link inside a communicator group (Eq. 6 denominator).

    Args:
        bw: ``(G, G)`` bandwidth matrix in bytes/s.
        gpus: iterable of GPU indices forming the group.

    Returns:
        Minimum off-diagonal entry of the group's bandwidth submatrix
        (both directions considered); ``inf`` for groups of size <= 1 — a
        singleton has no links, and ``inf`` makes downstream guards
        explicit.  Callers must special-case that ``inf``: the latency
        scalers (``_tp_scale``/``_cp_scale``) treat non-finite group
        bandwidth as scale 1.0, and :func:`ring_allreduce_time` never sees
        it because its ``n <= 1`` early-out fires first (it raises if a
        non-finite bandwidth reaches a real ring).
    """
    gpus = list(gpus)
    if len(gpus) <= 1:
        return float("inf")
    sub = bw[np.ix_(gpus, gpus)].copy()
    np.fill_diagonal(sub, np.inf)
    return float(sub.min())


def min_group_bw_batch(bw: np.ndarray, groups: np.ndarray) -> np.ndarray:
    """Batched :func:`min_group_bw`: slowest intra-group link per group.

    Args:
        bw: ``(G, G)`` bandwidth matrix in bytes/s.
        groups: ``(n_groups, m)`` integer array of GPU ids, one group per row.

    Returns:
        ``(n_groups,)`` array of the minimum off-diagonal submatrix entry per
        group (``inf`` when ``m <= 1``).  Bit-identical to calling
        :func:`min_group_bw` row by row.
    """
    ids = np.asarray(groups, dtype=np.intp)
    n_groups, m = ids.shape
    if m <= 1:
        return np.full(n_groups, np.inf)
    sub = bw[ids[:, :, None], ids[:, None, :]]
    eye = np.eye(m, dtype=bool)
    return np.where(eye[None, :, :], np.inf, sub).min(axis=(1, 2))

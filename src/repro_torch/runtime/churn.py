"""Trace-driven churn simulation: continuous replanning on a moving fleet.

Real clusters are not static: spot preemptions, node returns, degraded
links and straggling hosts arrive as a *stream*, and a configurator for
real-world clusters (the paper's premise) must be judged on how much
training it sustains across that stream — not on single-step latency at
one fleet snapshot.  This module provides the three pieces:

1. a **seeded, replayable trace**: :func:`generate_trace` draws
   preempt / return / degrade-link / straggler events from independent
   exponential arrival processes (in the style of the seeded
   ``degraded_host_spec`` fleet generators) into a :class:`ChurnTrace`
   whose canonical JSON round-trips byte-identically — the same seed is
   the same trace, forever;
2. a **fleet state machine**: :class:`FleetState` folds events into the
   effective cluster — surviving nodes keep their device tiers
   (:meth:`~repro_torch.core.cluster.ClusterSpec.with_node_subset`), stragglers
   become compute tiers (:meth:`~repro_torch.core.cluster.ClusterSpec.
   with_compute_factors`), degraded links scale the ground-truth
   bandwidth submatrix.  Nodes are ordered by *join time* (survivors
   first, returners appended), so an incumbent plan's GPU permutation
   projects onto the new fleet as a prefix — exactly the
   ``Budget.warm_start`` convention :func:`~repro_torch.core.dedication.
   project_perm` implements;
3. a **replay scorer**: :func:`simulate_churn` replays a trace against a
   replanning policy (warm incremental vs from-scratch), measuring each
   segment's step time with the event-driven cluster simulator and
   charging each replan its migration downtime — the score is the
   **throughput integral** (samples processed over the whole trace).
   Reshard accounting is double-entry: the per-transition
   :class:`~repro_torch.core.migration.PlanDiff` and an independent
   :class:`ResidentState` ledger (per-GPU resident shard identities keyed
   by *base* fleet ids, carried across the whole trace) must agree.

CLI (every replan on the CUDA device; ``--device cpu`` runs them on the
host)::

    python -m repro_torch.runtime.churn --nodes 16 --seed 0 --horizon 1800
    python -m repro_torch.runtime.churn --trace trace.json --policies warm,cold
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .._device import DeviceLike, resolve_device
from ..core.cluster import ClusterSpec, MID_RANGE, true_bandwidth_matrix
from ..core.memory import rank_state_bytes
from ..core.migration import diff_assignments, state_keys
from ..core.plan import Plan
from ..core.search import Candidate
from ..core.simulator import (ProfileCache, Workload, mapping4,
                              simulate_iteration)
from .elastic import replan_on

EVENT_KINDS = ("preempt", "return", "degrade_link", "straggler")


# ---------------------------------------------------------------------------
# the event stream
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ChurnEvent:
    """One fleet event.

    Attributes:
        t: event time, seconds from trace start.
        kind: one of :data:`EVENT_KINDS`.  ``preempt`` takes ``node``
            down; ``return`` brings it back (state lost — a returning
            spot instance re-fetches its shard); ``degrade_link`` scales
            the ``node``/``peer`` inter-node links by ``factor``
            (``1.0`` restores); ``straggler`` scales ``node``'s compute
            by ``factor`` (``1.0`` recovers).
        node: the subject node id in the *base* fleet.
        peer: the other endpoint for ``degrade_link`` (else ``-1``).
        factor: link/compute multiplier (unused for preempt/return).
    """
    t: float
    kind: str
    node: int
    peer: int = -1
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(
                f"kind must be one of {EVENT_KINDS}, got {self.kind!r}")
        # normalize numeric types so to_json() is canonical regardless of
        # whether callers passed ints or floats
        object.__setattr__(self, "t", float(self.t))
        object.__setattr__(self, "node", int(self.node))
        object.__setattr__(self, "peer", int(self.peer))
        object.__setattr__(self, "factor", float(self.factor))

    def to_json_dict(self) -> dict:
        return {"t": self.t, "kind": self.kind, "node": self.node,
                "peer": self.peer, "factor": self.factor}

    @classmethod
    def from_json_dict(cls, d: dict) -> "ChurnEvent":
        return cls(t=float(d["t"]), kind=d["kind"], node=int(d["node"]),
                   peer=int(d.get("peer", -1)),
                   factor=float(d.get("factor", 1.0)))


@dataclass(frozen=True)
class ChurnTrace:
    """A replayable event stream over a fixed base fleet.

    ``to_json`` is canonical (sorted keys, fixed separators, trailing
    newline): the same generator seed produces byte-identical text, and
    ``from_json(to_json(x)) == x`` exactly — the determinism contract
    tests pin.
    """
    n_nodes: int
    horizon_s: float
    seed: int
    min_nodes: int
    events: Tuple[ChurnEvent, ...]

    def __post_init__(self):
        object.__setattr__(self, "n_nodes", int(self.n_nodes))
        object.__setattr__(self, "horizon_s", float(self.horizon_s))
        object.__setattr__(self, "seed", int(self.seed))
        object.__setattr__(self, "min_nodes", int(self.min_nodes))
        object.__setattr__(self, "events", tuple(self.events))

    def to_json_dict(self) -> dict:
        return {"n_nodes": self.n_nodes, "horizon_s": self.horizon_s,
                "seed": self.seed, "min_nodes": self.min_nodes,
                "events": [e.to_json_dict() for e in self.events]}

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), sort_keys=True, indent=2,
                          allow_nan=False) + "\n"

    @classmethod
    def from_json_dict(cls, d: dict) -> "ChurnTrace":
        return cls(n_nodes=int(d["n_nodes"]),
                   horizon_s=float(d["horizon_s"]), seed=int(d["seed"]),
                   min_nodes=int(d["min_nodes"]),
                   events=tuple(ChurnEvent.from_json_dict(e)
                                for e in d["events"]))

    def save(self, path) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return str(path)

    @classmethod
    def load(cls, path) -> "ChurnTrace":
        with open(path) as f:
            return cls.from_json_dict(json.load(f))


def generate_trace(spec: ClusterSpec, *, horizon_s: float = 3600.0,
                   seed: int = 0, min_nodes: int = 2,
                   preempt_interval_s: float = 900.0,
                   outage_s: float = 400.0,
                   degrade_interval_s: float = 1200.0,
                   degrade_duration_s: float = 500.0,
                   straggler_interval_s: float = 1200.0,
                   straggler_duration_s: float = 500.0) -> ChurnTrace:
    """Draw a seeded event stream for ``spec``'s fleet.

    Four independent arrival processes with exponential inter-arrival
    times: preemptions (each schedules the node's return after an
    ``outage_s``-scaled stay-down), link degradations and stragglers
    (each schedules its own recovery).  Preemptions respect
    ``min_nodes``: a draw that would take the up-count to the floor is
    dropped, not resampled — so the event count stays a pure function of
    the seed.  Events are sorted by ``(t, kind, node, peer)``; the whole
    trace is a deterministic function of ``(spec.n_nodes, seed,
    rates)``.
    """
    if spec.n_nodes <= min_nodes:
        raise ValueError(
            f"fleet of {spec.n_nodes} nodes cannot churn above a "
            f"min_nodes={min_nodes} floor")
    rng = np.random.default_rng(seed)
    events: List[ChurnEvent] = []

    # preempt/return pairs (spot reclaims)
    down_until: Dict[int, float] = {}
    t = float(rng.exponential(preempt_interval_s))
    while t < horizon_s:
        up = [n for n in range(spec.n_nodes) if down_until.get(n, -1.0) < t]
        if len(up) > min_nodes:
            node = int(up[int(rng.integers(len(up)))])
            stay_down = float(outage_s * (0.5 + rng.random()))
            events.append(ChurnEvent(t, "preempt", node))
            if t + stay_down < horizon_s:
                events.append(ChurnEvent(t + stay_down, "return", node))
            down_until[node] = t + stay_down
        t += float(rng.exponential(preempt_interval_s))

    # link degradations (with recovery)
    t = float(rng.exponential(degrade_interval_s))
    while t < horizon_s:
        a = int(rng.integers(spec.n_nodes))
        b = int(rng.integers(spec.n_nodes - 1))
        b = b if b < a else b + 1
        factor = float(0.3 + 0.5 * rng.random())
        events.append(ChurnEvent(t, "degrade_link", a, peer=b,
                                 factor=factor))
        recover = t + float(degrade_duration_s * (0.5 + rng.random()))
        if recover < horizon_s:
            events.append(ChurnEvent(recover, "degrade_link", a, peer=b,
                                     factor=1.0))
        t += float(rng.exponential(degrade_interval_s))

    # stragglers (with recovery)
    t = float(rng.exponential(straggler_interval_s))
    while t < horizon_s:
        node = int(rng.integers(spec.n_nodes))
        factor = float(0.4 + 0.5 * rng.random())
        events.append(ChurnEvent(t, "straggler", node, factor=factor))
        recover = t + float(straggler_duration_s * (0.5 + rng.random()))
        if recover < horizon_s:
            events.append(ChurnEvent(recover, "straggler", node,
                                     factor=1.0))
        t += float(rng.exponential(straggler_interval_s))

    events.sort(key=lambda e: (e.t, e.kind, e.node, e.peer))
    return ChurnTrace(n_nodes=spec.n_nodes, horizon_s=horizon_s, seed=seed,
                      min_nodes=min_nodes, events=tuple(events))


# ---------------------------------------------------------------------------
# fleet state
# ---------------------------------------------------------------------------

class FleetState:
    """Folds a trace prefix into the effective cluster.

    Nodes are kept in *join order*: the initial fleet ``[0..n)``, minus
    preempted nodes, with returners appended at the tail.  That ordering
    is what makes incumbent warm-starts a prefix projection — a surviving
    GPU's position in the new fleet preserves its relative order in the
    old one, and every new GPU sits after all survivors.
    """

    def __init__(self, spec: ClusterSpec):
        self.spec = spec
        self.nodes: List[int] = list(range(spec.n_nodes))
        self.link_factors: Dict[Tuple[int, int], float] = {}
        self.compute: Dict[int, float] = {
            n: 1.0 for n in range(spec.n_nodes)}

    def apply(self, ev: ChurnEvent) -> None:
        if ev.kind == "preempt":
            if ev.node in self.nodes:
                self.nodes.remove(ev.node)
        elif ev.kind == "return":
            if ev.node not in self.nodes:
                self.nodes.append(ev.node)
        elif ev.kind == "degrade_link":
            pair = (min(ev.node, ev.peer), max(ev.node, ev.peer))
            if ev.factor >= 1.0:
                self.link_factors.pop(pair, None)
            else:
                self.link_factors[pair] = ev.factor
        elif ev.kind == "straggler":
            self.compute[ev.node] = ev.factor
        else:  # pragma: no cover - ChurnEvent validates kinds
            raise ValueError(f"unknown event kind {ev.kind!r}")

    def gpu_ids(self) -> List[int]:
        """Base-fleet GPU ids of the current fleet, in node-join order —
        index ``i`` is effective GPU ``i``'s identity in the base fleet."""
        return [g for n in self.nodes for g in self.spec.node_gpus(n)]

    def effective_spec(self) -> ClusterSpec:
        s = self.spec.with_node_subset(self.nodes)
        return s.with_compute_factors(
            [self.compute[n] for n in self.nodes])

    def effective_bw(self, bw_true: np.ndarray) -> np.ndarray:
        """The ground-truth bandwidth submatrix of the current fleet,
        with degraded inter-node links scaled down."""
        gpus = np.asarray(self.gpu_ids())
        sub = bw_true[np.ix_(gpus, gpus)].copy()
        pos = {n: i for i, n in enumerate(self.nodes)}
        gpn = self.spec.gpus_per_node
        for (a, b), f in sorted(self.link_factors.items()):
            if a not in pos or b not in pos:
                continue
            ia = np.arange(pos[a] * gpn, (pos[a] + 1) * gpn)
            ib = np.arange(pos[b] * gpn, (pos[b] + 1) * gpn)
            sub[np.ix_(ia, ib)] *= f
            sub[np.ix_(ib, ia)] *= f
        return sub


# ---------------------------------------------------------------------------
# replanning policies + the replay scorer
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ReplanPolicy:
    """How to respond to a fleet event.

    ``warm=True`` is the incremental policy: each replan warm-starts SA
    from the incumbent mapping projected onto the survivors and selects
    by ``latency + migration_weight * downtime``.  ``warm=False`` is the
    from-scratch baseline: cold SA, pure-fastest selection, whatever
    resharding that implies.

    ``backend`` is one of the unified SA cores (``"torch"``, the
    default, as :class:`~repro_torch.core.plan.Budget`'s, or ``"numpy"``,
    byte-identical to it) rather than the legacy per-candidate driver
    because the unified core *guards* its warm seed — the incumbent
    permutation is used only when it scores better than the coarse init —
    so warm-starting can shift but never degrade a candidate's SA
    outcome, keeping the cross-candidate ranking honest.  ``device`` is
    where every replan runs: ``None`` is the CUDA device and raises
    without one, the CPU must be named (``device="cpu"``).
    """
    name: str
    warm: bool
    migration_weight: float = 0.0
    sa_seconds: float = 0.25
    sa_iters: int = 400
    partition: str = "uniform"
    max_vpp: int = 1
    backend: str = "torch"
    seed: int = 0
    device: DeviceLike = None


#: warm incremental replanning.  ``migration_weight`` has units of
#: 1/steps — it converts downtime seconds into a per-step latency
#: penalty, so it should be ~``1 / (expected steps between events)``:
#: with millisecond step times and minutes-long segments that is about
#: 1e-5, letting a 10 s restart barrier tip only near-tie candidates.
WARM_POLICY = ReplanPolicy("warm", True, migration_weight=2e-5)
#: from-scratch baseline.
COLD_POLICY = ReplanPolicy("cold", False)
POLICIES = {"warm": WARM_POLICY, "cold": COLD_POLICY}


class ResidentState:
    """Independent reshard ledger: which shard each *base* GPU holds.

    Carried across the whole trace, so it catches accounting drift that a
    single-transition :class:`~repro_torch.core.migration.PlanDiff` cannot —
    the bench gate asserts the two agree on every transition.  A departed
    GPU's entry is dropped (spot reclaim loses the instance), so a
    returning node re-fetches its shard — matching ``PlanDiff``'s
    added-rank accounting.
    """

    def __init__(self):
        self.keys: Dict[int, tuple] = {}

    def transition(self, cfg, cand: Candidate,
                   gpus: Sequence[int]) -> Tuple[int, int, float]:
        """Fold in a new assignment; returns (moved, added, bytes)."""
        new_keys = state_keys(cfg, cand.conf, cand.mapping, cand.partition)
        shard = rank_state_bytes(cfg, cand.conf, cand.partition)
        m4 = mapping4(cand.conf, cand.mapping)
        stage_of = {int(g): x for x in range(cand.conf.pp)
                    for g in m4[x].reshape(-1)}
        moved = added = 0
        fetched = 0.0
        for local, base in enumerate(gpus):
            old = self.keys.get(base)
            if old == new_keys[local]:
                continue
            if old is None:
                added += 1
            else:
                moved += 1
            fetched += float(shard[stage_of[local]])
        self.keys = {base: new_keys[local]
                     for local, base in enumerate(gpus)}
        return moved, added, fetched


@dataclass
class PolicyReport:
    """Outcome of replaying one trace under one policy."""
    policy: str
    samples: float                  # the throughput integral
    downtime_s: float
    replans: int
    ranks_moved: int
    bytes_migrated: float
    resident_bytes: float           # independent ledger's total
    resident_moved: int
    segments: List[dict] = field(default_factory=list)

    def to_json_dict(self) -> dict:
        return dataclasses.asdict(self)


def _measure_step(w: Workload, spec: ClusterSpec, bw: np.ndarray,
                  cand: Candidate, partition_mode: str, *,
                  jitter: float, contention: float, seed: int) -> float:
    """Ground-truth seconds/step of a candidate on the effective fleet,
    via the event-driven cluster simulator."""
    prof = ProfileCache(w, spec, partition_mode).get(cand.conf)
    return float(simulate_iteration(
        cand.conf, cand.mapping, bw, prof, spec,
        jitter=jitter, contention=contention, seed=seed)["total"])


def simulate_churn(w: Workload, spec: ClusterSpec, trace: ChurnTrace,
                   policy: ReplanPolicy, *, day: int = 0,
                   jitter: float = 0.0, contention: float = 0.05,
                   sim_seed: int = 0) -> PolicyReport:
    """Replay ``trace`` under ``policy``; score the throughput integral.

    At t=0 both policies cold-plan the full fleet (no incumbent exists).
    At each event the fleet state advances and the policy replans on the
    effective spec/bandwidth; the segment until the next event
    contributes ``(duration - downtime) / step_time * bs_global``
    samples, where ``step_time`` is measured by the event-driven
    simulator (the "real cluster") and ``downtime`` comes from the
    migration model's :class:`~repro_torch.core.migration.PlanDiff` for the
    transition actually taken.

    Each replan draws a fresh SA seed (``policy.seed + replan index``) —
    both policies see the identical seed stream, so the comparison
    isolates warm-start/migration-aware selection.  Reusing one seed for
    every replan would let the *from-scratch* policy accidentally
    reproduce its previous mapping verbatim whenever the spec barely
    changed (SA is deterministic), crediting it with incremental
    behaviour it does not have.
    """
    if trace.n_nodes != spec.n_nodes:
        raise ValueError(
            f"trace was generated for {trace.n_nodes} nodes, "
            f"spec has {spec.n_nodes}")
    bw_true = true_bandwidth_matrix(spec, day)
    state = FleetState(spec)
    ledger = ResidentState()
    report = PolicyReport(policy=policy.name, samples=0.0, downtime_s=0.0,
                          replans=0, ranks_moved=0, bytes_migrated=0.0,
                          resident_bytes=0.0, resident_moved=0)

    def plan_now(incumbent: Optional[Plan],
                 survivors: Optional[List[int]], plan_idx: int):
        eff_spec = state.effective_spec()
        eff_bw = state.effective_bw(bw_true)
        ep = replan_on(
            w, eff_spec, eff_bw,
            incumbent=incumbent if policy.warm else None,
            migration_weight=policy.migration_weight if policy.warm else 0.0,
            survivors=survivors if policy.warm else None,
            sa_seconds=policy.sa_seconds, sa_iters=policy.sa_iters,
            partition=policy.partition, max_vpp=policy.max_vpp,
            backend=policy.backend, seed=policy.seed + plan_idx,
            device=policy.device)
        cand = ep.chosen if ep.chosen is not None else ep.plan.ranked[0]
        # the incumbent artifact for the *next* replan reflects the
        # candidate actually going live, not necessarily plan.best
        live = dataclasses.replace(
            ep.plan, conf=cand.conf, mapping=cand.mapping,
            latency=cand.latency, mem_pred=cand.mem_pred,
            partition=cand.partition, schedule=cand.schedule)
        return cand, live, eff_spec, eff_bw

    cand, live, eff_spec, eff_bw = plan_now(None, None, 0)
    step = _measure_step(w, eff_spec, eff_bw, cand, policy.partition,
                         jitter=jitter, contention=contention,
                         seed=sim_seed)
    r_moved, r_added, r_bytes = ledger.transition(
        w.cfg, cand, state.gpu_ids())
    prev_gpus = state.gpu_ids()
    t_prev, pending_downtime = 0.0, 0.0

    def close_segment(t_now: float):
        productive = max(0.0, (t_now - t_prev) - pending_downtime)
        report.samples += productive / step * w.bs_global
        report.downtime_s += min(pending_downtime, t_now - t_prev)
        report.segments.append(
            {"t0": t_prev, "t1": t_now, "step_time": step,
             "downtime": pending_downtime,
             "conf": repr(cand.conf)})

    for ev in trace.events:
        close_segment(ev.t)
        state.apply(ev)
        old_conf, old_mapping, old_part = (cand.conf, cand.mapping,
                                           cand.partition)
        incumbent = live
        # survivors: previous-fleet GPU positions of the new fleet's
        # surviving GPUs, in new order (join-order keeps this a prefix)
        old_pos = {base: i for i, base in enumerate(prev_gpus)}
        new_gpus = state.gpu_ids()
        survivors = [old_pos[g] for g in new_gpus if g in old_pos]
        cand, live, eff_spec, eff_bw = plan_now(incumbent, survivors,
                                                report.replans + 1)
        step = _measure_step(w, eff_spec, eff_bw, cand, policy.partition,
                             jitter=jitter, contention=contention,
                             seed=sim_seed)
        b_to_a = [old_pos.get(g, -1) for g in new_gpus]
        d = diff_assignments(
            w.cfg, old_conf, old_mapping, cand.conf, cand.mapping,
            partition_a=old_part, partition_b=cand.partition,
            b_to_a=b_to_a, n_nodes=eff_spec.n_nodes,
            inter_bw=spec.inter_bw)
        r_moved, r_added, r_bytes = ledger.transition(w.cfg, cand,
                                                      new_gpus)
        report.replans += 1
        report.ranks_moved += d.ranks_moved
        report.bytes_migrated += d.bytes_migrated
        report.resident_moved += r_moved
        report.resident_bytes += r_bytes
        pending_downtime = d.downtime_s
        t_prev = ev.t
        prev_gpus = new_gpus

    close_segment(trace.horizon_s)
    return report


# ---------------------------------------------------------------------------
# replay CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime.churn",
        description="Replay a churn trace against replanning policies "
                    "and report the throughput integral.")
    ap.add_argument("--trace", help="replay this trace JSON instead of "
                                    "generating one")
    ap.add_argument("--trace-out", help="save the (generated) trace here")
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--model", default="gpt-1.1b")
    ap.add_argument("--full", action="store_true",
                    help="use the full model (default: reduced() smoke "
                         "variant)")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--bs-global", type=int, default=64)
    ap.add_argument("--horizon", type=float, default=1800.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--min-nodes", type=int, default=2)
    ap.add_argument("--policies", default="warm,cold",
                    help="comma-separated subset of %s" % (
                        sorted(POLICIES),))
    ap.add_argument("--migration-weight", type=float, default=None,
                    help="override the warm policy's migration weight")
    ap.add_argument("--sa-iters", type=int, default=None,
                    help="override per-replan SA iterations")
    ap.add_argument("--jitter", type=float, default=0.0)
    ap.add_argument("--backend", choices=("torch", "numpy"),
                    default="torch", help="SA engine of every replan")
    ap.add_argument("--device", default="cuda",
                    help="device of every replan (default cuda: an error "
                         "without a card; pass cpu to run on the host)")
    ap.add_argument("--out", help="write the JSON report here")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)     # fails early without a card

    from .. import configs
    cfg = configs.get(args.model)
    if not args.full:
        cfg = cfg.reduced()
    w = Workload(cfg, seq=args.seq, bs_global=args.bs_global)

    if args.trace:
        trace = ChurnTrace.load(args.trace)
        spec = MID_RANGE.with_nodes(trace.n_nodes)
    else:
        spec = MID_RANGE.with_nodes(args.nodes)
        trace = generate_trace(spec, horizon_s=args.horizon,
                               seed=args.seed, min_nodes=args.min_nodes)
    if args.trace_out:
        trace.save(args.trace_out)
    print(f"trace: {len(trace.events)} events over {trace.horizon_s:.0f}s "
          f"on {trace.n_nodes} nodes (seed {trace.seed})")

    reports = {}
    for name in args.policies.split(","):
        pol = dataclasses.replace(POLICIES[name.strip()],
                                  backend=args.backend, device=device)
        if args.migration_weight is not None and pol.warm:
            pol = dataclasses.replace(
                pol, migration_weight=args.migration_weight)
        if args.sa_iters is not None:
            pol = dataclasses.replace(pol, sa_iters=args.sa_iters)
        rep = simulate_churn(w, spec, trace, pol, jitter=args.jitter)
        reports[pol.name] = rep
        print(f"{pol.name:>6}: {rep.samples:12.0f} samples, "
              f"{rep.downtime_s:7.1f}s down, {rep.replans} replans, "
              f"{rep.ranks_moved} ranks moved, "
              f"{rep.bytes_migrated / 1e9:.2f} GB migrated")

    if args.out:
        doc = {name: r.to_json_dict() for name, r in reports.items()}
        with open(args.out, "w") as f:
            json.dump(doc, f, sort_keys=True, indent=2)
            f.write("\n")
        print(f"report -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Static Plan verifier: check a serialized Plan without re-searching.

Pipette's core critique of prior configurators is that they "recommend
solutions that could not be executed"; a *cached* or hand-edited Plan
artifact can drift into exactly that state (the cluster re-tiered, the
schema evolved, a mapping corrupted in transit).  This module re-checks
the executability invariants of a Plan JSON against a
:class:`~repro_torch.core.cluster.ClusterSpec` in milliseconds — the gate a
plan-server must run before serving a cached plan.

Surfaced as ``python -m repro_torch.plan lint``.  Verifier rule ids:

=======  ===========================================================
PLN000   artifact malformed (missing/ill-typed required fields)
PLN001   unknown plan schema version
PLN002   conf arithmetic: pp*tp*cp*dp must equal n_gpus, batch
         divisibility must hold (Conf.valid)
PLN003   unschedulable: 1F1B needs n_mb >= pp (Conf.schedulable)
PLN004   mapping: shape must match (pp, tp[, cp], dp), dtype must be
         integral, and the data must be a permutation of range(G)
PLN005   memory: predicted peak bytes must fit under the cluster's
         mem_floor (tightest device tier)
PLN006   bandwidth digest: malformed, or mismatching a provided
         profiled matrix
PLN007   tier provenance: recorded digest must match the recorded
         table (and the spec's live fingerprint when a spec is given)
PLN008   cluster mismatch: plan's n_gpus / cluster name vs the spec
         it is being checked against
PLN009   partition/schedule: schedule name must be known, consistent
         with the conf's vpp; a recorded partition must carry strictly
         increasing boundaries covering exactly n_layers with
         pp*vpp stage chunks
=======  ===========================================================

All checks run on the *raw JSON dict* — a plan that fails
``Plan.load`` (e.g. unknown schema) still gets a diagnosis instead of a
traceback.  Severities: ``error`` findings gate (CLI exit 1);
``warning`` is suspicious but runnable; ``note`` records skipped checks
so "passed" is never silently "didn't look".
"""
from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

_HEX64 = re.compile(r"^[0-9a-f]{64}$")


@dataclass(frozen=True)
class PlanIssue:
    """One verifier finding.

    Attributes:
        rule: ``PLN000`` ... ``PLN009``.
        severity: ``error`` (gates), ``warning``, or ``note``.
        where: which artifact part ("best", "ranked[3]", "provenance").
        message: human-readable description.
    """
    rule: str
    severity: str
    where: str
    message: str

    def __str__(self):
        return f"{self.severity.upper():7s} {self.rule} [{self.where}] " \
               f"{self.message}"


def _err(rule, where, msg):
    return PlanIssue(rule, "error", where, msg)


def _warn(rule, where, msg):
    return PlanIssue(rule, "warning", where, msg)


def _note(rule, where, msg):
    return PlanIssue(rule, "note", where, msg)


def _check_conf(conf: dict, n_gpus: int, where: str) -> List[PlanIssue]:
    issues: List[PlanIssue] = []
    try:
        pp, tp, dp = int(conf["pp"]), int(conf["tp"]), int(conf["dp"])
        cp = int(conf.get("cp", 1))
        bs_micro = int(conf["bs_micro"])
        bs_global = int(conf["bs_global"])
    except (KeyError, TypeError, ValueError) as e:
        return [_err("PLN000", where, f"conf is malformed: {e!r}")]
    if min(pp, tp, cp, dp, bs_micro, bs_global) < 1:
        issues.append(_err("PLN002", where,
                           f"conf degrees must be >= 1, got (pp={pp}, "
                           f"tp={tp}, cp={cp}, dp={dp}, "
                           f"bs_micro={bs_micro}, bs_global={bs_global})"))
        return issues
    used = pp * tp * cp * dp
    if used != n_gpus:
        issues.append(_err("PLN002", where,
                           f"conf uses pp*tp*cp*dp = {used} GPUs but the "
                           f"cluster has {n_gpus} — this plan cannot be "
                           f"dedicated onto the fleet"))
    if bs_global % dp != 0:
        issues.append(_err("PLN002", where,
                           f"bs_global={bs_global} is not divisible by "
                           f"dp={dp}"))
        return issues
    bs_mini = bs_global // dp
    if bs_mini % bs_micro != 0:
        issues.append(_err("PLN002", where,
                           f"minibatch {bs_mini} is not divisible by "
                           f"bs_micro={bs_micro}"))
        return issues
    n_mb = bs_mini // bs_micro
    if n_mb < 1:
        issues.append(_err("PLN002", where,
                           f"n_mb = {n_mb}: microbatch larger than the "
                           f"minibatch"))
    elif n_mb < pp:
        issues.append(_err("PLN003", where,
                           f"unschedulable: 1F1B needs n_mb >= pp, got "
                           f"n_mb={n_mb} < pp={pp} (Eq. 3-6 would score "
                           f"a schedule that cannot exist)"))
    return issues


def _check_mapping(mapping: dict, conf: dict, n_gpus: int,
                   where: str) -> List[PlanIssue]:
    issues: List[PlanIssue] = []
    try:
        shape = [int(s) for s in mapping["shape"]]
        data = list(mapping["data"])
        dtype = str(mapping["dtype"])
        pp, tp, dp = int(conf["pp"]), int(conf["tp"]), int(conf["dp"])
        cp = int(conf.get("cp", 1))
    except (KeyError, TypeError, ValueError) as e:
        return [_err("PLN000", where, f"mapping is malformed: {e!r}")]
    if not dtype.startswith(("int", "uint")):
        issues.append(_err("PLN004", where,
                           f"mapping dtype must be integral (GPU ids), "
                           f"got {dtype!r}"))
    # stride/axis consistency: the mapping must factor exactly as the
    # conf's parallel degrees — 4D (pp, tp, cp, dp), or legacy 3D
    # (pp, tp, dp) only while cp == 1
    if shape not in ([pp, tp, cp, dp],
                     [pp, tp, dp] if cp == 1 else [pp, tp, cp, dp]):
        issues.append(_err("PLN004", where,
                           f"mapping shape {shape} is inconsistent with "
                           f"conf (pp={pp}, tp={tp}, cp={cp}, dp={dp}): "
                           f"expected {[pp, tp, cp, dp]}"
                           + (f" or legacy {[pp, tp, dp]}" if cp == 1
                              else "")))
    if math.prod(shape) != len(data):
        issues.append(_err("PLN004", where,
                           f"mapping carries {len(data)} entries but its "
                           f"shape {shape} implies {math.prod(shape)}"))
    if sorted(data) != list(range(n_gpus)):
        issues.append(_err("PLN004", where,
                           f"mapping is not a permutation of the {n_gpus} "
                           f"GPU ids: some GPU is either unused or "
                           f"dedicated to two workers"))
    return issues


def _check_partition(cand: dict, where: str) -> List[PlanIssue]:
    """PLN009: schedule name + vpp consistency + partition coverage."""
    from ..core.partition import SCHEDULES

    issues: List[PlanIssue] = []
    conf = cand.get("conf")
    if not isinstance(conf, dict):
        return []                       # already a PLN000 elsewhere
    try:
        pp = int(conf.get("pp", 0))
        vpp = int(conf.get("vpp", 1))
    except (TypeError, ValueError):
        return []                       # already a PLN000 elsewhere
    schedule = cand.get("schedule", "1f1b")
    if schedule not in SCHEDULES:
        issues.append(_err("PLN009", where,
                           f"unknown schedule {schedule!r}; this build "
                           f"knows {SCHEDULES}"))
        return issues
    expected = "interleaved-1f1b" if vpp > 1 else "1f1b"
    if schedule != expected:
        issues.append(_err("PLN009", where,
                           f"schedule {schedule!r} is inconsistent with "
                           f"vpp={vpp}: expected {expected!r}"))
    part = cand.get("partition")
    if part is None:
        return issues
    try:
        n_layers = int(part["n_layers"])
        bounds = [int(b) for b in part["boundaries"]]
    except (KeyError, TypeError, ValueError) as e:
        issues.append(_err("PLN009", where,
                           f"partition is malformed: {e!r}"))
        return issues
    if pp >= 1 and len(bounds) != pp * vpp:
        issues.append(_err("PLN009", where,
                           f"partition has {len(bounds)} stage chunks but "
                           f"the conf implies pp*vpp = {pp * vpp}"))
    if not bounds or bounds[0] < 1 \
            or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
        issues.append(_err("PLN009", where,
                           f"partition boundaries {bounds} must be "
                           f"strictly increasing with every stage chunk "
                           f"owning >= 1 layer"))
    elif bounds[-1] != n_layers:
        issues.append(_err("PLN009", where,
                           f"partition boundaries end at {bounds[-1]} but "
                           f"must cover exactly n_layers = {n_layers} — "
                           f"some layers would be unassigned or assigned "
                           f"twice"))
    return issues


def _mem_floor_from(d: dict, spec) -> Optional[float]:
    """Tightest per-GPU memory: live spec first, else recorded tiers."""
    if spec is not None:
        return float(spec.mem_floor)
    tiers = (d.get("provenance") or {}).get("tiers")
    if not tiers:
        return None
    try:
        used = sorted(set(int(t) for t in tiers["node_tiers"]))
        return min(float(tiers["tiers"][i]["mem"]) for i in used)
    except (KeyError, TypeError, ValueError, IndexError):
        return None


def verify_plan_dict(d: dict, spec=None,
                     bw=None) -> List[PlanIssue]:
    """Statically verify a raw Plan JSON dict.

    Args:
        d: the parsed artifact (``json.load`` of a ``Plan.save`` file).
        spec: optional live :class:`~repro_torch.core.cluster.ClusterSpec` to
            cross-check against (sizes, mem floor, tier fingerprint).
        bw: optional ``(G, G)`` profiled bandwidth matrix; when given the
            recorded digest must match its fingerprint.

    Returns:
        List of :class:`PlanIssue`, errors first.  An empty error set
        means "this artifact can execute on that cluster as far as
        static checks can tell".
    """
    from ..core.cluster import tier_fingerprint, tier_table_fingerprint
    from ..core.plan import PLAN_SCHEMA_VERSION, bw_fingerprint

    issues: List[PlanIssue] = []
    if not isinstance(d, dict):
        return [_err("PLN000", "artifact", "top level is not an object")]

    version = d.get("version")
    if version != PLAN_SCHEMA_VERSION:
        issues.append(_err("PLN001", "artifact",
                           f"unknown plan schema version {version!r} "
                           f"(this build reads version "
                           f"{PLAN_SCHEMA_VERSION}); refusing to trust "
                           f"field semantics"))

    prov = d.get("provenance")
    if not isinstance(prov, dict):
        issues.append(_err("PLN000", "provenance",
                           "provenance block is missing"))
        return issues
    try:
        n_gpus = int(prov["n_gpus"])
    except (KeyError, TypeError, ValueError):
        issues.append(_err("PLN000", "provenance",
                           "provenance.n_gpus is missing or not an int"))
        return issues

    # -- cluster cross-checks (PLN008) ------------------------------------
    if spec is not None:
        if spec.n_gpus != n_gpus:
            issues.append(_err("PLN008", "provenance",
                               f"plan was computed for {n_gpus} GPUs but "
                               f"the spec has {spec.n_gpus}"))
        if prov.get("cluster") != spec.name:
            issues.append(_warn("PLN008", "provenance",
                                f"plan records cluster "
                                f"{prov.get('cluster')!r}, checking "
                                f"against {spec.name!r}"))

    # -- bandwidth digest (PLN006) ----------------------------------------
    digest = prov.get("bw_digest")
    if not isinstance(digest, str) or not _HEX64.match(digest):
        issues.append(_err("PLN006", "provenance",
                           f"bw_digest {digest!r} is not a sha256 hex "
                           f"digest"))
    elif bw is not None:
        live = bw_fingerprint(bw)
        if live != digest:
            issues.append(_err("PLN006", "provenance",
                               f"bandwidth digest mismatch: plan was "
                               f"scored on sha256:{digest[:16]}… but the "
                               f"given matrix is sha256:{live[:16]}… — "
                               f"the interconnect snapshot changed; the "
                               f"plan is stale"))
    else:
        issues.append(_note("PLN006", "provenance",
                            "no bandwidth matrix given; digest checked "
                            "for format only"))

    # -- tier provenance (PLN007) -----------------------------------------
    tiers = prov.get("tiers")
    if tiers is not None:
        try:
            table = [(t["flops"], t["mem"], t["efficiency"], t["name"])
                     for t in tiers["tiers"]]
            node_tiers = [int(t) for t in tiers["node_tiers"]]
            recorded = tiers["digest"]
        except (KeyError, TypeError, ValueError):
            issues.append(_err("PLN000", "provenance.tiers",
                               "tier table is malformed"))
            table = None
        if table is not None:
            if any(not 0 <= t < len(table) for t in node_tiers):
                issues.append(_err("PLN007", "provenance.tiers",
                                   f"node_tiers index out of range "
                                   f"[0, {len(table)})"))
            if node_tiers and n_gpus % len(node_tiers) != 0:
                issues.append(_err("PLN007", "provenance.tiers",
                                   f"{len(node_tiers)} nodes cannot "
                                   f"evenly host {n_gpus} GPUs"))
            if tier_table_fingerprint(table, node_tiers) != recorded:
                issues.append(_err("PLN007", "provenance.tiers",
                                   "tier digest does not match the "
                                   "recorded tier table — the table or "
                                   "the digest was edited after planning"))
            if spec is not None:
                live = tier_fingerprint(spec)
                if live != recorded:
                    issues.append(_err("PLN007", "provenance.tiers",
                                       "plan's fleet composition differs "
                                       "from the spec's live tier "
                                       "fingerprint (node swapped or "
                                       "re-tiered); the plan is stale"))
    elif spec is not None and spec.has_tiers:
        issues.append(_err("PLN007", "provenance.tiers",
                           "spec is tiered but the plan records no tier "
                           "provenance — planned for a homogeneous "
                           "fleet"))

    # -- best + ranked candidates (PLN002/3/4/5) --------------------------
    best = d.get("best")
    if best is None:
        issues.append(_note("PLN002", "best",
                            "infeasible plan (no best candidate): "
                            "nothing to execute, executability checks "
                            "skipped"))
    candidates = ([("best", best)] if best is not None else []) \
        + [(f"ranked[{i}]", c)
           for i, c in enumerate(d.get("ranked") or [])]
    mem_floor = _mem_floor_from(d, spec)
    for where, cand in candidates:
        if not isinstance(cand, dict) or "conf" not in cand \
                or "mapping" not in cand:
            issues.append(_err("PLN000", where,
                               "candidate is missing conf/mapping"))
            continue
        issues.extend(_check_conf(cand["conf"], n_gpus, where))
        issues.extend(_check_mapping(cand["mapping"], cand["conf"],
                                     n_gpus, where))
        issues.extend(_check_partition(cand, where))
        mem_pred = cand.get("mem_pred")
        if mem_pred is None:
            if where == "best":
                issues.append(_note("PLN005", where,
                                    "no memory prediction recorded "
                                    "(memory-unaware strategy); OOM "
                                    "check skipped"))
        elif mem_floor is None:
            if where == "best":
                issues.append(_note("PLN005", where,
                                    "no memory floor derivable (no spec "
                                    "given and no tier provenance); OOM "
                                    "check skipped"))
        elif float(mem_pred) > mem_floor:
            issues.append(_err("PLN005", where,
                               f"predicted peak {float(mem_pred) / 1e9:.2f} "
                               f"GB exceeds the cluster's memory floor "
                               f"{mem_floor / 1e9:.2f} GB — this plan "
                               f"OOMs on its tightest device tier"))

    order = {"error": 0, "warning": 1, "note": 2}
    return sorted(issues, key=lambda i: (order[i.severity], i.rule,
                                         i.where))


def verify_plan_file(path, spec=None, bw=None) -> List[PlanIssue]:
    """:func:`verify_plan_dict` on a file; unreadable/unparsable files
    become ``PLN000`` errors instead of exceptions."""
    try:
        with open(path) as f:
            d = json.load(f)
    except OSError as e:
        return [_err("PLN000", "artifact", f"cannot read {path}: {e}")]
    except json.JSONDecodeError as e:
        return [_err("PLN000", "artifact",
                     f"{Path(path).name} is not valid JSON: {e}")]
    return verify_plan_dict(d, spec=spec, bw=bw)

"""The fleet-wide plan cache: fingerprint -> canonical plan bytes.

Two layers behind one interface:

- an in-memory LRU (``max_entries``) holding the exact canonical JSON
  text of each plan — a cache hit returns those bytes untouched, so a
  hit is **byte-identical** to the response that populated it;
- an optional on-disk store (``<fingerprint>.plan.json`` + a
  ``.meta.json`` sidecar) so a restarted server inherits the fleet's
  plan history.  Disk writes are atomic (temp file + ``os.replace``);
  a corrupt or unreadable entry is dropped and counted, never served.

The cache also answers the warm-start question: :meth:`PlanCache.nearest`
scans entries sharing the request's cluster digest / strategy from the
same or the immediately preceding day and returns the closest workload by
log-scale distance over (seq, global batch, d_model, n_layers) — the
incumbent whose mapping seeds the new search's SA chains.  Ties break by
(distance, day recency, fingerprint) so the lookup is fully
deterministic.
"""
from __future__ import annotations

import json
import math
import os
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

#: metadata fields every entry must carry to be servable
_REQUIRED_META = ("fingerprint", "cluster_digest", "strategy", "day")


class PlanCache:
    """LRU + disk plan cache keyed by request fingerprint.

    Args:
        cache_dir: directory for the persistent layer (``None`` =
            memory-only).  Created on first write.
        max_entries: in-memory LRU capacity; evicted entries stay on disk
            (the disk layer is the fleet history, bounded only by
            explicit ``evict``).
    """

    def __init__(self, cache_dir=None, *, max_entries: int = 256):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.cache_dir = Path(cache_dir) if cache_dir is not None else None
        self.max_entries = max_entries
        self._mem: "OrderedDict[str, Tuple[dict, str]]" = OrderedDict()
        self.counters: Dict[str, int] = {
            "hits": 0, "misses": 0, "puts": 0, "lru_evictions": 0,
            "evictions": 0, "corrupt_dropped": 0,
        }

    # -- paths --------------------------------------------------------------

    def _plan_path(self, fp: str) -> Path:
        return self.cache_dir / f"{fp}.plan.json"

    def _meta_path(self, fp: str) -> Path:
        return self.cache_dir / f"{fp}.meta.json"

    # -- core ---------------------------------------------------------------

    def get(self, fp: str) -> Optional[str]:
        """The cached plan text for ``fp``, or ``None``.  Disk entries are
        promoted into the LRU on hit; corrupt entries are dropped."""
        hit = self._mem.get(fp)
        if hit is not None:
            self._mem.move_to_end(fp)
            self.counters["hits"] += 1
            return hit[1]
        loaded = self._load_disk(fp)
        if loaded is not None:
            meta, text = loaded
            self._insert(fp, meta, text)
            self.counters["hits"] += 1
            return text
        self.counters["misses"] += 1
        return None

    def get_meta(self, fp: str) -> Optional[dict]:
        hit = self._mem.get(fp)
        if hit is not None:
            return hit[0]
        loaded = self._load_disk(fp)
        return None if loaded is None else loaded[0]

    def put(self, fp: str, meta: dict, text: str) -> None:
        """Insert a plan (canonical JSON text) under its fingerprint."""
        self.counters["puts"] += 1
        self._insert(fp, meta, text)
        if self.cache_dir is not None:
            self.cache_dir.mkdir(parents=True, exist_ok=True)
            self._atomic_write(self._plan_path(fp), text)
            self._atomic_write(self._meta_path(fp),
                               json.dumps(meta, sort_keys=True) + "\n")

    def evict(self, fp: str) -> bool:
        """Drop ``fp`` from both layers; True if anything was removed."""
        removed = self._mem.pop(fp, None) is not None
        if self.cache_dir is not None:
            for p in (self._plan_path(fp), self._meta_path(fp)):
                try:
                    os.remove(p)
                    removed = True
                except FileNotFoundError:
                    pass
        if removed:
            self.counters["evictions"] += 1
        return removed

    def entries(self) -> List[dict]:
        """Every entry's metadata (memory ∪ disk), fingerprint-sorted."""
        metas = {fp: meta for fp, (meta, _) in self._mem.items()}
        if self.cache_dir is not None and self.cache_dir.is_dir():
            for p in self.cache_dir.glob("*.meta.json"):
                fp = p.name[:-len(".meta.json")]
                if fp in metas:
                    continue
                loaded = self._load_disk(fp)
                if loaded is not None:
                    metas[fp] = loaded[0]
        return [metas[fp] for fp in sorted(metas)]

    def stats(self) -> dict:
        disk = 0
        if self.cache_dir is not None and self.cache_dir.is_dir():
            disk = sum(1 for _ in self.cache_dir.glob("*.plan.json"))
        return {**self.counters, "memory_entries": len(self._mem),
                "disk_entries": disk, "max_entries": self.max_entries}

    # -- warm-start neighbor lookup -----------------------------------------

    def nearest(self, meta: dict, *, exclude: str = "",
                max_distance: float = math.inf
                ) -> Optional[Tuple[str, float]]:
        """The cached entry closest to ``meta`` in workload space.

        Candidates must share ``cluster_digest`` and ``strategy`` (an
        incumbent mapping only transfers within the same fleet) and be
        feasible (carry a best mapping).  The bandwidth realisation drifts
        day to day, so candidates must come from the same *or the
        immediately preceding* day — a replan just after midnight may
        still warm-start from last night's incumbent (interconnect drift
        is gradual; the SA seed only sets a starting point), but older
        snapshots are rejected.  Same-day neighbors win ties over
        previous-day ones.  Distance is the sum of absolute log-ratios
        over (seq, bs_global, d_model, n_layers) — 0 for the same
        workload with different budget/space knobs, growing smoothly as
        the neighbor's shape diverges.  Returns ``(fingerprint,
        distance)`` or ``None``.
        """
        best: Optional[Tuple[float, int, str]] = None
        for cand in self.entries():
            fp = cand.get("fingerprint")
            if not fp or fp == exclude:
                continue
            if any(cand.get(k) != meta.get(k)
                   for k in ("cluster_digest", "strategy")):
                continue
            try:
                day_diff = int(meta.get("day")) - int(cand.get("day"))
            except (TypeError, ValueError):
                continue
            if day_diff not in (0, 1):
                continue
            if not cand.get("feasible", True):
                continue
            try:
                dist = math.fsum(
                    abs(math.log(float(cand[k]) / float(meta[k])))
                    for k in ("seq", "bs_global", "d_model", "n_layers"))
            except (KeyError, TypeError, ValueError, ZeroDivisionError):
                continue
            if dist > max_distance:
                continue
            key = (dist, day_diff, fp)
            if best is None or key < best:
                best = key
        return None if best is None else (best[2], best[0])

    # -- internals ----------------------------------------------------------

    def _insert(self, fp: str, meta: dict, text: str) -> None:
        self._mem[fp] = (meta, text)
        self._mem.move_to_end(fp)
        while len(self._mem) > self.max_entries:
            self._mem.popitem(last=False)
            self.counters["lru_evictions"] += 1

    def _load_disk(self, fp: str) -> Optional[Tuple[dict, str]]:
        if self.cache_dir is None:
            return None
        plan_p, meta_p = self._plan_path(fp), self._meta_path(fp)
        try:
            text = plan_p.read_text()
            meta = json.loads(meta_p.read_text())
            # both documents must parse and the sidecar must describe
            # this fingerprint — anything else is corruption
            json.loads(text)
            if (not isinstance(meta, dict)
                    or any(k not in meta for k in _REQUIRED_META)
                    or meta["fingerprint"] != fp):
                raise ValueError("meta sidecar does not match entry")
        except FileNotFoundError:
            return None
        except (OSError, ValueError):
            self.counters["corrupt_dropped"] += 1
            for p in (plan_p, meta_p):
                try:
                    os.remove(p)
                except OSError:
                    pass
            return None
        return meta, text

    @staticmethod
    def _atomic_write(path: Path, text: str) -> None:
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(text)
        os.replace(tmp, path)

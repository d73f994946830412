"""The async plan server: cache -> coalesce -> batch -> warm-start -> search.

One asyncio TCP server (newline-delimited JSON over localhost) serving
``plan`` / ``ping`` / ``stats`` / ``cache_ls`` / ``cache_evict`` /
``shutdown`` ops.  A plan request flows through four layers, cheapest
first:

1. **cache** — the request fingerprint is looked up in the
   :class:`~repro_torch.service.cache.PlanCache`; a hit is verified by the
   static plan verifier against the live spec and returned byte-identical
   without touching any Strategy (a verifier error drops the entry and
   falls through to a cold search);
2. **in-flight coalescing** — N identical concurrent requests share one
   search: the first creates a future under the fingerprint, the rest
   await it (``meta.cache == "coalesced"``);
3. **request batching** — with ``batch_window > 0``, near-identical
   requests (same workload + cluster + search-space shape, pipette or
   exhaustive) arriving within the window are grouped and run through one
   :class:`~repro_torch.core.search.BatchSearchContext` — a single enumeration
   and one batched ``predict_batch`` forward serve the whole group, each
   member's plan still bit-identical to its standalone search;
4. **warm-started annealing** — a cold pipette search first asks the
   cache for its nearest neighbor (same cluster/strategy, same or
   previous day, closest workload); the neighbor's best mapping seeds
   every SA chain via
   ``Budget.warm_start``, and the plan records the lineage
   (``provenance.lineage.warm_start_from``).

Searches execute on a single worker thread (``ThreadPoolExecutor(1)``) so
concurrent requests cannot interleave their launches on the device; the
event loop stays free to accept, coalesce, and answer cache hits while a
search runs.  The device is resolved once, when the server is built, in
the calling thread (``None`` is the CUDA device and raises without one,
the CPU must be named), and that indexed device is handed to every
search: the worker thread never resolves ``"cuda"`` itself.
Admission is typed: a request whose cluster spec fails ``ClusterSpec``
validation is rejected with a structured ``admission`` error before any
search work happens.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from .._device import DeviceLike, resolve_device
from ..analysis.plan_verifier import verify_plan_dict
from ..core import (BatchSearchContext, MegatronStrategy, Plan, Planner,
                    PlanRequest, profile_bandwidth, true_bandwidth_matrix)
from ..core.plan import STRATEGIES
from .cache import PlanCache
from .wire import (AdmissionError, WireError, cluster_digest,
                   decode_plan_request, incumbent_perm, request_meta)

#: strategies whose searches can share a BatchSearchContext
_BATCHABLE = ("pipette", "exhaustive")


@dataclasses.dataclass
class _Member:
    """One request waiting in a batch group."""
    req: PlanRequest
    meta: dict
    lineage: Optional[dict]
    future: "asyncio.Future"


class PlanServer:
    """The planning-as-a-service daemon.  See module docstring.

    Args:
        host / port: bind address; port 0 picks an ephemeral port
            (written to ``port_file`` when given, so shell clients can
            discover it).
        cache_dir: persistent cache directory (``None`` = memory-only).
        max_entries: in-memory LRU capacity of the plan cache.
        warm_start: enable nearest-neighbor warm-started annealing.
        warm_max_distance: log-scale workload distance beyond which a
            neighbor is not worth seeding from.
        batch_window: seconds to hold a batchable request open for
            grouping (0 disables batching).
        estimator: optional memory estimator shared by every pipette /
            exhaustive search (and their batched contexts).
        plan_fn: test hook — replaces the single-request compute path
            (``fn(req, strategy_name, day, lineage) -> Plan``); batching
            is disabled while set.
        device: where every search (estimator forward, torch SA backend)
            runs; resolved here, so ``None`` (the CUDA device) raises at
            construction on a machine without one.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 cache: Optional[PlanCache] = None, cache_dir=None,
                 max_entries: int = 256, warm_start: bool = True,
                 warm_max_distance: float = 2.0,
                 batch_window: float = 0.0, estimator=None,
                 plan_fn=None, port_file=None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.host, self.port = host, port
        self.cache = cache if cache is not None else PlanCache(
            cache_dir, max_entries=max_entries)
        self.warm_start = warm_start
        self.warm_max_distance = warm_max_distance
        self.batch_window = batch_window if plan_fn is None else 0.0
        self.estimator = estimator
        self.plan_fn = plan_fn
        self.port_file = port_file
        self.counters: Dict[str, int] = {
            "requests": 0, "cache_hits": 0, "cache_invalid": 0,
            "coalesced": 0, "searches_run": 0, "batch_groups": 0,
            "batched_members": 0, "predict_batches": 0,
            "warm_starts": 0, "admission_rejects": 0, "bad_requests": 0,
        }
        self._inflight: Dict[str, "asyncio.Future"] = {}
        self._groups: Dict[tuple, List[_Member]] = {}
        self._bw_cache: Dict[Tuple[str, int], np.ndarray] = {}
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._ready = threading.Event()
        self._stop: Optional[asyncio.Event] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None

    # -- lifecycle ----------------------------------------------------------

    async def serve(self) -> None:
        """Bind, announce readiness, and serve until ``shutdown``."""
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        server = await asyncio.start_server(self._handle_conn, self.host,
                                            self.port)
        self.port = server.sockets[0].getsockname()[1]
        if self.port_file is not None:
            with open(self.port_file, "w") as f:
                f.write(f"{self.port}\n")
        self._ready.set()
        try:
            async with server:
                await self._stop.wait()
        finally:
            self._ready.clear()
            self._pool.shutdown(wait=True)

    def run(self) -> None:
        """Blocking entry point (the CLI ``serve`` command)."""
        asyncio.run(self.serve())

    def start_in_thread(self, timeout: float = 30.0) -> threading.Thread:
        """Run the server on a daemon thread; returns once it is bound
        (``self.port`` holds the resolved port)."""
        t = threading.Thread(target=self.run, daemon=True,
                             name="plan-server")
        t.start()
        if not self._ready.wait(timeout):
            raise RuntimeError("plan server failed to start")
        return t

    def stop(self) -> None:
        """Request shutdown from any thread."""
        if self._loop is not None and self._stop is not None:
            self._loop.call_soon_threadsafe(self._stop.set)

    # -- connection handling ------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        # requests on one connection are served concurrently (a cache hit
        # must not queue behind a long search), with a write lock keeping
        # response lines whole; clients correlate via the echoed "id"
        wlock = asyncio.Lock()
        tasks: List[asyncio.Task] = []
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                tasks.append(asyncio.ensure_future(
                    self._serve_line(line, writer, wlock)))
        finally:
            for t in tasks:
                try:
                    await t
                except Exception:
                    pass
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _serve_line(self, line: bytes, writer: asyncio.StreamWriter,
                          wlock: asyncio.Lock) -> None:
        shutdown = False
        obj: dict = {}
        try:
            decoded = json.loads(line.decode())
            if not isinstance(decoded, dict):
                raise WireError("request must be a JSON object")
            obj = decoded
        except (UnicodeDecodeError, ValueError) as e:
            self.counters["bad_requests"] += 1
            resp = {"ok": False, "error": {"code": "bad-request",
                                           "message": f"invalid JSON: {e}"}}
        else:
            try:
                resp = await self._dispatch(obj)
            except AdmissionError as e:
                self.counters["admission_rejects"] += 1
                resp = {"ok": False,
                        "error": {"code": "admission", "message": str(e)}}
            except WireError as e:
                self.counters["bad_requests"] += 1
                resp = {"ok": False,
                        "error": {"code": "bad-request", "message": str(e)}}
            except Exception as e:
                resp = {"ok": False,
                        "error": {"code": "internal",
                                  "message": f"{type(e).__name__}: {e}"}}
            shutdown = bool(resp.pop("_shutdown", False))
        if "id" in obj:
            resp["id"] = obj["id"]
        data = (json.dumps(resp, sort_keys=True) + "\n").encode()
        async with wlock:
            try:
                writer.write(data)
                await writer.drain()
            except (ConnectionError, OSError):
                pass
        if shutdown and self._stop is not None:
            self._stop.set()

    # -- ops ----------------------------------------------------------------

    async def _dispatch(self, obj: dict) -> dict:
        op = obj.get("op", "plan")
        if op == "ping":
            return {"ok": True, "op": "ping"}
        if op == "stats":
            return {"ok": True,
                    "stats": {**self.counters, "cache": self.cache.stats()}}
        if op == "cache_ls":
            return {"ok": True, "entries": self.cache.entries()}
        if op == "cache_evict":
            fp = obj.get("fingerprint")
            if not isinstance(fp, str) or not fp:
                raise WireError("cache_evict needs a 'fingerprint' string")
            return {"ok": True, "evicted": self.cache.evict(fp)}
        if op == "shutdown":
            return {"ok": True, "op": "shutdown", "_shutdown": True}
        if op == "plan":
            return await self._plan_op(obj)
        raise WireError(f"unknown op {op!r}")

    async def _plan_op(self, obj: dict) -> dict:
        t0 = time.perf_counter()
        self.counters["requests"] += 1
        req, strategy, day = decode_plan_request(obj)
        meta = request_meta(req, strategy, day)
        fp = meta["fingerprint"]

        # layer 1: the plan cache — hits are verified, then returned
        # byte-identical without invoking any Strategy
        text = self.cache.get(fp)
        if text is not None:
            errors = [str(i) for i in verify_plan_dict(json.loads(text),
                                                       spec=req.spec)
                      if i.severity == "error"]
            if errors:
                self.counters["cache_invalid"] += 1
                self.cache.evict(fp)
            else:
                self.counters["cache_hits"] += 1
                return self._ok(text, fp, "hit", None, t0)

        # layer 2: in-flight coalescing — identical concurrent requests
        # share one search
        fut = self._inflight.get(fp)
        if fut is not None:
            self.counters["coalesced"] += 1
            text, lineage, err = await asyncio.shield(fut)
            if err is not None:
                return {"ok": False, "error": err}
            return self._ok(text, fp, "coalesced", lineage, t0)

        assert self._loop is not None
        fut = self._loop.create_future()
        self._inflight[fp] = fut
        try:
            text, lineage, err = await self._produce(req, strategy, day,
                                                     meta)
            fut.set_result((text, lineage, err))
        except BaseException as e:
            fut.set_result((None, None,
                            {"code": "internal",
                             "message": f"{type(e).__name__}: {e}"}))
            raise
        finally:
            self._inflight.pop(fp, None)
        if err is not None:
            return {"ok": False, "error": err}
        return self._ok(text, fp, "miss", lineage, t0)

    def _ok(self, text: str, fp: str, cache: str,
            lineage: Optional[dict], t0: float) -> dict:
        meta = {"cache": cache, "fingerprint": fp,
                "elapsed_s": time.perf_counter() - t0}
        if lineage is not None:
            meta["warm_start_from"] = lineage.get("warm_start_from")
        return {"ok": True, "plan": text, "meta": meta}

    # -- the compute path ---------------------------------------------------

    async def _produce(self, req: PlanRequest, strategy: str, day: int,
                       meta: dict):
        """Compute (directly or via a batch group) -> verify -> cache.

        Returns ``(plan_text, lineage, error_dict_or_None)``.
        """
        warm_req, lineage = self._warm(req, strategy, day, meta)
        if (self.batch_window > 0 and strategy in _BATCHABLE):
            plan = await self._via_group(warm_req, strategy, day, meta,
                                         lineage)
        else:
            self.counters["searches_run"] += 1
            plan = await self._loop.run_in_executor(
                self._pool, self._compute_one, warm_req, strategy, day,
                lineage)
        text = plan.to_json()
        errors = [str(i) for i in verify_plan_dict(json.loads(text),
                                                   spec=req.spec)
                  if i.severity == "error"]
        if errors:
            return None, None, {"code": "verifier",
                                "message": "computed plan failed "
                                           "verification",
                                "issues": errors}
        self.cache.put(meta["fingerprint"],
                       {**meta, "feasible": plan.feasible,
                        "warm_started": lineage is not None},
                       text)
        return text, lineage, None

    def _warm(self, req: PlanRequest, strategy: str, day: int,
              meta: dict) -> Tuple[PlanRequest, Optional[dict]]:
        """Seed a cold pipette request from its nearest cached neighbor."""
        if (not self.warm_start or strategy != "pipette"
                or req.budget.warm_start is not None):
            return req, None
        nb = self.cache.nearest(meta, exclude=meta["fingerprint"],
                                max_distance=self.warm_max_distance)
        if nb is None:
            return req, None
        nfp, dist = nb
        ntext = self.cache.get(nfp)
        if ntext is None:
            return req, None
        try:
            perm = incumbent_perm(json.loads(ntext))
        except ValueError:
            return req, None
        if perm is None or perm.shape != (req.spec.n_gpus,):
            return req, None
        warm = dataclasses.replace(
            req, budget=dataclasses.replace(
                req.budget, warm_start=tuple(int(x) for x in perm)))
        self.counters["warm_starts"] += 1
        return warm, {"warm_start_from": nfp, "distance": dist}

    def _compute_one(self, req: PlanRequest, strategy: str, day: int,
                     lineage: Optional[dict]) -> Plan:
        """Single-request compute (worker thread)."""
        if self.plan_fn is not None:
            return self.plan_fn(req, strategy, day, lineage)
        bw = self._bandwidth(req, day)
        return Planner(self._strategy(strategy, req),
                       device=self.device).plan(req, bw, lineage=lineage)

    def _strategy(self, name: str, req: PlanRequest):
        cls = STRATEGIES[name]
        if name in _BATCHABLE:
            return cls(estimator=self.estimator,
                       mem_limit=req.spec.mem_floor)
        if name == "megatron-lm":
            return MegatronStrategy(
                bw_true=true_bandwidth_matrix(req.spec))
        return cls()

    def _bandwidth(self, req: PlanRequest, day: int) -> np.ndarray:
        key = (cluster_digest(req.spec), day)
        bw = self._bw_cache.get(key)
        if bw is None:
            bw, _ = profile_bandwidth(req.spec, day)
            self._bw_cache[key] = bw
        return bw

    # -- batching -----------------------------------------------------------

    @staticmethod
    def _group_key(meta: dict, req: PlanRequest, strategy: str,
                   day: int) -> tuple:
        s = req.space
        return (meta["workload_digest"], meta["cluster_digest"], strategy,
                day, s.partition, s.max_cp, s.max_tp, s.max_vpp)

    async def _via_group(self, req: PlanRequest, strategy: str, day: int,
                         meta: dict, lineage: Optional[dict]) -> Plan:
        """Join (or open) the batch group for this request's shape."""
        assert self._loop is not None
        key = self._group_key(meta, req, strategy, day)
        member = _Member(req, meta, lineage, self._loop.create_future())
        group = self._groups.get(key)
        if group is None:
            self._groups[key] = [member]
            self._loop.create_task(self._close_group(key, strategy, day))
        else:
            group.append(member)
        plan, err = await member.future
        if err is not None:
            raise err
        return plan

    async def _close_group(self, key: tuple, strategy: str,
                           day: int) -> None:
        """Hold the window open, then run the whole group as one
        BatchSearchContext job on the worker thread."""
        await asyncio.sleep(self.batch_window)
        members = self._groups.pop(key, [])
        if not members:
            return
        self.counters["batch_groups"] += 1
        self.counters["batched_members"] += len(members)
        self.counters["searches_run"] += len(members)
        try:
            plans, n_pred = await self._loop.run_in_executor(
                self._pool, self._compute_group, members, strategy, day)
            self.counters["predict_batches"] += n_pred
            for m, plan in zip(members, plans):
                m.future.set_result((plan, None))
        except Exception as e:
            for m in members:
                if not m.future.done():
                    m.future.set_result((None, e))

    def _compute_group(self, members: List[_Member], strategy: str,
                       day: int):
        """Worker-thread body: one shared context, one search per member.

        Bit-identical to running each member standalone — the context's
        stages 1-4 are per-conf independent and the per-member stage 5 is
        exactly ``run_search``'s (see BatchSearchContext).
        """
        reqs = [m.req for m in members]
        spec = reqs[0].spec
        bw = self._bandwidth(reqs[0], day)
        ctx = BatchSearchContext.for_requests(
            reqs, bw, estimator=self.estimator, mem_limit=spec.mem_floor,
            device=self.device)
        dedicate = strategy == "pipette"
        plans = []
        for m in members:
            res = ctx.search(m.req, dedicate=dedicate)
            plans.append(Plan.from_search(
                res, m.req, bw, strategy=strategy,
                estimator=self.estimator, lineage=m.lineage))
        return plans, ctx.n_predict_batches

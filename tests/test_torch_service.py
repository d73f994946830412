"""Planning as a service on the PyTorch package (``service/``).

The cases of the JAX package's ``tests/test_service.py`` on the port: wire
fingerprints, the plan cache, batched search contexts, warm-started
annealing, and the async plan server (cache-hit byte identity, in-flight
coalescing, request batching, structured admission).  Every server is
``PlanServer(device="cpu")`` and every search names ``device="cpu"``;
searches take the port's default torch backend (the warm-start gate also
the NumPy one).  Beside them: a plan served by the port
is byte-equal to the one the JAX package's server makes for the same
request once ``budget.backend`` is normalised, and ``device=None``
raises without a CUDA device.
"""
import contextlib
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from repro import core as r_core
from repro import service as r_service
from repro.models.config import ModelConfig as RModelConfig
from repro_torch.analysis import verify_plan_dict
from repro_torch.core import (MID_RANGE, BatchSearchContext, Budget, Plan,
                              Planner, PlanRequest, PipetteStrategy,
                              SearchSpace, Workload, mapping_to_perm,
                              profile_bandwidth, run_search)
from repro_torch.models.config import ModelConfig
from repro_torch.service import (AdmissionError, PlanCache, PlanClient,
                                 PlanServer, ServiceError, WireError,
                                 decode_plan_request, encode_plan_request,
                                 incumbent_perm, request_fingerprint,
                                 request_meta, workload_digest)
from repro_torch.service.wire import (spec_from_wire, spec_to_wire,
                                      workload_from_wire)

GPT_KW = dict(name="g", family="dense", n_layers=16, d_model=1024,
              n_heads=16, n_kv_heads=16, d_ff=4096, vocab_size=32000)
GPT = ModelConfig(**GPT_KW)
CPU = "cpu"
SPEC = MID_RANGE.with_nodes(1)                  # 8 GPUs: fast server tests
W = Workload(GPT, 2048, 32)
BUDGET = Budget(sa_seconds=60.0, sa_iters=40, sa_topk=2)
REQ = PlanRequest(workload=W, spec=SPEC, space=SearchSpace(max_micro=2),
                  budget=BUDGET, seed=7)
#: same workload, different microbatch cap — distance-0 neighbor of REQ
REQ_NEIGHBOR = dataclasses.replace(REQ, space=SearchSpace(max_micro=4))


@pytest.fixture(scope="module")
def bw():
    return profile_bandwidth(SPEC)[0]


@pytest.fixture(scope="module")
def cold_plan(bw):
    return Planner(PipetteStrategy(), device=CPU).plan(REQ, bw)


@contextlib.contextmanager
def running_server(**kw):
    server = PlanServer(port=0, device=CPU, **kw)
    thread = server.start_in_thread()
    try:
        yield server, PlanClient(port=server.port)
    finally:
        server.stop()
        thread.join(timeout=30)
        assert not thread.is_alive(), "plan server failed to shut down"


class CountingEstimator:
    """Duck-typed MemoryEstimator stub: deterministic per-conf rows,
    counts how many batched forwards were issued."""
    with_cp = True
    residual = False
    soft_margin = 1.05
    workload_seq = 2048
    fit_gpu_mem = 80.0
    fit_gpus_per_node = 8

    def __init__(self):
        self.batch_calls = 0

    def predict_batch(self, cfg, confs, device=None):
        self.batch_calls += 1
        return np.asarray([float(c.pp + c.tp) for c in confs])


# ---------------------------------------------------------------------------
# wire format + fingerprints
# ---------------------------------------------------------------------------

def test_wire_round_trip_preserves_the_typed_request():
    obj = encode_plan_request(REQ, strategy="exhaustive", day=3)
    req, strategy, day = decode_plan_request(obj)
    assert (strategy, day) == ("exhaustive", 3)
    assert req.workload == REQ.workload
    assert req.spec == REQ.spec
    assert req.space == REQ.space
    assert req.budget == REQ.budget
    assert req.seed == REQ.seed


def test_fingerprint_is_stable_and_covers_the_determinism_domain():
    fp = request_fingerprint(REQ, "pipette", 0)
    assert fp == request_fingerprint(REQ, "pipette", 0)
    variants = [
        request_fingerprint(REQ, "pipette", 1),
        request_fingerprint(REQ, "exhaustive", 0),
        request_fingerprint(dataclasses.replace(REQ, seed=8), "pipette", 0),
        request_fingerprint(REQ_NEIGHBOR, "pipette", 0),
        request_fingerprint(
            dataclasses.replace(REQ, budget=dataclasses.replace(
                BUDGET, sa_iters=41)), "pipette", 0),
        request_fingerprint(
            dataclasses.replace(REQ, budget=dataclasses.replace(
                BUDGET, warm_start=tuple(range(SPEC.n_gpus)))),
            "pipette", 0),
    ]
    assert len({fp, *variants}) == len(variants) + 1


def test_workload_digest_same_for_name_and_inline_config():
    from repro_torch import configs
    by_name = workload_from_wire(
        {"config": "qwen2-7b", "seq": 128, "bs_global": 8})
    inline = workload_from_wire(
        {"config": dataclasses.asdict(configs.get("qwen2-7b")),
         "seq": 128, "bs_global": 8})
    assert workload_digest(by_name) == workload_digest(inline)


def test_spec_wire_round_trip_and_preset_decoding():
    assert spec_from_wire(spec_to_wire(SPEC)) == SPEC
    preset = spec_from_wire({"preset": "mid-range", "nodes": 1})
    assert preset == SPEC
    with pytest.raises(WireError, match="unknown cluster preset"):
        spec_from_wire({"preset": "not-a-fleet"})


def test_decode_errors_are_typed():
    good = encode_plan_request(REQ)
    with pytest.raises(WireError, match="unknown strategy"):
        decode_plan_request({**good, "strategy": "nope"})
    bad_spec = {**good, "cluster": {**good["cluster"], "n_nodes": 0}}
    with pytest.raises(AdmissionError, match="n_nodes"):
        decode_plan_request(bad_spec)


def test_incumbent_perm_extracts_a_gpu_permutation(cold_plan):
    perm = incumbent_perm(json.loads(cold_plan.to_json()))
    assert perm is not None and perm.shape == (SPEC.n_gpus,)
    assert np.array_equal(np.sort(perm), np.arange(SPEC.n_gpus))
    assert np.array_equal(perm, mapping_to_perm(cold_plan.mapping))
    assert incumbent_perm({"best": None}) is None
    assert incumbent_perm({"best": {"mapping": {"oops": 1}}}) is None


# ---------------------------------------------------------------------------
# plan cache
# ---------------------------------------------------------------------------

def _meta(fp, seq=2048, cluster="c", strategy="pipette", day=0,
          feasible=True):
    return {"fingerprint": fp, "cluster_digest": cluster,
            "strategy": strategy, "day": day, "seq": seq, "bs_global": 32,
            "d_model": 1024, "n_layers": 16, "feasible": feasible}


def test_cache_hits_return_the_exact_bytes_and_lru_evicts():
    cache = PlanCache(max_entries=2)
    cache.put("a", _meta("a"), '{"plan": "a"}\n')
    cache.put("b", _meta("b"), '{"plan": "b"}\n')
    assert cache.get("a") == '{"plan": "a"}\n'
    cache.put("c", _meta("c"), '{"plan": "c"}\n')   # evicts b (LRU)
    assert cache.get("b") is None
    assert cache.get("a") == '{"plan": "a"}\n'
    assert cache.counters["lru_evictions"] == 1
    assert cache.stats()["memory_entries"] == 2


def test_cache_persists_to_disk_and_survives_a_restart(tmp_path):
    first = PlanCache(tmp_path / "plans")
    first.put("a" * 64, _meta("a" * 64), '{"plan": 1}\n')
    reborn = PlanCache(tmp_path / "plans")
    assert reborn.get("a" * 64) == '{"plan": 1}\n'
    assert reborn.stats()["disk_entries"] == 1
    assert reborn.evict("a" * 64) is True
    assert reborn.get("a" * 64) is None
    assert not list((tmp_path / "plans").glob("*.json"))


def test_cache_drops_corrupt_disk_entries(tmp_path):
    cache = PlanCache(tmp_path / "plans")
    cache.put("a" * 64, _meta("a" * 64), '{"plan": 1}\n')
    (tmp_path / "plans" / (("a" * 64) + ".plan.json")).write_text("{oops")
    reborn = PlanCache(tmp_path / "plans")
    assert reborn.get("a" * 64) is None
    assert reborn.counters["corrupt_dropped"] == 1
    # both the entry and its sidecar are gone, not served
    assert not list((tmp_path / "plans").glob("*.json"))


def test_cache_nearest_neighbor_lookup_is_scoped_and_deterministic():
    cache = PlanCache()
    cache.put("same", _meta("same", seq=2048), "{}")
    cache.put("far", _meta("far", seq=4096), "{}")
    cache.put("alien", _meta("alien", seq=2048, cluster="other"), "{}")
    cache.put("oom", _meta("oom", seq=2048, feasible=False), "{}")
    cache.put("later", _meta("later", seq=2048, day=1), "{}")
    query = _meta("query", seq=2048)

    fp, dist = cache.nearest(query, exclude="query")
    assert (fp, dist) == ("same", 0.0)
    fp, dist = cache.nearest(query, exclude="same")
    assert fp == "far" and dist == pytest.approx(np.log(2.0))
    assert cache.nearest(query, exclude="same", max_distance=0.5) is None
    # ties break lexicographically by fingerprint
    cache.put("also-same", _meta("also-same", seq=2048), "{}")
    fp, _ = cache.nearest(query, exclude="query")
    assert fp == "also-same"


def test_cache_nearest_accepts_previous_day_across_midnight():
    """Warm-start eligibility accepts the previous day, so a replan at
    00:01 may seed from an incumbent cached at 23:59 (interconnect drift is
    gradual and the seed only sets a starting point); anything older — or
    from the future — is still rejected, and same-day neighbors win ties
    over previous-day ones."""
    cache = PlanCache()
    cache.put("yesterday", _meta("yesterday", day=6), "{}")
    cache.put("two-days-old", _meta("two-days-old", day=5), "{}")
    cache.put("tomorrow", _meta("tomorrow", day=8), "{}")
    query = _meta("query", day=7)
    fp, dist = cache.nearest(query, exclude="query")
    assert (fp, dist) == ("yesterday", 0.0)
    # a same-day neighbor at equal distance beats the previous-day one,
    # even when the previous-day fingerprint sorts first
    cache.put("z-today", _meta("z-today", day=7), "{}")
    fp, _ = cache.nearest(query, exclude="query")
    assert fp == "z-today"
    # with only stale/future entries there is no warm-start source
    lonely = PlanCache()
    lonely.put("two-days-old", _meta("two-days-old", day=5), "{}")
    lonely.put("tomorrow", _meta("tomorrow", day=8), "{}")
    assert lonely.nearest(query, exclude="query") is None


# ---------------------------------------------------------------------------
# batched search contexts (N requests, one enumerate/predict_batch pass)
# ---------------------------------------------------------------------------

def test_batch_context_is_bit_identical_to_standalone_searches(bw):
    reqs = [REQ, dataclasses.replace(REQ_NEIGHBOR, seed=11)]
    mem_limit = 4.2                     # prunes high pp+tp rows of the stub

    est_batch = CountingEstimator()
    ctx = BatchSearchContext.for_requests(reqs, bw, estimator=est_batch,
                                          mem_limit=mem_limit, device=CPU)
    est_solo = CountingEstimator()
    for req in reqs:
        batched = Plan.from_search(ctx.search(req), req, bw,
                                   strategy="pipette", estimator=est_batch)
        solo = Planner(PipetteStrategy(
            estimator=est_solo, mem_limit=mem_limit),
            device=CPU).plan(req, bw)
        assert batched.to_json() == solo.to_json()
    # the whole group shared ONE batched predict_batch forward
    assert ctx.n_predict_batches == 1
    assert est_batch.batch_calls == 1
    assert est_solo.batch_calls == len(reqs)


def test_batch_context_rejects_incompatible_requests(bw):
    ctx = BatchSearchContext.for_requests([REQ], bw, device=CPU)
    other_workload = dataclasses.replace(
        REQ, workload=Workload(GPT, 4096, 32))
    with pytest.raises(ValueError, match="workload/cluster"):
        ctx.search(other_workload)
    with pytest.raises(ValueError, match="exceeds the"):
        ctx.search(REQ_NEIGHBOR)        # max_micro=4 over the union cap 2
    with pytest.raises(ValueError, match="shape knobs"):
        BatchSearchContext.for_requests(
            [REQ, dataclasses.replace(REQ, space=SearchSpace(
                max_micro=2, max_cp=2))], bw, device=CPU)


# ---------------------------------------------------------------------------
# warm-started annealing
# ---------------------------------------------------------------------------

def test_budget_warm_start_must_be_a_permutation():
    with pytest.raises(ValueError, match="permutation"):
        Budget(warm_start=(0, 2))
    assert Budget(warm_start=[1, 0]).warm_start == (1, 0)


def test_run_search_rejects_a_wrong_sized_warm_start(bw):
    bad = dataclasses.replace(
        REQ, budget=dataclasses.replace(BUDGET, warm_start=(1, 0)))
    with pytest.raises(ValueError, match="warm_start"):
        run_search(bad, bw, device=CPU)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_warm_start_is_never_worse_and_spends_fewer_accepted_moves(backend):
    """The acceptance gate: seeded from a cached neighbor's incumbent, SA
    reaches a plan at least as good as the cold search's while accepting
    strictly fewer improving moves (or landing on the identical best)."""
    spec = MID_RANGE.with_nodes(2)      # heterogeneous enough that SA works
    bw2 = profile_bandwidth(spec)[0]
    seed_req = PlanRequest(
        workload=W, spec=spec, space=SearchSpace(max_micro=2),
        budget=Budget(sa_seconds=60.0, sa_iters=80, sa_topk=2,
                      backend=backend), seed=7)
    incumbent = run_search(seed_req, bw2, device=CPU)
    perm = tuple(int(x) for x in mapping_to_perm(incumbent.best.mapping))

    neighbor = dataclasses.replace(seed_req, space=SearchSpace(max_micro=4))
    cold = run_search(neighbor, bw2, device=CPU)
    warm = run_search(dataclasses.replace(
        neighbor, budget=dataclasses.replace(
            neighbor.budget, warm_start=perm)), bw2, device=CPU)

    assert warm.best.latency <= cold.best.latency
    same_best = (warm.best.conf == cold.best.conf
                 and np.array_equal(warm.best.mapping, cold.best.mapping))
    assert (warm.overhead.sa_accepted_to_best
            < cold.overhead.sa_accepted_to_best) or same_best


def test_warm_started_plan_records_the_budget_and_lineage(bw, cold_plan):
    perm = tuple(int(x) for x in mapping_to_perm(cold_plan.mapping))
    warm_req = dataclasses.replace(
        REQ_NEIGHBOR, budget=dataclasses.replace(BUDGET, warm_start=perm))
    lineage = {"warm_start_from": "f" * 64, "distance": 0.0}
    plan = Planner(PipetteStrategy(), device=CPU).plan(warm_req, bw,
                                                       lineage=lineage)
    d = plan.to_json_dict()
    assert d["provenance"]["budget"]["warm_start"] == list(perm)
    assert d["provenance"]["lineage"] == lineage
    # and it round-trips
    assert Plan.from_json_dict(d).provenance.lineage == lineage


# ---------------------------------------------------------------------------
# the plan server
# ---------------------------------------------------------------------------

def test_server_cache_hit_is_byte_identical_and_runs_no_search():
    with running_server(warm_start=False) as (server, client):
        assert client.ping() is True
        first = client.submit(REQ)
        again = client.submit(REQ)
    assert first["meta"]["cache"] == "miss"
    assert again["meta"]["cache"] == "hit"
    assert again["plan"] == first["plan"]
    assert first["meta"]["fingerprint"] == request_meta(
        REQ, "pipette", 0)["fingerprint"]
    # the Overhead proof: exactly one search ever ran
    assert server.counters["searches_run"] == 1
    assert server.counters["cache_hits"] == 1
    assert server.counters["requests"] == 2


def test_server_coalesces_identical_concurrent_requests(cold_plan):
    release, started, calls = threading.Event(), threading.Event(), []

    def plan_fn(req, strategy, day, lineage):
        calls.append((strategy, day))
        started.set()
        assert release.wait(timeout=30)
        return cold_plan

    with running_server(plan_fn=plan_fn, warm_start=False) as \
            (server, client):
        results = []
        worker = threading.Thread(
            target=lambda: results.extend(client.submit_many([REQ] * 3)))
        worker.start()
        assert started.wait(timeout=30)
        # all three are in the house and two of them are waiting on the
        # first one's in-flight future — no second search was started
        stats = PlanClient(port=server.port).stats()
        assert stats["coalesced"] == 2
        assert stats["searches_run"] == 1
        release.set()
        worker.join(timeout=60)
        assert not worker.is_alive()

    assert len(calls) == 1
    assert [r["meta"]["cache"] for r in results] == \
        ["miss", "coalesced", "coalesced"]
    assert len({r["plan"] for r in results}) == 1


def test_server_batches_near_identical_requests_through_one_context(bw):
    est = CountingEstimator()
    with running_server(batch_window=0.5, estimator=est,
                        warm_start=False) as (server, client):
        first, second = client.submit_many([REQ, REQ_NEIGHBOR])
        stats = client.stats()

    assert [r["meta"]["cache"] for r in (first, second)] == ["miss", "miss"]
    assert stats["batch_groups"] == 1
    assert stats["batched_members"] == 2
    assert stats["searches_run"] == 2
    # ONE predict_batch forward served both members ...
    assert stats["predict_batches"] == 1
    assert est.batch_calls == 1
    # ... and each member's plan is byte-identical to its standalone search
    solo_est = CountingEstimator()
    for req, resp in ((REQ, first), (REQ_NEIGHBOR, second)):
        solo = Planner(PipetteStrategy(
            estimator=solo_est, mem_limit=SPEC.mem_floor),
            device=CPU).plan(req, bw)
        assert resp["plan"] == solo.to_json()


def test_server_warm_starts_from_the_nearest_cached_neighbor():
    with running_server() as (server, client):
        seeded = client.submit(REQ)
        warmed = client.submit(REQ_NEIGHBOR)
        entries = client.cache_ls()
        stats = client.stats()

    seed_fp = seeded["meta"]["fingerprint"]
    assert warmed["meta"]["cache"] == "miss"
    assert warmed["meta"]["warm_start_from"] == seed_fp
    assert stats["warm_starts"] == 1

    plan = json.loads(warmed["plan"])
    assert plan["provenance"]["lineage"] == \
        {"warm_start_from": seed_fp, "distance": 0.0}
    perm = plan["provenance"]["budget"]["warm_start"]
    assert sorted(perm) == list(range(SPEC.n_gpus))
    by_fp = {e["fingerprint"]: e for e in entries}
    assert by_fp[seed_fp]["warm_started"] is False
    assert by_fp[warmed["meta"]["fingerprint"]]["warm_started"] is True


def test_server_rejects_an_invalid_cluster_with_a_structured_error():
    with running_server(warm_start=False) as (server, client):
        good = encode_plan_request(REQ)
        bad = {**good, "cluster": {**good["cluster"], "n_nodes": 0}}
        resp = client.request(bad)
        with pytest.raises(ServiceError, match="unknown strategy") as ei:
            client._checked(client.request({**good, "strategy": "nope"}))
    assert resp["ok"] is False
    assert resp["error"]["code"] == "admission"
    assert "n_nodes" in resp["error"]["message"]
    assert ei.value.code == "bad-request"
    assert server.counters["admission_rejects"] == 1
    assert server.counters["bad_requests"] == 1
    assert server.counters["searches_run"] == 0


def test_server_evicts_bad_cache_entries_and_recomputes(cold_plan):
    with running_server(warm_start=False) as (server, client):
        first = client.submit(REQ)
        fp = first["meta"]["fingerprint"]
        # poison the entry: valid JSON, but not a servable plan — the
        # admission verifier must catch it and fall back to a cold search
        server.cache.put(fp, _meta(fp), json.dumps({"version": 1}) + "\n")
        again = client.submit(REQ)
        assert client.cache_evict(fp) is True
        third = client.submit(REQ)

    assert again["meta"]["cache"] == "miss"
    assert again["plan"] == first["plan"]
    assert server.counters["cache_invalid"] == 1
    # evict -> cold search again; byte-identical by determinism
    assert third["meta"]["cache"] == "miss"
    assert third["plan"] == first["plan"]
    assert server.counters["searches_run"] == 3


def test_server_persistent_cache_survives_restart_and_corruption(tmp_path):
    cache_dir = tmp_path / "plans"
    with running_server(cache_dir=cache_dir, warm_start=False) as \
            (server, client):
        first = client.submit(REQ)
        fp = first["meta"]["fingerprint"]

    # a fresh server on the same directory serves from disk, no search
    with running_server(cache_dir=cache_dir, warm_start=False) as \
            (server2, client2):
        again = client2.submit(REQ)
        assert again["meta"]["cache"] == "hit"
        assert again["plan"] == first["plan"]
        assert server2.counters["searches_run"] == 0

    # corrupt the artifact on disk: dropped, recomputed cold, identical
    (cache_dir / f"{fp}.plan.json").write_text("{oops")
    with running_server(cache_dir=cache_dir, warm_start=False) as \
            (server3, client3):
        recomputed = client3.submit(REQ)
        assert recomputed["meta"]["cache"] == "miss"
        assert recomputed["plan"] == first["plan"]
        assert server3.counters["searches_run"] == 1
        assert server3.cache.counters["corrupt_dropped"] == 1


# ---------------------------------------------------------------------------
# CLI plumbing
# ---------------------------------------------------------------------------

def test_cli_parser_covers_the_service_surface():
    from repro_torch.service.__main__ import build_parser
    parser = build_parser()
    serve = parser.parse_args(["serve", "--port-file", "p", "--batch-window",
                               "0.1"])
    assert serve.batch_window == 0.1
    submit = parser.parse_args(
        ["submit", "--port", "1", "--config", "qwen2-7b", "--reduced",
         "--cluster", "mid-range", "--nodes", "1", "--strategy",
         "exhaustive"])
    assert (submit.config, submit.strategy) == ("qwen2-7b", "exhaustive")
    evict = parser.parse_args(["cache", "evict", "f" * 64, "--port", "1"])
    assert evict.fingerprint == "f" * 64
    assert serve.device == "cuda" and submit.backend == "torch"
    assert parser.parse_args(["serve", "--device", "cpu"]).device == CPU
    assert parser.parse_args(["submit", "--config", "qwen2-7b",
                              "--backend", "numpy"]).backend == "numpy"


# ---------------------------------------------------------------------------
# the port against the JAX package's server, and the device rule
# ---------------------------------------------------------------------------

def _normalised(text):
    d = json.loads(text)
    d["provenance"]["budget"].pop("backend")
    return json.dumps(d, sort_keys=True)


def test_served_plan_is_byte_equal_to_the_reference_servers():
    """One request through the port's server on its torch backend and
    through the JAX package's server on its NumPy backend: the same plan,
    byte for byte once ``budget.backend`` is dropped, which the port's
    verifier passes against the live spec."""
    r_spec = r_core.MID_RANGE.with_nodes(1)
    r_req = r_core.PlanRequest(
        workload=r_core.Workload(RModelConfig(**GPT_KW), 2048, 32),
        spec=r_spec, space=r_core.SearchSpace(max_micro=2),
        budget=r_core.Budget(sa_seconds=60.0, sa_iters=40, sa_topk=2,
                             backend="numpy"), seed=7)
    r_server = r_service.PlanServer(port=0, warm_start=False)
    thread = r_server.start_in_thread()
    try:
        want = r_service.PlanClient(port=r_server.port).submit(r_req)
    finally:
        r_server.stop()
        thread.join(timeout=30)
    assert REQ.budget.backend == "torch"
    with running_server(warm_start=False) as (server, client):
        got = client.submit(REQ)
    assert json.loads(got["plan"])["provenance"]["budget"]["backend"] \
        == "torch"
    assert _normalised(got["plan"]) == _normalised(want["plan"])
    assert not [i for i in verify_plan_dict(json.loads(got["plan"]),
                                            spec=SPEC)
                if i.severity == "error"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is "
                    "present; the no-device error cannot show")
def test_server_and_cli_need_a_device_or_the_cpu_named(tmp_path):
    from repro_torch.service.__main__ import main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PlanServer(port=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["serve", "--port-file", str(tmp_path / "port")])
    assert not (tmp_path / "port").exists()

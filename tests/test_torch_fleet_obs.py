"""The port's fleet observability plane (``obs/fleet_obs.py``) and its
HTTP surface on the port's router, mirroring the ``tests/test_fleet_obs.py``
tests whose surface is ported.

Pure parity with the reference's ``obs/fleet_obs.py`` on the same event
sequences (drawn with numpy from a seed): the journal's payloads, paging,
replay and rare-kind retention; ``RouterTimeline`` records under an
injected clock; the flight recorder's retention. Over HTTP (tiny f32
port replicas on the CPU, one stream killed by the seeded
``router.midstream`` fault and resumed): ``/fleet/events``' schema,
order and determinism across two same-seed runs; ``/fleet/debug/requests``
whose integer-ns segments sum to the wall time; timelines off; the
router's ``/debug/traces`` query surface and span attributes;
``/fleet/health`` through ``fleet_stats``; ``/metrics`` (``gpu_router_*``);
``/fleet/metrics`` and ``/fleet/debug/traces/{id}`` answering over an
unreachable replica, and ``--plugins`` (refused naming ROADMAP A.14).
"""

import asyncio
import time

import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families

from k8s_gpu_device_plugin_torch.obs import fleet_obs as tobs
from k8s_gpu_device_plugin_torch.obs.trace import configure
from k8s_gpu_device_plugin_torch.serving import async_http
from k8s_gpu_device_plugin_torch.serving import router as trouter
from k8s_gpu_device_plugin_torch.serving.faults import FaultPlane
from k8s_gpu_device_plugin_torch.serving.fleet import FleetRegistry
from k8s_gpu_device_plugin_torch.serving.testing import (
    get_json,
    inprocess_fleet,
    per_replica_registry_factories,
    post_json,
    stream_generate,
)
from k8s_gpu_device_plugin_tpu.obs import fleet_obs as jobs
from tests.test_torch_router import (  # noqa: F401 - the module fixture
    BUCKETS,
    ENGINE_KW,
    model,
    run,
)

KINDS = ["failover", "cooldown_429", "drain", "promote", "stream_resume",
         "kv_transfer", "undrain"]


@pytest.fixture()
def tracer():
    t = configure(enabled=True)
    t.clear()
    yield t
    configure(enabled=False)
    t.clear()


# --- pure parity -------------------------------------------------------------


@pytest.mark.parametrize("maxlen,rare", [(4, 2), (8, 4), (64, 16)])
def test_journal_payloads_paging_and_replay_match_the_reference(maxlen,
                                                                rare):
    rng = np.random.default_rng(maxlen)
    t = tobs.FleetEventJournal(maxlen=maxlen, rare_maxlen=rare)
    j = jobs.FleetEventJournal(maxlen=maxlen, rare_maxlen=rare)
    for i in range(150):
        kind = KINDS[int(rng.integers(0, len(KINDS)))]
        fields = {"replica": f"r{int(rng.integers(0, 3))}", "attempt": i}
        et, ej = t.emit(kind, **fields), j.emit(kind, **fields)
        assert tobs.FleetEventJournal.replay([et]) == \
            jobs.FleetEventJournal.replay([ej])
        assert et["trace_id"] == ej["trace_id"] == ""
    for limit in (None, 0, 1, 3, 1000):
        for since in (None, 0, 75, 149, 150):
            pt = t.events_payload(limit=limit, since=since)
            pj = j.events_payload(limit=limit, since=since)
            assert (pt["total"], pt["returned"]) == \
                (pj["total"], pj["returned"])
            assert tobs.FleetEventJournal.replay(pt["events"]) == \
                jobs.FleetEventJournal.replay(pj["events"])
    assert t.stats() == j.stats()
    assert t.NONDETERMINISTIC_FIELDS == j.NONDETERMINISTIC_FIELDS
    assert t.FREQUENT_KINDS == j.FREQUENT_KINDS


def test_journal_rare_events_survive_request_rate_floods():
    j = tobs.FleetEventJournal(maxlen=8, rare_maxlen=4)
    j.emit("promote", promoted="r2", replaced="r0")
    j.emit("stream_resume", source="r0", target="r1", tokens_at_death=3)
    for _ in range(100):
        j.emit("cooldown_429", replica="r0", retry_after_s=1.0)
        j.emit("failover", replica="r1", attempt=1)
    payload = j.events_payload()
    assert {"promote", "stream_resume"} <= {e["kind"]
                                            for e in payload["events"]}
    seqs = [e["seq"] for e in payload["events"]]
    assert seqs == sorted(seqs) and seqs[:2] == [1, 2]
    assert payload["total"] == 202
    page = j.events_payload(since=1, limit=1)
    assert [e["kind"] for e in page["events"]] == ["stream_resume"]


class Clock:
    """``perf_counter_ns`` and ``time`` stepping by a seeded amount."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.ns = 10**9

    def perf_counter_ns(self):
        self.ns += int(self.rng.integers(1, 10**7))
        return self.ns

    def time(self):
        return 1.7e9 + self.ns / 1e9


def _timelines(mod, seed, monkeypatch):
    clock = Clock(seed)
    monkeypatch.setattr(time, "perf_counter_ns", clock.perf_counter_ns)
    monkeypatch.setattr(time, "time", clock.time)
    rng = np.random.default_rng(seed)
    rec = mod.RouterFlightRecorder(recent=6, ring=3, slow_ms=30.0)
    for i in range(20):
        tl = rec.start("/v1/generate", trace_id=f"{i:032x}")
        for _ in range(int(rng.integers(0, 4))):
            tl.relay_on(f"r{int(rng.integers(0, 2))}")
            if rng.integers(0, 2):
                tl.advance("resume_gap")
                tl.resumes += 1
            if rng.integers(0, 3) == 0:
                tl.advance("transfer_gap")
        tl.failovers = int(rng.integers(0, 2))
        tl.tokens = int(rng.integers(0, 9))
        if rng.integers(0, 5) == 0:
            tl.error_code = "resume_failed"
        record = tl.finalize(["ok", "resumed", "refused"][i % 3], 200)
        assert sum(d for _, _, d in record["segments"]) == record["total_ns"]
        assert sum(record["phases"].values()) == record["total_ns"]
        rec.on_done(record)
    return rec


def test_timelines_and_flight_recorder_match_the_reference(monkeypatch):
    t = _timelines(tobs, 4, monkeypatch)
    j = _timelines(jobs, 4, monkeypatch)
    assert t.request_stats() == j.request_stats()
    assert t.stats() == j.stats()
    assert t.resume_gap_ms() == j.resume_gap_ms()
    for rid in (1, 5, 19, 20, 99):
        assert t.get(rid) == j.get(rid)
    assert t.request_stats()["retained"] > 0


def test_flight_recorder_retention_policy():
    rec = tobs.RouterFlightRecorder(recent=8, ring=4, slow_ms=0.0)
    fast = rec.start("/v1/generate").finalize("ok", 200)
    rec.on_done(fast)
    resumed_tl = rec.start("/v1/generate")
    resumed_tl.resumes = 1
    resumed = resumed_tl.finalize("resumed", 200)
    rec.on_done(resumed)
    stats = rec.request_stats()
    assert stats["completed"] == 2 and stats["retained"] == 1
    assert [r["rid"] for r in stats["retained_requests"]] == [resumed["rid"]]
    assert rec.get(fast["rid"])["outcome"] == "ok"
    assert rec.get(resumed["rid"])["retained"] is True
    assert rec.get(10_000) is None


# --- over HTTP -----------------------------------------------------------------


async def _resumed_stream(model, check, seed, router_kw=None):
    """Two port replicas (each with its own registry), rr, the seeded
    ``router.midstream:nth=2`` fault: one streamed request dies on its
    second frame and resumes. ``check(ctx, events)`` then runs."""
    cfg, params = model
    engine_factory, server_factory = per_replica_registry_factories(
        params, cfg, **ENGINE_KW)
    prompt = [int(seed) + t for t in range(1, 9)]
    async with inprocess_fleet(
        params, cfg, n_replicas=2, device="cpu",
        engine_factory=engine_factory, server_factory=server_factory,
        router_kw={"policy": "rr", "health_interval_s": 0.1,
                   "prompt_buckets": BUCKETS,
                   "faults": FaultPlane.from_spec("router.midstream:nth=2"),
                   **(router_kw or {})},
    ) as ctx:
        stream = await stream_generate(ctx.base, prompt=prompt, max_new=8)
        assert stream["done"] and len(stream["tokens"]) == 8
        await check(ctx, ctx.router.journal.events_payload()["events"])


def test_fleet_events_schema_ordering_and_determinism(model):
    replays = []

    async def check(ctx, events):
        base = ctx.base
        assert [e["seq"] for e in events] == list(range(1, len(events) + 1))
        (evt,) = [e for e in events if e["kind"] == "stream_resume"]
        assert set(evt) >= {"seq", "kind", "t", "trace_id", "source",
                            "target", "tokens_at_death"}
        assert evt["source"] != evt["target"]
        assert evt["tokens_at_death"] == 2  # nth=2: died on frame 2
        s, page = await get_json(f"{base}/fleet/events?limit=1")
        assert page["returned"] == 1 and page["total"] == len(events)
        s, tail = await get_json(f"{base}/fleet/events?since={evt['seq'] - 1}")
        assert tail["events"][0]["seq"] == evt["seq"]
        for bad in ("limit=x", "limit=-1", "since=nope"):
            s, err = await get_json(f"{base}/fleet/events?{bad}")
            assert s == 400
        assert "event seq" in err["error"]
        replays.append(tobs.FleetEventJournal.replay(events))

    run(_resumed_stream(model, check, seed=31))
    run(_resumed_stream(model, check, seed=31))
    assert replays[0] == replays[1]


def test_router_timeline_http_surface_and_wall_sum(model):
    async def check(ctx, events):
        base = ctx.base
        s, stats = await get_json(f"{base}/fleet/debug/requests")
        assert s == 200
        (tl,) = [t for t in stats["retained_requests"] if t["resumes"]]
        assert sum(d for _, _, d in tl["segments"]) == tl["total_ns"]
        assert sum(tl["phases"].values()) == tl["total_ns"]
        assert tl["resume_gap_ns"] > 0 and tl["outcome"] == "resumed"
        assert len(set(tl["replicas"])) == 2 and tl["tokens"] == 8
        s, one = await get_json(f"{base}/fleet/debug/requests/{tl['rid']}")
        assert s == 200 and one["rid"] == tl["rid"]
        s, _ = await get_json(f"{base}/fleet/debug/requests/zz")
        assert s == 400
        s, _ = await get_json(f"{base}/fleet/debug/requests/999999")
        assert s == 404

    run(_resumed_stream(model, check, seed=33))


def test_timelines_off_disables_surface(model):
    cfg, params = model

    async def body():
        async with inprocess_fleet(
                params, cfg, n_replicas=1, device="cpu", engine_kw=ENGINE_KW,
                router_kw={"timelines": False, "health_interval_s": 0.2,
                           "prompt_buckets": BUCKETS}) as ctx:
            s, _, _ = await post_json(f"{ctx.base}/v1/generate",
                                      {"prompt": [1, 2, 3, 4], "max_new": 2})
            assert s == 200
            s, _ = await get_json(f"{ctx.base}/fleet/debug/requests")
            assert s == 404
            s, _ = await get_json(f"{ctx.base}/fleet/debug/requests/1")
            assert s == 404
            assert ctx.router.router_stats()["timelines"] is None

    run(body())


def test_router_debug_traces_surface_and_span_attrs(model, tracer):
    async def check(ctx, events):
        base = ctx.base
        await asyncio.sleep(0.2)
        s, full = await get_json(f"{base}/debug/traces")
        assert s == 200 and full["total"] >= 1
        s, page = await get_json(f"{base}/debug/traces?limit=1")
        assert page["returned"] == 1 and page["total"] >= full["total"]
        cutoff = full["traces"][-1]["start_us"]
        s, newer = await get_json(f"{base}/debug/traces?since={cutoff}")
        assert all(t["start_us"] > cutoff for t in newer["traces"])
        for bad in ("limit=x", "limit=-1", "since=nope"):
            s, _ = await get_json(f"{base}/debug/traces?{bad}")
            assert s == 400
        tid = full["traces"][0]["trace_id"]
        s, doc = await get_json(f"{base}/debug/traces/{tid}")
        assert s == 200 and "traceEvents" in doc
        s, _ = await get_json(f"{base}/debug/traces/{'0' * 32}")
        assert s == 404
        spans = [sp for t in ctx.router.tracer._finished
                 for sp in t["spans"] if sp["component"] == "router_http"
                 and sp["name"].startswith("POST /v1/generate")]
        resumed = next(sp for sp in spans if sp["attrs"].get("resumed"))
        assert resumed["attrs"]["replica"] in ("r0", "r1")
        assert "affinity_hit" in resumed["attrs"]
        # the replicas' serving_http spans carry their fleet identity
        # and join the router's trace through traceparent
        served = [sp for t in ctx.router.tracer._finished
                  for sp in t["spans"] if sp["component"] == "serving_http"
                  and sp["attrs"].get("path") == "/v1/generate"]
        assert {sp["attrs"]["replica"] for sp in served} == {"r0", "r1"}
        assert {sp["trace_id"] for sp in served} <= \
            {sp["trace_id"] for sp in spans}

    run(_resumed_stream(model, check, seed=34))


def test_fleet_health_reads_through_fleet_stats_and_metrics(model):
    cfg, params = model

    async def body():
        from k8s_gpu_device_plugin_torch.metrics.exposition import Registry

        registry = Registry()
        async with inprocess_fleet(
                params, cfg, n_replicas=2, device="cpu", engine_kw=ENGINE_KW,
                router_kw={"health_interval_s": 0.1, "prompt_buckets": BUCKETS,
                           "registry": registry,
                           "metrics": trouter.RouterMetrics(registry)}) \
                as ctx:
            snap = ctx.router.fleet_stats()
            assert snap["admitting"] == 2
            assert "journal" in snap["router"]
            assert "timelines" in snap["router"]
            s, fh = await get_json(f"{ctx.base}/fleet/health")
            assert fh["admitting"] == 2 and set(fh["replicas"]) == {"r0",
                                                                   "r1"}
            s, _, _ = await post_json(f"{ctx.base}/v1/generate",
                                      {"prompt": [1, 2, 3], "max_new": 2})
            assert s == 200
            status, headers, text = await async_http.fetch(
                "GET", f"{ctx.base}/metrics", timeout_s=5)
            assert status == 200
            fams = {f.name: f for f in text_string_to_metric_families(
                text.decode())}
            assert {"gpu_router_requests", "gpu_router_affinity_hits",
                    "gpu_router_failovers", "gpu_router_promotions",
                    "gpu_router_stream_resumes", "gpu_router_kv_transfers",
                    "gpu_router_inflight", "gpu_router_replica_up"} <= \
                set(fams)
            assert fams["gpu_router_requests"].type == "counter"
            assert fams["gpu_router_inflight"].type == "gauge"
            ok = [s for s in fams["gpu_router_requests"].samples
                  if s.name == "gpu_router_requests_total"]
            assert sum(s.value for s in ok) == 1
            assert set(ok[0].labels) == {"replica", "outcome"}
            s, h = await get_json(f"{ctx.base}/v1/health")
            assert s == 200 and h["admitting"] == 2
            ctx.fleet.get("r0").draining = True
            ctx.fleet.get("r1").draining = True
            s, h = await get_json(f"{ctx.base}/v1/health")
            assert s == 503 and h["admitting"] == 0

    run(body())


def test_fleet_routes_served_and_plugins_refused(capsys):
    """``GET /fleet/metrics`` and ``GET /fleet/debug/traces/{id}`` answer
    over a fleet whose one replica is unreachable (a federation of none
    with one scrape error; a 404 naming the unreachable replica);
    ``--plugins`` is refused at startup naming ROADMAP A.14 (the device
    plugin). The refusal flips when that item lands."""
    fleet_reg = FleetRegistry.from_spec("a=http://127.0.0.1:1")
    with pytest.raises(ValueError, match="A.14"):
        trouter.ReplicaRouter(fleet_reg, prompt_buckets=BUCKETS,
                              plugins=[("n0", "http://127.0.0.1:2")])
    assert trouter._main(["--replicas", "a=http://127.0.0.1:1",
                          "--plugins", "n0=http://127.0.0.1:2"]) == 2
    assert "ROADMAP A.14" in capsys.readouterr().err

    async def body():
        router = trouter.ReplicaRouter(
            FleetRegistry.from_spec("a=http://127.0.0.1:1"),
            host="127.0.0.1", port=0, health_interval_s=60.0,
            prompt_buckets=BUCKETS)
        stop = asyncio.Event()
        task = asyncio.create_task(router.run(stop))
        while router.bound_port is None:
            await asyncio.sleep(0.01)
        try:
            base = f"http://127.0.0.1:{router.bound_port}"
            s, body = await get_json(f"{base}/fleet/debug/traces/{'a' * 32}")
            assert s == 404 and body["unreachable"] == ["a"]
            status, _, text = await async_http.fetch(
                "GET", f"{base}/fleet/metrics", timeout_s=30)
            fams = {f.name: f for f in text_string_to_metric_families(
                text.decode())}
            assert status == 200
            assert fams["gpu_fleet_replicas"].samples[0].value == 0
            assert fams["gpu_fleet_scrape_errors"].samples[0].value == 1
        finally:
            stop.set()
            await asyncio.wait_for(task, 30)

    run(body())

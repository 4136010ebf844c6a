"""The fleet's read-only surfaces: metrics federation and cross-replica
trace stitching (``obs/fleet_obs.py``, ``obs/export.py``, the router's
``GET /fleet/metrics`` and ``GET /fleet/debug/traces/{id}``).

Pure parity with the reference on the same inputs, drawn with numpy from
a seed:

- ``federate_metrics``: replica expositions rendered by the port's
  ``ServingMetrics`` (classic and OpenMetrics, exemplars included),
  federated by both packages; the reference reads them under its
  ``tpu_serving_`` names, and its output, mapped back to ``gpu_``, must
  equal the port's text exactly. The OpenMetrics output parses under
  ``prometheus_client``'s strict parser. Escaped replica ids, the
  weighted MFU, summed histograms and an idle fleet (0, not NaN).
- ``spans_from_chrome``, ``stitch_spans``, ``stitched_trace_payload`` and
  ``to_fleet_chrome_trace``: equal to the reference's on random span
  forests with duplicates, orphans and spans without an id.

Over HTTP (two tiny f32 port replicas on the CPU behind the port's
router, tracing on): a streamed request's stitched trace holds a router
track and the serving replica's, with no orphans; ``/fleet/metrics``
lists every replica's series under its ``replica`` label in both
formats; after one replica is killed the trace reports it unreachable
and federation counts a scrape error; an unknown trace answers 404. The
device plugin's federation is refused naming ROADMAP A.14.
"""

import asyncio

import numpy as np
import pytest
from prometheus_client.openmetrics.parser import (
    text_string_to_metric_families as om_families,
)
from prometheus_client.parser import text_string_to_metric_families

from k8s_gpu_device_plugin_torch.metrics.exposition import Registry
from k8s_gpu_device_plugin_torch.metrics.serving_metrics import ServingMetrics
from k8s_gpu_device_plugin_torch.obs import export as texport
from k8s_gpu_device_plugin_torch.obs import fleet_obs as tobs
from k8s_gpu_device_plugin_torch.obs.trace import configure
from k8s_gpu_device_plugin_torch.serving import async_http
from k8s_gpu_device_plugin_torch.serving.testing import (
    get_json,
    inprocess_fleet,
    per_replica_registry_factories,
    stream_generate,
)
from k8s_gpu_device_plugin_tpu.obs import export as jexport
from k8s_gpu_device_plugin_tpu.obs import fleet_obs as jobs
from tests.test_torch_router import (  # noqa: F401 - the module fixture
    BUCKETS,
    ENGINE_KW,
    model,
    run,
)

OM_ACCEPT = {"Accept": "application/openmetrics-text; version=1.0.0"}


def _exposition(seed: int, openmetrics: bool, *, mfu=None, tps=None) -> str:
    """One replica's ``/metrics`` as the port renders it: TTFT and
    inter-token observations with exemplars, counters, the MFU and
    bandwidth gauges and the throughput window, all drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    metrics = ServingMetrics(Registry())
    try:
        for i in range(int(rng.integers(1, 6))):
            metrics.on_submit()
            metrics.observe_ttft(float(rng.uniform(0, 3)),
                                 f"{seed:016x}{i:016x}")
            for _ in range(int(rng.integers(0, 4))):
                metrics.observe_inter_token(float(rng.uniform(0, 0.2)))
            metrics.on_finish("length")
        metrics.set_mfu(float(rng.uniform(0, 60)) if mfu is None else mfu,
                        float(rng.uniform(0, 90)))
        metrics.tokens_per_second.set(
            float(rng.uniform(0, 500)) if tps is None else tps)
        return metrics._registry.render(openmetrics=openmetrics)
    finally:
        metrics.close()


def _to_reference(text: str) -> str:
    return text.replace("gpu_serving_", "tpu_serving_")


def _from_reference(text: str) -> str:
    return text.replace("tpu_serving_", "gpu_serving_").replace(
        "tpu_fleet_", "gpu_fleet_")


def _samples(text: str, openmetrics: bool) -> dict:
    parse = om_families if openmetrics else text_string_to_metric_families
    return {f.name: f for f in parse(text)}


@pytest.mark.parametrize("openmetrics", [False, True])
@pytest.mark.parametrize("ids", [("r0", "r1", "r2"),
                                 ('a"b', "back\\slash", "new\nline")])
def test_federate_metrics_matches_the_reference(openmetrics, ids):
    scrapes = [(rid, _exposition(10 + i, openmetrics))
               for i, rid in enumerate(ids)]
    errors = ["down"]
    got = tobs.federate_metrics(scrapes, openmetrics=openmetrics,
                                scrape_errors=errors)
    want = jobs.federate_metrics(
        [(rid, _to_reference(t)) for rid, t in scrapes],
        openmetrics=openmetrics, scrape_errors=errors)
    assert got == _from_reference(want)
    fams = _samples(got, openmetrics)
    replicas = {s.labels["replica"] for s in fams["gpu_serving_ttft_seconds"]
                .samples}
    assert replicas == set(ids)
    assert fams["gpu_fleet_replicas"].samples[0].value == len(ids)
    assert fams["gpu_fleet_scrape_errors"].samples[0].value == 1
    if openmetrics:
        assert got.endswith("# EOF\n")
        exemplars = [s.exemplar for s in fams["gpu_serving_ttft_seconds"]
                     .samples if s.exemplar is not None]
        assert exemplars and all("trace_id" in e.labels for e in exemplars)


def test_fleet_histograms_sum_and_mfu_weights_by_throughput():
    scrapes = [("r0", _exposition(1, False, mfu=40.0, tps=100.0)),
               ("r1", _exposition(2, False, mfu=10.0, tps=300.0))]
    fams = _samples(tobs.federate_metrics(scrapes), False)
    assert fams["gpu_fleet_mfu_pct"].samples[0].value == \
        pytest.approx((40.0 * 100 + 10.0 * 300) / 400)
    for fam in ("ttft_seconds", "inter_token_seconds"):
        per = [s for s in fams[f"gpu_serving_{fam}"].samples
               if s.name.endswith("_count")]
        (fleet,) = [s for s in fams[f"gpu_fleet_{fam}"].samples
                    if s.name.endswith("_count")]
        assert len(per) == 2 and fleet.value == sum(s.value for s in per)
        buckets = {}
        for s in fams[f"gpu_serving_{fam}"].samples:
            if s.name.endswith("_bucket"):
                buckets[s.labels["le"]] = buckets.get(s.labels["le"], 0) \
                    + s.value
        assert {s.labels["le"]: s.value for s in fams[f"gpu_fleet_{fam}"]
                .samples if s.name.endswith("_bucket")} == buckets


def test_idle_fleet_reports_zero_not_nan():
    scrapes = [(f"r{i}", _exposition(i, True, mfu=0.0, tps=0.0))
               for i in range(2)]
    fams = _samples(tobs.federate_metrics(scrapes, openmetrics=True), True)
    assert fams["gpu_fleet_mfu_pct"].samples[0].value == 0.0
    assert fams["gpu_fleet_hbm_bw_util_pct"].samples[0].value == 0.0
    empty = _samples(tobs.federate_metrics([], scrape_errors=["r0"]), False)
    assert empty["gpu_fleet_replicas"].samples[0].value == 0
    assert empty["gpu_fleet_mfu_pct"].samples[0].value == 0.0


def test_plugin_federation_refused_naming_a14():
    for kw in ({"plugin_scrapes": [("n0", "x 1\n")]},
               {"plugin_scrape_errors": ["n0"]}):
        with pytest.raises(NotImplementedError, match="ROADMAP A.14"):
            tobs.federate_metrics([("r0", "x 1\n")], **kw)


def test_classic_to_om_matches_the_reference():
    text = _exposition(7, False)
    assert tobs._classic_to_om(text) == \
        _from_reference(jobs._classic_to_om(_to_reference(text)))


# --- trace stitching --------------------------------------------------------


def _forest(seed: int) -> list:
    """Span fragments of one trace as three sources return them: the
    router's ring and two replicas', with duplicated spans (one tracer
    shared by an in-process fleet), orphans (parents no fragment holds)
    and spans without an id."""
    rng = np.random.default_rng(seed)
    spans = []
    for i in range(24):
        parent = None
        roll = rng.integers(0, 6)
        if spans and roll > 1:
            parent = spans[int(rng.integers(0, len(spans)))]["span_id"]
        elif roll == 1:
            parent = f"gone{i}"
        component = ["router_http", "serving_http", "engine", "batcher"][
            int(rng.integers(0, 4))]
        attrs = {"path": "/v1/generate", "n": int(rng.integers(0, 9))}
        if rng.integers(0, 3) == 0:
            attrs["replica"] = f"r{int(rng.integers(0, 2))}"
        spans.append({
            "name": f"span{i}", "component": component,
            "trace_id": "ab" * 16,
            "span_id": "" if rng.integers(0, 12) == 0 else f"{seed}s{i}",
            "parent_id": parent,
            "start_us": int(rng.integers(0, 10**6)),
            "dur_us": int(rng.integers(0, 5000)),
            "status": "ok", "thread": "t", "attrs": attrs})
    fragments = [(src, []) for src in ("router", "r0", "r1")]
    for span in spans:
        for src, frag in fragments:
            if rng.integers(0, 2):
                frag.append(span)
    return fragments


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stitching_matches_the_reference(seed):
    fragments = _forest(seed)
    got_tracks, got_summary = tobs.stitch_spans(fragments)
    want_tracks, want_summary = jobs.stitch_spans(fragments)
    assert got_tracks == want_tracks and got_summary == want_summary
    assert got_summary["deduped"] > 0 and got_summary["orphans"]
    assert texport.to_fleet_chrome_trace(got_tracks) == \
        jexport.to_fleet_chrome_trace(want_tracks)
    assert tobs.stitched_trace_payload(fragments) == \
        jobs.stitched_trace_payload(fragments)
    for _, spans in fragments:
        doc = texport.to_chrome_trace([s for s in spans if s["span_id"]])
        assert tobs.spans_from_chrome(doc) == jobs.spans_from_chrome(doc)
    assert tobs.stitched_trace_payload([("r0", [])]) is None


# --- the two routes over HTTP -----------------------------------------------


def test_fleet_routes_over_two_port_replicas(model):
    cfg, params = model
    tracer = configure(enabled=True)
    tracer.clear()
    engine_factory, server_factory = per_replica_registry_factories(
        params, cfg, **ENGINE_KW)

    async def metrics(base, openmetrics):
        status, headers, raw = await async_http.fetch(
            "GET", f"{base}/fleet/metrics",
            headers=OM_ACCEPT if openmetrics else None, timeout_s=30)
        assert status == 200
        assert headers["Content-Type"].startswith(
            "application/openmetrics-text" if openmetrics else "text/plain")
        return _samples(raw.decode(), openmetrics)

    async def body():
        async with inprocess_fleet(
                params, cfg, n_replicas=2, device="cpu",
                engine_factory=engine_factory, server_factory=server_factory,
                router_kw={"policy": "rr", "health_interval_s": 0.1,
                           "prompt_buckets": BUCKETS}) as ctx:
            for seed in (1, 2):
                got = await stream_generate(
                    ctx.base, prompt=[seed + t for t in range(6)], max_new=4)
                assert got["done"]
            await asyncio.sleep(0.2)  # the replicas' spans have closed
            routed = [t for t in tracer._finished if any(
                s["component"] == "router_http"
                and s["name"].startswith("POST /v1/generate")
                for s in t["spans"])]
            tid = routed[-1]["trace_id"]
            s, doc = await get_json(f"{ctx.base}/fleet/debug/traces/{tid}")
            assert s == 200 and doc["fleet"]["trace_id"] == tid
            tracks = doc["fleet"]["tracks"]
            assert "router" in tracks and (set(tracks) & {"r0", "r1"})
            assert doc["fleet"]["orphans"] == [] and \
                doc["fleet"]["unreachable"] == []
            rows = {e["args"]["name"] for e in doc["traceEvents"]
                    if e["name"] == "process_name"}
            assert rows == set(tracks)
            s, miss = await get_json(
                f"{ctx.base}/fleet/debug/traces/{'0' * 32}")
            assert s == 404 and miss["unreachable"] == []
            for om in (False, True):
                fams = await metrics(ctx.base, om)
                ttft = fams["gpu_serving_ttft_seconds"].samples
                assert {x.labels["replica"] for x in ttft} == {"r0", "r1"}
                assert fams["gpu_fleet_replicas"].samples[0].value == 2
                assert fams["gpu_fleet_scrape_errors"].samples[0].value == 0
                count = [x.value for x in ttft if x.name.endswith("_count")]
                (fleet,) = [x.value for x in fams["gpu_fleet_ttft_seconds"]
                            .samples if x.name.endswith("_count")]
                assert fleet == sum(count) == 2
            await ctx.kill_replica(1)
            s, doc = await get_json(f"{ctx.base}/fleet/debug/traces/{tid}")
            assert s == 200 and doc["fleet"]["unreachable"] == ["r1"]
            fams = await metrics(ctx.base, False)
            assert fams["gpu_fleet_replicas"].samples[0].value == 1
            assert fams["gpu_fleet_scrape_errors"].samples[0].value == 1

    try:
        run(body())
    finally:
        configure(enabled=False)
        tracer.clear()

"""The port's observability layer against the reference's
(``tests/test_obs.py``, ``test_obs_export.py``, ``test_obs_integration.py``
and the exposition half of ``test_attribution.py``).

- The tracer core, run as the same scenario through the reference's
  ``obs/trace.py`` and the port's copy: span trees, structural
  completion, error status, the bounded rings, traceparent, the thread
  hop through ``attach``; the Perfetto export equal for equal records;
  trace ids on the JSON log records.
- The port's own registry (``metrics/exposition.py``): ``ServingMetrics``
  built at one prefix on both sides has the reference's family names,
  types, label names and bucket bounds, and after the same hook calls
  the same sample values; both renderings parse under
  ``prometheus_client``'s classic and OpenMetrics parsers (that package
  is used here only), with exemplars on the ttft, inter-token and phase
  buckets and printable-but-gnarly tenants escaped alike; control
  characters are refused; ``close`` frees the families.
- The batcher's span trees (bucketed, chunked, paged, a cancel) have the
  reference batcher's span names and parentage for the same requests,
  and the histograms count what the reference's count.
- Over HTTP: a request joins the batcher's tree through ``traceparent``
  and gets one back; ``/debug/traces`` pages with ``limit``/``since`` and
  answers 400 to garbage; ``/metrics`` negotiates OpenMetrics; a
  supervised restart counts on ``/metrics`` and leaves its spans.
A tiny f32 model (two layers, the JAX weights through ``params_from_jax``)
on the CPU.
"""

import json
import logging
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from prometheus_client import CollectorRegistry
from prometheus_client import generate_latest as ref_classic
from prometheus_client.openmetrics.exposition import (
    generate_latest as ref_openmetrics,
)
from prometheus_client.openmetrics.parser import (
    text_string_to_metric_families as parse_openmetrics,
)
from prometheus_client.parser import (
    text_string_to_metric_families as parse_classic,
)

from k8s_gpu_device_plugin_tpu.metrics import serving_metrics as jsm
from k8s_gpu_device_plugin_tpu.models import batching as jbatch
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.obs import export as jexport
from k8s_gpu_device_plugin_tpu.obs import prom as jprom
from k8s_gpu_device_plugin_tpu.obs import trace as jtrace
from k8s_gpu_device_plugin_torch.metrics import serving_metrics as tsm
from k8s_gpu_device_plugin_torch.metrics.exposition import (
    Counter,
    Histogram,
    Registry,
)
from k8s_gpu_device_plugin_torch.models import batching as tbatch
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax
from k8s_gpu_device_plugin_torch.obs import export as texport
from k8s_gpu_device_plugin_torch.obs import prom as tprom
from k8s_gpu_device_plugin_torch.obs import trace as ttrace
from k8s_gpu_device_plugin_torch.serving import server as srv
from k8s_gpu_device_plugin_torch.utils.log import JsonFormatter

torch.set_num_threads(1)

@pytest.fixture
def tracers():
    """Both process tracers (the reference batcher reports to its own),
    enabled for one test and restored after."""
    trs = [jtrace.configure(enabled=True), ttrace.configure(enabled=True)]
    for tr in trs:
        tr.clear()
    try:
        yield trs
    finally:
        for tr in trs:
            tr.enabled = False
            tr.clear()


# --- the tracer core, the same scenarios through both modules --------------


def _tree(mod):
    tr = mod.Tracer()
    tr.enabled = True
    with tr.span("root", component="test", k="v") as root:
        with tr.span("child", component="test") as child:
            assert child.trace_id == root.trace_id
            assert child.parent_id == root.span_id
        grand = tr.span("manual", component="test", parent=child)
        grand.set(extra=1).end()
    (top,) = tr.traces()
    spans = tr.get_trace(top["trace_id"])
    return ({k: top[k] for k in ("root", "n_spans", "status")},
            sorted((s["name"], s["parent_id"] is None, s["attrs"].get("k"))
                   for s in spans))


def _completion(mod):
    tr = mod.Tracer()
    tr.enabled = True
    root = tr.span("root", component="test")
    child = tr.span("child", component="test", parent=root)
    root.end()
    before = len(tr.traces())  # the child is still open
    child.end()
    return before, len(tr.traces())


def _error(mod):
    tr = mod.Tracer()
    tr.enabled = True
    with pytest.raises(ValueError):
        with tr.span("boom", component="test"):
            raise ValueError("nope")
    top = tr.traces()[0]
    (span,) = tr.get_trace(top["trace_id"])
    return top["status"], span["status"], span["attrs"]["error"]


def _bounds(mod):
    ring = mod.Tracer(max_traces=3)
    ring.enabled = True
    for i in range(10):
        ring.span(f"t{i}", component="test").end()
    live = mod.Tracer(max_traces=4)
    live.max_live_traces = 8
    live.enabled = True
    leaked = [live.span(f"leak{i}", component="test") for i in range(20)]
    n_live = len(live._live)
    evicted = [t["n_spans"] for t in live.traces() if t["incomplete"]]
    for span in leaked:
        span.end()
    cap = mod.Tracer(max_spans_per_trace=4)
    cap.enabled = True
    with cap.span("root", component="test"):
        for i in range(10):
            cap.span(f"s{i}", component="test").end()
    top = cap.traces()[0]
    return ([t["root"] for t in ring.traces()], n_live, evicted,
            len(live._live), top["n_spans"], top["dropped_spans"])


def _traceparent(mod):
    tr = mod.Tracer()
    tr.enabled = True
    span = tr.span("x", component="test")
    header = mod.format_traceparent(span)
    parsed = mod.parse_traceparent(header)
    child = tr.span("y", component="test", parent=parsed)
    bad = [mod.parse_traceparent(v) for v in (
        None, "", "garbage", "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
        "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
        "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
        "00-" + "g" * 32 + "-" + "b" * 16 + "-01")]
    ok = mod.parse_traceparent("cc-" + "A" * 32 + "-" + "B" * 16 + "-01-x")
    return (parsed.trace_id == span.trace_id, child.parent_id == span.span_id,
            header.startswith("00-") and header.endswith("-01"), bad,
            (ok.trace_id, ok.span_id))


def _thread_hop(mod):
    """The engine's hop: capture on one thread, attach on another."""
    tr = mod.Tracer()
    tr.enabled = True
    out = {}
    with tr.span("http", component="serving_http") as http:
        parent = mod.current_context()

    def worker():
        out["before"] = mod.current_context()
        with mod.attach(parent):
            out["child"] = tr.span("request", component="serving")
        out["child"].end()

    th = threading.Thread(target=worker)
    th.start()
    th.join(30)
    return (out["before"] is None,
            out["child"].parent_id == http.span_id,
            out["child"].trace_id == http.trace_id)


@pytest.mark.parametrize("scenario", [_tree, _completion, _error, _bounds,
                                      _traceparent, _thread_hop])
def test_tracer_core_matches_the_reference(scenario):
    assert scenario(ttrace) == scenario(jtrace)


def test_disabled_tracer_hands_out_the_shared_noop():
    tr = ttrace.Tracer()
    span = tr.span("x", component="test")
    assert span is ttrace.NOOP_SPAN
    with span as s:
        s.set(a=1).end()
    assert tr.traces() == [] and span.context() is None


def test_chrome_export_equals_the_reference_for_the_same_records():
    tr = ttrace.Tracer()
    tr.enabled = True
    root = tr.span("request", component="serving", rid=7)
    with ttrace.attach(root):
        with tr.span("prefill", component="serving", bucket=32, obj=object()):
            pass
        cross = tr.span("decode_dispatch", component="serving_engine", step=3)
    th = threading.Thread(target=cross.end, name="engine-worker")
    th.start()
    th.join(30)
    root.end()
    spans = tr.get_trace(root.trace_id)
    doc = texport.to_chrome_trace(spans)
    ref = jexport.to_chrome_trace(spans)
    # the object() attr stringifies with its id on both sides alike
    assert doc == ref
    complete = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(complete) == 3 and all(e["dur"] >= 1 for e in complete)
    assert {e["args"]["name"] for e in doc["traceEvents"]
            if e["ph"] == "M"} == {"serving", "serving_engine"}


def test_log_records_carry_the_active_trace_ids():
    tr = ttrace.configure(enabled=True)
    try:
        fmt = JsonFormatter()

        def entry(msg):
            rec = logging.LogRecord("x", logging.INFO, __file__, 1, msg,
                                    None, None)
            return json.loads(fmt.format(rec))

        assert "trace_id" not in entry("idle")
        with tr.span("op", component="test") as span:
            got = entry("inside")
        assert (got["trace_id"], got["span_id"]) == (span.trace_id,
                                                     span.span_id)
    finally:
        tr.enabled = False
        tr.clear()


# --- the registry and ServingMetrics against prometheus_client -------------

GNARLY = 'we"ird\\tenant'


def _populate(m):
    """Every hook the served paths call, with the same arguments."""
    m.on_submit()
    m.on_prefill_chunk()
    m.on_prefill_tokens(40, "computed")
    m.on_prefill_tokens(32, "prefix_reused")
    m.on_prefix_hit(32)
    m.on_prefix_miss()
    m.on_prefix_evict(4096)
    m.set_prefix_resident_bytes(8192, 2)
    m.set_kv_pages(64, 10, 12.5)
    m.on_kv_admission_rejected("pool_pressure")
    m.on_kv_pages_recycled(3)
    m.on_prefill_chunk_deferred("pool_pressure")
    m.set_kv_reserved_bytes(1 << 30)
    m.set_decode_attn_backend({"decode": {"backend": "plain"},
                               "verify": {"backend": "plain"},
                               "prefill": {"backend": "plain"}})
    m.observe_queue_wait(0.02)
    m.on_deadline_miss(GNARLY, 0.5)
    m.on_goodput(GNARLY, "0", 7)
    m.on_preemption()
    m.on_sched_rejected("queue_full")
    m.on_spec_round(4, [2, 3])
    m.on_first_token()
    m.on_step(3, 1, 2, 1)
    m.on_finish("budget")
    m.observe_ttft(0.05, "ab" * 16)
    m.observe_ttft(0.2)
    m.observe_inter_token(0.004, "cd" * 16)
    m.observe_phase("queue_wait", 0.001, "ab" * 16)
    m.observe_phase("decode", 0.01, None)
    m.set_mfu(12.5, 40.0)
    m.on_model_work(1e9, 2e9)
    m.on_tenant_flops(GNARLY, 1e9)
    m.observe_dispatch(0.001)
    m.observe_readback(0.008)
    m.on_engine_restart(1, 2)
    m.on_pipeline_flush()


def _pair(prefix="x"):
    ref_reg = CollectorRegistry()
    ref = jsm.ServingMetrics(registry=ref_reg, prefix=prefix)
    port_reg = Registry()
    port = tsm.ServingMetrics(port_reg, prefix=prefix)
    return ref_reg, ref, port_reg, port


def _families(text: str, parser) -> dict:
    """name -> (type, label names of its samples, bucket bounds, the
    sample values but the time-dependent ones). The attention backend's
    label values are the port's own (cuda / plain for the reference's
    pallas / xla): its samples count, their values do not compare."""
    out = {}
    for fam in parser(text):
        if fam.name.endswith("_created") or fam.name == "x_tokens_per_second":
            continue
        labels = {k for s in fam.samples for k in s.labels if k != "le"}
        bounds = sorted({float(s.labels["le"]) for s in fam.samples
                         if "le" in s.labels})
        values = sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                        for s in fam.samples if not s.name.endswith("_created"))
        if fam.name == "x_decode_attn_backend":
            values = len(values)
        out[fam.name] = (fam.type, labels, bounds, values)
    return out


def test_serving_metrics_families_match_the_reference():
    """Name, type, label names and buckets of every family, object by
    object, at one prefix."""
    ref_reg, ref, port_reg, port = _pair()
    try:
        want = {}
        for c in ref_reg._collector_to_names:
            want[c._name] = (c._type, tuple(c._labelnames),
                             tuple(getattr(c, "_upper_bounds", ())))
        got = {}
        for f in port_reg.families():
            name = f.name[:-len("_total")] if f.type == "counter" else f.name
            got[name] = (f.type, f.labelnames, getattr(f, "buckets", ()))
        assert got == want
    finally:
        ref.close()
        port.close()


def test_metrics_render_parses_like_the_reference_in_both_formats():
    ref_reg, ref, port_reg, port = _pair()
    try:
        _populate(ref)
        _populate(port)
        classic = port_reg.render()
        assert _families(classic, parse_classic) == _families(
            ref_classic(ref_reg).decode(), parse_classic)
        om = port_reg.render(openmetrics=True)
        assert om.endswith("# EOF\n")
        got = _families(om, parse_openmetrics)
        assert got == _families(ref_openmetrics(ref_reg).decode(),
                                parse_openmetrics)
        assert any(("tenant", GNARLY) in v[1]
                   for v in got["x_sched_goodput_tokens"][3])
        fams = {f.name: f for f in parse_openmetrics(om)}

        def exemplars(name):
            return [s.exemplar for s in fams[name].samples
                    if s.name.endswith("_bucket") and s.exemplar]

        assert any(e.labels == {"trace_id": "ab" * 16}
                   for e in exemplars("x_ttft_seconds"))
        assert exemplars("x_inter_token_seconds")
        assert exemplars("x_request_phase_seconds")
        # the classic text carries no exemplar
        assert "# {" not in classic
    finally:
        ref.close()
        port.close()


def test_registry_refuses_control_characters_and_frees_on_close():
    reg = Registry()
    m = tsm.ServingMetrics(reg)
    for bad in ("a\nb", "a\tb", "a\x00b"):
        with pytest.raises(ValueError, match="control character"):
            m.on_goodput(bad, "0", 1)
    # the batcher's admission rule is the first gate, as the reference's
    for bad in ("a\nb", "a\tb"):
        with pytest.raises(ValueError):
            tbatch.ContinuousBatcher.validate_sched(bad, 1, None)
    assert tbatch.ContinuousBatcher.validate_sched(GNARLY, 1, None)[0] \
        == GNARLY
    with pytest.raises(ValueError, match="already registered"):
        tsm.ServingMetrics(reg)
    m.close()
    assert reg.families() == []
    second = tsm.ServingMetrics(reg)  # a successor registers the same names
    assert len(reg.families()) == len(list(
        jsm.ServingMetrics(registry=CollectorRegistry())
        ._registry._collector_to_names))
    second.close()
    with pytest.raises(KeyError):
        reg.unregister(Counter("y", "y"))
    h = Histogram("h", "h", buckets=(1.0,), registry=reg)
    with pytest.raises(ValueError, match="128"):
        h.observe(0.5, {"trace_id": "z" * 200})


def test_span_metrics_match_the_reference_family():
    ref_reg = CollectorRegistry()
    ref = jprom.SpanMetrics(registry=ref_reg, prefix="x")
    reg = Registry()
    tr = ttrace.Tracer()
    tr.enabled = True
    port = tprom.SpanMetrics(reg, prefix="x").install(tr)
    try:
        with tr.span("op", component="c"):
            pass
        (fam,) = reg.families()
        assert (fam.name, fam.labelnames, fam.buckets) == (
            ref.span_seconds._name, tuple(ref.span_seconds._labelnames),
            tuple(ref.span_seconds._upper_bounds))
        assert reg.get_sample_value(
            "x_span_duration_seconds_count",
            {"component": "c", "operation": "op"}) == 1.0
    finally:
        port.close()
        ref.close()
    assert reg.families() == [] and tr._listeners == []
    assert tprom.SpanMetrics(Registry()).span_seconds.name == \
        "gpu_obs_span_duration_seconds"
    assert tsm.ServingMetrics(Registry()).ttft_seconds.name == \
        "gpu_serving_ttft_seconds"


# --- the batcher's span trees and histograms against the JAX batcher's ----


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompt(key, n, vocab=512):
    return np.random.default_rng(key).integers(1, vocab, n).tolist()


def _shape(tracer) -> list:
    """Each finished trace as its root and the sorted names of the
    spans under it (the span ids differ between runs)."""
    out = []
    for summary in tracer.traces():
        spans = tracer.get_trace(summary["trace_id"])
        by_id = {s["span_id"]: s for s in spans}
        root = [s for s in spans if s["parent_id"] is None]
        out.append((summary["root"], sorted(
            (s["name"], by_id[s["parent_id"]]["name"]
             if s["parent_id"] in by_id else None) for s in spans),
            len(root)))
    return sorted(out)


SCENARIOS = {
    # (batcher kwargs, requests (key, prompt length, max_new))
    "bucketed": (dict(prompt_buckets=(8, 16)), [(1, 5, 4)]),
    "chunked": (dict(chunked_prefill=4), [(2, 10, 3)]),
    "paged": (dict(chunked_prefill=8, kv_layout="paged", kv_page_size=16),
              [(3, 20, 3), (4, 9, 2)]),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_request_span_trees_match_the_reference(models, tracers, scenario):
    jcfg, jparams, tcfg, tparams = models
    kw, requests = SCENARIOS[scenario]
    shapes = []
    for mod, cfg, params, tr in ((jbatch, jcfg, jparams, tracers[0]),
                                 (tbatch, tcfg, tparams, tracers[1])):
        cb = mod.ContinuousBatcher(params, cfg, n_slots=2, max_len=64, **kw)
        rids = [cb.submit(_prompt(k, n), max_new=m) for k, n, m in requests]
        cb.run()
        shapes.append(_shape(tr))
        if mod is tbatch:
            trees = [tr.get_trace(t["trace_id"]) for t in tr.traces()
                     if t["root"] == "request"]
    assert shapes[1] == shapes[0]
    by_rid = {}
    for spans in trees:
        names = {s["name"]: s for s in spans}
        by_rid[names["request"]["attrs"]["rid"]] = names
    for rid, (_, _, max_new) in zip(rids, requests):
        names = by_rid[rid]
        root = names["request"]
        assert root["parent_id"] is None
        for child in ("admit", "decode", "retire"):
            assert names[child]["parent_id"] == root["span_id"]
        assert names["retire"]["attrs"]["reason"] == "budget"
        assert names["decode"]["attrs"]["tokens"] == max_new
    if scenario == "chunked":
        chunks = [s for s in trees[0] if s["name"] == "prefill_chunk"]
        assert len(chunks) >= 2 and any(s["attrs"].get("final")
                                        for s in chunks)


def test_cancel_closes_the_span_tree(models, tracers):
    tcfg, tparams = models[2], models[3]
    cb = tbatch.ContinuousBatcher(tparams, tcfg, n_slots=1, max_len=64,
                                  prompt_buckets=(8,))
    rid = cb.submit(_prompt(3, 4), max_new=32)
    cb.step()  # admitted, first decode dispatched
    assert cb.cancel(rid)
    (summary,) = tracers[1].traces()  # the cancel completes the trace
    spans = {s["name"]: s for s in tracers[1].get_trace(summary["trace_id"])}
    assert spans["retire"]["attrs"]["reason"] == "cancelled"


def test_disabled_tracing_leaves_no_traces(models):
    tr = ttrace.configure(enabled=False)
    tr.clear()
    tcfg, tparams = models[2], models[3]
    cb = tbatch.ContinuousBatcher(tparams, tcfg, n_slots=1, max_len=64,
                                  prompt_buckets=(8,))
    cb.submit(_prompt(6, 4), max_new=2)
    cb.run()
    assert tr.traces() == []
    assert all(r.span is None for r in cb.done_requests.values())


def test_histograms_count_what_the_reference_counts(models):
    """The same requests through both batchers with their metrics: the
    counters and the histograms' counts agree (prefix hits included)."""
    jcfg, jparams, tcfg, tparams = models
    from k8s_gpu_device_plugin_tpu.serving import prefix_cache as jpc
    from k8s_gpu_device_plugin_torch.serving import prefix_cache as tpc

    counts = []
    for mod, pcm, cfg, params in ((jbatch, jpc, jcfg, jparams),
                                  (tbatch, tpc, tcfg, tparams)):
        if mod is jbatch:
            reg = CollectorRegistry()
            m = jsm.ServingMetrics(registry=reg, prefix="x")
            value = reg.get_sample_value
        else:
            reg = Registry()
            m = tsm.ServingMetrics(reg, prefix="x")
            value = reg.get_sample_value
        pc = pcm.PrefixCache(cfg, buckets=(8, 16, 32), budget_bytes=1 << 22,
                             metrics=m)
        cb = mod.ContinuousBatcher(params, cfg, n_slots=2, max_len=64,
                                   chunked_prefill=8, prompt_buckets=(8, 16,
                                                                      32),
                                   prefix_cache=pc, metrics=m)
        for key, n, new in [(4, 20, 4), (5, 6, 3), (4, 20, 2)]:
            cb.submit(_prompt(key, n), max_new=new)
        cb.run()
        counts.append({name: value(name, labels) for name, labels in [
            ("x_ttft_seconds_count", None),
            ("x_inter_token_seconds_count", None),
            ("x_generated_tokens_total", None),
            ("x_requests_submitted_total", None),
            ("x_requests_finished_total", {"reason": "budget"}),
            ("x_prefill_chunks_total", None),
            ("x_prefill_tokens_total", {"source": "computed"}),
            ("x_prefill_tokens_total", {"source": "prefix_reused"}),
            ("x_prefix_cache_hits_total", None),
            ("x_prefix_cache_misses_total", None),
            ("x_prefix_cache_entries", None),
            ("x_kv_reserved_bytes", None),
        ]})
        m.close()
    assert counts[1] == counts[0]
    assert counts[1]["x_ttft_seconds_count"] == 3
    assert counts[1]["x_inter_token_seconds_count"] == 3 + 2 + 1


# --- over HTTP -------------------------------------------------------------


def _serve(flags):
    args = srv.build_parser().parse_args([
        "--preset", "tiny", "--device", "cpu", "--host", "127.0.0.1",
        "--port", "0", "--slots", "2", "--maxLen", "64", "--chunkedPrefill",
        "8", "--seed", "0", *flags])
    server = srv.build_server(args)
    server.start()
    return server, f"http://127.0.0.1:{server.bound_port}"


def _call(url, path, body=None, headers=None):
    req = urllib.request.Request(
        url + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read().decode()


@pytest.fixture(scope="module")
def traced():
    """A server with --tracing --traceSteps (it turns the process tracer
    on, and off again when it stops)."""
    server, url = _serve(["--tracing", "--traceSteps"])
    tracer = ttrace.get_tracer()
    tracer.clear()
    try:
        yield server, url, tracer
    finally:
        server.stop()
        tracer.clear()
    assert not tracer.enabled


def _wait_for(fn, tries=200):
    for _ in range(tries):
        got = fn()
        if got:
            return got
        threading.Event().wait(0.05)
    return fn()


def test_http_request_joins_the_batcher_tree(traced):
    _, url, tracer = traced
    caller = ttrace.SpanContext("ab" * 16, "cd" * 8)
    status, headers, _ = _call(
        url, "/v1/generate", {"prompt": _prompt(8, 5), "max_new": 3},
        headers={"traceparent": ttrace.format_traceparent(caller)})
    assert status == 200
    back = ttrace.parse_traceparent(headers["traceparent"])
    assert back.trace_id == caller.trace_id

    def tree():
        spans = tracer.get_trace(caller.trace_id) or []
        names = {s["name"] for s in spans}
        return spans if {"retire", "POST /v1/generate"} <= names else None

    spans = _wait_for(tree)
    by_name = {s["name"]: s for s in spans}
    http = by_name["POST /v1/generate"]
    assert http["parent_id"] == caller.span_id
    assert http["component"] == "serving_http"
    assert http["attrs"]["status_code"] == 200
    assert by_name["request"]["parent_id"] == http["span_id"]
    assert {"admit", "prefill_chunk", "decode", "retire"} <= set(by_name)
    # --traceSteps: batch-scoped dispatch and readback traces
    roots = {t["root"] for t in tracer.traces()}
    assert {"decode_dispatch", "decode_readback"} <= roots
    # a telemetry read starts no trace
    n = len(tracer.traces())
    _call(url, "/v1/health")
    assert len(tracer.traces()) == n


def test_debug_traces_limit_since_and_garbage(traced):
    _, url, tracer = traced
    for i in range(3):
        assert _call(url, "/v1/generate", {"prompt": _prompt(40 + i, 5),
                                           "max_new": 2})[0] == 200

    def full():
        payload = json.loads(_call(url, "/debug/traces")[2])
        posts = [t for t in payload["traces"] if t["root"].startswith("POST")]
        return payload if len(posts) >= 3 else None

    payload = _wait_for(full)
    assert payload["total"] == len(payload["traces"]) == payload["returned"]
    page = json.loads(_call(url, "/debug/traces?limit=1")[2])
    assert page["returned"] == len(page["traces"]) == 1
    assert page["total"] >= payload["total"]
    cutoff = payload["traces"][1]["start_us"]
    newer = json.loads(_call(url, f"/debug/traces?since={cutoff}")[2])
    assert all(t["start_us"] > cutoff for t in newer["traces"])
    assert json.loads(_call(url, "/debug/traces?limit=0")[2])["traces"] == []
    for bad in ("limit=x", "limit=-1", "since=nope", "limit="):
        assert _call(url, f"/debug/traces?{bad}")[0] == 400
    one = payload["traces"][0]["trace_id"]
    status, _, body = _call(url, f"/debug/traces/{one}")
    assert status == 200 and json.loads(body)["traceEvents"]
    assert _call(url, "/debug/traces/" + "0" * 32)[0] == 404


def test_metrics_endpoint_negotiates_openmetrics_with_exemplars(traced):
    _, url, _ = traced
    assert _call(url, "/v1/generate", {"prompt": _prompt(37, 10),
                                       "max_new": 4})[0] == 200
    status, headers, classic = _call(url, "/metrics")
    assert status == 200
    assert headers["Content-Type"].startswith("text/plain")
    fams = {f.name: f for f in parse_classic(classic)}
    assert fams["gpu_serving_requests_submitted"].samples[0].value >= 1
    assert "gpu_obs_span_duration_seconds" in fams  # --tracing's histogram
    status, headers, om = _call(url, "/metrics", headers={
        "Accept": "application/openmetrics-text; version=1.0.0"})
    assert headers["Content-Type"].startswith("application/openmetrics-text")
    fams = {f.name: f for f in parse_openmetrics(om)}
    ex = [s.exemplar for s in fams["gpu_serving_ttft_seconds"].samples
          if s.name.endswith("_bucket") and s.exemplar]
    assert ex and len(ex[0].labels["trace_id"]) == 32  # the request's trace
    assert any(s.exemplar for s in fams["gpu_serving_request_phase_seconds"]
               .samples if s.name.endswith("_bucket"))
    assert fams["gpu_serving_decode_attn_backend"].samples


def test_two_servers_in_one_process_own_their_registries(traced):
    """A second server (and its families) starts and stops beside a live
    one; the stopped one's families are gone."""
    server, url = _serve([])
    try:
        assert server.registry is not traced[0].registry
        assert "gpu_serving_ttft_seconds" in _call(url, "/metrics")[2]
    finally:
        server.stop()
    assert server.registry.families() == []
    assert traced[0].registry.families()


def test_supervised_restart_counts_and_leaves_its_spans():
    server, url = _serve(["--tracing", "--faults", "decode.apply:nth=3"])
    tracer = ttrace.get_tracer()
    tracer.clear()
    try:
        status, _, body = _call(url, "/v1/generate",
                                {"prompt": _prompt(9, 6), "max_new": 6})
        assert status == 200 and len(json.loads(body)["tokens"]) == 6
        reg = server.registry
        assert reg.get_sample_value("gpu_serving_engine_restarts_total") == 1
        assert reg.get_sample_value(
            "gpu_serving_engine_resumed_requests_total") == 1
        roots = {t["root"] for t in tracer.traces()}
        assert {"engine_crash", "engine_restart"} <= roots
        health = json.loads(_call(url, "/v1/health")[2])
        assert health["supervisor"]["restarts_total"] == 1
        # the rebuilt batcher kept the server's attributor and accumulator
        assert server.engine.cb.attribution is not None
        assert health["attribution"]["retired"] == 1
    finally:
        server.stop()
        tracer.clear()


def test_scheduler_hooks_reach_the_registry():
    server, url = _serve(["--schedPolicy", "slo"])
    try:
        assert _call(url, "/v1/generate", {
            "prompt": _prompt(11, 6), "max_new": 3, "tenant": "gold",
            "priority": 0})[0] == 200
        assert _call(url, "/v1/generate", {
            "prompt": _prompt(12, 6), "max_new": 3, "deadline_ms": 1})[0] \
            == 200
        reg = server.registry
        assert reg.get_sample_value(
            "gpu_serving_sched_queue_wait_seconds_count") == 2
        assert reg.get_sample_value(
            "gpu_serving_sched_goodput_tokens_total",
            {"tenant": "gold", "priority": "0"}) == 3
        assert reg.get_sample_value(
            "gpu_serving_sched_deadline_misses_total",
            {"tenant": "default"}) == 1
    finally:
        server.stop()


def test_devices_stays_refused_naming_its_item(models):
    tcfg, tparams = models[2], models[3]
    with pytest.raises(NotImplementedError, match="A.14"):
        tbatch.ContinuousBatcher(tparams, tcfg, 2, 64, devices=object())
    cb = tbatch.ContinuousBatcher(
        tparams, tcfg, 2, 64, metrics=tsm.ServingMetrics(Registry()),
        trace_steps=True, attribution=None, mfu=None)
    assert cb.trace_steps and cb.metrics is not None

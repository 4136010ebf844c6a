"""Per-request latency attribution, the flight recorder and the live
roofline of the port, against the reference's (``tests/test_attribution.py``).

A tiny f32 model (two layers; the JAX weights come across through
``params_from_jax``) on the CPU:

- every retired request's segments and phases sum to its wall time
  within 5e-5 s, contiguously, with TTFT at its cursor, over the
  reference's matrix (layout x prefix cache x depth x speculative); the
  records' structure (segment names, tokens, prompt and cached tokens,
  chunks, inter-token counts) equals the JAX batcher's records for the
  same requests;
- greedy and seeded streams are bit-identical with attribution, metrics,
  the MFU accumulator and tracing attached or absent;
- the flight recorder (threshold, deadline, p99-of-window), the bounded
  rings and the cursor across a preemption give the reference's records
  for the same inputs;
- the cost model and ``MfuAccumulator`` give the reference's numbers when
  both price at the same peaks; a CUDA card missing from the table
  raises naming itself;
- the HTTP surface: the ``timeline`` field (native, SSE done event,
  OpenAI envelope), ``/debug/requests{,/rid}``, ``/debug/slow``,
  ``/v1/health``'s ``mfu`` and ``attribution`` with the reference's keys,
  and 404s with ``--attributionOff``.
"""

import dataclasses
import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.metrics import roofline as jroof
from k8s_gpu_device_plugin_tpu.models import batching as jbatch
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.models import spec_batching as jspec
from k8s_gpu_device_plugin_tpu.obs import attribution as jattr
from k8s_gpu_device_plugin_tpu.serving import prefix_cache as jpc
from k8s_gpu_device_plugin_torch.metrics import roofline as troof
from k8s_gpu_device_plugin_torch.metrics.exposition import Registry
from k8s_gpu_device_plugin_torch.metrics.serving_metrics import ServingMetrics
from k8s_gpu_device_plugin_torch.models import batching as tbatch
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models import spec_batching as tspec
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax
from k8s_gpu_device_plugin_torch.models.sampling import Sampler
from k8s_gpu_device_plugin_torch.obs import attribution as tattr
from k8s_gpu_device_plugin_torch.obs.trace import configure
from k8s_gpu_device_plugin_torch.serving import prefix_cache as tpc
from k8s_gpu_device_plugin_torch.serving import server as srv

torch.set_num_threads(1)

BUCKETS = (8, 16, 32)
PS = 16
H100 = troof.CARDS[troof.OFF_DEVICE_CARD]


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    # the draft: the target's first layer with its head
    jd = (dataclasses.replace(jcfg, n_layers=1),
          {**jparams, "layers": jax.tree.map(lambda x: x[:1],
                                             jparams["layers"])})
    td = (dataclasses.replace(tcfg, n_layers=1),
          {**tparams, "layers": {k: v[:1]
                                 for k, v in tparams["layers"].items()}})
    return jcfg, jparams, tcfg, tparams, jd, td


def _prompt(key, n, vocab=512):
    return np.random.default_rng(key).integers(1, vocab, n).tolist()


def _batcher(models, layout, cache, depth, spec, jax_side=False, **obs):
    jcfg, jparams, tcfg, tparams, jd, td = models
    cfg, params, draft = ((jcfg, jparams, jd) if jax_side
                          else (tcfg, tparams, td))
    pc_mod = jpc if jax_side else tpc
    pc = pc_mod.PrefixCache(cfg, buckets=BUCKETS, budget_bytes=1 << 22) \
        if cache else None
    kw = dict(n_slots=2, max_len=64, chunked_prefill=8, prompt_buckets=BUCKETS,
              pipeline_depth=depth, prefix_cache=pc, kv_layout=layout,
              kv_page_size=PS if layout == "paged" else None, **obs)
    if spec:
        mod = jspec if jax_side else tspec
        return mod.SpeculativeBatcher(params, cfg, draft[1], draft[0],
                                      gamma=3, **kw)
    mod = jbatch if jax_side else tbatch
    return mod.ContinuousBatcher(params, cfg, **kw)


def _matrix_requests(cb, spec):
    return [
        cb.submit(_prompt(7, 12), max_new=5),
        # the speculative engine shares one sampler: no per-request seed
        cb.submit(_prompt(8, 20), max_new=4, seed=None if spec else 11,
                  tenant="gold", priority=0),
        cb.submit(_prompt(7, 12), max_new=3),  # same prompt: a cache hit
    ]


MATRIX = [
    ("dense", False, 0, False),
    ("dense", False, 1, False),
    ("dense", True, 1, False),
    ("paged", False, 1, False),
    ("paged", True, 0, False),
    ("paged", True, 1, False),
    ("dense", False, 1, True),
    ("paged", True, 1, True),
]


@pytest.mark.parametrize("layout,cache,depth,spec", MATRIX)
def test_phase_breakdown_sums_to_wall_time(models, layout, cache, depth,
                                           spec):
    """The acceptance pin: every retired request's segments (and its
    phases) sum to its submit -> done wall time, contiguously."""
    att = tattr.RequestAttributor()
    cb = _batcher(models, layout, cache, depth, spec, attribution=att)
    rids = _matrix_requests(cb, spec)
    cb.run()
    stats = att.request_stats()
    assert stats["retired"] == len(rids)
    for rec in stats["requests"]:
        assert sum(d for _, _, d in rec["segments"]) == pytest.approx(
            rec["total_s"], abs=5e-5)
        assert sum(rec["phases"].values()) == pytest.approx(
            rec["total_s"], abs=5e-5)
        cursor = 0.0
        for _name, start, dur in rec["segments"]:
            assert start == pytest.approx(cursor, abs=5e-5)
            cursor = start + dur
        # TTFT is the queue_wait + prefill share (no preemptions here)
        assert rec["ttft_s"] == pytest.approx(
            rec["phases"]["queue_wait"] + rec["phases"]["prefill"],
            abs=5e-5)
        assert rec["phases"]["decode"] >= 0.0
        assert rec["detail"]["itl"]["count"] == max(0, rec["tokens"] - 1)
        assert rec["tokens"] == len(cb.done_requests[rec["rid"]].out)
        if spec:
            assert rec["spec_rounds"] >= 1


def _structure(rec: dict) -> tuple:
    return ([s[0] for s in rec["segments"]], rec["tokens"],
            rec["prompt_tokens"], rec["cached_tokens"],
            rec["prefill_chunks"], rec["detail"]["itl"]["count"],
            rec["tenant"], rec["priority"], rec["reason"])


@pytest.mark.parametrize("layout,cache,depth", [("dense", True, 1),
                                                ("paged", True, 0)])
def test_timeline_records_match_the_reference(models, layout, cache, depth):
    """The same requests through the JAX batcher and the port's: the
    timelines' structure is the reference's, record for record."""
    recs = []
    for jax_side in (True, False):
        att = (jattr if jax_side else tattr).RequestAttributor()
        cb = _batcher(models, layout, cache, depth, False, jax_side=jax_side,
                      attribution=att)
        _matrix_requests(cb, False)
        cb.run()
        recs.append({r["rid"]: _structure(r)
                     for r in att.request_stats()["requests"]})
    assert recs[0] == recs[1]


@pytest.mark.parametrize("layout,depth,spec", [("dense", 1, False),
                                               ("paged", 0, False),
                                               ("paged", 1, True)])
def test_streams_bit_identical_attribution_on_off(models, layout, depth,
                                                  spec):
    """The house pin: attribution, metrics, the MFU accumulator and span
    tracing (with the per-step spans) attached or absent, greedy and
    seeded token and logprob streams are the same bit for bit."""
    tcfg = models[2]

    def run(on):
        obs = {}
        if on:
            metrics = ServingMetrics(Registry())
            obs = dict(
                attribution=tattr.RequestAttributor(metrics=metrics),
                mfu=troof.MfuAccumulator(
                    troof.ServingCostModel.for_config(tcfg, device="cpu"),
                    metrics=metrics, window_s=0.0),
                metrics=metrics, trace_steps=True)
        tracer = configure(enabled=on)
        tracer.clear()
        try:
            cb = _batcher(models, layout, True, depth, spec, **obs)
            cb.submit(_prompt(21, 12), max_new=6)
            if spec:
                cb.submit(_prompt(22, 9), max_new=5)
            else:
                cb.submit(_prompt(22, 9), max_new=5, seed=7,
                          sampler=Sampler(temperature=0.8, top_k=8))
            cb.run()
            if on:
                assert tracer.traces()  # the trees were really built
        finally:
            configure(enabled=False)
            tracer.clear()
        return {rid: (tuple(r.out), tuple(r.out_logp))
                for rid, r in cb.done_requests.items()}

    assert run(False) == run(True)


# --- flight recorder: the same synthetic retirements through both --------


class _FakeReq:
    def __init__(self, rid, t_submit, tenant="default"):
        self.rid = rid
        self.tenant = tenant
        self.priority = 1
        self.t_submit = t_submit
        self.t_first_tok = t_submit
        self.out = [1, 2]
        self.prompt = [3] * 4
        self.cached_tokens = 0
        self.prefill_computed = 4
        self.prefilled_out = 0
        self.preemptions = 0
        self.deadline = None
        self.timeline = None


def _retire(att, rid, total_s, missed=False, t0=100.0):
    req = _FakeReq(rid, t0)
    req.timeline = att.start(req)
    req.timeline.advance("prefill", t0)
    req.timeline.advance("decode", t0)
    att.on_retired(req, "budget", t0 + total_s, deadline_missed=missed)
    return req


def _strip(obj):
    """Records without the wall-clock submit stamp (the two attributors
    read the clock at different instants)."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k != "t_submit_wall"}
    if isinstance(obj, list):
        return [_strip(x) for x in obj]
    return obj


def _both(make, drive) -> list:
    out = []
    for mod in (jattr, tattr):
        att = make(mod)
        drive(att)
        out.append(_strip([att.request_stats(), att.slow_stats(),
                           att.count_stats()]))
    return out


def test_flight_recorder_threshold_and_deadline():
    def drive(att):
        _retire(att, 0, 0.001)           # fast: summary only
        _retire(att, 1, 0.050)           # breaches 5 ms: full detail
        _retire(att, 2, 0.001, missed=True)  # deadline miss: always kept

    ref, port = _both(
        lambda m: m.RequestAttributor(slow_ms=5.0, window_min=10_000), drive)
    assert port == ref
    slow = port[1]
    assert slow["captured"] == 2
    assert {r["rid"] for r in slow["requests"]} == {1, 2}
    for r in slow["requests"]:
        assert r["slow"] is True and "steps" in r
    att = tattr.RequestAttributor(slow_ms=5.0, window_min=10_000)
    drive(att)
    assert "steps" not in att.get(0) and "steps" in att.get(1)
    assert att.get(99) is None


def test_flight_recorder_p99_auto_trigger():
    def drive(att):
        for i in range(10):
            _retire(att, i, 0.001 * (1 + i % 3))
        _retire(att, 99, 0.500)  # 500x the window p99: captured

    ref, port = _both(
        lambda m: m.RequestAttributor(slow_ms=0.0, window=64, window_min=8),
        drive)
    assert port == ref
    assert any(r["rid"] == 99 for r in port[1]["requests"])
    assert port[1]["auto_p99_ms"] is not None


def test_recent_and_slow_rings_are_bounded():
    def drive(att):
        for i in range(10):
            _retire(att, i, 0.001 if i % 2 else 1.0)

    ref, port = _both(
        lambda m: m.RequestAttributor(recent=4, slow_ring=2, slow_ms=500.0,
                                      window_min=10_000), drive)
    assert port == ref
    assert port[2]["retired"] == 10
    assert [r["rid"] for r in port[0]["requests"]] == [9, 8, 7, 6]
    assert [r["rid"] for r in port[1]["requests"]] == [8, 6]


def test_timeline_cursor_exactness_across_preemption_shape():
    """queue -> prefill -> decode -> queue -> prefill -> decode sums
    exactly, and the records equal the reference's."""
    recs = []
    for mod in (jattr, tattr):
        att = mod.RequestAttributor()
        t0 = 100.0
        req = _FakeReq(0, t0)
        tl = att.start(req)
        req.timeline = tl
        tl.advance("prefill", t0 + 1)     # admitted
        tl.advance("decode", t0 + 3)      # first token
        tl.advance("queue_wait", t0 + 4)  # preempted
        tl.advance("prefill", t0 + 6)     # re-admitted
        tl.advance("decode", t0 + 7)      # resumed first token
        recs.append(_strip(att.on_retired(req, "budget", t0 + 9)))
    assert recs[1] == recs[0]
    assert recs[1]["phases"] == {"queue_wait": pytest.approx(3.0),
                                 "prefill": pytest.approx(3.0),
                                 "decode": pytest.approx(3.0)}
    assert sum(d for _, _, d in recs[1]["segments"]) == pytest.approx(9.0)


def test_timeline_bounds_step_detail():
    tl = tattr.RequestTimeline(0, "rid:0", "default", 1, 0.0)
    for i in range(5000):
        tl.add_itl(float(i), 0.001)
    assert len(tl.steps) == tattr.MAX_STEP_DETAIL == jattr.MAX_STEP_DETAIL
    assert tl.itl_count == 5000


# --- the roofline -------------------------------------------------------


def _cost_models(models):
    """The port's cost model on the CPU (the H100's peaks) and the
    reference's given the same peaks."""
    jcfg, tcfg = models[0], models[2]
    port = troof.ServingCostModel.for_config(tcfg, device="cpu")
    ref = dataclasses.replace(
        jroof.ServingCostModel.for_config(jcfg, generation="v5e"),
        generation=port.generation, peak_tflops=H100.peak_bf16_tflops,
        hbm_gbps=H100.hbm_gbps)
    return ref, port


def test_cost_model_matches_the_reference_at_the_same_peaks(models):
    ref, port = _cost_models(models)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    tcfg = models[2]
    assert port.flops_per_token == pytest.approx(tcfg.flops_per_token() / 3)
    assert port.weight_bytes == int(port.flops_per_token / 2) * 4  # f32
    for args in ((2, 50), (8, 8000), (0, 0)):
        assert port.decode_step_bytes(*args) == ref.decode_step_bytes(*args)
    for f, t in ((1e12, 1.0), (3e14, 0.25), (1.0, 0.0)):
        assert port.mfu_pct(f, t) == ref.mfu_pct(f, t)
        assert port.hbm_bw_util_pct(f, t) == ref.hbm_bw_util_pct(f, t)
    assert port.mfu_pct(port.peak_tflops * 1e12, 1.0) == pytest.approx(100.0)
    assert port.hbm_bw_util_pct(port.hbm_gbps * 1e9, 1.0) == \
        pytest.approx(100.0)
    assert port.generation.startswith("NVIDIA H100 80GB HBM3")
    assert "cpu" in port.generation
    # tp divides the same work across the cards
    tp2 = troof.ServingCostModel.for_config(models[2], device="cpu", tp=2)
    assert tp2.mfu_pct(1e12, 1.0) == pytest.approx(port.mfu_pct(1e12, 1.0) / 2)


def test_card_table_raises_for_an_unknown_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA Imaginary 7")
    with pytest.raises(ValueError, match="NVIDIA Imaginary 7"):
        troof.card_for("cuda")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert troof.card_for("cuda") == ("NVIDIA H100 80GB HBM3", H100)
    assert (H100.peak_bf16_tflops, H100.hbm_gbps) == (989.4, 3352.0)


class _Rec:
    """A metrics double recording what the accumulator pushes."""

    def __init__(self):
        self.calls = []

    def set_mfu(self, mfu_pct, bw_pct):
        self.calls.append(("set_mfu", mfu_pct, bw_pct))

    def on_model_work(self, flops, nbytes):
        self.calls.append(("work", flops, nbytes))

    def on_tenant_flops(self, tenant, flops):
        self.calls.append(("tenant", tenant, flops))


def test_mfu_accumulator_matches_the_reference(models, monkeypatch):
    """The same hook sequence on a shared fake clock: totals, windows,
    the gauges pushed, per-tenant goodput per TFLOP, the idle reset."""
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    ref_model, port_model = _cost_models(models)
    out = []
    for mod, model in ((jroof, ref_model), (troof, port_model)):
        rec = _Rec()
        acc = mod.MfuAccumulator(model, metrics=rec, window_s=1.0)
        acc.on_prefill_tokens(10)
        for step in range(5):
            clock[0] += 0.4
            acc.on_step(emitted=2, active=2, live_tokens=20 + 2 * step)
        req = _FakeReq(0, 0.0, tenant="gold")
        acc.on_retired(req, goodput_tokens=2)
        mid = acc.mfu_stats()
        acc.on_idle()
        out.append((acc.totals(), mid, acc.mfu_stats(), rec.calls))
    assert out[1] == out[0]
    (flops, nbytes), mid, idle, calls = out[1]
    assert flops == pytest.approx(20 * port_model.flops_per_token)
    # a window closed with positive shares (the tiny model's round to 0
    # in the snapshot's four decimals)
    assert any(c[0] == "set_mfu" and c[1] > 0 and c[2] > 0 for c in calls)
    assert mid["tenants"]["gold"]["goodput_tokens"] == 2
    assert idle["serving_mfu_pct"] == 0.0 and calls[-1] == ("set_mfu", 0, 0)


# --- the HTTP surface ------------------------------------------------------


def _serve(flags, params):
    args = srv.build_parser().parse_args([
        "--preset", "tiny", "--device", "cpu", "--host", "127.0.0.1",
        "--port", "0", "--slots", "2", "--maxLen", "64", "--chunkedPrefill",
        "8", "--seed", "0", *flags])
    server = srv.build_server(args, params=params)
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
def tiny_bf16():
    cfg = srv.PRESETS["tiny"]()
    return srv.load_params(cfg, seed=0, device="cpu")


@pytest.fixture(scope="module")
def served(tiny_bf16):
    """The server at its defaults: attribution and the roofline on."""
    server, url = _serve(["--slowRequestMs", "1"], tiny_bf16)
    try:
        yield server, url
    finally:
        server.stop()


def test_generate_timeline_and_debug_endpoints(served):
    _, url = served
    prompt = _prompt(31, 10)
    status, _, body = _call(url, "/v1/generate",
                            {"prompt": prompt, "max_new": 4})
    assert status == 200 and "timeline" not in json.loads(body)
    status, _, body = _call(url, "/v1/generate",
                            {"prompt": prompt, "max_new": 4,
                             "timeline": True})
    assert status == 200
    tl = json.loads(body)["timeline"]
    assert tl["tokens"] == 4
    assert set(tl["phases"]) == {"queue_wait", "prefill", "decode"}
    assert sum(tl["phases"].values()) == pytest.approx(tl["total_s"],
                                                       abs=5e-5)
    rid = tl["rid"]
    status, _, body = _call(url, "/debug/requests")
    listing = json.loads(body)
    assert status == 200 and listing["retired"] >= 2
    assert any(r["rid"] == rid for r in listing["requests"])
    status, _, body = _call(url, f"/debug/requests/{rid}")
    assert status == 200 and json.loads(body)["rid"] == rid
    assert _call(url, "/debug/requests/notanint")[0] == 400
    assert _call(url, "/debug/requests/999999")[0] == 404
    # --slowRequestMs 1: every request is captured with its step detail
    status, _, body = _call(url, "/debug/slow")
    slow = json.loads(body)
    assert status == 200 and slow["captured"] >= 2 and slow["slow_ms"] == 1.0
    assert "steps" in slow["requests"][0]


def test_sse_done_event_and_openai_envelope_carry_the_timeline(served):
    _, url = served
    status, _, raw = _call(url, "/v1/generate",
                           {"prompt": _prompt(33, 8), "max_new": 3,
                            "stream": True, "timeline": True})
    assert status == 200
    events = [json.loads(line[len("data: "):])
              for line in raw.splitlines() if line.startswith("data: ")]
    assert events[-1]["done"] is True
    assert events[-1]["timeline"]["tokens"] == 3
    status, _, body = _call(url, "/v1/completions",
                            {"prompt": _prompt(35, 9), "max_tokens": 3,
                             "timeline": True})
    assert status == 200 and json.loads(body)["timeline"]["tokens"] == 3
    status, _, body = _call(url, "/v1/completions",
                            {"prompt": _prompt(35, 9), "max_tokens": 3})
    assert "timeline" not in json.loads(body)


def test_health_carries_mfu_and_attribution_with_the_reference_keys(served):
    _, url = served
    _call(url, "/v1/generate", {"prompt": _prompt(37, 9), "max_new": 3})
    status, _, body = _call(url, "/v1/health")
    health = json.loads(body)
    ref_model = jroof.ServingCostModel.for_config(
        jllama.LlamaConfig.tiny(), generation="v5e")
    assert set(health["mfu"]) == set(
        jroof.MfuAccumulator(ref_model).mfu_stats())
    assert set(health["attribution"]) == set(
        jattr.RequestAttributor().count_stats())
    assert health["mfu"]["generation"].startswith("NVIDIA H100 80GB HBM3")
    assert health["mfu"]["peak_tflops"] == 989.4
    assert health["mfu"]["model_tflops_total"] > 0
    assert health["attribution"]["retired"] >= 1


def test_debug_endpoints_404_when_attribution_off(tiny_bf16):
    server, url = _serve(["--attributionOff"], tiny_bf16)
    try:
        for path in ("/debug/requests", "/debug/requests/0", "/debug/slow"):
            assert _call(url, path)[0] == 404
        status, _, body = _call(url, "/v1/generate",
                                {"prompt": [1, 2, 3], "max_new": 2,
                                 "timeline": True})
        got = json.loads(body)
        # the opt-in field answers null, never an error
        assert status == 200 and got["timeline"] is None
        health = json.loads(_call(url, "/v1/health")[2])
        assert "mfu" not in health and "attribution" not in health
    finally:
        server.stop()

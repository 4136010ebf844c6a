"""The engine supervisor, the fault plane's engine seams and the server's
scheduling surface, on the CPU.

An injected crash on the engine thread (``decode.apply`` mid-decode,
``prefill.dispatch`` mid-prefill), on dense and paged caches with the
prefix cache on, is recovered in place: every stream completes with the
tokens of an uncrashed run (logprobs within 1e-5: the resumed token's
comes from a prefill forward), no error frame, and ``/v1/health``'s
``supervisor`` counts the restart. Past the restart budget every open
stream ends with a structured ``engine_dead`` frame. The ``supervisor``
and ``sched`` sections carry the reference's keys; a burst past
``--maxQueue`` answers 429 with ``Retry-After``; ``resume_out`` continues
a stream over HTTP; the ``health.handler`` point answers 500.
"""

import json
import queue
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_torch.models.batching import ContinuousBatcher
from k8s_gpu_device_plugin_torch.models.llama import LlamaConfig
from k8s_gpu_device_plugin_torch.serving import server as srv
from k8s_gpu_device_plugin_torch.serving.faults import FaultPlane
from k8s_gpu_device_plugin_torch.serving.prefix_cache import PrefixCache
from k8s_gpu_device_plugin_torch.serving.scheduler import Scheduler
from k8s_gpu_device_plugin_torch.serving.supervisor import (
    EngineSupervisor,
    StreamError,
)
from k8s_gpu_device_plugin_tpu.serving import scheduler as jsched
from k8s_gpu_device_plugin_tpu.serving import supervisor as jsup

# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's OpenMP pool from spinning against
# them (these shapes gain nothing from more)
torch.set_num_threads(1)

SPECS = [(5, 12), (40, 10), (20, 14), (36, 8)]  # (prompt length, max_new)


@pytest.fixture(scope="module")
def model():
    cfg = LlamaConfig.tiny(dtype=torch.float32, head_dim_override=64,
                           n_layers=2)
    return cfg, srv.load_params(cfg, seed=3, device="cpu")


def _prompts(vocab):
    rng = np.random.default_rng(21)
    return [rng.integers(1, vocab, n).tolist() for n, _ in SPECS]


def _recipe(cfg, params, layout, faults=None):
    def make():
        kw = {}
        if layout == "paged":
            kw = dict(kv_layout="paged", kv_page_size=16)
        return ContinuousBatcher(
            params, cfg, n_slots=2, max_len=128, chunked_prefill=16,
            prefix_cache=make.cache, scheduler=make.sched, faults=faults,
            **kw)

    # one cache and one scheduler across rebuilds, as the server's recipe
    make.cache = PrefixCache(cfg, buckets=(32, 64, 128), budget_bytes=1 << 22)
    make.sched = Scheduler()
    return make


def _drain(q: queue.Queue) -> list:
    items = []
    while True:
        item = q.get(timeout=120)
        if item is None:
            return items
        items.append(item)


def _uncrashed(cfg, params, layout):
    cb = _recipe(cfg, params, layout)()
    rids = [cb.submit(p, max_new=n)
            for p, (_, n) in zip(_prompts(cfg.vocab_size), SPECS)]
    cb.run()
    return [cb.done_requests[r] for r in rids]


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("spec", ["decode.apply:nth=6",
                                  "prefill.dispatch:nth=3"])
def test_crash_recovers_with_the_uncrashed_tokens(model, layout, spec):
    cfg, params = model
    want = _uncrashed(cfg, params, layout)
    plane = FaultPlane.from_spec(spec)
    engine = srv.InferenceEngine(
        make_batcher=_recipe(cfg, params, layout, plane),
        supervisor=EngineSupervisor(max_restarts=2))
    try:
        subs = [engine.submit(p, n) for p, (_, n)
                in zip(_prompts(cfg.vocab_size), SPECS)]
        got = [_drain(q) for _, q in subs]
        stats = engine.stats()
    finally:
        engine.shutdown()
    for items, w in zip(got, want):
        assert not any(isinstance(x, StreamError) for x in items)
        assert [t for t, _ in items] == w.out
        np.testing.assert_allclose([lp for _, lp in items], w.out_logp,
                                   atol=1e-5, rtol=0)
    sup = stats["supervisor"]
    assert (sup["crashes_total"], sup["restarts_total"]) == (1, 1)
    assert sup["state"] == "ok" and stats["alive"]
    assert sup["resumed_total"] + sup["replayed_total"] >= 1
    if spec.startswith("decode"):
        assert sup["resumed_total"] >= 1
    assert "injected fault" in sup["last_crash"]["error"]
    if layout == "paged":
        # the new pool holds only what the prefix cache pins
        while engine.cb.prefix_cache.evict_one():
            pass
        assert engine.cb.pool.in_use == 0


def test_budget_exhausted_closes_every_stream_with_engine_dead(model):
    cfg, params = model
    # two fires: the second lands right after the one allowed restart
    plane = FaultPlane.from_spec("decode.apply:nth=4:times=2")
    engine = srv.InferenceEngine(
        make_batcher=_recipe(cfg, params, "dense", plane),
        supervisor=EngineSupervisor(max_restarts=1))
    try:
        subs = [engine.submit(p, n) for p, (_, n)
                in zip(_prompts(cfg.vocab_size), SPECS)]
        got = [_drain(q) for _, q in subs]
        stats = engine.stats()
        with pytest.raises(RuntimeError, match="dead"):
            engine.submit([1, 2], 2)
    finally:
        engine.shutdown()
    for items, (_, n) in zip(got, SPECS):
        # never a silent short completion: a structured frame ends it
        assert isinstance(items[-1], StreamError)
        assert items[-1].code == "engine_dead"
        assert "restart budget exhausted" in items[-1].message
        assert len(items) - 1 < n
    assert not stats["alive"]
    assert stats["supervisor"]["state"] == "dead"
    assert stats["supervisor"]["restarts_total"] == 1
    # an engine without a recipe has no supervisor: a crash ends it
    with pytest.raises(ValueError, match="recipe"):
        srv.InferenceEngine(_recipe(cfg, params, "dense")(),
                            supervisor=EngineSupervisor())


@pytest.fixture(scope="module")
def served():
    args = srv.build_parser().parse_args([
        "--device", "cpu", "--preset", "tiny", "--port", "0", "--host",
        "127.0.0.1", "--slots", "1", "--maxLen", "128", "--chunkedPrefill",
        "16", "--schedPolicy", "slo", "--maxQueue", "1",
        "--faults", "health.handler:nth=2"])
    tiny = srv.PRESETS["tiny"]()
    server = srv.build_server(args, params=srv.load_params(
        tiny, seed=0, device="cpu"))
    server.start()
    try:
        yield f"http://127.0.0.1:{server.bound_port}", server
    finally:
        server.stop()


def _call(url, path, body=None):
    req = urllib.request.Request(
        url + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read().decode()


def test_health_sections_carry_the_reference_keys(served):
    url, _ = served
    status, _, body = _call(url, "/v1/health")
    assert status == 200
    health = json.loads(body)
    assert set(health["supervisor"]) == set(jsup.EngineSupervisor().stats())
    assert set(health["sched"]) == set(jsched.SloScheduler().sched_stats())
    assert health["sched"]["policy"] == "slo"
    assert health["supervisor"]["max_restarts"] == 3
    # the armed health.handler point fires on its second hit only
    status, _, body = _call(url, "/v1/health")
    assert status == 500 and "health.handler" in json.loads(body)["error"]
    assert _call(url, "/v1/health")[0] == 200


def test_burst_past_max_queue_answers_429_with_retry_after(served):
    url, _ = served
    out = []

    def post():
        out.append(_call(url, "/v1/generate",
                         {"prompt": list(range(1, 30)), "max_new": 90}))

    threads = [threading.Thread(target=post) for _ in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    codes = sorted(s for s, _, _ in out)
    assert 200 in codes and 429 in codes
    status, headers, body = next(o for o in out if o[0] == 429)
    err = json.loads(body)
    assert (err["code"], err["reason"]) == ("overloaded", "queue_full")
    assert int(headers["Retry-After"]) == err["retry_after"] >= 1
    status, _, body = _call(url, "/v1/health")
    assert json.loads(body)["sched"]["rejections"]["queue_full"] >= 1


def test_http_resume_continues_the_stream(served):
    url, _ = served
    prompt = list(range(3, 40))
    status, _, body = _call(url, "/v1/generate", {
        "prompt": prompt, "max_new": 12, "logprobs": True})
    assert status == 200
    full = json.loads(body)
    status, _, body = _call(url, "/v1/generate", {
        "prompt": prompt, "max_new": 12, "resume_out": full["tokens"][:5],
        "resume_logprobs": full["logprobs"][:5]})
    assert status == 200, body
    # only the continuation comes back
    assert json.loads(body)["tokens"] == full["tokens"][5:]
    status, _, body = _call(url, "/v1/generate", {
        "prompt": prompt, "max_new": 12, "resume_out": "abc"})
    assert status == 400 and "resume_out" in json.loads(body)["error"]
    status, _, body = _call(url, "/v1/generate", {
        "prompt": prompt, "max_new": 4, "resume_out": [1, 2, 3, 4]})
    assert status == 422 and "nothing left" in json.loads(body)["error"]

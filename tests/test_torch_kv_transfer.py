"""KV page export and install in the port (``models/paging.py``'s wire
format, ``models/batching.py``'s export and install,
``serving/server.py``'s ``POST /v1/kv/export/{rid}``), against the
reference's ``tests/test_kv_transfer.py`` (without tensor parallelism and
without the router, which the port has not yet).

A tiny model (2 layers, hd 64, pages of 16, chunks of 8) with the JAX
weights converted. Pins:

- **round trip**: a stream exported after three tokens and resubmitted
  to another batcher with ``resume_out`` + ``kv_pages`` continues with
  the uninterrupted stream's tokens and logprobs bit for bit, on f32,
  bf16, int8 and int4 caches, at pipeline depth 0 and 1, greedy, seeded
  and with a repetition penalty (the install lands in a slot whose
  previous occupant marked other tokens); a re-export of an installed
  stream gives the original blob's full pages byte for byte;
- **pool discipline**: the source holds its pages until the cancel, an
  installed request cancelled mid-decode drains the pool to zero,
  ``pool.check()`` holds after every run; an install under a prefix
  cache makes no match;
- **refusals**: dense, unknown and prefilling exports; every mismatch
  ``validate_kv_pages`` checks; a full pool answers 429
  ``kv_pool_pressure`` with ``Retry-After: 1``;
- **over HTTP**, two port servers: 200 (the spliced stream is the
  uninterrupted one), 400, 404, 409, 422 and 503;
- **spans and counts**: ``kv_export`` / ``kv_install`` spans and the
  ``kv_installed`` provenance;
- **across frameworks** (f32): both packages' ``pack_kv_wire`` give the
  same blob for the same planes, each unpacks the other's, malformed
  blobs raise the same messages; a blob the JAX batcher exported
  continues in the port with the JAX uninterrupted run's greedy tokens,
  logprobs within 1e-4, and the reverse.
"""

import contextlib
import dataclasses
import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_torch.metrics.exposition import Registry
from k8s_gpu_device_plugin_torch.metrics.serving_metrics import ServingMetrics
from k8s_gpu_device_plugin_torch.models import batching as tbatch
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models import paging as tpaging
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax
from k8s_gpu_device_plugin_torch.models.sampling import Sampler
from k8s_gpu_device_plugin_torch.obs import trace as ttrace
from k8s_gpu_device_plugin_torch.serving import server as srv
from k8s_gpu_device_plugin_torch.serving.prefix_cache import PrefixCache
from k8s_gpu_device_plugin_torch.serving.scheduler import (
    SchedulerOverloadError,
)
from k8s_gpu_device_plugin_tpu.models import batching as jbatch
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.models import paging as jpaging

torch.set_num_threads(1)

PS, CHUNK, MAX_LEN = 16, 8, 64
BUCKETS = (8, 16, 32)
KW = dict(n_slots=2, max_len=MAX_LEN, prompt_buckets=BUCKETS,
          chunked_prefill=CHUNK, kv_layout="paged", kv_page_size=PS)
MAX_NEW = 10


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, head_dim_override=64,
                                   n_layers=2)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, head_dim_override=64,
                                   n_layers=2)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def bf16_params(models):
    jcfg, jparams, tcfg, _ = models
    cfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    return cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")


def _prompt(key, n, vocab):
    return np.random.default_rng(key).integers(1, vocab, n).tolist()


def _cfg(tcfg, cache):
    """The port's f32 config with ``cache_quant`` ``cache``."""
    return dataclasses.replace(tcfg, cache_quant=cache)


def _batcher(params, cfg, **kw):
    return tbatch.ContinuousBatcher(params, cfg, **{**KW, **kw})


def _step_until(cb, rid, n):
    """Step until ``rid`` has emitted at least ``n`` tokens (and still
    decodes)."""
    for _ in range(300):
        if any(r.rid == rid and len(r.out) >= n for r in cb.running.values()):
            return
        assert rid not in cb.done, "finished before the export point"
        cb.step()
    raise AssertionError(f"request {rid} never reached {n} tokens")


def _finish(cb, rid):
    cb.run()
    req = cb.done_requests[rid]
    return req.out, req.out_logp


def _drained(cb):
    cb.pool.check()
    assert cb.pool.in_use == 0


def _export(params, cfg, prompt, depth=1, **kw):
    """A stream on its own batcher, exported after three tokens and then
    cancelled: (blob, resume_out, resume_logprobs)."""
    src = _batcher(params, cfg, pipeline_depth=depth)
    rid = src.submit(prompt, MAX_NEW, **kw)
    _step_until(src, rid, 3)
    blob, out, lps = src.export_kv_pages(rid)
    assert src.pool.in_use > 0  # the export does not release the source
    assert src.cancel(rid)
    src.run()
    _drained(src)
    return blob, out, lps


MODES = {"greedy": {}, "seeded": {"sampler": Sampler(temperature=0.8),
                                  "seed": 123},
         "penalty": {"sampler": Sampler(repetition_penalty=1.5)}}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("cache", ["none", "bf16", "int8", "int4"])
def test_export_install_continues_bit_for_bit(models, bf16_params, cache,
                                              depth, mode):
    _, _, tcfg, tparams = models
    if cache == "bf16":  # an unquantized bf16 model and cache
        cfg, tparams = bf16_params
    else:
        cfg = _cfg(tcfg, cache)
    kw = dict(MODES[mode])
    prompt = _prompt(5, 20, cfg.vocab_size)
    ref = _batcher(tparams, cfg, pipeline_depth=depth)
    want = _finish(ref, ref.submit(prompt, MAX_NEW, **kw))

    blob, out, lps = _export(tparams, cfg, prompt, depth, **kw)
    assert blob["cache_quant"] == cfg.cache_quant
    assert blob["tokens"] == len(prompt) + len(out) - 1
    assert blob["n_pages"] == -(-blob["tokens"] // PS)
    assert len(out) >= 3 and lps == want[1][:len(out)]

    dst = _batcher(tparams, cfg, pipeline_depth=depth)
    # the install's slot held another prompt first (its presence row is
    # stale), and a neighbour decodes beside it
    first = dst.submit(_prompt(6, 12, cfg.vocab_size), 2)
    dst.submit(_prompt(7, 9, cfg.vocab_size), 30)
    while first not in dst.done:
        dst.step()
    rid = dst.submit(prompt, MAX_NEW, resume_out=out, resume_logp=lps,
                     kv_pages=blob, **kw)
    got = _finish(dst, rid)
    assert got[0] == want[0]
    assert got[1] == want[1]  # logprobs bit for bit, not within a tolerance
    assert dst.prefill_tokens["kv_installed"] == blob["tokens"]
    _drained(dst)


@pytest.mark.parametrize("cache", ["none", "int8", "int4"])
def test_reexport_reproduces_the_blob_bitwise(models, cache):
    """Re-exporting an installed stream gives the original blob's full
    pages byte for byte on every plane, codes and scales alike: the
    transfer copies rows, it never re-encodes them."""
    _, _, tcfg, tparams = models
    cfg = _cfg(tcfg, cache)
    prompt = _prompt(5, 20, cfg.vocab_size)
    blob, out, lps = _export(tparams, cfg, prompt, seed=123,
                             sampler=Sampler(temperature=0.8))
    dst = _batcher(tparams, cfg)
    rid = dst.submit(prompt, MAX_NEW, resume_out=out, resume_logp=lps,
                     kv_pages=blob, seed=123, sampler=Sampler(temperature=0.8))
    _step_until(dst, rid, len(out) + 1)
    blob2, out2, _ = dst.export_kv_pages(rid)
    dst.cancel(rid)
    _drained(dst)
    assert out2[:len(out)] == out
    _, p1 = tpaging.unpack_kv_wire(blob)
    _, p2 = tpaging.unpack_kv_wire(blob2)
    assert set(p1) == set(p2) == ({"k", "v"} if cache == "none" else
                                  {"k", "v", "k_scale", "v_scale"})
    full = blob["tokens"] // PS
    assert full >= 1
    for name in p1:
        assert torch.equal(p1[name][:, :full].view(torch.uint8),
                           p2[name][:, :full].view(torch.uint8)), name
    if cache == "int4":
        # the reference's int4 planes: one code a byte, last axis hd
        assert blob["planes"]["k"]["dtype"] == "int4"
        assert blob["planes"]["k"]["shape"][-1] == cfg.head_dim


def test_export_refuses_dense_unknown_and_prefilling(models):
    _, _, tcfg, tparams = models
    dense = tbatch.ContinuousBatcher(
        tparams, tcfg, n_slots=2, max_len=MAX_LEN, prompt_buckets=BUCKETS,
        chunked_prefill=CHUNK)
    rid = dense.submit(_prompt(6, 10, tcfg.vocab_size), 4)
    with pytest.raises(ValueError, match="paged"):
        dense.export_kv_pages(rid)
    dense.run()
    cb = _batcher(tparams, tcfg)
    with pytest.raises(KeyError, match="unknown or finished"):
        cb.export_kv_pages(999)
    rid = cb.submit(_prompt(6, 20, tcfg.vocab_size), 4)
    with pytest.raises(ValueError, match="not finished prefill"):
        cb.export_kv_pages(rid)  # queued: no pages yet
    cb.step()
    assert rid in {r.rid for r in cb.prefilling.values()}
    with pytest.raises(ValueError, match="not finished prefill"):
        cb.export_kv_pages(rid)
    cb.run()
    with pytest.raises(KeyError, match="unknown or finished"):
        cb.export_kv_pages(rid)
    _drained(cb)


@pytest.fixture(scope="module")
def int8_blob(models):
    _, _, tcfg, tparams = models
    cfg = _cfg(tcfg, "int8")
    prompt = _prompt(5, 20, cfg.vocab_size)
    return (cfg, prompt) + _export(tparams, cfg, prompt)


def _mutated(blob, what):
    b = json.loads(json.dumps(blob))
    if what == "page_size":
        b["page_size"] = 8
    elif what == "tokens":
        b["tokens"] -= 1
    elif what == "n_pages":  # one page more than the rows need
        meta, planes = tpaging.unpack_kv_wire(b)
        planes = {k: torch.cat([x, x[:, :1]], dim=1)
                  for k, x in planes.items()}
        b = tpaging.pack_kv_wire(planes, page_size=meta["page_size"],
                                 cache_quant=meta["cache_quant"],
                                 tokens=meta["tokens"])
    elif what == "planes":
        del b["planes"]["v_scale"]
    elif what == "dtype":
        b["planes"]["k"]["dtype"] = "int4"  # int8 bytes declared int4
    elif what == "rows":
        p = b["planes"]["k_scale"]
        p["shape"][-2] //= 2
        p["shape"][-1] *= 2
    return b


MISMATCHES = {
    "page_size": "page_size=8 but this pool uses 16",
    "cache_quant": "exported from a cache_quant='int8' pool",
    "planes": r"carries planes \['k', 'k_scale', 'v'\]",
    "dtype": r"plane 'k' is .* int4; this pool's rows are .* int8",
    "rows": r"plane 'k_scale' is .*; this pool's rows are \(L=2, n, 16, 4",
    "tokens": r"covers \d+ cache rows but the folded prompt",
    "n_pages": r"ships \d+ pages for \d+ rows; page_size 16 needs",
    "no_resume_out": "kv_pages without resume_out",
    "dense_receiver": "requires the paged KV layout",
}


@pytest.mark.parametrize("what", list(MISMATCHES))
def test_validate_kv_pages_refuses_every_mismatch(models, int8_blob, what):
    _, _, tcfg, tparams = models
    cfg, prompt, blob, out, lps = int8_blob
    kw = {}
    if what == "cache_quant":
        cfg = _cfg(tcfg, "int4")
    elif what == "dense_receiver":
        kw = dict(kv_layout="dense", kv_page_size=None)
    else:
        blob = _mutated(blob, what)
    resume = {} if what == "no_resume_out" else dict(resume_out=out,
                                                     resume_logp=lps)
    cb = _batcher(tparams, cfg, **kw)
    with pytest.raises(ValueError, match=MISMATCHES[what]):
        cb.submit(prompt, MAX_NEW, kv_pages=blob, **resume)
    assert not cb.pending
    if cb.pool is not None:
        _drained(cb)


def test_cancel_after_install_drains_and_source_holds_until_cancel(
        models, int8_blob):
    _, _, tcfg, tparams = models
    cfg, prompt, _, _, _ = int8_blob
    src = _batcher(tparams, cfg)
    rid = src.submit(prompt, MAX_NEW)
    _step_until(src, rid, 3)
    held = src.pool.in_use
    blob, out, lps = src.export_kv_pages(rid)
    assert src.pool.in_use == held > 0  # the source keeps its pages...
    src.step()
    assert src.pool.in_use == held      # ...and decodes on until...
    assert src.cancel(rid)              # ...the cancel
    _drained(src)
    dst = _batcher(tparams, cfg)
    rid2 = dst.submit(prompt, MAX_NEW, resume_out=out, resume_logp=lps,
                      kv_pages=blob)
    _step_until(dst, rid2, len(out) + 1)
    # a cold admission's reservation: prompt + the whole budget
    assert dst.pool.in_use == dst.pool.pages_for_tokens(len(prompt) + MAX_NEW)
    assert dst.cancel(rid2)
    dst.run()
    _drained(dst)


def test_install_under_a_prefix_cache_makes_no_match(models):
    _, _, tcfg, tparams = models
    prompt = _prompt(8, 40, tcfg.vocab_size)
    blob, out, lps = _export(tparams, tcfg, prompt)
    pc = PrefixCache(tcfg, buckets=BUCKETS, budget_bytes=1 << 20)
    dst = _batcher(tparams, tcfg, prefix_cache=pc)
    dst.submit(prompt, 4)  # promotes the prompt's boundaries
    dst.run()
    assert pc.stats.entries > 0
    hits = pc.stats.hits
    rid = dst.submit(prompt, MAX_NEW, resume_out=out, resume_logp=lps,
                     kv_pages=blob)
    got = _finish(dst, rid)
    assert pc.stats.hits == hits and pc.stats.misses == 1
    assert dst.done_requests[rid].cached_tokens == 0
    assert dst.pages_aliased == 0
    ref = _batcher(tparams, tcfg)
    assert got == _finish(ref, ref.submit(prompt, MAX_NEW))
    while pc.evict_one():
        pass
    _drained(dst)


def test_spans_and_the_kv_installed_count(models):
    _, _, tcfg, tparams = models
    prompt = _prompt(5, 20, tcfg.vocab_size)
    tracer = ttrace.configure(enabled=True)
    tracer.clear()
    try:
        blob, out, lps = _export(tparams, tcfg, prompt)
        registry = Registry()
        metrics = ServingMetrics(registry)
        dst = _batcher(tparams, tcfg, metrics=metrics)
        rid = dst.submit(prompt, MAX_NEW, resume_out=out, resume_logp=lps,
                         kv_pages=blob)
        dst.run()
        spans = [s for t in tracer.traces()
                 for s in tracer.get_trace(t["trace_id"])]
    finally:
        tracer.enabled = False
        tracer.clear()
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)
    (export,), (install,) = by_name["kv_export"], by_name["kv_install"]
    assert export["attrs"] == {"pages": blob["n_pages"],
                               "tokens": blob["tokens"]}
    assert install["attrs"] == export["attrs"]
    roots = {s["span_id"]: s for s in by_name["request"]}
    assert roots[install["parent_id"]]["attrs"]["rid"] == rid
    assert dst.prefill_tokens == {"computed": 0, "prefix_reused": 0,
                                  "kv_installed": blob["tokens"]}
    assert (f'gpu_serving_prefill_tokens_total{{source="kv_installed"}} '
            f'{float(blob["tokens"])}') in registry.render()


def test_install_pool_pressure_answers_kv_pool_pressure(models, int8_blob):
    """A pool that fits the stream but has not the pages free right now
    refuses the install at submit (the reference's 429 cue), and admits
    the same submit once the pages are back."""
    _, _, _, tparams = models
    cfg, prompt, blob, out, lps = int8_blob
    engine = srv.InferenceEngine(_batcher(tparams, cfg))
    try:
        pool = engine.cb.pool
        held = pool.alloc(pool.free_pages - 1)  # graftlint: disable=refcount-pairing
        try:
            with pytest.raises(SchedulerOverloadError) as ei:
                engine.submit(prompt, MAX_NEW, resume_out=out,
                              resume_logp=lps, kv_pages=blob)
            assert (ei.value.reason, ei.value.retry_after) == (
                "kv_pool_pressure", 1)
        finally:
            pool.decref(held)
        _, q = engine.submit(prompt, MAX_NEW, resume_out=out,
                             resume_logp=lps, kv_pages=blob)
        toks = srv.drain_queue(q)[0]
        # only the continuation streams: the client has the resumed ones
        assert len(toks) == MAX_NEW - len(out)
    finally:
        engine.shutdown()
    _drained(engine.cb)


# --- over HTTP: two port servers ---------------------------------------------


def _start(argv, params):
    args = srv.build_parser().parse_args([
        "--device", "cpu", "--preset", "tiny", "--port", "0", "--host",
        "127.0.0.1", "--maxLen", "128", "--chunkedPrefill", str(CHUNK),
        "--prefixCacheOff", *argv])
    server = srv.build_server(args, params=params)
    server.start()
    return server, f"http://127.0.0.1:{server.bound_port}"


def _call(url, path, body=None):
    req = urllib.request.Request(
        url + path, data=b"" if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _open_stream(url, body):
    """A streamed /v1/generate: (connection, response, its request id)."""
    host, port = url.removeprefix("http://").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    conn.request("POST", "/v1/generate", json.dumps({**body, "stream": True}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    return conn, resp, int(resp.getheader("X-Request-Id"))


def _frames(resp):
    while True:
        line = resp.readline()
        if not line:
            return
        if line.startswith(b"data: "):
            evt = json.loads(line[len(b"data: "):])
            yield evt
            if evt.get("done") or "error" in evt:
                return


@contextlib.contextmanager
def _paused_after(server, n):
    """Within the block, the engine's steps do nothing once a running
    request has ``n`` tokens: its loop goes on taking submissions and
    exports, so an export lands while the stream is live, however fast
    the CPU decodes it."""
    cb = server.engine.cb
    step = cb.step
    go = threading.Event()

    def paused():
        if not go.is_set() and any(len(r.out) >= n
                                   for r in cb.running.values()):
            time.sleep(0.001)
            return 0
        return step()

    cb.step = paused
    try:
        yield
    finally:
        go.set()


@pytest.fixture(scope="module")
def tiny_params():
    return srv.load_params(srv.PRESETS["tiny"](), seed=0, device="cpu")


@pytest.fixture(scope="module")
def servers(tiny_params):
    params = tiny_params
    paged = ["--kvLayout", "paged", "--kvPageSize", str(PS)]
    made = [_start([*paged, "--slots", "2"], params),
            _start([*paged, "--slots", "2"], params),
            _start(["--slots", "1"], params)]
    try:
        yield [url for _, url in made], [s for s, _ in made]
    finally:
        for server, _ in made:
            server.stop()


def test_http_export_and_install_between_two_servers(servers):
    (a, b, dense), (sa, sb, _) = servers
    body = {"prompt": _prompt(5, 20, 512), "max_new": 40, "seed": 123,
            "temperature": 0.8, "logprobs": True}
    status, ref, _ = _call(b, "/v1/generate", body)
    assert status == 200
    got, exp = [], None
    with _paused_after(sa, 3):
        conn, resp, eid = _open_stream(a, body)
        for evt in _frames(resp):
            if "token" in evt:
                got.append(evt["token"])
                if len(got) == 3 and exp is None:
                    status, exp, _ = _call(a, f"/v1/kv/export/{eid}")
                    assert status == 200, exp
    conn.close()
    assert exp["id"] == eid and exp["kv_pages"]["layout"] == "paged"
    # the stream closed having delivered a prefix of the snapshot
    assert exp["resume_out"][:len(got)] == got and len(got) >= 3
    status, cont, _ = _call(b, "/v1/generate", {
        **body, "resume_out": exp["resume_out"],
        "resume_logprobs": exp["resume_logprobs"],
        "kv_pages": exp["kv_pages"]})
    assert status == 200, cont
    assert exp["resume_out"] + cont["tokens"] == ref["tokens"]
    assert exp["resume_logprobs"] + cont["logprobs"] == ref["logprobs"]
    # a finished or cancelled request is gone; a garbage id is malformed
    assert _call(a, f"/v1/kv/export/{eid}")[0] == 404
    assert _call(a, "/v1/kv/export/zzz")[0] == 400
    # the dense layout has no pages to ship
    status, err, _ = _call(dense, "/v1/kv/export/0")
    assert status == 503 and "paged" in err["error"]
    for server in (sa, sb):
        server.engine.cb.pool.check()
        assert server.engine.cb.pool.in_use == 0
    assert sa.engine.stats()["prefill_tokens"]["kv_installed"] == 0
    assert sb.engine.stats()["prefill_tokens"]["kv_installed"] == \
        exp["kv_pages"]["tokens"]


def test_http_export_of_a_queued_request_answers_409(tiny_params):
    """One slot, two streams: the second waits in the queue while the
    first decodes, and its export answers 409 (retry after its first
    token)."""
    server, url = _start(["--kvLayout", "paged", "--kvPageSize", str(PS),
                          "--slots", "1"], tiny_params)
    try:
        body = {"prompt": _prompt(9, 20, 512), "max_new": 8}
        with _paused_after(server, 1):
            c1, r1, _ = _open_stream(url, body)
            next(_frames(r1))  # the first request decodes in the slot
            c2, r2, e2 = _open_stream(url, body)
            status, err, _ = _call(url, f"/v1/kv/export/{e2}")
        assert status == 409 and "first" in err["error"], err
        for conn, resp in ((c1, r1), (c2, r2)):
            assert list(_frames(resp))[-1].get("done")
            conn.close()
        server.engine.cb.pool.check()
    finally:
        server.stop()


def test_http_kv_pages_body_checks_and_429(servers, models):
    (a, b, _), (sa, sb, _) = servers
    prompt = _prompt(5, 20, 512)
    for body, status, text in (
            ({"kv_pages": {"planes": {}}}, 400, "requires resume_out"),
            ({"resume_out": [1], "kv_pages": [1]}, 400, "wire blob object"),
            ({"resume_out": [1, 2], "kv_pages": {"planes": {}}}, 422,
             "unsupported KV wire version")):
        got, err, _ = _call(b, "/v1/generate",
                            {"prompt": prompt, "max_new": 8, **body})
        assert got == status and text in json.dumps(err), err
    # pool pressure: the pages are not free right now -> 429 + Retry-After
    with _paused_after(sa, 1):
        conn, resp, eid = _open_stream(a, {"prompt": prompt, "max_new": 40})
        next(_frames(resp))
        status, exp, _ = _call(a, f"/v1/kv/export/{eid}")
    assert status == 200
    list(_frames(resp))
    conn.close()
    pool = sb.engine.cb.pool
    held = pool.alloc(pool.free_pages - 1)  # graftlint: disable=refcount-pairing
    try:
        status, err, headers = _call(b, "/v1/generate", {
            "prompt": prompt, "max_new": 40,
            "resume_out": exp["resume_out"], "kv_pages": exp["kv_pages"]})
    finally:
        pool.decref(held)
    assert status == 429 and err["reason"] == "kv_pool_pressure"
    assert headers["Retry-After"] == "1"
    pool.check()


def test_export_answer_is_json_dumps_byte_for_byte(int8_blob):
    """The route splices the planes' base64 into its answer: the bytes
    are ``json.dumps``'s."""
    _, _, blob, out, lps = int8_blob
    res = {"kv_pages": blob, "resume_out": out, "resume_logprobs": lps,
           "id": 3}
    assert srv.kv_export_json(res) == json.dumps(res).encode()


# --- across frameworks --------------------------------------------------------


def _planes(cache):
    """The same planes for both packages: (JAX numpy planes, the port's
    torch planes, cache_quant)."""
    rng = np.random.default_rng(0)
    shape = (2, 3, 4, 2, 8)
    f32 = rng.standard_normal(shape).astype(np.float32)
    scales = rng.random((*shape[:-1], 1)).astype(np.float32)
    if cache == "f32":
        j = {"k": f32, "v": -f32}
    elif cache == "bf16":
        j = {"k": f32.astype(ml_dtypes.bfloat16),
             "v": (2 * f32).astype(ml_dtypes.bfloat16)}
    else:
        lo, hi = (-127, 128) if cache == "int8" else (-8, 8)
        codes = [rng.integers(lo, hi, shape).astype(np.int8) for _ in "kv"]
        if cache == "int4":
            codes = [c.astype(ml_dtypes.int4) for c in codes]
        j = {"k": codes[0], "v": codes[1], "k_scale": scales,
             "v_scale": scales * 2}

    def port(x):
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(x.astype(np.int8) if x.dtype ==
                                ml_dtypes.int4 else x.copy())

    quant = cache if cache in ("int8", "int4") else "none"
    return j, {k: port(v) for k, v in j.items()}, quant


@pytest.mark.parametrize("cache", ["f32", "bf16", "int8", "int4"])
def test_wire_blobs_equal_across_packages(cache):
    j, t, quant = _planes(cache)
    kw = dict(page_size=4, cache_quant=quant, tokens=9)
    jblob = jpaging.pack_kv_wire(j, **kw)
    tblob = tpaging.pack_kv_wire(t, **kw)
    assert tblob == jblob  # base64 strings included
    meta, back = tpaging.unpack_kv_wire(jblob)
    jmeta, jback = jpaging.unpack_kv_wire(tblob)
    assert meta == jmeta
    for name, x in t.items():
        assert torch.equal(back[name].view(torch.uint8), x.view(torch.uint8))
        jx = np.asarray(jback[name])
        if cache == "bf16":
            assert np.array_equal(jx.view(np.int16), j[name].view(np.int16))
        else:
            assert np.array_equal(jx.astype(np.float32),
                                  j[name].astype(np.float32))


def _blob():
    return jpaging.pack_kv_wire(_planes("f32")[0], page_size=4,
                                cache_quant="none", tokens=9)


MALFORMED = {
    "not_a_blob": lambda b: [1, 2],
    "version": lambda b: {**b, "version": 2},
    "layout": lambda b: {**b, "layout": "dense"},
    "dtype": lambda b: {**b, "planes": {
        **b["planes"], "k": {**b["planes"]["k"], "dtype": "float8_zz"}}},
    "shape": lambda b: {**b, "planes": {
        **b["planes"], "k": {**b["planes"]["k"], "shape": [2, 3, 4, 16]}}},
    "payload": lambda b: {**b, "planes": {
        **b["planes"], "k": {**b["planes"]["k"], "data": "AAAA"}}},
}


@pytest.mark.parametrize("what", list(MALFORMED))
def test_malformed_blobs_raise_the_reference_messages(what):
    blob = MALFORMED[what](_blob())
    with pytest.raises(ValueError) as want:
        jpaging.unpack_kv_wire(blob)
    with pytest.raises(ValueError) as got:
        tpaging.unpack_kv_wire(blob)
    assert str(got.value) == str(want.value)


def _jax_batcher(jparams, jcfg):
    return jbatch.ContinuousBatcher(jparams, jcfg, pipeline_depth=1, **KW)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_blobs_continue_across_frameworks(models, direction):
    """A blob exported by one package's batcher installs in the other's and
    continues with the exporter's uninterrupted greedy tokens, logprobs
    within 1e-4 (f32 summation order differs between the packages)."""
    jcfg, jparams, tcfg, tparams = models
    prompt = _prompt(5, 20, tcfg.vocab_size)
    if direction == "jax_to_port":
        ref = _jax_batcher(jparams, jcfg)
        src, dst = _jax_batcher(jparams, jcfg), _batcher(tparams, tcfg)
    else:
        ref = _batcher(tparams, tcfg)
        src, dst = _batcher(tparams, tcfg), _jax_batcher(jparams, jcfg)
    want = _finish(ref, ref.submit(prompt, MAX_NEW))
    rid = src.submit(prompt, MAX_NEW)
    _step_until(src, rid, 3)
    blob, out, lps = src.export_kv_pages(rid)
    src.cancel(rid)
    blob = json.loads(json.dumps(blob))  # as it crosses the wire
    rid2 = dst.submit(prompt, MAX_NEW, resume_out=out, resume_logp=lps,
                      kv_pages=blob)
    got = _finish(dst, rid2)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], atol=1e-4, rtol=0)
    dst.pool.check()
    assert dst.pool.in_use == 0

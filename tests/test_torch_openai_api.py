"""The port's OpenAI façade against the reference's, on the CPU.

A tiny f32 model with 2 layers, the JAX weights carried across with
``params_from_jax``, served by the port (``http.server``, port 0) and,
for the envelope pins, by the reference (aiohttp on a thread of its own)
with the same tokenizer, scorer and embedder settings. Pinned:

- the key sets of ``/v1/completions`` (plain, streamed, n > 1, echo),
  ``/v1/chat/completions`` (plain, streamed), ``/v1/models``,
  ``/v1/embeddings`` and the error envelopes equal the reference's for
  the same bodies (ids, timestamps and generated values aside);
- greedy completions equal the port's own ``/v1/generate``, tokens and
  logprobs; n seeded choices equal single requests at seed + i;
- SSE framing (chunks, finish_reason, ``data: [DONE]``), stop-string
  trimming in plain and streamed answers, streams that never split a
  multi-byte character, ``best_of`` ranking, echo scoring against a
  forward oracle (short and chunked), the error envelope and 429.
"""

import asyncio
import contextlib
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models.batching import ContinuousBatcher
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax
from k8s_gpu_device_plugin_torch.serving import openai_api as oai
from k8s_gpu_device_plugin_torch.serving import server as srv
from k8s_gpu_device_plugin_torch.serving.embeddings import Embedder
from k8s_gpu_device_plugin_torch.serving.scheduler import make_scheduler
from k8s_gpu_device_plugin_torch.serving.scoring import Scorer
from k8s_gpu_device_plugin_torch.serving.tokenizer import ByteTokenizer
from k8s_gpu_device_plugin_tpu.models import llama as jllama

# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's OpenMP pool from spinning against
# them (these shapes gain nothing from more)
torch.set_num_threads(1)

ENGINE = dict(n_slots=2, max_len=64, chunked_prefill=8)
SCORER = dict(buckets=(16, 32), max_len=48, chunk=16)
EMBED_BUCKETS = (32,)


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


@contextlib.contextmanager
def port_server(cfg, params, *, tokenizer=None, scorer=None, embedder=None,
                **batcher_kw):
    engine = srv.InferenceEngine(ContinuousBatcher(
        params, cfg, **{**ENGINE, **batcher_kw}))
    server = srv.InferenceServer(engine, host="127.0.0.1", port=0,
                                 tokenizer=tokenizer, scorer=scorer,
                                 embedder=embedder)
    server.start()
    try:
        yield f"http://127.0.0.1:{server.bound_port}"
    finally:
        server.stop()


@pytest.fixture(scope="module")
def port(models):
    """The port with a byte tokenizer, a scorer and an embedder."""
    _, _, cfg, params = models
    with port_server(cfg, params, tokenizer=ByteTokenizer(),
                     scorer=Scorer(params, cfg, **SCORER),
                     embedder=Embedder(params, cfg,
                                       buckets=EMBED_BUCKETS)) as url:
        yield url


@pytest.fixture(scope="module")
def bare(models):
    """The port serving token ids only: no tokenizer, scorer, embedder."""
    _, _, cfg, params = models
    with port_server(cfg, params) as url:
        yield url


def request(url, path, body=None):
    """(status, headers, text) of one call; GET when ``body`` is None."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read().decode()


def post(url, path, body):
    status, _, text = request(url, path, body)
    return status, json.loads(text)


def events(text):
    """SSE ``data:`` payloads: dicts, and the closing "[DONE]"."""
    out = []
    for line in text.split("\n\n"):
        if line.startswith("data: "):
            payload = line[len("data: "):]
            out.append(payload if payload == "[DONE]" else json.loads(payload))
    return out


def shape(v, key=None):
    """The schema of a JSON value: dict keys (recursively), list element
    shapes as a set, scalars as a kind. ``top_logprobs`` entries are
    token -> logprob maps, keyed by data."""
    if isinstance(v, dict):
        if key == "top_logprobs":
            return "token_map"
        return {k: shape(x, k) for k, x in sorted(v.items())}
    if isinstance(v, list):
        return sorted({json.dumps(shape(x, key)) for x in v})
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "bool"
    return "number" if isinstance(v, (int, float)) else type(v).__name__


CASES = {
    "completions": ("/v1/completions",
                    {"prompt": "hi", "max_tokens": 4, "logprobs": 1}),
    "completions_ids_n2": ("/v1/completions",
                           {"prompt": [5, 6, 7], "max_tokens": 3, "n": 2,
                            "temperature": 0.9, "seed": 1}),
    "completions_stream": ("/v1/completions",
                           {"prompt": "hi", "max_tokens": 4, "stream": True,
                            "logprobs": 1}),
    "echo": ("/v1/completions", {"prompt": "hello", "echo": True,
                                 "max_tokens": 0, "logprobs": 2}),
    "chat": ("/v1/chat/completions",
             {"messages": [{"role": "user", "content": "hi"}],
              "max_tokens": 3, "logprobs": True}),
    "chat_stream": ("/v1/chat/completions",
                    {"messages": [{"role": "user", "content": "hi"}],
                     "max_tokens": 3, "stream": True}),
    "models": ("/v1/models", None),
    "embeddings": ("/v1/embeddings", {"input": ["hello", "world"]}),
    "error_400": ("/v1/completions", {"prompt": [], "max_tokens": 2}),
    "error_404": ("/v1/completions", {"model": "nope", "prompt": "x"}),
    "error_embed_404": ("/v1/embeddings", {"model": "nope", "input": "x"}),
}


@pytest.fixture(scope="module")
def reference(models):
    """The reference façade's answers to CASES, with the same settings;
    its server (aiohttp on a loop of its own) is stopped before the
    first test reads them."""
    from k8s_gpu_device_plugin_tpu.serving import embeddings as jemb
    from k8s_gpu_device_plugin_tpu.serving import scoring as jscore
    from k8s_gpu_device_plugin_tpu.serving import server as jsrv
    from k8s_gpu_device_plugin_tpu.serving import tokenizer as jtok

    jcfg, jparams, _, _ = models
    server = jsrv.InferenceServer(
        jsrv.InferenceEngine(jparams, jcfg, **ENGINE), host="127.0.0.1",
        port=0, tokenizer=jtok.ByteTokenizer(),
        scorer=jscore.Scorer(jparams, jcfg, **SCORER),
        embedder=jemb.Embedder(jparams, jcfg, buckets=EMBED_BUCKETS))
    loop = asyncio.new_event_loop()
    stop = asyncio.Event()
    thread = threading.Thread(
        target=lambda: loop.run_until_complete(server.run(stop)),
        daemon=True)
    thread.start()
    try:
        for _ in range(600):
            if server.bound_port:
                break
            time.sleep(0.05)
        url = f"http://127.0.0.1:{server.bound_port}"
        return {case: request(url, *CASES[case]) for case in CASES}
    finally:
        loop.call_soon_threadsafe(stop.set)
        thread.join(60)
        loop.close()


@pytest.mark.parametrize("case", sorted(CASES))
def test_envelope_key_sets_match_the_reference(port, reference, case):
    path, body = CASES[case]
    got = request(port, path, body)
    want = reference[case]
    assert got[0] == want[0], (got[2], want[2])
    if body is not None and body.get("stream"):
        assert got[1]["Content-Type"].startswith("text/event-stream")
        g, w = events(got[2]), events(want[2])
        assert g[-1] == w[-1] == "[DONE]"
        assert shape(g[0]) == shape(w[0])           # the first chunk
        assert shape(g[-2]) == shape(w[-2])         # the finish chunk
        assert {json.dumps(shape(e)) for e in g[:-1]} <= \
            {json.dumps(shape(e)) for e in w[:-1]} | {json.dumps(shape(g[-2]))}
        return
    assert shape(json.loads(got[2])) == shape(json.loads(want[2]))


def _prompt(seed, n, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, n).tolist()


def test_greedy_completions_equal_native_generate(port):
    prompt = _prompt(1, 6)
    status, native = post(port, "/v1/generate",
                          {"prompt": prompt, "max_new": 8, "logprobs": True})
    assert status == 200
    status, p = post(port, "/v1/completions",
                     {"prompt": prompt, "max_tokens": 8, "logprobs": 0})
    assert status == 200
    assert p["object"] == "text_completion" and p["id"].startswith("cmpl-")
    assert p["model"] == oai.MODEL_ID
    ch = p["choices"][0]
    assert ch["finish_reason"] == "length"
    assert ch["text"] == ByteTokenizer().decode(native["tokens"])
    assert ch["logprobs"]["token_logprobs"] == native["logprobs"]
    assert p["usage"] == {"prompt_tokens": 6,
                          "prompt_tokens_details": {"cached_tokens": 0},
                          "completion_tokens": 8, "total_tokens": 14}


def test_seeded_choices_equal_single_requests(port):
    """Choice i of an n-request is the single request at seed + i."""
    body = {"prompt": _prompt(3, 5), "max_tokens": 6, "temperature": 0.9,
            "top_p": 0.9, "logprobs": 0, "seed": 40}
    status, p = post(port, "/v1/completions", {**body, "n": 3})
    assert status == 200 and [c["index"] for c in p["choices"]] == [0, 1, 2]
    assert p["usage"]["completion_tokens"] == 18
    for i, choice in enumerate(p["choices"]):
        _, single = post(port, "/v1/completions", {**body, "seed": 40 + i})
        assert choice["text"] == single["choices"][0]["text"]
        assert choice["logprobs"] == single["choices"][0]["logprobs"]


def test_stream_sse_framing(port):
    body = {"prompt": "ab", "max_tokens": 5}
    _, fixed = post(port, "/v1/completions", body)
    status, headers, text = request(port, "/v1/completions",
                                    {**body, "stream": True, "logprobs": 1})
    assert status == 200
    assert headers["Content-Type"].startswith("text/event-stream")
    evts = events(text)
    assert evts[-1] == "[DONE]"
    chunks = evts[:-1]
    assert all(c["object"] == "text_completion" for c in chunks)
    assert "".join(c["choices"][0]["text"] for c in chunks) == \
        fixed["choices"][0]["text"]
    finishes = [c["choices"][0]["finish_reason"] for c in chunks]
    assert finishes[-1] == "length" and all(f is None for f in finishes[:-1])
    lps = [lp for c in chunks if "logprobs" in c["choices"][0]
           for lp in c["choices"][0]["logprobs"]["token_logprobs"]]
    assert len(lps) == 5 and all(isinstance(x, float) for x in lps)


def test_chat_completions_and_stream(port):
    msgs = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "hi"}]
    status, p = post(port, "/v1/chat/completions",
                     {"messages": msgs, "max_tokens": 4, "logprobs": True})
    assert status == 200
    assert p["object"] == "chat.completion"
    assert p["id"].startswith("chatcmpl-")
    msg = p["choices"][0]["message"]
    assert msg["role"] == "assistant"
    assert len(p["choices"][0]["logprobs"]["content"]) == 4
    _, _, text = request(port, "/v1/chat/completions",
                         {"messages": msgs, "max_tokens": 4, "stream": True})
    evts = events(text)
    assert evts[-1] == "[DONE]"
    chunks = evts[:-1]
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant"}
    assert "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks) == msg["content"]
    # max_completion_tokens wins over max_tokens
    _, p = post(port, "/v1/chat/completions",
                {"messages": msgs, "max_completion_tokens": 3,
                 "max_tokens": 7})
    assert p["usage"]["completion_tokens"] == 3


def test_chat_default_budget_is_the_slot_not_16(port):
    status, p = post(port, "/v1/chat/completions",
                     {"messages": [{"role": "user", "content": "hi"}]})
    assert status == 200
    assert p["usage"]["completion_tokens"] > 16
    assert p["choices"][0]["finish_reason"] == "length"


def test_stop_string_trimmed_from_plain_and_streamed_output(port):
    """A matched stop is never in the text (the native API keeps it):
    the stop is a cleanly decoding window of the greedy continuation."""
    tok = ByteTokenizer()
    _, native = post(port, "/v1/generate", {"text": "a", "max_new": 16})
    out = native["tokens"]
    # the first window of two single-byte tokens (ASCII round-trips)
    cut = next(i for i in range(1, 14) if all(t < 128 for t in out[i:i + 2]))
    stop_str = tok.decode(out[cut:cut + 2])
    assert tok.encode(stop_str) == out[cut:cut + 2]
    kept = tok.decode(out[:cut])
    body = {"prompt": "a", "max_tokens": 16, "stop": stop_str, "logprobs": 0}
    _, p = post(port, "/v1/completions", body)
    ch = p["choices"][0]
    assert ch["finish_reason"] == "stop"
    assert ch["text"] == kept and len(ch["logprobs"]["token_logprobs"]) == cut
    assert p["usage"]["completion_tokens"] == cut
    _, _, text = request(port, "/v1/completions", {**body, "stream": True})
    chunks = events(text)[:-1]
    streamed = "".join(c["choices"][0]["text"] for c in chunks)
    assert streamed == kept and stop_str not in streamed
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"


class _MappedTokenizer(ByteTokenizer):
    """Byte decoding of chosen ids: ``table`` maps model ids to bytes,
    every other id to a letter (the model's vocabulary is 512)."""

    def __init__(self, table: dict) -> None:
        self.table = table

    def decode(self, ids):
        return super().decode([self.table.get(int(i), 97 + int(i) % 26)
                               for i in ids])


def test_stream_never_splits_a_three_byte_character(models):
    """Three tokens of the greedy continuation decode as the three bytes
    of U+20AC: the stream holds the first two back and emits the whole
    character with the third, never a U+FFFD half."""
    _, _, cfg, params = models
    prompt = _prompt(11, 6)
    with port_server(cfg, params) as url:
        _, native = post(url, "/v1/generate", {"prompt": prompt,
                                               "max_new": 12})
    out = native["tokens"]
    # a window of three distinct ids that occur nowhere else in the
    # answer (its tokens before the window and the one after it)
    i = next(i for i in range(8) if len(set(out[i:i + 3])) == 3
             and not set(out[i:i + 3]) & set(out[:i] + out[i + 3:i + 4]))
    out = out[:i + 4]
    tok = _MappedTokenizer(dict(zip(out[i:i + 3], b"\xe2\x82\xac")))
    with port_server(cfg, params, tokenizer=tok) as url:
        _, _, text = request(url, "/v1/completions",
                             {"prompt": prompt, "max_tokens": len(out),
                              "stream": True})
    pieces = [c["choices"][0]["text"] for c in events(text)[:-1]]
    assert "€" in pieces and "�" not in "".join(pieces)
    assert "".join(pieces) == tok.decode(out)


def test_text_differ_holds_partial_characters():
    differ = oai._TextDiffer(ByteTokenizer())
    ids = [97, 0xE2, 0x82, 0xAC, 98, 0xC3]
    pieces = [differ.push(t) for t in ids]
    assert pieces == ["a", "", "", "€", "b", ""]
    assert differ.flush() == "�"


def test_models_lists_the_base_model_only(port):
    status, p = post(port, "/v1/models", None)
    assert status == 200 and p["object"] == "list"
    assert [m["id"] for m in p["data"]] == [oai.MODEL_ID]


@pytest.mark.parametrize("path,body,needle", [
    ("/v1/completions", {"prompt": "hi"}, "tokenizer"),
    ("/v1/completions", {"prompt": [1, 2], "stop": "x"}, "tokenizer"),
    ("/v1/completions", {"prompt": [1, 2], "n": 99}, "n must"),
    ("/v1/chat/completions",
     {"messages": [{"role": "user", "content": "x"}]}, "tokenizer"),
    ("/v1/completions", {"prompt": []}, "prompt"),
    ("/v1/completions", {"prompt": [1, 512]}, "outside vocab"),
    ("/v1/completions", {"prompt": [True, False]}, "prompt"),
    ("/v1/completions", {"prompt": [1, 2], "logprobs": 9}, "between 0 and 5"),
    ("/v1/completions", {"prompt": [1, 2], "timeline": True}, "timeline"),
    ("/v1/completions", {"prompt": [1, 2], "priority": 99}, "priority"),
    ("/v1/completions", {"prompt": [1, 2], "echo": True, "max_tokens": 0},
     "--scoring"),
    ("/v1/embeddings", {"input": [1, 2]}, "not enabled"),
])
def test_error_envelope(bare, path, body, needle):
    status, p = post(bare, path, body)
    assert status == 400, p
    assert needle in p["error"]["message"]
    assert p["error"]["type"] == "invalid_request_error"


def test_unserved_model_is_404(port):
    for path, body in (("/v1/completions", {"model": "fr", "prompt": "x"}),
                       ("/v1/chat/completions",
                        {"model": "fr", "messages": [{"role": "user",
                                                      "content": "x"}]})):
        status, p = post(port, path, body)
        assert status == 404 and p["error"]["code"] == "model_not_found"
    status, _ = post(port, "/v1/completions",
                     {"model": oai.MODEL_ID, "prompt": "x", "max_tokens": 1})
    assert status == 200


@pytest.mark.parametrize("status,kind", [
    (400, "invalid_request_error"), (404, "invalid_request_error"),
    (422, "invalid_request_error"), (500, "server_error"),
    (503, "server_error"),
])
def test_error_types_key_sdk_retries(status, kind):
    sent = []

    class Handler:
        def _json(self, code, payload, headers=None):
            sent.append((code, payload))

    oai.oai_error(Handler(), "boom", status)
    assert sent == [(status, {"error": {"message": "boom", "type": kind,
                                        "code": None}})]


def test_overload_answers_429_with_retry_after(models):
    """A one-deep queue under a burst: 429, Retry-After, the retryable
    rate_limit_error envelope naming the valve."""
    _, _, cfg, params = models
    from concurrent.futures import ThreadPoolExecutor

    body = {"prompt": _prompt(7, 9), "max_tokens": 40}
    with port_server(cfg, params, scheduler=make_scheduler(
            "fifo", max_queue=1)) as url:
        with ThreadPoolExecutor(8) as pool:
            results = list(pool.map(
                lambda _: request(url, "/v1/completions", body), range(8)))
    rejected = [r for r in results if r[0] == 429]
    assert rejected and any(r[0] == 200 for r in results)
    for _, headers, text in rejected:
        assert int(headers["Retry-After"]) >= 1
        err = json.loads(text)["error"]
        assert err["type"] == "rate_limit_error"
        assert err["code"] == "queue_full" and err["retry_after"] >= 1


def test_echo_scoring_matches_the_forward_oracle(models, port):
    _, _, cfg, params = models
    prompt = _prompt(5, 10)
    logits = tllama.forward(params, torch.tensor([prompt]), cfg)[0]
    lp = torch.log_softmax(logits, dim=-1).detach()
    expect = [float(lp[i - 1, prompt[i]]) for i in range(1, len(prompt))]
    status, p = post(port, "/v1/completions",
                     {"prompt": prompt, "echo": True, "max_tokens": 0,
                      "logprobs": 0})
    assert status == 200
    ch = p["choices"][0]
    assert ch["finish_reason"] == "length"
    assert p["usage"] == {"prompt_tokens": 10, "completion_tokens": 0,
                          "total_tokens": 10}
    assert ch["logprobs"]["token_logprobs"][0] is None
    np.testing.assert_allclose(ch["logprobs"]["token_logprobs"][1:], expect,
                               atol=1e-5, rtol=0)
    assert ch["logprobs"]["top_logprobs"] is None
    _, p2 = post(port, "/v1/completions",
                 {"prompt": prompt, "echo": True, "max_tokens": 0})
    assert p2["choices"][0]["logprobs"] is None
    for bad, needle in [({"max_tokens": 3}, "max_tokens 0"),
                        ({"n": 2}, "n == 1"), ({"stream": True}, "stream"),
                        ({"best_of": 2}, "best_of")]:
        status, p3 = post(port, "/v1/completions",
                          {"prompt": prompt, "echo": True, "max_tokens": 0,
                           "logprobs": 0, **bad})
        assert status == 400 and needle in p3["error"]["message"]


def test_echo_long_prompt_takes_the_chunked_path(models, port):
    """40 tokens past the largest bucket (32) and under the cap (48):
    chunks of 16 through the cached forward, the oracle's scores."""
    _, _, cfg, params = models
    prompt = _prompt(13, 40)
    logits = tllama.forward(params, torch.tensor([prompt]), cfg)[0]
    lp = torch.log_softmax(logits, dim=-1).detach()
    status, p = post(port, "/v1/completions",
                     {"prompt": prompt, "echo": True, "max_tokens": 0,
                      "logprobs": 1})
    assert status == 200
    np.testing.assert_allclose(
        p["choices"][0]["logprobs"]["token_logprobs"][1:],
        [float(lp[i - 1, prompt[i]]) for i in range(1, 40)], atol=1e-4,
        rtol=0)
    status, p = post(port, "/v1/completions",
                     {"prompt": _prompt(14, 49), "echo": True,
                      "max_tokens": 0})
    assert status == 400 and "cap 48" in p["error"]["message"]


def test_echo_text_tokens_concatenate(port):
    text_in = "héllo"  # é is two byte tokens
    status, p = post(port, "/v1/completions",
                     {"prompt": text_in, "echo": True, "max_tokens": 0,
                      "logprobs": 0})
    assert status == 200
    ch = p["choices"][0]
    assert ch["text"] == text_in
    assert "".join(ch["logprobs"]["tokens"]) == text_in
    assert ch["logprobs"]["text_offset"] == \
        sorted(ch["logprobs"]["text_offset"])


def test_echo_top_logprobs_alternatives(models, bare):
    """A token-ids-only server with a scorer: logprobs=K gives K id-keyed
    alternatives a position, best first; 0 gives none."""
    _, _, cfg, params = models
    prompt = _prompt(9, 8)
    with port_server(cfg, params,
                     scorer=Scorer(params, cfg, **SCORER)) as url:
        status, p = post(url, "/v1/completions",
                         {"prompt": prompt, "echo": True, "max_tokens": 0,
                          "logprobs": 2})
    assert status == 200
    tops = p["choices"][0]["logprobs"]["top_logprobs"]
    assert tops[0] is None and len(tops) == len(prompt)
    assert all(len(t) == 2 and all(k.isdigit() for k in t) for t in tops[1:])
    logits = tllama.forward(params, torch.tensor([prompt]), cfg)[0]
    best = logits.argmax(-1).tolist()
    assert [int(next(iter(t))) for t in tops[1:]] == best[:-1]


def test_best_of_ranks_by_mean_logprob(port):
    body = {"prompt": _prompt(4, 5), "max_tokens": 4}
    status, p = post(port, "/v1/completions",
                     {**body, "n": 2, "best_of": 4, "temperature": 1.2,
                      "logprobs": 0, "seed": 11})
    assert status == 200, p
    assert [c["index"] for c in p["choices"]] == [0, 1]
    assert p["usage"]["completion_tokens"] == 16   # every candidate billed
    means = [np.mean(c["logprobs"]["token_logprobs"]) for c in p["choices"]]
    assert means[0] >= means[1]
    for bad in ({"best_of": 1, "n": 2}, {"best_of": 9},
                {"best_of": 2, "stream": True}):
        status, _ = post(port, "/v1/completions", {**body, **bad})
        assert status == 400, bad


def test_embeddings_http(models, port):
    _, _, cfg, params = models
    status, p = post(port, "/v1/embeddings", {"input": ["hello", "world"]})
    assert status == 200
    assert [d["index"] for d in p["data"]] == [0, 1]
    assert len(p["data"][0]["embedding"]) == cfg.d_model
    assert p["usage"]["prompt_tokens"] == 10  # five bytes each
    want = Embedder(params, cfg, buckets=EMBED_BUCKETS).embed(
        ByteTokenizer().encode("hello"))
    np.testing.assert_array_equal(np.float32(p["data"][0]["embedding"]), want)
    _, one = post(port, "/v1/embeddings", {"input": [5, 6, 7]})
    _, nested = post(port, "/v1/embeddings", {"input": [[5, 6, 7]]})
    assert one["data"][0]["embedding"] == nested["data"][0]["embedding"]
    for bad in ([], [cfg.vocab_size], [-1], [True, False], "x" * 33):
        status, _ = post(port, "/v1/embeddings", {"input": bad})
        assert status == 400, bad


def test_a_stopped_server_is_freed_without_the_cycle_collector(models):
    """The OpenAI routes hold no reference back to their server: a server
    stopped and dropped frees its batcher (and on a card its KV cache) at
    once, not at the cycle collector's next pass."""
    import gc
    import weakref

    _, _, cfg, params = models
    gc.disable()
    try:
        engine = srv.InferenceEngine(ContinuousBatcher(params, cfg, **ENGINE))
        server = srv.InferenceServer(engine, host="127.0.0.1", port=0,
                                     tokenizer=ByteTokenizer())
        server.start()
        url = f"http://127.0.0.1:{server.bound_port}"
        assert post(url, "/v1/completions",
                    {"prompt": "hi", "max_tokens": 2})[0] == 200
        batcher = weakref.ref(engine.cb)
        server.stop()
        del engine, server
        assert batcher() is None
    finally:
        gc.enable()

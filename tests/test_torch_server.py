"""The port's HTTP server on the CPU against its own batcher.

A tiny f32 model served on ``device="cpu"``, port 0. ``/v1/generate``,
plain and SSE, must return exactly the tokens (and logprobs, bitwise:
the same code on the same weights) that ``ContinuousBatcher.run``
produces for the same requests. The KV flags (``--kvLayout``,
``--kvPageSize``, ``--kvPages``, ``--cacheQuant``) are driven through
``build_server`` on the tiny preset: each layout's ``/v1/health`` names
its ``kv`` residency and its attention route, every layout answers with
the dense bf16 server's greedy tokens where the cache is unquantized,
and a request the pool can never hold answers 422 with the pool's limit.
The serving surface: ``n``, ``text`` and ``stop_text`` are served (n
seeded choices equal single requests at seed + i, bit for bit; the
decoded ``text`` covers a resumed request's whole output), ``timeline``
is served (its latency timeline), ``adapter`` and ``kv_pages`` still
answer 400 naming the field, and
``--eosId`` has the reference's three states (unset: the tokenizer's
EOS stops a stream).
"""

import json
import urllib.error
import urllib.request

import pytest
import torch

from k8s_gpu_device_plugin_torch.models.batching import ContinuousBatcher
from k8s_gpu_device_plugin_torch.models.llama import LlamaConfig
from k8s_gpu_device_plugin_torch.serving import server as srv
from k8s_gpu_device_plugin_torch.serving.tokenizer import ByteTokenizer

# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's OpenMP pool from spinning against
# them (these shapes gain nothing from more)
torch.set_num_threads(1)

PROMPTS = [[5, 9, 13], list(range(1, 41))]


@pytest.fixture(scope="module")
def served():
    cfg = LlamaConfig.tiny(dtype=torch.float32, head_dim_override=64)
    params = srv.load_params(cfg, seed=3, device="cpu")
    engine = srv.InferenceEngine(srv.ContinuousBatcher(
        params, cfg, n_slots=2, max_len=96, chunked_prefill=16))
    server = srv.InferenceServer(engine, host="127.0.0.1", port=0)
    server.start()
    try:
        yield cfg, params, f"http://127.0.0.1:{server.bound_port}"
    finally:
        server.stop()


def _post(url, body):
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read().decode()


def _expected(cfg, params, max_new):
    cb = ContinuousBatcher(params, cfg, n_slots=2, max_len=96,
                           chunked_prefill=16)
    rids = [cb.submit(p, max_new=max_new) for p in PROMPTS]
    cb.run()
    return [cb.done_requests[r] for r in rids]


def test_generate_plain_and_sse_match_the_batcher(served):
    cfg, params, url = served
    want = _expected(cfg, params, 7)
    status, _, body = _post(url, {"prompt": PROMPTS[0], "max_new": 7,
                                  "logprobs": True})
    assert status == 200
    got = json.loads(body)
    assert set(got) == {"id", "tokens", "cached_tokens", "logprobs"}
    assert got["tokens"] == want[0].out
    assert got["logprobs"] == want[0].out_logp

    status, headers, body = _post(url, {"prompt": PROMPTS[1], "max_new": 7,
                                        "stream": True})
    assert status == 200
    assert headers["Content-Type"] == "text/event-stream"
    frames = [json.loads(line[len("data: "):])
              for line in body.split("\n\n") if line.startswith("data: ")]
    assert frames[-1] == {"done": True}
    assert [f["token"] for f in frames[:-1]] == want[1].out


def test_generate_key_sets_match_the_reference(served):
    """The reference's non-streamed body always carries ``cached_tokens``
    (0 on a prefix-cache miss; reference ``serving/server.py:1396-1406``);
    its SSE done event adds the field only when it is > 0 (``:1477-1480``).
    The port has no prefix cache: 0 in the body, absent from the event."""
    _, _, url = served
    status, _, body = _post(url, {"prompt": PROMPTS[0], "max_new": 3})
    assert status == 200
    got = json.loads(body)
    assert set(got) == {"id", "tokens", "cached_tokens"}
    assert got["cached_tokens"] == 0
    status, _, body = _post(url, {"prompt": PROMPTS[0], "max_new": 3,
                                  "stream": True})
    assert status == 200
    frames = [json.loads(line[len("data: "):])
              for line in body.split("\n\n") if line.startswith("data: ")]
    assert [set(f) for f in frames] == [{"token"}] * 3 + [{"done"}]


@pytest.mark.parametrize("field,value", [
    ("adapter", "fr"), ("timeline", True), ("kv_pages", {"pages": []}),
])
def test_unimplemented_field_answers_400_naming_it(served, field, value):
    """``adapter`` waits for the adapters (ROADMAP A.10), ``kv_pages`` for
    KV transfer (A.10). ``timeline`` is served since latency attribution
    (A.9): this server's batcher runs without an attributor, so the
    answer carries it as null, as the reference's does under
    ``--attributionOff``."""
    _, _, url = served
    status, _, body = _post(url, {"prompt": [1, 2], "max_new": 2,
                                  field: value})
    if field == "timeline":
        assert status == 200
        assert json.loads(body)["timeline"] is None
        return
    assert status == 400
    assert field in json.loads(body)["error"]


@pytest.fixture(scope="module")
def texted():
    """The tiny server with the byte tokenizer (its EOS is none)."""
    server, url = _serve(["--tokenizer", "byte"])
    try:
        yield server, url
    finally:
        server.stop()


def _tokens(url, body):
    status, _, raw = _post(url, body)
    assert status == 200, raw
    return json.loads(raw)


@pytest.mark.parametrize("field,value", [
    ("n", 2), ("text", "hello"), ("stop_text", ["x"]),
])
def test_served_field_answers_200(texted, field, value):
    """The fields the port refused until the serving surface landed."""
    _, url = texted
    byte = ByteTokenizer()
    body = {"prompt": byte.encode("hello"), "max_new": 4, field: value}
    if field == "text":
        del body["prompt"]
    got = _tokens(url, body)
    plain = _tokens(url, {"prompt": byte.encode("hello"), "max_new": 4})
    assert got["text"] == byte.decode(got["tokens"])
    if field == "n":
        assert got["completions"] == [got["tokens"]] * 2  # greedy twice
        assert got["completions_text"] == [got["text"]] * 2
    else:  # text is the same prompt; "x" never fires on these tokens
        assert got["tokens"] == plain["tokens"]
        assert set(got) == {"id", "tokens", "cached_tokens", "text"}


@pytest.mark.parametrize("body,field", [
    ({"text": "hi"}, "text"),
    ({"prompt": [1, 2], "stop_text": ["x"]}, "stop_text"),
    ({"prompt": [1, 2], "n": 9}, "n"),
    ({"prompt": [1, 2], "n": 2, "stream": True}, "stream"),
    ({"prompt": [1, 2], "resume_out": [3], "n": 2}, "resume_out"),
    ({"prompt": [1, 2], "seed": -1}, "seed"),
])
def test_surface_fields_refused_by_name(served, body, field):
    _, _, url = served
    status, _, raw = _post(url, {"max_new": 2, **body})
    assert status == 400 and field in json.loads(raw)["error"]


def test_text_field_refusals_with_a_tokenizer(texted):
    _, url = texted
    for body, needle in (({"text": "hi", "prompt": [1]}, "not both"),
                         ({"text": "hi", "resume_out": [1]}, "resume_out"),
                         ({"text": ""}, "text")):
        status, _, raw = _post(url, {"max_new": 2, **body})
        assert status == 400 and needle in json.loads(raw)["error"], raw


def test_n_seeded_choices_equal_single_requests(texted):
    """Choice i of an n-request is the single request at (seed + i) %
    2**31, bit for bit (tokens and logprobs); cached_tokens is the
    largest of the choices'."""
    _, url = texted
    body = {"prompt": PROMPTS[1][:30], "max_new": 6, "temperature": 0.9,
            "logprobs": True}
    got = _tokens(url, {**body, "n": 3, "seed": 2**31 - 2})
    assert got["tokens"] == got["completions"][0]
    assert got["logprobs"] == got["completions_logprobs"][0]
    for i, seed in enumerate((2**31 - 2, 2**31 - 1, 0)):
        one = _tokens(url, {**body, "seed": seed})
        assert got["completions"][i] == one["tokens"]
        assert got["completions_logprobs"][i] == one["logprobs"]
    assert got["completions"][0] != got["completions"][1]


def test_resumed_text_covers_the_whole_output(texted):
    _, url = texted
    byte = ByteTokenizer()
    full = _tokens(url, {"prompt": PROMPTS[0], "max_new": 6})
    cont = _tokens(url, {"prompt": PROMPTS[0], "max_new": 6,
                         "resume_out": full["tokens"][:2]})
    assert cont["tokens"] == full["tokens"][2:]
    assert cont["text"] == full["text"] == byte.decode(full["tokens"])
    status, _, raw = _post(url, {"prompt": PROMPTS[0], "max_new": 6,
                                 "resume_out": full["tokens"][:2],
                                 "stream": True})
    frames = [json.loads(line[len("data: "):])
              for line in raw.split("\n\n") if line.startswith("data: ")]
    assert [f["token"] for f in frames[:-1]] == full["tokens"][2:]
    assert frames[-1] == {"done": True, "text": full["text"]}


class _EosTokenizer(ByteTokenizer):
    def __init__(self, eos_id):
        self.eos_id = eos_id


@pytest.mark.parametrize("eos_arg,tok_eos,want", [
    (None, None, None), (None, 7, 7), ("none", 7, None), (-1, 7, None),
    (5, 7, 5), (5, None, 5),
])
def test_resolve_eos_three_states(eos_arg, tok_eos, want):
    tok = None if tok_eos is None else _EosTokenizer(tok_eos)
    assert srv.resolve_eos(eos_arg, tok) == want


def test_eos_id_and_the_tokenizers_eos_stop_a_stream(monkeypatch):
    """--eosId N stops a stream at N (kept, like the reference); unset,
    the tokenizer's EOS does; 'none' turns stopping off."""
    def stream(flags):
        server, url = _serve(flags)
        try:
            _, _, raw = _post(url, {"prompt": PROMPTS[0], "max_new": 8,
                                    "stream": True})
        finally:
            server.stop()
        frames = [json.loads(line[len("data: "):])
                  for line in raw.split("\n\n")
                  if line.startswith("data: ")]
        assert frames[-1]["done"]
        return [f["token"] for f in frames[:-1]]

    full = stream(["--eosId", "none"])
    assert len(full) == 8
    eos = full[3]
    want = full[:full.index(eos) + 1]
    assert len(want) < 8
    assert stream(["--eosId", str(eos)]) == want
    monkeypatch.setattr(srv, "load_tokenizer",
                        lambda spec: _EosTokenizer(eos))
    assert stream(["--tokenizer", "byte"]) == want
    assert stream(["--tokenizer", "byte", "--eosId", "none"]) == full
    assert stream(["--tokenizer", "byte", "--eosId", "-1"]) == full


def test_surface_flags_refused_with_weight_quant(capsys):
    base = ["--preset", "tiny", "--device", "cpu", "--port", "0",
            "--weightQuant", "int8"]
    for flag in ("--embeddings", "--scoring"):
        assert srv._main(base + [flag]) == 2
        assert flag in capsys.readouterr().err
    with pytest.raises(SystemExit):
        srv.build_parser().parse_args(["--eosId", "1.5"])


def test_scheduling_fields_are_served(served):
    """``tenant``, ``priority`` and ``deadline_ms`` are served (the fifo
    engine admits in arrival order: the same tokens as without them);
    a value outside the batcher's rule answers 400 naming it."""
    cfg, params, url = served
    want = _expected(cfg, params, 4)
    status, _, body = _post(url, {"prompt": PROMPTS[0], "max_new": 4,
                                  "tenant": "gold", "priority": 0,
                                  "deadline_ms": 60000})
    assert status == 200, body
    assert json.loads(body)["tokens"] == want[0].out
    for field, value in (("priority", 10), ("deadline_ms", -1),
                         ("tenant", "x" * 65)):
        status, _, body = _post(url, {"prompt": [1, 2], "max_new": 2,
                                      field: value})
        assert status == 400 and field.split("_")[0] in \
            json.loads(body)["error"]


def test_logit_bias_answers_200_with_the_forced_token(served):
    """logit_bias is served as the reference parses it (string keys): +100
    forces a token at every step; a malformed map answers 400, a bias
    outside [-100, 100] 422 (the batcher's bound)."""
    _, _, url = served
    status, _, body = _post(url, {"prompt": PROMPTS[0], "max_new": 4,
                                  "logit_bias": {"77": 100.0}})
    assert status == 200, body
    assert json.loads(body)["tokens"] == [77] * 4
    status, _, body = _post(url, {"prompt": PROMPTS[0], "max_new": 2,
                                  "logit_bias": {"abc": 1.0}})
    assert status == 400 and "logit_bias" in json.loads(body)["error"]
    status, _, body = _post(url, {"prompt": PROMPTS[0], "max_new": 2,
                                  "logit_bias": [1, 2]})
    assert status == 400
    status, _, body = _post(url, {"prompt": PROMPTS[0], "max_new": 2,
                                  "logit_bias": {"5": 101}})
    assert status == 422 and "[-100, 100]" in json.loads(body)["error"]


def test_oversized_request_answers_422(served):
    _, _, url = served
    status, _, body = _post(url, {"prompt": list(range(1, 90)),
                                  "max_new": 20})
    assert status == 422
    err = json.loads(body)["error"]
    assert err["code"] == "request_too_large" and err["limit"] == 96


def test_health_answers(served):
    _, _, url = served
    with urllib.request.urlopen(url + "/v1/health", timeout=30) as resp:
        health = json.loads(resp.read())
    assert health["alive"] and health["slots"] == 2
    assert health["device"] == "cpu"
    assert health["decode_attn"]["decode"]["backend"] == "plain"
    assert health["decode_attn"]["decode"]["route"] == "dense"
    assert health["kernel_launches"] == {}
    assert health["kv"]["layout"] == "dense"
    assert health["kv"]["reserved_bytes"] == 2 * 96 * 2 * 2 * 4 * 64 * 4
    assert health["kv"]["admission_rejected"]["pool_pressure"] == 0


KV_FLAGS = {
    "dense": [],
    "paged": ["--kvLayout", "paged", "--kvPageSize", "16", "--kvPages", "5"],
    "int8_dense": ["--cacheQuant", "int8"],
    "int8_paged": ["--cacheQuant", "int8", "--kvLayout", "paged",
                   "--kvPageSize", "16", "--kvPages", "5"],
    "int4_dense": ["--cacheQuant", "int4"],
    "int4_paged": ["--cacheQuant", "int4", "--kvLayout", "paged",
                   "--kvPageSize", "16", "--kvPages", "5"],
}


def _serve(flags):
    args = srv.build_parser().parse_args([
        "--preset", "tiny", "--device", "cpu", "--host", "127.0.0.1",
        "--port", "0", "--slots", "2", "--maxLen", "64", "--chunkedPrefill",
        "16", "--seed", "3", *flags])
    server = srv.build_server(args)
    server.start()
    return server, f"http://127.0.0.1:{server.bound_port}"


@pytest.fixture(scope="module")
def dense_tokens():
    server, url = _serve([])
    try:
        return [json.loads(_post(url, {"prompt": p[:30], "max_new": 6})[2])
                ["tokens"] for p in PROMPTS]
    finally:
        server.stop()


@pytest.mark.parametrize("route", list(KV_FLAGS))
def test_kv_flags_reach_the_batcher_and_health(route, dense_tokens):
    server, url = _serve(KV_FLAGS[route])
    try:
        cfg = server.engine.cb.cfg
        # bf16 rows, or codes (int8 a byte each, int4 two a byte) and an
        # f32 scale, for K and for V
        code_bytes = {"int8": cfg.head_dim, "int4": cfg.head_dim // 2}
        quant = route.split("_")[0]
        token_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * (
            code_bytes[quant] + 4 if quant in code_bytes
            else cfg.head_dim * 2)
        got = [json.loads(_post(url, {"prompt": p[:30], "max_new": 6})[2])
               ["tokens"] for p in PROMPTS]
        assert all(len(t) == 6 for t in got)
        if not route.startswith("int"):
            assert got == dense_tokens
        with urllib.request.urlopen(url + "/v1/health", timeout=30) as resp:
            health = json.loads(resp.read())
        assert {m["route"] for m in health["decode_attn"].values()} == {route}
        kv = health["kv"]
        assert kv["admission_rejected"] == {"pool_pressure": 0,
                                            "request_too_large": 0}
        if "paged" in route:
            assert kv["layout"] == "paged" and kv["page_size"] == 16
            assert kv["pages_total"] == 4 and kv["pages_in_use"] == 0
            assert kv["pages_in_use_peak"] >= 3
            assert kv["reserved_bytes"] == 5 * 16 * token_bytes
            # (30 + 40 tokens) needs 5 pages of 16 rows: the pool holds 4
            status, _, body = _post(url, {"prompt": list(range(1, 31)),
                                          "max_new": 40})
            err = json.loads(body)["error"]
            assert status == 422 and err["code"] == "request_too_large"
            assert err["limit"] == 4 * 16 and err["prompt_tokens"] == 30
        else:
            assert kv == {"layout": "dense",
                          "reserved_bytes": 2 * 64 * token_bytes,
                          "admission_rejected": kv["admission_rejected"]}
    finally:
        server.stop()


@pytest.mark.parametrize("flags", [["--pipelineDepth", "0"],
                                   ["--chunkedPrefill", "0", "--maxLen", "48"]])
def test_loop_flags_serve_the_same_greedy_tokens(flags, dense_tokens):
    """--pipelineDepth 0 (the synchronous loop) and --chunkedPrefill 0
    (bucketed prefill) answer with the default server's greedy tokens;
    /v1/health names the depth. With buckets a prompt longer than the
    largest bucket that fits --maxLen (32 of 48) answers 422."""
    server, url = _serve(flags)
    try:
        got = [json.loads(_post(url, {"prompt": p[:30], "max_new": 6})[2])
               ["tokens"] for p in PROMPTS]
        assert got == dense_tokens
        with urllib.request.urlopen(url + "/v1/health", timeout=30) as resp:
            decode = json.loads(resp.read())["decode"]
        assert decode["pipeline_depth"] == int(
            flags[0] != "--pipelineDepth")
        assert decode["graph"] is None  # the CPU runs the eager step
        if flags[0] == "--chunkedPrefill":
            status, _, body = _post(url, {"prompt": list(range(1, 40)),
                                          "max_new": 4})
            assert status == 422 and "largest bucket" in body
    finally:
        server.stop()


def test_kv_flags_refused_by_name(capsys):
    base = ["--preset", "tiny", "--device", "cpu", "--port", "0"]
    assert srv._main(base + ["--kvPages", "9"]) == 2
    assert "--kvLayout paged" in capsys.readouterr().err
    assert srv._main(base + ["--kvLayout", "paged", "--kvPageSize", "12",
                             "--maxLen", "96", "--chunkedPrefill",
                             "16"]) == 2
    assert "power of two" in capsys.readouterr().err

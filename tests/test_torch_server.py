"""The port's HTTP server on the CPU against its own batcher.

A tiny f32 model served on ``device="cpu"``, port 0. ``/v1/generate``,
plain and SSE, must return exactly the tokens (and logprobs, bitwise:
the same code on the same weights) that ``ContinuousBatcher.run``
produces for the same requests.
"""

import json
import urllib.error
import urllib.request

import pytest
import torch

from k8s_gpu_device_plugin_torch.models.batching import ContinuousBatcher
from k8s_gpu_device_plugin_torch.models.llama import LlamaConfig
from k8s_gpu_device_plugin_torch.serving import server as srv

# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's OpenMP pool from spinning against
# them (these shapes gain nothing from more)
torch.set_num_threads(1)

PROMPTS = [[5, 9, 13], list(range(1, 41))]


@pytest.fixture(scope="module")
def served():
    cfg = LlamaConfig.tiny(dtype=torch.float32, head_dim_override=64)
    params = srv.load_params(cfg, seed=3, device="cpu")
    engine = srv.InferenceEngine(params, cfg, n_slots=2, max_len=96,
                                 chunked_prefill=16)
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
    assert set(got) == {"id", "tokens", "logprobs"}
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


@pytest.mark.parametrize("field,value", [
    ("adapter", "fr"), ("n", 2), ("text", "hello"), ("logit_bias", {"1": 2}),
    ("stop_text", ["x"]), ("tenant", "gold"),
])
def test_unimplemented_field_answers_400_naming_it(served, field, value):
    _, _, url = served
    status, _, body = _post(url, {"prompt": [1, 2], "max_new": 2,
                                  field: value})
    assert status == 400
    assert field in json.loads(body)["error"]


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
    assert health["kernel_launches"] == {}

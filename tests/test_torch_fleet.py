"""Two port replicas behind the REFERENCE's replica router, in-process: a
cross-package pin that the port's replicas speak the reference router's
wire. The port's own router (``serving/router.py``) has its tests beside
this one: ``tests/test_torch_router*.py`` and
``tests/test_torch_fleet_obs.py``.

The port's ``InferenceServer`` (``device="cpu"``, port 0) twice, on one
set of tiny f32 weights, behind ``serving/router.py::ReplicaRouter`` of
the reference (aiohttp on the test's event loop), in the pattern of
``tests/test_router.py``. The router reads a replica's ``/v1/health``
through ``.get`` (``replica_id``, ``queued``, ``active``,
``prefilling``, ``kv``, ``sched``) and resumes a stream that died
mid-relay through the replica's ``resume_out`` / ``resume_logprobs``
seam. Pinned:

- streamed and plain ``/v1/generate`` and streamed ``/v1/completions``
  through the router equal direct submission bit for bit (greedy and
  seeded; OpenAI chunks with their ids and timestamps aside);
- a replica stopped mid-stream: the stream resumes on the other with the
  uninterrupted run's tokens, and its logprobs within 1e-5 (a resumed
  token's logprob comes from a chunk forward, not a T = 1 decode: the
  reference's own resume-logprob finding, ROADMAP C).
"""

import asyncio
import json
import socket

import aiohttp
import pytest
import torch

from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models.batching import ContinuousBatcher
from k8s_gpu_device_plugin_torch.serving import server as srv
from k8s_gpu_device_plugin_torch.serving.tokenizer import ByteTokenizer
from k8s_gpu_device_plugin_tpu.serving.fleet import FleetRegistry
from k8s_gpu_device_plugin_tpu.serving.router import ReplicaRouter

# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's OpenMP pool from spinning against
# them (these shapes gain nothing from more)
torch.set_num_threads(1)

PROMPT = [5, 9, 13, 21, 34, 55]


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=240))


@pytest.fixture(scope="module")
def model():
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    return cfg, tllama.init_params(cfg, seed=7, device="cpu")


class Replica:
    """One port server whose live connections can be cut (the crash
    path: the listener closes first, then every open stream)."""

    def __init__(self, cfg, params):
        self.server = srv.InferenceServer(
            srv.InferenceEngine(ContinuousBatcher(
                params, cfg, n_slots=2, max_len=64, chunked_prefill=8)),
            host="127.0.0.1", port=0, tokenizer=ByteTokenizer())
        self.socks = []
        accept = self.server.get_request

        def get_request():
            sock, addr = accept()
            self.socks.append(sock)
            return sock, addr

        self.server.get_request = get_request
        self.server.start()
        self.url = f"http://127.0.0.1:{self.server.bound_port}"

    def kill(self):
        self.server.shutdown()
        self.server.server_close()
        for sock in self.socks:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # closed already
        self.server.engine.shutdown()

    def stop(self):
        if self.server.socket.fileno() != -1:
            self.server.stop()
        else:
            self.server.engine.shutdown()


async def with_fleet(model, body):
    cfg, params = model
    replicas = [Replica(cfg, params) for _ in range(2)]
    fleet = FleetRegistry.from_spec(",".join(
        f"r{i}={r.url}" for i, r in enumerate(replicas)))
    router = ReplicaRouter(fleet, host="127.0.0.1", port=0, policy="rr",
                           health_interval_s=0.05, drain_timeout_s=30.0)
    stop = asyncio.Event()
    task = asyncio.create_task(router.run(stop))
    try:
        while router.bound_port is None:
            assert not task.done(), task.exception()
            await asyncio.sleep(0.01)
        async with aiohttp.ClientSession() as session:
            await body(session, f"http://127.0.0.1:{router.bound_port}",
                       replicas, router)
    finally:
        stop.set()
        await asyncio.wait_for(task, 30)
        for r in replicas:
            await asyncio.get_running_loop().run_in_executor(None, r.stop)


async def read_events(resp, on_token=None) -> list:
    """SSE payloads of one stream; ``on_token(count)`` after each token
    event (the kill hook)."""
    out, n = [], 0
    async for line in resp.content:
        line = line.decode().strip()
        if not line.startswith("data: "):
            continue
        payload = line[len("data: "):]
        evt = payload if payload == "[DONE]" else json.loads(payload)
        out.append(evt)
        if isinstance(evt, dict) and "token" in evt:
            n += 1
            if on_token is not None:
                await on_token(n)
    return out


def _toks_lps(events):
    toks = [e["token"] for e in events if "token" in e]
    return toks, [e.get("logprob") for e in events if "token" in e]


def _strip(evt):
    """An OpenAI chunk without the per-request id and timestamp."""
    if isinstance(evt, dict):
        return {k: v for k, v in evt.items() if k not in ("id", "created")}
    return evt


@pytest.mark.parametrize("seeded", [False, True])
def test_streams_through_the_router_equal_direct(model, seeded):
    body = {"prompt": PROMPT, "max_new": 10, "logprobs": True}
    if seeded:
        body.update(temperature=0.8, seed=77)
    oai = {"prompt": PROMPT, "max_tokens": 6, "stream": True, "logprobs": 1,
           "model": "tpu-serving", **({"temperature": 0.8, "seed": 77}
                                      if seeded else {})}

    async def check(session, base, replicas, router):
        direct = replicas[0].url
        async with session.post(f"{direct}/v1/generate", json=body) as r:
            want = await r.json()
        async with session.post(f"{base}/v1/generate", json=body) as r:
            assert r.status == 200
            got = await r.json()
        assert got["tokens"] == want["tokens"]
        assert got["logprobs"] == want["logprobs"]
        assert got["text"] == want["text"]
        sse = dict(body, stream=True)
        async with session.post(f"{direct}/v1/generate", json=sse) as r:
            ev_direct = await read_events(r)
        for _ in range(2):  # rr: each replica serves one
            async with session.post(f"{base}/v1/generate", json=sse) as r:
                assert r.headers["Content-Type"].startswith(
                    "text/event-stream")
                assert await read_events(r) == ev_direct
        assert _toks_lps(ev_direct) == (want["tokens"], want["logprobs"])
        async with session.post(f"{direct}/v1/completions", json=oai) as r:
            oai_direct = [_strip(e) for e in await read_events(r)]
        async with session.post(f"{base}/v1/completions", json=oai) as r:
            oai_routed = [_strip(e) for e in await read_events(r)]
        assert oai_routed == oai_direct and oai_direct[-1] == "[DONE]"

    run(with_fleet(model, check))


@pytest.mark.parametrize("seeded", [False, True])
def test_replica_stopped_midstream_resumes_on_the_other(model, seeded):
    body = {"prompt": PROMPT, "max_new": 24, "stream": True,
            "logprobs": True}
    if seeded:
        body.update(temperature=0.8, seed=77)

    async def check(session, base, replicas, router):
        async with session.post(f"{base}/v1/generate", json=body) as r:
            baseline = await read_events(r)
        base_toks, base_lps = _toks_lps(baseline)
        assert baseline[-1]["done"] and len(base_toks) == 24
        killed = []

        async def kill_at_3(n):
            if n != 3 or killed:
                return
            serving = next(i for i in range(2)
                           if router.fleet.get(f"r{i}").inflight > 0)
            killed.append(serving)
            await asyncio.get_running_loop().run_in_executor(
                None, replicas[serving].kill)

        async with session.post(f"{base}/v1/generate", json=body) as r:
            events = await read_events(r, on_token=kill_at_3)
        assert killed, "the kill hook never fired"
        toks, lps = _toks_lps(events)
        assert events[-1].get("done") is True       # no error frame
        assert toks == base_toks and len(toks) == 24  # none re-emitted
        assert max(abs(a - b) for a, b in zip(lps, base_lps)) <= 1e-5
        stats = router.router_stats()
        assert stats["resumes"] == 1 and stats["resume_failures"] == 0

    run(with_fleet(model, check))

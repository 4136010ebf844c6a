"""The port's replica router (``serving/router.py`` on ``async_http``)
over port replicas, mirroring ``tests/test_router.py`` test by test.

Tiny f32 port replicas on the CPU (``n_slots=2, max_len=64,
chunked_prefill=8``, one module-scoped set of weights) in an in-process
fleet (``serving/testing.py``), the router on the test's event loop.
Pinned: streams through the router equal direct submission bit for bit;
affinity homes; a drain that finishes in-flight work and refuses or
spills new work; a dead replica's failover with health aggregated; a
forwarded 429 with ``Retry-After``; a wedged replica failed over within
the header timeout (the test closes its wedge's writers before
``wait_closed``, which on Python >= 3.12.1 waits for every open
connection); a poll loop that survives probe exceptions; warm-spare
promotion; a rolling restart with zero drops that waits for a replica
restarted at the same port (its ``uptime_s`` resetting); a client
disconnect that cancels upstream; the replica's fleet identity on
``/v1/health``. Mid-stream resume, faults and the budget are in
``test_torch_router_resume.py``.
"""

import asyncio
import contextlib
import json

import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models.batching import ContinuousBatcher
from k8s_gpu_device_plugin_torch.serving import async_http
from k8s_gpu_device_plugin_torch.serving import server as srv
from k8s_gpu_device_plugin_torch.serving.fleet import FleetRegistry
from k8s_gpu_device_plugin_torch.serving.router import ReplicaRouter
from k8s_gpu_device_plugin_torch.serving.scheduler import Scheduler
from k8s_gpu_device_plugin_torch.serving.testing import (
    get_json,
    inprocess_fleet,
    post_json,
    stream_events,
)
from k8s_gpu_device_plugin_torch.serving.tokenizer import ByteTokenizer

# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's OpenMP pool from spinning against
# them (these shapes gain nothing from more)
torch.set_num_threads(1)

BUCKETS = (8, 16, 32)
ENGINE_KW = dict(n_slots=2, max_len=64, chunked_prefill=8)


def run(coro, timeout: float = 60.0):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


@pytest.fixture(scope="module")
def model():
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    return cfg, tllama.init_params(cfg, seed=7, device="cpu")


def prompt(seed: int, n: int, cfg) -> list:
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, n).tolist()


@contextlib.asynccontextmanager
async def fleet(model, n: int = 2, policy: str = "affinity",
                router_kw=None, engine_kw=None, server_kw=None,
                engine_factory=None):
    cfg, params = model
    async with inprocess_fleet(
        params, cfg, n_replicas=n, device="cpu",
        engine_kw={**ENGINE_KW, **(engine_kw or {})},
        engine_factory=engine_factory, server_kw=server_kw,
        router_kw={"policy": policy, "prompt_buckets": BUCKETS,
                   "health_interval_s": 0.1, "drain_timeout_s": 30.0,
                   **(router_kw or {})},
    ) as ctx:
        yield ctx


def toks_lps(events):
    return ([e["token"] for e in events if "token" in e],
            [e.get("logprob") for e in events if "token" in e])


# --- fleet identity (the replica's /v1/health) -----------------------------


def test_health_reports_replica_id_and_uptime_resetting(model):
    """``/v1/health`` carries ``replica_id`` (``--replicaId``, or
    hostname:port) and ``uptime_s``, and ``uptime_s`` starts again on a
    new server at the same port: how the rolling restart tells a new
    process behind the same address."""
    cfg, params = model

    async def body():
        loop = asyncio.get_running_loop()
        engine = srv.InferenceEngine(ContinuousBatcher(params, cfg,
                                                       **ENGINE_KW))
        first = srv.InferenceServer(engine, host="127.0.0.1", port=0,
                                    replica_id="r7")
        first.start()
        port = first.bound_port
        url = f"http://127.0.0.1:{port}"
        await asyncio.sleep(0.3)
        status, h1 = await get_json(f"{url}/v1/health")
        assert status == 200 and h1["replica_id"] == "r7"
        assert h1["uptime_s"] >= 0.3
        await loop.run_in_executor(None, first.stop)
        engine = srv.InferenceEngine(ContinuousBatcher(params, cfg,
                                                       **ENGINE_KW))
        second = srv.InferenceServer(engine, host="127.0.0.1", port=port)
        second.start()
        try:
            status, h2 = await get_json(f"{url}/v1/health")
            assert status == 200
            assert h2["uptime_s"] < h1["uptime_s"]
            # no --replicaId: hostname:port, stable across calls
            assert h2["replica_id"].endswith(f":{port}")
            assert second.replica_label() == h2["replica_id"]
        finally:
            await loop.run_in_executor(None, second.stop)
        args = srv.build_parser().parse_args(["--replicaId", "r3"])
        assert args.replicaId == "r3"

    run(body())


# --- proxy parity ----------------------------------------------------------


def test_streams_via_router_bit_identical(model):
    """Tokens AND logprobs through the router equal direct submission, in
    JSON and SSE modes, and the OpenAI surface proxies the same."""
    cfg, _ = model
    p = prompt(310, 6, cfg)

    async def body():
        async with fleet(model, server_kw={"tokenizer": ByteTokenizer()}) \
                as ctx:
            direct = ctx.replica_base(0)
            req = {"prompt": p, "max_new": 5, "logprobs": True}
            s1, _, d_direct = await post_json(f"{direct}/v1/generate", req)
            s2, _, d_routed = await post_json(f"{ctx.base}/v1/generate",
                                              req)
            assert s1 == s2 == 200
            assert d_routed["tokens"] == d_direct["tokens"]
            assert d_routed["logprobs"] == d_direct["logprobs"]
            sse = dict(req, stream=True)
            ev_direct = await stream_events(f"{direct}/v1/generate", sse)
            ev_routed = await stream_events(f"{ctx.base}/v1/generate", sse)
            assert ev_routed == ev_direct
            assert toks_lps(ev_routed) == (d_direct["tokens"],
                                           d_direct["logprobs"])
            assert ev_routed[-1]["done"] is True
            oai = {"prompt": p, "max_tokens": 4, "model": "tpu-serving"}
            _, _, c_direct = await post_json(f"{direct}/v1/completions", oai)
            _, _, c_routed = await post_json(f"{ctx.base}/v1/completions",
                                             oai)
            assert c_routed["choices"][0] == c_direct["choices"][0]
            assert c_routed["usage"] == c_direct["usage"]

    run(body())


def test_affinity_routes_shared_prefix_to_one_replica(model):
    """Six requests sharing a bucket-covering prefix land on ONE replica
    and count as affinity hits; distinct prefixes spread."""
    cfg, _ = model

    async def body():
        async with fleet(model) as ctx:
            shared = prompt(320, 16, cfg)
            for i in range(6):
                s, _, _ = await post_json(f"{ctx.base}/v1/generate", {
                    "prompt": shared + prompt(330 + i, 4, cfg),
                    "max_new": 2})
                assert s == 200
            relayed = {r.rid: r.relayed for r in ctx.fleet.all()}
            assert sorted(relayed.values()) == [0, 6], relayed
            stats = ctx.router.router_stats()
            assert stats["affinity_hits"] == 6 and stats["failovers"] == 0
            for i in range(8):
                s, _, _ = await post_json(f"{ctx.base}/v1/generate", {
                    "prompt": prompt(400 + i, 20, cfg), "max_new": 2})
                assert s == 200
            assert all(r.relayed > 0 for r in ctx.fleet.all())

    run(body())


# --- drain -----------------------------------------------------------------


def test_drain_finishes_inflight_stream_and_refuses_new(model):
    """Drain mid-stream: the stream delivers every token and its done
    event; while draining, new submits answer 503 ``draining`` on both
    API surfaces (metadata reads still answer); undrain restores
    admission."""
    cfg, _ = model
    p = prompt(340, 3, cfg)

    async def body():
        async with fleet(model, n=1) as ctx:
            base = ctx.base
            drain = {}

            async def on_token(n):
                if n == 1:
                    drain["task"] = asyncio.create_task(
                        post_json(f"{base}/fleet/drain/r0"))

            events = await stream_events(
                f"{base}/v1/generate",
                {"prompt": p, "max_new": 60, "stream": True}, on_token)
            assert len(toks_lps(events)[0]) == 60 and events[-1]["done"]
            status, _, d = await drain["task"]
            assert status == 200 and d["drained"] is True
            assert d["replica"] == "r0" and d["drain_seconds"] >= 0.0
            s, _, refuse = await post_json(f"{base}/v1/generate",
                                           {"prompt": p, "max_new": 2})
            assert s == 503 and refuse["code"] == "draining"
            s, _, refuse = await post_json(f"{base}/v1/completions",
                                           {"prompt": p, "max_tokens": 2})
            assert s == 503 and refuse["error"]["code"] == "draining"
            assert refuse["error"]["type"] == "server_error"
            s, _, refuse = await post_json(
                f"{base}/v1/chat/completions",
                {"messages": [{"role": "user", "content": "hi"}]})
            assert s == 503 and refuse["error"]["code"] == "draining"
            s, _ = await get_json(f"{base}/v1/models")
            assert s == 200
            s, _, d = await post_json(f"{base}/fleet/undrain/r0")
            assert s == 200 and d["draining"] is False
            s, _, want = await post_json(f"{ctx.replica_base(0)}/v1/generate",
                                         {"prompt": p, "max_new": 3})
            s2, _, got = await post_json(f"{base}/v1/generate",
                                         {"prompt": p, "max_new": 3})
            assert s == s2 == 200 and got["tokens"] == want["tokens"]

    run(body())


def test_drain_spills_new_work_to_the_survivor(model):
    cfg, _ = model

    async def body():
        async with fleet(model) as ctx:
            s, _, d = await post_json(f"{ctx.base}/fleet/drain/r0")
            assert s == 200 and d["drained"] is True
            for i in range(4):
                s, _, _ = await post_json(f"{ctx.base}/v1/generate", {
                    "prompt": prompt(350 + i, 5, cfg), "max_new": 2})
                assert s == 200
            assert ctx.fleet.get("r0").relayed == 0
            assert ctx.fleet.get("r1").relayed == 4
            assert ctx.fleet.snapshot()["replicas"]["r0"]["draining"]
            s, _, _ = await post_json(f"{ctx.base}/fleet/drain/nope")
            assert s == 404

    run(body())


# --- failover and the fleet surfaces ---------------------------------------


def test_dead_replica_fails_over_and_health_aggregates(model):
    cfg, _ = model

    async def body():
        async with fleet(model) as ctx:
            base = ctx.base
            for i in range(4):
                s, _, _ = await post_json(f"{base}/v1/generate", {
                    "prompt": prompt(360 + i, 12, cfg), "max_new": 2})
                assert s == 200
            await asyncio.sleep(0.3)
            snap = ctx.fleet.snapshot()
            assert snap["live"] == 2
            # the ids each replica's /v1/health reported
            assert {v["reported_id"] for v in snap["replicas"].values()} \
                == {"r0", "r1"}
            await ctx.kill_replica(0)
            for i in range(8):
                s, _, _ = await post_json(f"{base}/v1/generate", {
                    "prompt": prompt(370 + i, 12, cfg), "max_new": 2})
                assert s == 200
            stats = ctx.router.router_stats()
            assert stats["outcomes"].get("unreachable", 0) >= 1
            assert stats["failovers"] >= 1
            for _ in range(40):
                if ctx.fleet.snapshot()["live"] == 1:
                    break
                await asyncio.sleep(0.05)
            assert ctx.fleet.snapshot()["replicas"]["r0"]["alive"] is False
            s, agg = await get_json(f"{base}/fleet/health")
            assert agg["live"] == 1 and agg["router"]["failovers"] >= 1
            s, models = await get_json(f"{base}/v1/models")
            assert s == 200 and models["data"][0]["id"] == "tpu-serving"
            s, h = await get_json(f"{base}/v1/health")
            assert s == 200 and h["router"] is True and h["live"] == 1

    run(body())


def test_backend_429_forwarded_with_retry_after(model):
    """A single overloaded replica's 429 reaches the client verbatim
    (body + Retry-After); the cooldown does not wedge the fleet."""
    cfg, _ = model
    p = prompt(380, 9, cfg)

    async def body():
        async with fleet(model, n=1,
                         engine_kw={"scheduler": Scheduler(max_queue=1)}) \
                as ctx:
            results = await asyncio.gather(*(
                post_json(f"{ctx.base}/v1/generate",
                          {"prompt": p, "max_new": 40})
                for _ in range(8)))
            rejected = [r for r in results if r[0] == 429]
            assert rejected and any(r[0] == 200 for r in results)
            for _, headers, payload in rejected:
                assert int(headers["Retry-After"]) >= 1
                assert payload["code"] == "overloaded"
            s, _, _ = await post_json(f"{ctx.base}/v1/generate",
                                      {"prompt": p, "max_new": 2})
            assert s in (200, 429)

    run(body())


def test_header_timeout_default_is_finite():
    router = ReplicaRouter(FleetRegistry.from_spec("r0=http://127.0.0.1:1"),
                           prompt_buckets=BUCKETS)
    assert router.header_timeout_s > 0


def test_wedged_replica_fails_over_within_header_timeout():
    """One wedged backend (accepts, never answers) and one healthy stub:
    every request lands on the healthy one within the header timeout,
    counted as a failover. The wedge's writers are closed before
    ``wait_closed`` (Python >= 3.12.1 waits for open connections)."""

    async def body():
        writers = []

        async def wedge(reader, writer):
            writers.append(writer)
            await asyncio.sleep(3600)

        wedged = await asyncio.start_server(wedge, "127.0.0.1", 0)
        wedged_port = wedged.sockets[0].getsockname()[1]
        stub = async_http.HttpServer()

        async def gen(request):
            return async_http.json_response({"id": 0, "tokens": [1, 2]})

        stub.add_post("/v1/generate", gen)
        ok_port = await stub.start("127.0.0.1", 0)
        fleet_reg = FleetRegistry.from_spec(
            f"w=http://127.0.0.1:{wedged_port},ok=http://127.0.0.1:{ok_port}")
        # the proxy's header timeout fails over, not the health poller
        router = ReplicaRouter(fleet_reg, host="127.0.0.1", port=0,
                               policy="rr", header_timeout_s=0.4,
                               health_interval_s=60.0,
                               prompt_buckets=BUCKETS)
        stop = asyncio.Event()
        task = asyncio.create_task(router.run(stop))
        while router.bound_port is None:
            await asyncio.sleep(0.01)
        try:
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            for _ in range(2):  # rr: one of these starts on the wedge
                s, _, d = await post_json(
                    f"http://127.0.0.1:{router.bound_port}/v1/generate",
                    {"prompt": [1, 2, 3], "max_new": 2})
                assert s == 200 and d["tokens"] == [1, 2]
            assert loop.time() - t0 < 5.0
            assert router.router_stats()["failovers"] >= 1
        finally:
            stop.set()
            await asyncio.wait_for(task, 30)
            wedged.close()
            for w in writers:
                w.close()
            await asyncio.wait_for(wedged.wait_closed(), 10)
            await stub.close()

    run(body(), timeout=30)


def test_poll_loop_survives_probe_exceptions_and_marks_down():
    async def body():
        fleet_reg = FleetRegistry.from_spec(
            "bad=http://127.0.0.1:1,good=http://127.0.0.1:2", dead_after=3)
        router = ReplicaRouter(fleet_reg, health_interval_s=0.02,
                               prompt_buckets=BUCKETS)
        probed = {"good": 0}

        async def fake_probe(rep):
            if rep.rid == "bad":
                raise RuntimeError("raised inside the poll iteration")
            probed["good"] += 1
            fleet_reg.note_success(rep, {"alive": True})
            return {"alive": True}

        router._probe_health = fake_probe
        task = asyncio.create_task(router._poll_loop())
        try:
            await asyncio.sleep(0.3)
            assert not task.done()
            bad = fleet_reg.get("bad")
            assert bad.consecutive_failures >= 3 and bad.alive is False
            assert fleet_reg.get("good").alive and probed["good"] >= 3
        finally:
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await task

    run(body())


# --- warm spares and the rolling restart -----------------------------------


def test_warm_spare_promotion(model):
    cfg, _ = model

    async def body():
        async with fleet(model, n=3, router_kw={
                "warm_spares": 1, "health_interval_s": 0.05}) as ctx:
            assert [r.rid for r in ctx.fleet.active()] == ["r0", "r1"]
            assert [r.rid for r in ctx.fleet.spares()] == ["r2"]
            for i in range(6):
                s, _, _ = await post_json(f"{ctx.base}/v1/generate", {
                    "prompt": prompt(560 + i, 12, cfg), "max_new": 2})
                assert s == 200
            assert ctx.fleet.get("r2").relayed == 0
            await ctx.kill_replica(0)
            for _ in range(100):
                if ctx.router.router_stats()["promotions"] >= 1:
                    break
                await asyncio.sleep(0.05)
            assert ctx.router.router_stats()["promotions"] == 1
            assert {r.rid for r in ctx.fleet.active()} == {"r1", "r2"}
            assert ctx.fleet.get("r0").spare
            for i in range(8):
                s, _, _ = await post_json(f"{ctx.base}/v1/generate", {
                    "prompt": prompt(570 + i, 12, cfg), "max_new": 2})
                assert s == 200
            assert ctx.fleet.get("r2").relayed > 0
            s, snap = await get_json(f"{ctx.base}/fleet/health")
            assert snap["router"]["promotions"] == 1
            assert snap["replicas"]["r0"]["spare"] is True
            assert snap["replicas"]["r2"]["spare"] is False
            assert snap["spares"] == 1
            kinds = [e["kind"] for e in ctx.router.journal.events_payload()[
                "events"]]
            assert "promote" in kinds

    run(body())


def test_mark_spares_must_leave_an_active_replica():
    fleet_reg = FleetRegistry.from_spec("a=http://h:1,b=http://h:2")
    with pytest.raises(ValueError, match="active replica"):
        fleet_reg.mark_spares(2)


def test_rolling_restart_zero_drops_waits_for_new_processes(model):
    """POST /fleet/rolling-restart with ``wait_restart_s``: each replica
    drains (streams in flight finish whole), is replaced by a NEW server
    at the same port while the cycle waits, and the cycle sees the
    restart by ``uptime_s`` resetting; zero dropped tokens, zero
    resumes, admission restored everywhere."""
    cfg, params = model

    async def body():
        loop = asyncio.get_running_loop()
        async with fleet(model, policy="rr",
                         router_kw={"health_interval_s": 0.05}) as ctx:
            base = ctx.base
            wait = asyncio.Queue()
            orig = ctx.router._wait_restart

            async def waiting(rep, timeout_s):
                wait.put_nowait(rep.rid)
                return await orig(rep, timeout_s)

            ctx.router._wait_restart = waiting

            async def restarter():
                for _ in range(2):
                    rid = await wait.get()
                    i = int(rid[1:])
                    old = ctx.servers[i]
                    await asyncio.sleep(0.1)  # the old uptime is above
                    await loop.run_in_executor(None, old.stop)
                    engine = srv.InferenceEngine(
                        ContinuousBatcher(params, cfg, **ENGINE_KW))
                    new = srv.InferenceServer(
                        engine, host="127.0.0.1", port=old.bound_port,
                        replica_id=rid)
                    new.start()
                    ctx.servers[i] = new

            async def stream_one(k):
                events = await stream_events(f"{base}/v1/generate", {
                    "prompt": prompt(590 + k, 5, cfg), "max_new": 40,
                    "stream": True})
                return len(toks_lps(events)[0]), bool(events[-1].get("done"))

            streams = [asyncio.create_task(stream_one(k)) for k in range(4)]
            restarts = asyncio.create_task(restarter())
            await asyncio.sleep(0.2)
            s, _, cycle = await post_json(f"{base}/fleet/rolling-restart",
                                          {"wait_restart_s": 20})
            assert s == 200, cycle
            assert cycle["completed"] is True
            assert set(cycle["replicas"]) == {"r0", "r1"}
            assert all(v["drained"] and v["restarted"]
                       for v in cycle["replicas"].values())
            await restarts
            s, _, _ = await post_json(f"{base}/v1/generate", {
                "prompt": prompt(599, 5, cfg), "max_new": 2})
            assert s == 200
            results = await asyncio.gather(*streams)
            assert all(done and n == 40 for n, done in results), results
            assert not any(r.draining for r in ctx.fleet.all())
            assert ctx.router.router_stats()["resumes"] == 0
            kinds = [e["kind"] for e in ctx.router.journal.events_payload()[
                "events"] if e["kind"].startswith("rolling")]
            assert kinds == ["rolling_restart", "rolling_drain",
                             "rolling_undrain", "rolling_drain",
                             "rolling_undrain", "rolling_restart_done"]

    run(body())


def test_rolling_restart_wait_restart_detects_new_process():
    async def body():
        fleet_reg = FleetRegistry.from_spec("a=http://127.0.0.1:1")
        router = ReplicaRouter(fleet_reg, health_interval_s=0.01,
                               prompt_buckets=BUCKETS)
        rep = fleet_reg.get("a")
        rep.health = {"uptime_s": 120.0}
        uptimes = [150.0, 3.0]

        async def fake_probe(r):
            return {"uptime_s": uptimes.pop(0) if uptimes else 4.0}

        router._probe_health = fake_probe
        assert await router._wait_restart(rep, timeout_s=5.0) is True

        async def old_process(r):
            return {"uptime_s": 500.0}

        router._probe_health = old_process
        rep.health = {"uptime_s": 120.0}
        assert await router._wait_restart(rep, timeout_s=0.05) is False

    run(body())


# --- a client that leaves --------------------------------------------------


def test_client_disconnect_cancels_upstream(model):
    """A client that aborts its SSE stream mid-generation frees the
    replica's slot: the router closes the backend connection hard and
    the replica's active count returns to zero long before the budget
    would have drained."""
    cfg, _ = model

    async def body():
        async with fleet(model, n=1, engine_kw={"max_len": 4096}) as ctx:
            engine = ctx.servers[0].engine
            resp = await async_http.request(
                "POST", f"{ctx.base}/v1/generate", json.dumps({
                    "prompt": prompt(601, 5, cfg), "max_new": 4000,
                    "stream": True}).encode(),
                {"Content-Type": "application/json"})
            assert resp.status == 200
            seen = 0
            async for line in resp.iter_lines():
                if line.startswith(b"data: "):
                    seen += 1
                    if seen >= 2:
                        break
            resp.close()
            for _ in range(200):
                st = engine.stats()
                if not (st["active"] or st["queued"] or st["prefilling"]):
                    break
                await asyncio.sleep(0.05)
            st = engine.stats()
            assert st["active"] == 0 and st["queued"] == 0, st
            assert st["decode_tokens"] < 4000
            for _ in range(40):
                if ctx.fleet.get("r0").inflight == 0:
                    break
                await asyncio.sleep(0.05)
            assert ctx.fleet.get("r0").inflight == 0

    run(body())

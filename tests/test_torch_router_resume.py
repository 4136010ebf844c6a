"""Cross-replica stream resume through the port's router, mirroring the
resume half of ``tests/test_router.py``.

Tiny f32 port replicas on the CPU (the fleet of
``test_torch_router.py``). Pinned: a replica killed mid-stream (its
listener and open sockets cut, so the relay's close-delimited body ends
before its done frame) resumes on the other with the uninterrupted
run's tokens bit for bit and no token twice, greedy and seeded; the
continuation equals a direct ``resume_out`` / ``resume_logprobs``
submission of the same fold to the survivor bit for bit, tokens and
logprobs (a resumed token's logprob comes from the fold's chunk forward
rather than a T = 1 decode, so against the uninterrupted run the
logprobs are held within 1e-5: ROADMAP C); the resume seam over HTTP;
a resume refused with a 4xx fails fast and keeps the replica alive;
the injected ``router.midstream`` and ``router.connect`` faults; the
budget's structured error frame, charged per replica death.
"""

import asyncio

import pytest

from k8s_gpu_device_plugin_torch.serving import async_http
from k8s_gpu_device_plugin_torch.serving.faults import FaultPlane
from k8s_gpu_device_plugin_torch.serving.fleet import (
    FleetRegistry,
    FleetRestartBudget,
    Replica,
)
from k8s_gpu_device_plugin_torch.serving.router import ReplicaRouter
from k8s_gpu_device_plugin_torch.serving.testing import (
    post_json,
    stream_events,
)
from tests.test_torch_router import (  # noqa: F401 - the module fixture
    BUCKETS,
    fleet,
    model,
    prompt,
    run,
    toks_lps,
)


@pytest.mark.parametrize("seeded", [False, True])
def test_midstream_replica_kill_resumes_bit_identical(model, seeded):
    """Kill the replica serving a stream after 3 relayed tokens: the
    client stream has every token once and ends with done; its tokens
    are the uninterrupted run's; its continuation is a direct resume of
    the same fold on the survivor, bit for bit."""
    cfg, _ = model
    body = {"prompt": prompt(500 + int(seeded), 6, cfg), "max_new": 24,
            "stream": True, "logprobs": True}
    if seeded:
        body.update(temperature=0.8, seed=77)

    async def check():
        async with fleet(model, policy="rr",
                         router_kw={"health_interval_s": 0.05}) as ctx:
            baseline = await stream_events(f"{ctx.base}/v1/generate", body)
            base_toks, base_lps = toks_lps(baseline)
            assert baseline[-1].get("done") and len(base_toks) == 24
            killed = []

            async def kill_at_3(n):
                if n != 3 or killed:
                    return
                serving = next(i for i in range(2)
                               if ctx.fleet.get(f"r{i}").inflight > 0)
                killed.append(serving)
                await ctx.kill_replica(serving)

            events = await stream_events(f"{ctx.base}/v1/generate", body,
                                         kill_at_3)
            assert killed, "the kill hook never fired"
            toks, lps = toks_lps(events)
            assert events[-1].get("done") is True      # no error frame
            assert toks == base_toks and len(toks) == 24
            assert max(abs(a - b) for a, b in zip(lps, base_lps)) <= 1e-5
            stats = ctx.router.router_stats()
            assert stats["resumes"] == 1 and stats["resume_failures"] == 0
            assert stats["fleet_budget"]["charged_total"] == 1
            (resume,) = [e for e in ctx.router.journal.events_payload()[
                "events"] if e["kind"] == "stream_resume"]
            k = resume["tokens_at_death"]
            assert resume["source"] == f"r{killed[0]}"
            survivor = 1 - killed[0]
            assert resume["target"] == f"r{survivor}"
            direct = await stream_events(
                f"{ctx.replica_base(survivor)}/v1/generate",
                dict(body, resume_out=toks[:k], resume_logprobs=lps[:k]))
            assert toks_lps(direct) == (toks[k:], lps[k:])

    run(check())


def test_resume_seam_http_continuation(model):
    """The native resume seam through the router: resume_out = the first
    k tokens of a finished run gives EXACTLY the remaining tokens,
    greedy and seeded, streamed and not; malformed resume fields are
    forwarded unjournaled and answered by the replica."""
    cfg, _ = model
    p = prompt(520, 6, cfg)

    async def check():
        async with fleet(model, n=1) as ctx:
            url = f"{ctx.base}/v1/generate"
            for seeded in (False, True):
                req = {"prompt": p, "max_new": 10, "logprobs": True}
                if seeded:
                    req.update(temperature=0.9, seed=11)
                s, _, full = await post_json(url, req)
                assert s == 200
                for k in (1, 4, 9):
                    res = dict(req, resume_out=full["tokens"][:k],
                               resume_logprobs=full["logprobs"][:k])
                    s, _, cont = await post_json(url, res)
                    assert s == 200
                    assert cont["tokens"] == full["tokens"][k:]
                    assert max(abs(a - b) for a, b in zip(
                        cont["logprobs"], full["logprobs"][k:])) <= 1e-5
                    events = await stream_events(url, dict(res, stream=True))
                    assert toks_lps(events) == (cont["tokens"],
                                                cont["logprobs"])
                    assert events[-1].get("done") is True
            s, _, _ = await post_json(url, {"prompt": p, "max_new": 3,
                                            "resume_out": [1, 2, 3]})
            assert s == 422
            s, _, _ = await post_json(url, {"prompt": p, "max_new": 8,
                                            "resume_out": [1], "n": 2})
            assert s == 400
            for bad in (["x"], 5):
                s, _, _ = await post_json(url, {
                    "prompt": p, "max_new": 8, "stream": True,
                    "resume_out": bad})
                assert s == 400
            assert ctx.router.router_stats()["journaled"] == 0

    run(check())


def test_resume_refusal_keeps_replica_alive_and_fails_fast():
    """A candidate answering a resume with a 4xx proves its engine alive
    (no liveness failure) and refuses deterministically: the stream ends
    with ``resume_failed`` at once, not after the resume window."""

    async def check():
        async def gen_b(request):  # two tokens, then no done frame
            out = async_http.StreamResponse(
                headers={"Content-Type": "text/event-stream"})
            await out.prepare(request)
            await out.write(b'data: {"token": 1}\n\n')
            await out.write(b'data: {"token": 2}\n\n')
            return out

        async def gen_a(request):
            return async_http.json_response({"error": "no resume here"},
                                            status=422)

        stubs = []
        for handler in (gen_a, gen_b):
            stub = async_http.HttpServer()
            stub.add_post("/v1/generate", handler)
            stubs.append((stub, await stub.start("127.0.0.1", 0)))
        fleet_reg = FleetRegistry.from_spec(
            f"a=http://127.0.0.1:{stubs[0][1]},"
            f"b=http://127.0.0.1:{stubs[1][1]}", dead_after=3)
        # rr's first pick is the SECOND replica (b)
        router = ReplicaRouter(fleet_reg, host="127.0.0.1", port=0,
                               policy="rr", health_interval_s=60.0,
                               resume_timeout_s=30.0, prompt_buckets=BUCKETS)
        stop = asyncio.Event()
        task = asyncio.create_task(router.run(stop))
        while router.bound_port is None:
            await asyncio.sleep(0.01)
        try:
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            events = await stream_events(
                f"http://127.0.0.1:{router.bound_port}/v1/generate",
                {"prompt": [1, 2, 3], "max_new": 8, "stream": True})
            assert events[-1]["error"]["code"] == "resume_failed"
            assert [e["token"] for e in events[:-1]] == [1, 2]
            assert loop.time() - t0 < 5.0
            a = fleet_reg.get("a")
            assert a.alive is True and a.consecutive_failures == 0
            assert router.router_stats()["resume_failures"] == 1
        finally:
            stop.set()
            await asyncio.wait_for(task, 30)
            for stub, _ in stubs:
                await stub.close()

    run(check())


def test_injected_midstream_fault_resumes_on_other_replica(model):
    """``router.midstream:nth=2``: the relay's second frame is an injected
    death; the continuation comes from the other replica and the client
    sees every token once."""
    cfg, _ = model
    body = {"prompt": prompt(530, 6, cfg), "max_new": 12, "stream": True,
            "logprobs": True}

    async def check():
        async with fleet(model, policy="rr", router_kw={
                "faults": FaultPlane.from_spec("router.midstream:nth=2")}) \
                as ctx:
            s, _, want = await post_json(
                f"{ctx.replica_base(0)}/v1/generate",
                dict(body, stream=False))
            assert s == 200
            events = await stream_events(f"{ctx.base}/v1/generate", body)
            toks, _ = toks_lps(events)
            assert events[-1].get("done") is True
            assert toks == want["tokens"] and len(toks) == 12
            assert ctx.router.router_stats()["resumes"] == 1

    run(check())


def test_injected_router_connect_fault_fails_over(model):
    cfg, _ = model

    async def check():
        async with fleet(model, router_kw={
                "faults": FaultPlane.from_spec("router.connect:nth=1")}) \
                as ctx:
            for i in range(3):
                s, _, _ = await post_json(f"{ctx.base}/v1/generate", {
                    "prompt": prompt(400 + i, 12, cfg), "max_new": 2})
                assert s == 200
            stats = ctx.router.router_stats()
            assert stats["failovers"] >= 1
            assert stats["outcomes"].get("unreachable", 0) >= 1

    run(check())


def test_fleet_budget_exhausted_ends_with_error_frame(model):
    """Budget 0 = cross-replica resume off: a mid-stream death ends the
    stream with the structured error frame, never a clean short
    completion."""
    cfg, _ = model

    async def check():
        async with fleet(model, policy="rr", router_kw={
                "fleet_restart_budget": 0,
                "faults": FaultPlane.from_spec("router.midstream:nth=2")}) \
                as ctx:
            events = await stream_events(f"{ctx.base}/v1/generate", {
                "prompt": prompt(540, 6, cfg), "max_new": 12,
                "stream": True})
            assert not any(e.get("done") for e in events)
            assert events[-1]["error"]["code"] == "fleet_budget_exhausted"
            stats = ctx.router.router_stats()
            assert stats["resumes"] == 0 and stats["resume_failures"] == 1
            kinds = [e["kind"] for e in ctx.router.journal.events_payload()[
                "events"]]
            assert kinds == ["budget_exhausted"]

    run(check())


def test_fleet_restart_budget_charges_per_death_not_per_stream():
    budget = FleetRestartBudget(max_restarts=2, window_s=60.0)
    r0, r1, r2 = (Replica(f"r{i}", f"http://h:{i}") for i in range(3))
    assert all(budget.charge(r0) for _ in range(5))
    assert budget.stats()["window_used"] == 1
    assert budget.charge(r1)
    assert not budget.charge(r2)
    assert budget.charge(r0) and budget.charge(r1)
    r0.epoch += 1
    assert not budget.charge(r0)
    with pytest.raises(ValueError):
        FleetRestartBudget(max_restarts=-1)


def test_flapping_replica_burns_budget_per_death():
    fleet_reg = FleetRegistry.from_spec("a=http://h:1,b=http://h:2",
                                        dead_after=3)
    budget = FleetRestartBudget(max_restarts=1, window_s=60.0)
    a = fleet_reg.get("a")
    fleet_reg.note_failure(a)
    assert a.alive is True and budget.charge(a)
    fleet_reg.note_success(a, {"alive": True})
    assert a.consecutive_failures == 0
    fleet_reg.note_failure(a)
    assert not budget.charge(a)
    e = a.epoch
    fleet_reg.note_success(a, {"alive": True})
    fleet_reg.note_success(a, {"alive": True})
    assert a.epoch == e + 1

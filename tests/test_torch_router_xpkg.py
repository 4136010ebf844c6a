"""The port's router against the reference's, and the slice as a whole
against the JAX package.

- **Router against router**: the reference's ``ReplicaRouter`` (aiohttp)
  and the port's (``async_http``) over the SAME two port replicas (tiny
  f32, on the CPU), affinity policy and one bucket ladder: for the same
  requests they choose the same replica, relay the same JSON and SSE
  payloads, answer ``/fleet/health`` with the same keys, and journal
  the same ``/fleet/events`` for a drain and undrain sequence.
- **The slice as a whole**: two JAX replicas behind the reference's
  router against two port replicas behind the port's router, on the
  same tiny weights (``models/convert.py``'s ``params_from_jax``): the
  same greedy tokens, f32 logprobs within 1e-4, for a plain stream and
  for a stream whose replica is killed after 3 tokens and resumes on
  the other.
"""

import asyncio
import json

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax
from k8s_gpu_device_plugin_torch.serving.testing import (
    get_json,
    inprocess_fleet,
    post_json,
    stream_events,
)
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.obs.fleet_obs import FleetEventJournal
from k8s_gpu_device_plugin_tpu.serving import testing as jtesting
from k8s_gpu_device_plugin_tpu.serving.server import InferenceEngine
from k8s_gpu_device_plugin_tpu.serving.fleet import FleetRegistry
from k8s_gpu_device_plugin_tpu.serving.router import ReplicaRouter
from tests.test_torch_router import (  # noqa: F401 - the module fixture
    BUCKETS,
    ENGINE_KW,
    model,
    prompt,
    run,
    toks_lps,
)

torch.set_num_threads(1)


def _keys(tree, prefix=""):
    """Every key path of a JSON object (per-replica entries by id)."""
    out = set()
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.add(prefix + k)
            out |= _keys(v, f"{prefix}{k}.")
    return out


def test_port_router_agrees_with_the_reference_router(model):
    cfg, _ = model

    async def body():
        async with inprocess_fleet(
                model[1], cfg, n_replicas=2, device="cpu",
                engine_kw=ENGINE_KW,
                router_kw={"prompt_buckets": BUCKETS,
                           "health_interval_s": 0.1}) as ctx:
            jfleet = FleetRegistry.from_spec(",".join(
                f"r{i}={ctx.replica_base(i)}" for i in range(2)))
            jrouter = ReplicaRouter(jfleet, host="127.0.0.1", port=0,
                                    prompt_buckets=BUCKETS,
                                    health_interval_s=0.1)
            stop = asyncio.Event()
            task = asyncio.create_task(jrouter.run(stop))
            while jrouter.bound_port is None:
                assert not task.done(), task.exception()
                await asyncio.sleep(0.01)
            jbase = f"http://127.0.0.1:{jrouter.bound_port}"
            try:
                await asyncio.sleep(0.3)  # both pollers have seen both
                for i in range(6):
                    req = {"prompt": prompt(700 + i, 12 + i, cfg),
                           "max_new": 4, "logprobs": True}
                    chosen = []
                    for base, reg in ((ctx.base, ctx.fleet),
                                      (jbase, jfleet)):
                        before = {r.rid: r.relayed for r in reg.all()}
                        s, _, got = await post_json(f"{base}/v1/generate",
                                                    req)
                        assert s == 200
                        chosen.append([r.rid for r in reg.all()
                                       if r.relayed > before[r.rid]])
                        if base == ctx.base:
                            want = got
                        else:
                            assert got["tokens"] == want["tokens"]
                            assert got["logprobs"] == want["logprobs"]
                    assert chosen[0] == chosen[1] and len(chosen[0]) == 1
                    sse = dict(req, stream=True)
                    assert await stream_events(f"{ctx.base}/v1/generate",
                                               sse) == \
                        await stream_events(f"{jbase}/v1/generate", sse)
                s1, mine = await get_json(f"{ctx.base}/fleet/health")
                s2, theirs = await get_json(f"{jbase}/fleet/health")
                assert s1 == s2 == 200 and _keys(mine) == _keys(theirs)
                s1, mine = await get_json(f"{ctx.base}/v1/health")
                s2, theirs = await get_json(f"{jbase}/v1/health")
                assert mine == theirs
                for op in ("drain", "undrain"):
                    for base in (ctx.base, jbase):
                        s, _, _ = await post_json(f"{base}/fleet/{op}/r1")
                        assert s == 200
                s, _, _ = await post_json(f"{ctx.base}/fleet/drain/nope")
                assert s == 404
                replays = []
                for base in (ctx.base, jbase):
                    s, events = await get_json(f"{base}/fleet/events")
                    replays.append(FleetEventJournal.replay(
                        events["events"]))
                assert [e["kind"] for e in replays[0]] == \
                    ["drain", "drain_done", "undrain"]
                assert replays[0] == replays[1]
            finally:
                stop.set()
                await asyncio.wait_for(task, 30)

    run(body())


@pytest.fixture(scope="module")
def both():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, n_layers=2)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, n_layers=2)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def test_the_slice_matches_the_jax_fleet(both):
    """Plain stream and a mid-stream kill and resume: JAX replicas behind
    the reference's router and port replicas behind the port's router
    give the same greedy tokens, logprobs within 1e-4."""
    jcfg, jparams, tcfg, tparams = both
    body = {"prompt": prompt(810, 10, tcfg), "max_new": 16,
            "stream": True, "logprobs": True}
    router_kw = {"policy": "rr", "prompt_buckets": BUCKETS,
                 "health_interval_s": 0.05}

    async def kill_run(base, fleet_ctx, read):
        killed = []

        async def kill_at_3(n):
            if n == 3 and not killed:
                i = next(i for i in range(2)
                         if fleet_ctx.fleet.get(f"r{i}").inflight > 0)
                killed.append(i)
                await fleet_ctx.kill_replica(i)

        events = await read(base, kill_at_3)
        assert killed and events[-1].get("done") is True
        assert fleet_ctx.router.router_stats()["resumes"] == 1
        return toks_lps(events)

    engines = []

    def engine_factory(i):
        engines.append(InferenceEngine(jparams, jcfg, **ENGINE_KW))
        return engines[-1]

    async def jax_side():
        async with jtesting.inprocess_fleet(
                jparams, jcfg, n_replicas=2, engine_factory=engine_factory,
                router_kw=router_kw) as ctx:
            async with aiohttp.ClientSession() as session:

                async def read(base, on_token=None):
                    events, n = [], 0
                    async with session.post(f"{base}/v1/generate",
                                            json=body) as r:
                        async for line in r.content:
                            line = line.decode().strip()
                            if not line.startswith("data: "):
                                continue
                            evt = json.loads(line[len("data: "):])
                            events.append(evt)
                            if "token" in evt:
                                n += 1
                                if on_token is not None:
                                    await on_token(n)
                            if "done" in evt or "error" in evt:
                                break
                    return events

                plain = toks_lps(await read(ctx.base))
                return plain, await kill_run(ctx.base, ctx, read)

    async def port_side():
        async with inprocess_fleet(tparams, tcfg, n_replicas=2, device="cpu",
                                   engine_kw=ENGINE_KW,
                                   router_kw=router_kw) as ctx:

            async def read(base, on_token=None):
                return await stream_events(f"{base}/v1/generate", body,
                                           on_token)

            plain = toks_lps(await read(ctx.base))
            return plain, await kill_run(ctx.base, ctx, read)

    try:
        want = run(jax_side(), timeout=120)
    finally:
        # the fleet's teardown shuts each engine down after its server's
        # cleanup, which a timeout or a cancelled cleanup skips: shut
        # every reference engine down here on every path (idempotent)
        for engine in engines:
            engine.shutdown()
    got = run(port_side())
    for (jt, jl), (tt, tl) in zip(want, got):
        assert tt == jt and len(tt) == 16
        assert max(abs(a - b) for a, b in zip(tl, jl)) <= 1e-4

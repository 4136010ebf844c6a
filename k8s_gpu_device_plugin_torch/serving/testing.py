"""In-process serving fleet: the port's replicas behind the port's router.

Port of ``k8s_gpu_device_plugin_tpu/serving/testing.py``: N port
``InferenceServer`` s on ephemeral ports (each on its own
``http.server`` thread, its engine on its own thread) behind a
``ReplicaRouter`` on the caller's event loop. The port's fleet tests and
``chip_smoke.py``'s ``fleet_*`` part drive their fleets through it;
clients talk to it through ``serving/async_http.py``.

Usage::

    async with inprocess_fleet(params, cfg, n_replicas=2, device="cpu",
                               engine_kw=dict(n_slots=2, max_len=64),
                               router_kw=dict(policy="rr")) as fleet:
        got = await stream_generate(fleet.base, prompt=[1, 2, 3],
                                    max_new=8)
        await fleet.kill_replica(0)    # the crash path
        fleet.router.router_stats()

``device`` (``"cuda"`` unless the caller asks for ``"cpu"``) is where
the replicas serve; ``params`` must live there. Per-replica state (a
prefix cache, a scheduler, a metrics registry — objects that must NOT
be shared between engines) comes from ``engine_factory(i)``.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import socket
import time

from k8s_gpu_device_plugin_torch.serving import async_http
from k8s_gpu_device_plugin_torch.serving.fleet import FleetRegistry
from k8s_gpu_device_plugin_torch.serving.router import ReplicaRouter


def per_replica_registry_factories(
    params, cfg, *, n_slots: int = 2, max_len: int = 64,
    chunked_prefill: int = 8, **batcher_kw,
):
    """``(engine_factory, server_factory)`` giving every replica its OWN
    registry (``metrics/exposition.py``) and the ServingMetrics bound to
    it, so N replicas in one process are scraped independently."""
    from k8s_gpu_device_plugin_torch.metrics.exposition import Registry
    from k8s_gpu_device_plugin_torch.metrics.serving_metrics import (
        ServingMetrics,
    )
    from k8s_gpu_device_plugin_torch.models.batching import (
        ContinuousBatcher,
    )
    from k8s_gpu_device_plugin_torch.serving.server import InferenceEngine

    def engine_factory(i: int):
        return InferenceEngine(ContinuousBatcher(
            params, cfg, n_slots=n_slots, max_len=max_len,
            chunked_prefill=chunked_prefill,
            metrics=ServingMetrics(Registry()), **batcher_kw))

    def server_factory(i: int, engine):
        from k8s_gpu_device_plugin_torch.serving.server import (
            InferenceServer,
        )

        metrics = engine.cb.metrics
        return InferenceServer(engine, host="127.0.0.1", port=0,
                               replica_id=f"r{i}",
                               registry=metrics._registry, metrics=metrics)

    return engine_factory, server_factory


async def post_json(url: str, body=None, *, timeout_s: float = 120.0,
                    headers: "dict | None" = None) -> tuple:
    """One POST of ``body`` as JSON (None = an empty body) -> (status,
    headers, the answer parsed as JSON, or None when it is not JSON)."""
    data = b"" if body is None else json.dumps(body).encode()
    status, rhdrs, raw = await async_http.fetch(
        "POST", url, data, {"Content-Type": "application/json",
                            **(headers or {})}, timeout_s=timeout_s)
    try:
        return status, rhdrs, json.loads(raw)
    except ValueError:
        return status, rhdrs, None


async def get_json(url: str, *, timeout_s: float = 30.0) -> tuple:
    """One GET -> (status, the answer parsed as JSON)."""
    status, _, raw = await async_http.fetch("GET", url, timeout_s=timeout_s)
    return status, json.loads(raw)


async def stream_events(url: str, body: dict, on_token=None) -> list:
    """The SSE payloads of one streamed POST to ``url``, read until the
    done or error frame; ``on_token(count)`` is awaited after each token
    frame (a test's mid-stream hook)."""
    resp = await async_http.request(
        "POST", url, json.dumps(body).encode(),
        {"Content-Type": "application/json"})
    events, n = [], 0
    try:
        async for raw in resp.iter_lines():
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            evt = payload if payload == "[DONE]" else json.loads(payload)
            events.append(evt)
            if isinstance(evt, dict) and "token" in evt:
                n += 1
                if on_token is not None:
                    await on_token(n)
            if isinstance(evt, dict) and ("done" in evt or "error" in evt):
                break
    finally:
        resp.release()
    return events


async def stream_generate(base: str, *, prompt, max_new: int,
                          logprobs: bool = True, seed=None,
                          **fields) -> dict:
    """One streamed ``/v1/generate`` through ``base`` (a router or a
    replica), drained frame by frame; returns ``{"tokens", "logprobs",
    "done", "error", "wall_s", "ttft_s"}`` with the client-observed wall
    time and time to the first token frame (``error`` is the structured
    error frame's payload, or None). ``fields`` join the body."""
    t0 = time.perf_counter()
    toks: list[int] = []
    logps: list[float] = []
    done = False
    error = None
    ttft = None
    body = {"prompt": prompt, "max_new": max_new, "stream": True,
            "logprobs": logprobs, **fields}
    if seed is not None:
        body["seed"] = seed
    resp = await async_http.request(
        "POST", f"{base}/v1/generate", json.dumps(body).encode(),
        {"Content-Type": "application/json"})
    try:
        if resp.status != 200:
            raise AssertionError(f"HTTP {resp.status}: "
                                 f"{(await resp.read())[:300]!r}")
        async for raw in resp.iter_lines():
            text = raw.decode().strip()
            if not text.startswith("data: "):
                continue
            evt = json.loads(text[len("data: "):])
            if "token" in evt:
                if ttft is None:
                    ttft = time.perf_counter() - t0
                toks.append(int(evt["token"]))
                if "logprob" in evt:
                    logps.append(float(evt["logprob"]))
            if evt.get("done"):
                done = True
            if evt.get("error"):
                error = evt["error"]
    finally:
        resp.release()
    return {"tokens": toks, "logprobs": logps, "done": done,
            "error": error, "wall_s": time.perf_counter() - t0,
            "ttft_s": ttft}


def _track_sockets(server) -> list:
    """Record every connection ``server`` accepts (its ``get_request``),
    so a kill can cut them."""
    socks: list = []
    accept = server.get_request

    def get_request():
        sock, addr = accept()
        socks.append(sock)
        return sock, addr

    server.get_request = get_request
    return socks


class InprocessFleet:
    """Handles for one fleet: port servers (bound, each to be served on
    its own thread) and the routers over them. :func:`inprocess_fleet`
    builds one for tests; a caller holding servers already built (the
    card smoke's, from ``build_server``) makes its own and drives it the
    same way: :meth:`start`, :meth:`add_router` on its event loop,
    :meth:`kill`, :meth:`close_routers` and :meth:`stop`."""

    def __init__(self, servers: list):
        self.servers: list = list(servers)
        self.killed: set[int] = set()
        self._socks = [_track_sockets(s) for s in self.servers]
        self._routers: list[tuple] = []  # (router, stop event, task)
        self.fleet: FleetRegistry | None = None  # the first router's
        self.router: ReplicaRouter | None = None
        self.base: str = ""          # the first router's http://host:port

    def start(self) -> None:
        """Serve every replica (each on its ``http.server`` thread)."""
        for server in self.servers:
            server.start()

    def replica_base(self, i: int) -> str:
        """Direct (router-bypassing) address of replica ``i``."""
        return f"http://127.0.0.1:{self.servers[i].bound_port}"

    async def add_router(self, **router_kw) -> ReplicaRouter:
        """A router over every replica (ids ``r0``, ``r1``, ...) on the
        running event loop, serving on an ephemeral port; the first one
        becomes ``router`` / ``fleet`` / ``base``."""
        registry = FleetRegistry.from_spec(",".join(
            f"r{i}={self.replica_base(i)}" for i in range(len(self.servers))
        ))
        router = ReplicaRouter(registry, host="127.0.0.1", port=0,
                               **router_kw)
        stop = asyncio.Event()
        task = asyncio.create_task(router.run(stop))
        self._routers.append((router, stop, task))
        while router.bound_port is None:
            if task.done():
                exc = task.exception()
                raise exc if exc is not None else RuntimeError(
                    "router task exited before binding a port")
            await asyncio.sleep(0.01)
        if self.router is None:
            self.router, self.fleet = router, registry
            self.base = f"http://127.0.0.1:{router.bound_port}"
        return router

    async def close_routers(self) -> None:
        for router, stop, task in self._routers:
            if not task.done():
                stop.set()
                await asyncio.wait_for(task, 30)
        self._routers.clear()

    def kill(self, i: int) -> None:
        """Stop replica ``i`` abruptly (the crash path — no drain): every
        open connection is cut at once, so a mid-stream relay sees its
        body end without a done frame, the way it would when the process
        vanishes; then the engine stops and the listener closes (its
        accept loop notices within half a second). Blocking."""
        self.killed.add(i)
        server = self.servers[i]
        for sock in self._socks[i]:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # closed already
        server.engine.shutdown()
        server.shutdown()
        server.server_close()

    async def kill_replica(self, i: int) -> None:
        """:meth:`kill` off the event loop."""
        await asyncio.get_running_loop().run_in_executor(None, self.kill, i)

    def stop(self) -> None:
        """Stop every replica still serving (and release a killed one's
        metric families and span listener). Blocking."""
        for i, server in enumerate(self.servers):
            if i not in self.killed:
                server.stop()
                continue
            if server.metrics is not None:
                server.metrics.close()
            if server.span_metrics is not None:
                server.span_metrics.close()


@contextlib.asynccontextmanager
async def inprocess_fleet(
    params,
    cfg,
    n_replicas: int = 2,
    engine_kw: dict | None = None,   # ContinuousBatcher kwargs
    engine_factory=None,   # (i) -> InferenceEngine; overrides engine_kw
    router_kw: dict | None = None,
    server_kw: dict | None = None,   # extra InferenceServer kwargs
    server_factory=None,   # (i, engine) -> InferenceServer; overrides
    # server_kw. Keep host="127.0.0.1", port=0, replica_id=f"r{i}" (the
    # registry below keys on those)
    device: str = "cuda",
):
    from k8s_gpu_device_plugin_torch.device import resolve_device
    from k8s_gpu_device_plugin_torch.models.batching import (
        ContinuousBatcher,
    )
    from k8s_gpu_device_plugin_torch.serving.server import (
        InferenceEngine,
        InferenceServer,
    )

    dev = resolve_device(device)
    where = {t.device.type for t in _tensors(params)}
    if where != {dev.type}:
        raise ValueError(f"the fleet serves on {dev.type}; the params "
                         f"live on {sorted(where)}")
    servers = []
    ctx = None
    loop = asyncio.get_running_loop()
    try:
        for i in range(n_replicas):
            if engine_factory is not None:
                engine = engine_factory(i)
            else:
                engine = InferenceEngine(ContinuousBatcher(
                    params, cfg, **(engine_kw or {})))
            if server_factory is not None:
                servers.append(server_factory(i, engine))
            else:
                servers.append(InferenceServer(
                    engine, host="127.0.0.1", port=0, replica_id=f"r{i}",
                    **(server_kw or {})))
        ctx = InprocessFleet(servers)
        ctx.start()
        await ctx.add_router(**(router_kw or {}))
        yield ctx
    finally:
        if ctx is not None:
            await ctx.close_routers()
            await loop.run_in_executor(None, ctx.stop)
        else:
            for server in servers:
                await loop.run_in_executor(None, server.engine.shutdown)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "device"):
        yield tree

"""``serving/async_http.py``: the port router's HTTP/1.1 layer on asyncio.

Pinned against raw sockets and against aiohttp (an independent HTTP
implementation, here only as a peer): response bodies framed by
``Content-Length``, by chunked coding and to EOF (the port replicas'
HTTP/1.0 SSE), cut bodies told apart by framing; a header timeout
against a wedged socket; a client that vanishes mid-SSE raises
``ClientGone`` on the server's write, and through the router closes the
upstream connection; request bodies pass byte for byte, through the
server and through the router; the route table's ``{name}`` segments,
404 and 405; the header cap (431).
"""

import asyncio
import json

import aiohttp
import pytest
from aiohttp import web

from k8s_gpu_device_plugin_torch.serving import async_http
from k8s_gpu_device_plugin_torch.serving.fleet import FleetRegistry
from k8s_gpu_device_plugin_torch.serving.router import ReplicaRouter

BUCKETS = (8, 16, 32)


def run(coro, timeout: float = 30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


async def raw_server(reply: bytes, close: bool = True):
    """A server that reads one request head and answers ``reply`` as
    given (then closes, or holds the connection open)."""
    writers = []

    async def handle(reader, writer):
        writers.append(writer)
        await reader.readuntil(b"\r\n\r\n")
        writer.write(reply)
        await writer.drain()
        if close:
            writer.close()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    return server, server.sockets[0].getsockname()[1], writers


async def shut(server, writers):
    server.close()
    for w in writers:
        w.close()
    await asyncio.wait_for(server.wait_closed(), 10)


BODY = b'data: {"token": 1}\n\n' * 50 + b'data: {"done": true}\n\n'


def chunked(data: bytes, size: int = 37) -> bytes:
    out = b""
    for i in range(0, len(data), size):
        piece = data[i:i + size]
        out += b"%x\r\n%s\r\n" % (len(piece), piece)
    return out + b"0\r\n\r\n"


@pytest.mark.parametrize("framing", ["length", "chunked", "eof"])
def test_response_bodies_by_each_framing(framing):
    head = b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
    reply = {"length": head + b"Content-Length: %d\r\n\r\n" % len(BODY)
             + BODY,
             "chunked": head + b"Transfer-Encoding: chunked\r\n\r\n"
             + chunked(BODY),
             "eof": b"HTTP/1.0 200 OK\r\nContent-Type: text/event-stream"
             b"\r\n\r\n" + BODY}[framing]

    async def body():
        server, port, writers = await raw_server(reply)
        try:
            url = f"http://127.0.0.1:{port}/x"
            resp = await async_http.request("GET", url)
            assert resp.status == 200
            assert resp.headers["content-type"] == "text/event-stream"
            lines = [line async for line in resp.iter_lines()]
            assert b"".join(lines) == BODY
            assert lines[-2:] == [b'data: {"done": true}\n', b"\n"]
            resp.release()
            status, _, data = await async_http.fetch("GET", url,
                                                     timeout_s=5)
            assert status == 200 and data == BODY
        finally:
            await shut(server, writers)

    run(body())


@pytest.mark.parametrize("framing", ["length", "chunked", "eof"])
def test_cut_bodies_are_told_apart_by_framing(framing):
    """A ``Content-Length`` or chunked body cut short raises HttpError
    (an OSError); a close-delimited one simply ends (its caller reads
    the last frame to tell a crash from a clean end)."""
    cut = BODY[:100]
    head = b"HTTP/1.1 200 OK\r\n"
    reply = {"length": head + b"Content-Length: %d\r\n\r\n" % len(BODY)
             + cut,
             "chunked": head + b"Transfer-Encoding: chunked\r\n\r\n"
             + chunked(BODY)[:120],
             "eof": head + b"\r\n" + cut}[framing]

    async def body():
        server, port, writers = await raw_server(reply)
        try:
            resp = await async_http.request("GET",
                                            f"http://127.0.0.1:{port}/")
            got = b""
            if framing == "eof":
                async for data in resp.iter_any():
                    got += data
                assert got == cut
            else:
                with pytest.raises(async_http.HttpError):
                    async for data in resp.iter_any():
                        got += data
                assert issubclass(async_http.HttpError, OSError)
            resp.close()
        finally:
            await shut(server, writers)

    run(body())


def test_header_timeout_against_a_wedged_socket():
    async def body():
        writers = []

        async def wedge(reader, writer):
            writers.append(writer)
            await asyncio.sleep(3600)

        server = await asyncio.start_server(wedge, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        loop = asyncio.get_running_loop()
        try:
            t0 = loop.time()
            with pytest.raises(asyncio.TimeoutError):
                await async_http.request(
                    "POST", f"http://127.0.0.1:{port}/v1/generate", b"{}",
                    header_timeout_s=0.3)
            assert 0.25 < loop.time() - t0 < 3.0
            with pytest.raises(asyncio.TimeoutError):
                await async_http.fetch("GET", f"http://127.0.0.1:{port}/",
                                       timeout_s=0.2)
        finally:
            server.close()
            for w in writers:
                w.close()
            await asyncio.wait_for(server.wait_closed(), 10)
        # nobody listening: a connection error, an OSError
        with pytest.raises(OSError):
            await async_http.request("GET", f"http://127.0.0.1:{port}/",
                                     connect_timeout_s=2.0)

    run(body())


def test_server_routes_params_methods_and_header_cap():
    async def body():
        seen = {}

        async def one(request):
            seen["info"] = dict(request.match_info)
            seen["query"] = request.query
            seen["template"] = request.route_template
            return async_http.json_response({"ok": True}, status=201,
                                            headers={"X-A": "b"})

        app = async_http.HttpServer(max_header_bytes=4096)
        app.add_get("/fleet/drain/{replica}", one)
        port = await app.start("127.0.0.1", 0)
        base = f"http://127.0.0.1:{port}"
        try:
            status, headers, data = await async_http.fetch(
                "GET", f"{base}/fleet/drain/r%201?limit=3&since=",
                timeout_s=5)
            assert status == 201 and json.loads(data) == {"ok": True}
            assert headers["x-a"] == "b"
            assert seen == {"info": {"replica": "r 1"},
                            "query": {"limit": "3", "since": ""},
                            "template": "/fleet/drain/{replica}"}
            status, _, data = await async_http.fetch(
                "GET", f"{base}/fleet/drain", timeout_s=5)
            assert status == 404 and "no route" in json.loads(data)["error"]
            status, _, _ = await async_http.fetch(
                "POST", f"{base}/fleet/drain/r0", timeout_s=5)
            assert status == 405
            status, _, _ = await async_http.fetch(
                "GET", f"{base}/fleet/drain/r0",
                headers={"X-Big": "y" * 8000}, timeout_s=5)
            assert status == 431
        finally:
            await app.close()

    run(body())


def test_interop_with_an_independent_peer():
    """aiohttp's client reads the server's chunked SSE and JSON; the
    client reads aiohttp's server's chunked stream and JSON."""

    async def body():
        async def sse(request):
            out = async_http.StreamResponse(
                headers={"Content-Type": "text/event-stream"})
            await out.prepare(request)
            for i in range(5):
                await out.write(f"data: {i}\n\n".encode())
            return out

        async def echo(request):
            return async_http.json_response({"n": len(request.body)})

        app = async_http.HttpServer()
        app.add_get("/sse", sse)
        app.add_post("/echo", echo)
        port = await app.start("127.0.0.1", 0)

        async def aio_sse(request):
            resp = web.StreamResponse(
                headers={"Content-Type": "text/event-stream"})
            await resp.prepare(request)
            for i in range(5):
                await resp.write(f"data: {i}\n\n".encode())
            return resp

        aio = web.Application()
        aio.router.add_get("/sse", aio_sse)
        runner = web.AppRunner(aio)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        aio_port = runner.addresses[0][1]
        want = b"".join(f"data: {i}\n\n".encode() for i in range(5))
        try:
            async with aiohttp.ClientSession() as s:
                async with s.get(f"http://127.0.0.1:{port}/sse") as r:
                    assert r.headers["Transfer-Encoding"] == "chunked"
                    assert await r.read() == want
                async with s.post(f"http://127.0.0.1:{port}/echo",
                                  data=b"x" * 70000) as r:
                    assert (await r.json()) == {"n": 70000}
            resp = await async_http.request(
                "GET", f"http://127.0.0.1:{aio_port}/sse")
            assert b"".join([d async for d in resp.iter_any()]) == want
            resp.release()
        finally:
            await app.close()
            await runner.cleanup()

    run(body())


def test_client_gone_mid_sse_raises_and_the_router_closes_upstream():
    """The client leaves a relayed stream: the router's write to it
    raises ClientGone, and the router cuts its backend connection, which
    the backend sees as ITS client gone."""

    async def body():
        backend_gone = asyncio.Event()
        frames_sent = []

        async def slow_sse(request):
            out = async_http.StreamResponse(
                headers={"Content-Type": "text/event-stream"})
            await out.prepare(request)
            try:
                for i in range(400):
                    await out.write(b'data: {"token": %d}\n\n' % i)
                    frames_sent.append(i)
                    await asyncio.sleep(0.01)
            except async_http.ClientGone:
                backend_gone.set()
                raise
            return out

        stub = async_http.HttpServer()
        stub.add_post("/v1/generate", slow_sse)
        port = await stub.start("127.0.0.1", 0)
        router = ReplicaRouter(
            FleetRegistry.from_spec(f"a=http://127.0.0.1:{port}"),
            host="127.0.0.1", port=0, health_interval_s=60.0,
            prompt_buckets=BUCKETS)
        stop = asyncio.Event()
        task = asyncio.create_task(router.run(stop))
        while router.bound_port is None:
            await asyncio.sleep(0.01)
        try:
            resp = await async_http.request(
                "POST", f"http://127.0.0.1:{router.bound_port}/v1/generate",
                json.dumps({"prompt": [1, 2], "max_new": 400,
                            "stream": True}).encode())
            n = 0
            async for line in resp.iter_lines():
                if line.startswith(b"data: "):
                    n += 1
                    if n == 3:
                        break
            resp.close()
            await asyncio.wait_for(backend_gone.wait(), 10)
            assert len(frames_sent) < 400
            for _ in range(100):
                if router.fleet.get("a").inflight == 0:
                    break
                await asyncio.sleep(0.02)
            assert router.fleet.get("a").inflight == 0
            assert router.router_stats()["resumes"] == 0
        finally:
            stop.set()
            await asyncio.wait_for(task, 30)
            await stub.close()

    run(body())


def test_request_bodies_are_byte_transparent():
    """Whatever bytes a client posts reach the backend unchanged through
    the router: not JSON, odd whitespace, UTF-8, a NUL."""

    async def body():
        got = []

        async def record(request):
            got.append(request.body)
            return async_http.json_response({"id": 0, "tokens": []})

        stub = async_http.HttpServer()
        stub.add_post("/v1/generate", record)
        stub.add_post("/v1/embeddings", record)
        port = await stub.start("127.0.0.1", 0)
        router = ReplicaRouter(
            FleetRegistry.from_spec(f"a=http://127.0.0.1:{port}"),
            host="127.0.0.1", port=0, health_interval_s=60.0,
            prompt_buckets=BUCKETS)
        stop = asyncio.Event()
        task = asyncio.create_task(router.run(stop))
        while router.bound_port is None:
            await asyncio.sleep(0.01)
        sent = [b'{"prompt": [1, 2],   "max_new": 3 }',
                b"not json at all \x00 \xff",
                '{"input": "héllo ☃"}'.encode(),
                b""]
        try:
            for data, path in zip(sent, ("/v1/generate", "/v1/generate",
                                         "/v1/embeddings", "/v1/generate")):
                status, _, _ = await async_http.fetch(
                    "POST", f"http://127.0.0.1:{router.bound_port}{path}",
                    data, {"Content-Type": "application/json"}, timeout_s=5)
                assert status == 200
            assert got == sent
        finally:
            stop.set()
            await asyncio.wait_for(task, 30)
            await stub.close()

    run(body())

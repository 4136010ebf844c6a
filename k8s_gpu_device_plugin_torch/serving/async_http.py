"""A small HTTP/1.1 layer on ``asyncio``: the replica router's wire.

The reference's router (``k8s_gpu_device_plugin_tpu/serving/router.py``)
serves and proxies on aiohttp, which the card's machine does not have.
This module is what the port's router (``serving/router.py``) uses in
its place, and no more:

- **Server** (:class:`HttpServer`): ``asyncio.start_server``, one request
  a connection (every answer says ``Connection: close``). The request
  line, headers (capped at ``max_header_bytes``: 431 past it) and a
  ``Content-Length`` or chunked body are read whole before the handler
  runs. Routes are a table of (method, template) whose ``{name}``
  segments match one path segment each (``request.match_info``). One
  middleware hook wraps every handler (the router's traceparent span).
  A handler answers a :class:`Response` (a body with
  ``Content-Length``: :func:`json_response` builds the JSON one) or a
  :class:`StreamResponse` it writes frame by frame (SSE, chunked
  transfer coding, so a client tells a finished stream from a cut one).
  A write to a client that has gone raises :class:`ClientGone`.
- **Client** (:func:`request`, :func:`fetch`): ``asyncio.open_connection``,
  the body sent as the raw bytes given (byte-transparent), the connect
  bounded by ``connect_timeout_s`` and the whole header phase (connect,
  send, status line and headers) by ``header_timeout_s`` (0 =
  unbounded). The body is read by ``Content-Length``, by chunked coding
  or to EOF (the port's replicas answer HTTP/1.0 on ``http.server``: an
  SSE body there ends when the connection closes, so a crash and a clean
  end both read as EOF and the caller tells them apart by the last
  frame). :meth:`ClientResponse.iter_any` yields the body as it arrives,
  :meth:`ClientResponse.iter_lines` by line (SSE);
  :meth:`ClientResponse.close` aborts the connection (how an upstream
  request is cancelled: the replica sees the reset and frees the slot).

Every failure to reach a peer or to read a well-formed answer from it is
an ``OSError`` (connection errors, :class:`HttpError`,
``TimeoutError``), so one ``except OSError`` covers the wire. Nothing
here blocks the event loop: no threads, no blocking socket calls.
"""

from __future__ import annotations

import asyncio
import http
import json
from urllib.parse import parse_qsl, unquote, urlsplit

from k8s_gpu_device_plugin_torch.utils.log import get_logger

log = get_logger()

#: request/response head cap (request line or status line + headers)
MAX_HEADER_BYTES = 64 * 1024
#: the client's stream buffer: large bodies (a KV-page export) arrive in
#: pieces of this size at most between event-loop turns
_CLIENT_LIMIT = 1 << 20
_READ = 1 << 16


class ClientGone(Exception):
    """The client side of a streamed answer went away mid-write. Not an
    ``OSError``: a relay that reads a backend and writes a client must be
    able to tell the client's departure from the backend's failure."""


class HttpError(OSError):
    """A peer's HTTP message is malformed or was cut short."""


class Headers:
    """Case-insensitive header map (the last value of a repeated name
    wins)."""

    __slots__ = ("_d",)

    def __init__(self, items=()):
        self._d: dict[str, tuple[str, str]] = {}
        for k, v in (items.items() if isinstance(items, dict) else items):
            self._d[k.lower()] = (k, v)

    def get(self, name: str, default=None):
        hit = self._d.get(name.lower())
        return default if hit is None else hit[1]

    def __getitem__(self, name: str) -> str:
        return self._d[name.lower()][1]

    def __setitem__(self, name: str, value: str) -> None:
        self._d[name.lower()] = (name, value)

    def __contains__(self, name: str) -> bool:
        return name.lower() in self._d

    def items(self):
        return list(self._d.values())


def _parse_head(raw: bytes) -> tuple[str, Headers]:
    """``first line\\r\\nName: value\\r\\n...\\r\\n\\r\\n`` -> (first line,
    headers). HttpError on a header line without a colon."""
    lines = raw.decode("latin-1").split("\r\n")
    items = []
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep or not name.strip():
            raise HttpError(f"malformed header line {line[:80]!r}")
        items.append((name.strip(), value.strip()))
    return lines[0], Headers(items)


async def _read_head(reader: asyncio.StreamReader) -> "bytes | None":
    """The head up to its blank line; None on EOF before any byte.
    HttpError past the stream's limit or on EOF mid-head."""
    try:
        return await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise HttpError("connection closed mid-head") from None
    except asyncio.LimitOverrunError:
        raise HttpError("head too large") from None


async def _chunks(reader: asyncio.StreamReader):
    """The data of a chunked body, piece by piece. HttpError when the
    body is cut before its last chunk."""
    try:
        while True:
            line = await reader.readuntil(b"\r\n")
            try:
                size = int(line.split(b";", 1)[0].strip(), 16)
            except ValueError:
                raise HttpError(f"bad chunk size {line[:40]!r}") from None
            if size == 0:
                while await reader.readuntil(b"\r\n") != b"\r\n":
                    pass  # trailers
                return
            while size:
                data = await reader.read(min(size, _READ))
                if not data:
                    raise HttpError("connection closed mid-chunk")
                size -= len(data)
                yield data
            if await reader.readexactly(2) != b"\r\n":
                raise HttpError("chunk without its CRLF")
    except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
        raise HttpError("chunked body cut short") from None


# --- server ---------------------------------------------------------------


class Request:
    """One request, its body read whole."""

    def __init__(self, method: str, target: str, headers: Headers,
                 body: bytes, writer: asyncio.StreamWriter,
                 reader: asyncio.StreamReader):
        self.method = method
        path, _, query = target.partition("?")
        self.path = unquote(path)
        self.query = dict(parse_qsl(query, keep_blank_values=True))
        self.headers = headers
        self.body = body
        #: the matched route's template (``obs/http.route_label`` names
        #: spans by it) and its ``{name}`` segments
        self.route_template: "str | None" = None
        self.match_info: dict[str, str] = {}
        self._writer = writer
        self._reader = reader

    def json(self):
        """The body as JSON (ValueError on garbage)."""
        return json.loads(self.body)


def _status_line(status: int) -> bytes:
    try:
        reason = http.HTTPStatus(status).phrase
    except ValueError:
        reason = ""
    return f"HTTP/1.1 {status} {reason}\r\n".encode()


def _head(status: int, headers: Headers) -> bytes:
    lines = [_status_line(status)]
    for k, v in headers.items():
        lines.append(f"{k}: {v}\r\n".encode("latin-1"))
    lines.append(b"Connection: close\r\n\r\n")
    return b"".join(lines)


class Response:
    """A whole answer, sent with ``Content-Length``."""

    prepared = False

    def __init__(self, body: bytes = b"", status: int = 200,
                 content_type: str = "application/json",
                 headers: "dict | None" = None):
        self.body = body
        self.status = status
        self.headers = Headers(headers or {})
        if "Content-Type" not in self.headers:
            self.headers["Content-Type"] = content_type

    def encode(self) -> bytes:
        self.headers["Content-Length"] = str(len(self.body))
        return _head(self.status, self.headers) + self.body


def json_response(payload, status: int = 200,
                  headers: "dict | None" = None) -> Response:
    return Response(json.dumps(payload).encode(), status=status,
                    headers=headers)


class StreamResponse:
    """An answer written as it is made, in chunked transfer coding:
    :meth:`prepare` sends the head, :meth:`write` one piece (flushed),
    :meth:`write_eof` the last chunk. A client that has gone surfaces as
    :class:`ClientGone` from :meth:`write`."""

    def __init__(self, status: int = 200, headers: "dict | None" = None):
        self.status = status
        self.headers = Headers(headers or {})
        self.prepared = False
        self.finished = False
        self._writer: "asyncio.StreamWriter | None" = None
        self._reader: "asyncio.StreamReader | None" = None

    async def prepare(self, request: Request) -> None:
        self._writer, self._reader = request._writer, request._reader
        self.headers["Transfer-Encoding"] = "chunked"
        self.prepared = True
        await self._send(_head(self.status, self.headers))

    async def _send(self, data: bytes) -> None:
        w = self._writer
        # a client closes its end when it leaves: EOF on the request
        # side (the body was read whole) says so before a write would
        if w.is_closing() or self._reader.at_eof():
            raise ClientGone("client connection closed")
        try:
            w.write(data)
            await w.drain()
        except (ConnectionError, OSError, RuntimeError) as e:
            raise ClientGone(str(e)) from None

    async def write(self, data: bytes) -> None:
        if data:
            await self._send(b"%x\r\n%s\r\n" % (len(data), data))

    async def write_eof(self) -> None:
        if not self.finished:
            self.finished = True
            await self._send(b"0\r\n\r\n")


def _match(template: list[str], segs: list[str]) -> "dict | None":
    if len(template) != len(segs):
        return None
    info = {}
    for t, s in zip(template, segs):
        if t.startswith("{") and t.endswith("}"):
            if not s:
                return None
            info[t[1:-1]] = s
        elif t != s:
            return None
    return info


class HttpServer:
    """Routes over ``asyncio.start_server``. ``middleware(request,
    handler)`` wraps every matched handler."""

    def __init__(self, middleware=None,
                 max_header_bytes: int = MAX_HEADER_BYTES):
        self.middleware = middleware
        self.max_header_bytes = int(max_header_bytes)
        self._routes: list[tuple[str, str, list[str], object]] = []
        self._server: "asyncio.Server | None" = None
        self._conns: dict[asyncio.Task, asyncio.StreamWriter] = {}
        self.bound_port: "int | None" = None

    def add_route(self, method: str, template: str, handler) -> None:
        self._routes.append((method, template, template.split("/"),
                             handler))

    def add_get(self, template: str, handler) -> None:
        self.add_route("GET", template, handler)

    def add_post(self, template: str, handler) -> None:
        self.add_route("POST", template, handler)

    async def start(self, host: str, port: int) -> int:
        self._server = await asyncio.start_server(
            self._serve_conn, host, port, limit=self.max_header_bytes)
        self.bound_port = self._server.sockets[0].getsockname()[1]
        return self.bound_port

    async def close(self) -> None:
        """Stop listening, cut every open connection, and wait for their
        handlers to unwind."""
        if self._server is None:
            return
        self._server.close()
        tasks = list(self._conns)
        for task, writer in list(self._conns.items()):
            writer.transport.abort()
            task.cancel()
        for task in tasks:
            try:
                await task
            except BaseException:  # noqa: BLE001 - unwinding on purpose
                pass
        # every connection is closed above: on Python >= 3.12.1 this
        # waits for them, which is why they are cut first
        await self._server.wait_closed()
        self._server = None

    def _resolve(self, request: Request):
        segs = request.path.split("/")
        allowed = False
        for method, template, tsegs, handler in self._routes:
            info = _match(tsegs, segs)
            if info is None:
                continue
            if method != request.method:
                allowed = True
                continue
            request.route_template = template
            request.match_info = info
            return handler
        return 405 if allowed else 404

    async def _read_request(self, reader, writer) -> "Request | None":
        raw = await _read_head(reader)
        if raw is None:
            return None
        line, headers = _parse_head(raw)
        parts = line.split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/"):
            raise HttpError(f"malformed request line {line[:80]!r}")
        method, target, _ = parts
        if headers.get("Expect", "").lower() == "100-continue":
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await writer.drain()
        if "chunked" in headers.get("Transfer-Encoding", "").lower():
            body = b"".join([piece async for piece in _chunks(reader)])
        else:
            try:
                n = int(headers.get("Content-Length", "0") or 0)
            except ValueError:
                raise HttpError("bad Content-Length") from None
            try:
                body = await reader.readexactly(n) if n > 0 else b""
            except asyncio.IncompleteReadError:
                raise HttpError("connection closed mid-body") from None
        return Request(method, target, headers, body, writer, reader)

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns[task] = writer
        try:
            try:
                request = await self._read_request(reader, writer)
            except HttpError as e:
                status = 431 if "too large" in str(e) else 400
                writer.write(json_response({"error": str(e)},
                                           status=status).encode())
                await writer.drain()
                return
            if request is None:
                return
            resp = await self._answer(request)
            if isinstance(resp, StreamResponse):
                if not resp.prepared:
                    await resp.prepare(request)
                await resp.write_eof()
            else:
                writer.write(resp.encode())
                await writer.drain()
        except (ClientGone, ConnectionError, OSError):
            pass  # the client went away: nobody to answer
        finally:
            del self._conns[task]
            writer.close()

    async def _answer(self, request: Request):
        handler = self._resolve(request)
        if handler == 404:
            return json_response({"error": f"no route {request.path}"},
                                 status=404)
        if handler == 405:
            return json_response(
                {"error": f"{request.method} not allowed on "
                          f"{request.path}"}, status=405)
        try:
            if self.middleware is not None:
                return await self.middleware(request, handler)
            return await handler(request)
        except (ClientGone, asyncio.CancelledError):
            raise
        except Exception as e:  # noqa: BLE001 - one request's fault
            log.exception("handler failed: %s %s", request.method,
                          request.path)
            return json_response({"error": f"internal error: {e}"},
                                 status=500)


# --- client ---------------------------------------------------------------


class ClientResponse:
    """A response whose head has arrived; the body is read on demand and
    exactly once (``read``, ``iter_any`` or ``iter_lines``)."""

    def __init__(self, status: int, headers: Headers,
                 reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, framing: str,
                 length: int):
        self.status = status
        self.headers = headers
        self._reader = reader
        self._writer = writer
        self._framing = framing  # "length" | "chunked" | "eof"
        self._length = length

    async def iter_any(self):
        """The body's bytes as they arrive. HttpError when a
        ``Content-Length`` or chunked body is cut short; a body read to
        EOF simply ends."""
        r = self._reader
        if self._framing == "chunked":
            async for piece in _chunks(r):
                yield piece
            return
        if self._framing == "length":
            left = self._length
            while left:
                data = await r.read(min(left, _READ))
                if not data:
                    raise HttpError(f"body cut short: {left} bytes missing")
                left -= len(data)
                yield data
            return
        while True:
            data = await r.read(_READ)
            if not data:
                return
            yield data

    async def iter_lines(self):
        """The body line by line, each with its ``b"\\n"`` (a cut last
        line without it)."""
        buf = b""
        async for data in self.iter_any():
            buf += data
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                yield line + b"\n"
        if buf:
            yield buf

    async def read(self) -> bytes:
        if self._framing == "length":
            try:
                return await self._reader.readexactly(self._length)
            except asyncio.IncompleteReadError:
                raise HttpError("body cut short") from None
        return b"".join([d async for d in self.iter_any()])

    async def text(self) -> str:
        return (await self.read()).decode()

    async def json(self):
        return json.loads(await self.read())

    def close(self) -> None:
        """Abort the connection (the peer sees a reset)."""
        self._writer.transport.abort()

    def release(self) -> None:
        """Close the connection politely (one request a connection:
        nothing is pooled)."""
        self._writer.close()


async def _request(method: str, url: str, body: bytes, headers,
                   connect_timeout_s: "float | None") -> ClientResponse:
    parts = urlsplit(url)
    if parts.scheme != "http" or not parts.hostname:
        raise HttpError(f"only http://host[:port] URLs are served: {url!r}")
    host, port = parts.hostname, parts.port or 80
    conn = asyncio.open_connection(host, port, limit=_CLIENT_LIMIT)
    if connect_timeout_s:
        reader, writer = await asyncio.wait_for(conn, connect_timeout_s)
    else:
        reader, writer = await conn
    try:
        target = parts.path or "/"
        if parts.query:
            target += "?" + parts.query
        hdrs = Headers(headers or {})
        hdrs["Host"] = f"{host}:{port}"
        if body or method not in ("GET", "HEAD"):
            hdrs["Content-Length"] = str(len(body))
        hdrs["Connection"] = "close"
        head = [f"{method} {target} HTTP/1.1\r\n".encode()]
        head += [f"{k}: {v}\r\n".encode("latin-1") for k, v in hdrs.items()]
        writer.write(b"".join(head) + b"\r\n" + body)
        await writer.drain()
        while True:
            raw = await _read_head(reader)
            if raw is None:
                raise HttpError("connection closed before the response")
            line, rhdrs = _parse_head(raw)
            parts_ = line.split(" ", 2)
            try:
                status = int(parts_[1])
            except (IndexError, ValueError):
                raise HttpError(f"malformed status line {line[:80]!r}") \
                    from None
            if status != 100:
                break
        if method == "HEAD" or status in (204, 304):
            framing, length = "length", 0
        elif "chunked" in rhdrs.get("Transfer-Encoding", "").lower():
            framing, length = "chunked", 0
        elif rhdrs.get("Content-Length") is not None:
            try:
                framing, length = "length", int(rhdrs["Content-Length"])
            except ValueError:
                raise HttpError("bad Content-Length") from None
        else:
            framing, length = "eof", 0
        return ClientResponse(status, rhdrs, reader, writer, framing, length)
    except BaseException:
        writer.transport.abort()
        raise


async def request(method: str, url: str, body: bytes = b"",
                  headers: "dict | None" = None, *,
                  header_timeout_s: float = 0.0,
                  connect_timeout_s: "float | None" = None,
                  ) -> ClientResponse:
    """Send one request and return once the response head arrived.
    ``header_timeout_s`` (> 0) bounds connect + send + head: a peer that
    accepts and never answers raises ``TimeoutError``."""
    coro = _request(method, url, body, headers, connect_timeout_s)
    if header_timeout_s > 0:
        return await asyncio.wait_for(coro, header_timeout_s)
    return await coro


async def fetch(method: str, url: str, body: bytes = b"",
                headers: "dict | None" = None, *,
                timeout_s: float) -> tuple[int, Headers, bytes]:
    """One whole exchange, bounded by ``timeout_s`` end to end ->
    (status, headers, body)."""

    async def whole():
        resp = await _request(method, url, body, headers, timeout_s)
        try:
            data = await resp.read()
        except BaseException:
            resp.close()
            raise
        resp.release()
        return resp.status, resp.headers, data

    return await asyncio.wait_for(whole(), timeout_s)

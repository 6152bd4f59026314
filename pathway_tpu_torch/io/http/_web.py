"""A minimal HTTP/1.1 server on the standard library's asyncio — the part of
``aiohttp.web`` that the REST connector uses (``Application``, its runner
and site, ``Request`` and ``json_response``), so that the port serves REST
where aiohttp is not installed.

What it speaks: a request line and headers, a body sent with
``Content-Length`` or ``Transfer-Encoding: chunked``, keep-alive (HTTP/1.1
by default, HTTP/1.0 on request), routing by path and method with
aiohttp's replies for an unknown path (404) and a known path with another
method (405 and ``Allow``), and HEAD on GET routes added with ``add_get``.
A catch-all route (``add_route("*", CATCH_ALL, handler)``, the reference's
``add_route("*", "/{tail:.*}")``) answers every path and method that no
exact route takes. A handler returns a ``Response`` (sent with
``Content-Length``) or a ``StreamResponse`` it wrote itself: ``prepare``
sends the head with ``Transfer-Encoding: chunked`` (HTTP/1.1; an HTTP/1.0
peer gets the raw body and a close), ``write`` sends one chunk and waits for
the socket, ``write_eof`` sends the last chunk. ``Application.serve`` runs
on the caller's event loop until its stop event is set (``on_bound`` gets
the bound port, which ``port=0`` leaves to the system); then the listener
closes at once (the port is free again), idle keep-alive connections close,
handlers still running get ``shutdown_timeout`` seconds to answer, and the
rest are cancelled. The client side is ``_web_client.py``.
"""

from __future__ import annotations

import asyncio
import json as _json
import logging
from email.utils import formatdate
from http import HTTPStatus
from typing import Any, Awaitable, Callable, Mapping
from urllib.parse import parse_qsl, unquote, urlsplit

_SERVER = "pathway_tpu_torch"
_MAX_BODY = 1 << 26
CATCH_ALL = "/{tail:.*}"
_log = logging.getLogger(__name__)


class HttpError(Exception):
    """A malformed request: answered with ``status`` and the connection
    closed."""

    def __init__(self, status: int):
        super().__init__(status)
        self.status = status


class Headers(dict):
    """Case-insensitive header mapping (keys stored lower-case); the first
    of repeated headers wins, as ``CIMultiDict.get`` gives it."""

    def __getitem__(self, name: str) -> str:
        return super().__getitem__(name.lower())

    def __contains__(self, name: object) -> bool:
        return isinstance(name, str) and super().__contains__(name.lower())

    def get(self, name: str, default: Any = None) -> Any:
        return super().get(name.lower(), default)


class Request:
    """One parsed request: ``method``, ``path`` (percent-decoded),
    ``headers``, ``query`` (first value per name) and the body through
    ``text()``/``json()``."""

    def __init__(
        self, method: str, target: str, version: str, headers: Headers, body: bytes
    ):
        self.method = method
        self.version = version
        self.headers = headers
        parts = urlsplit(target)
        self.path = unquote(parts.path) or "/"
        self.query: dict[str, str] = {}
        for name, value in parse_qsl(parts.query, keep_blank_values=True):
            self.query.setdefault(name, value)
        self._body = body
        self._writer: asyncio.StreamWriter | None = None  # for a StreamResponse
        self._streamed = False  # a StreamResponse sent its head

    @property
    def keep_alive(self) -> bool:
        conn = (self.headers.get("connection") or "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"

    async def text(self) -> str:
        charset = "utf-8"
        for param in (self.headers.get("content-type") or "").split(";")[1:]:
            name, _, value = param.strip().partition("=")
            if name.lower() == "charset" and value:
                charset = value.strip('"')
        return self._body.decode(charset, errors="replace")

    async def json(self) -> Any:
        """The body parsed as JSON; ``ValueError`` when it is not."""
        return _json.loads(await self.text())

    async def read(self) -> bytes:
        return self._body


class Response:
    def __init__(
        self,
        body: bytes = b"",
        status: int = 200,
        headers: Mapping[str, str] | None = None,
        content_type: str = "text/plain; charset=utf-8",
    ):
        self.body = body
        self.status = status
        self.headers: dict[str, str] = dict(headers or {})
        self.content_type = content_type


class StreamResponse:
    """A response the handler writes itself, in chunks (see the module
    docstring). Returned from the handler once written; a handler that
    returns before ``write_eof`` gets the last chunk sent for it."""

    def __init__(self, status: int = 200, headers: Mapping[str, str] | None = None):
        self.status = status
        self.headers: dict[str, str] = dict(headers or {})
        self._request: Request | None = None
        self._chunked = True
        self._eof = False

    @property
    def prepared(self) -> bool:
        return self._request is not None

    async def prepare(self, request: Request) -> None:
        writer = request._writer
        if writer is None:
            raise RuntimeError("request is not bound to a connection")
        self._request = request
        request._streamed = True
        self._chunked = request.version == "HTTP/1.1"
        head = [f"HTTP/1.1 {self.status} {HTTPStatus(self.status).phrase}"]
        names = {name.lower() for name in self.headers}
        for name, value in self.headers.items():
            head.append(f"{name}: {value}")
        if "content-type" not in names:
            head.append("Content-Type: application/octet-stream")
        if self._chunked:
            head.append("Transfer-Encoding: chunked")
        else:
            head.append("Connection: close")
        head.append(f"Date: {formatdate(usegmt=True)}")
        head.append(f"Server: {_SERVER}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
        await writer.drain()

    async def write(self, data: bytes) -> None:
        if self._request is None or self._eof:
            raise RuntimeError("write before prepare or after write_eof")
        if not data:
            return
        writer = self._request._writer
        assert writer is not None
        if self._chunked:
            writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        else:
            writer.write(data)
        await writer.drain()

    async def write_eof(self) -> None:
        if self._request is None or self._eof:
            return
        self._eof = True
        writer = self._request._writer
        assert writer is not None
        if self._chunked:
            writer.write(b"0\r\n\r\n")
        await writer.drain()


def json_response(
    data: Any, *, status: int = 200, headers: Mapping[str, str] | None = None
) -> Response:
    return Response(
        _json.dumps(data).encode(),
        status=status,
        headers=headers,
        content_type="application/json; charset=utf-8",
    )


def _text_response(status: int, headers: Mapping[str, str] | None = None) -> Response:
    phrase = HTTPStatus(status).phrase
    return Response(f"{status}: {phrase}".encode(), status=status, headers=headers)


Handler = Callable[[Request], Awaitable["Response | StreamResponse"]]


class Application:
    """Routes by exact path, then by method; then the catch-all route."""

    def __init__(self, shutdown_timeout: float = 1.0):
        self.shutdown_timeout = shutdown_timeout
        self._routes: dict[str, dict[str, Handler]] = {}
        self._busy: set[asyncio.Task] = set()  # connections inside a handler
        self._idle: set[asyncio.Task] = set()  # connections between requests
        self._closing = False

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        self._routes.setdefault(path, {})[method.upper()] = handler

    def add_get(self, path: str, handler: Handler) -> None:
        self.add_route("GET", path, handler)
        self.add_route("HEAD", path, handler)

    async def serve(
        self,
        host: str,
        port: int,
        stop: asyncio.Event,
        on_bound: Callable[[int], None] | None = None,
    ) -> None:
        """Listen on ``host:port`` until ``stop`` is set, then shut down;
        ``on_bound(port)`` runs once the listener is bound."""
        server = await asyncio.start_server(self._connection, host, port)
        if on_bound is not None:
            on_bound(server.sockets[0].getsockname()[1])
        try:
            await stop.wait()
        finally:
            self._closing = True
            server.close()  # the listener goes now: a new connect is refused
            for task in list(self._idle):
                task.cancel()
            busy = list(self._busy)
            if busy:
                _done, pending = await asyncio.wait(busy, timeout=self.shutdown_timeout)
                for task in pending:
                    task.cancel()
            rest = list(self._idle | self._busy)
            if rest:
                await asyncio.wait(rest, timeout=self.shutdown_timeout)

    async def _connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        task = asyncio.current_task()
        assert task is not None
        try:
            while not self._closing:
                self._idle.add(task)
                try:
                    request = await _read_request(reader)
                finally:
                    self._idle.discard(task)
                if request is None:
                    return
                self._busy.add(task)
                request._writer = writer
                try:
                    response = await self._dispatch(request)
                    if isinstance(response, StreamResponse):
                        if not response.prepared:
                            await response.prepare(request)
                        await response.write_eof()
                        keep = response._chunked and request.keep_alive and not self._closing
                    elif request._streamed:
                        # the handler failed after its stream's head went
                        # out: no second head can follow, so cut the body
                        keep = False
                    else:
                        keep = request.keep_alive and not self._closing
                        _write_response(writer, request, response, keep)
                        await writer.drain()
                finally:
                    self._busy.discard(task)
                if not keep:
                    return
        except HttpError as e:
            _write_response(writer, None, _text_response(e.status), False)
            try:
                await writer.drain()
            except ConnectionError:
                pass
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    async def _dispatch(self, request: Request) -> Response | StreamResponse:
        methods = self._routes.get(request.path) or self._routes.get(CATCH_ALL)
        if methods is None:
            return _text_response(404)
        handler = methods.get(request.method) or methods.get("*")
        if handler is None:
            return _text_response(405, {"Allow": ",".join(sorted(methods))})
        try:
            return await handler(request)
        except asyncio.CancelledError:
            raise
        except (ConnectionError, asyncio.IncompleteReadError):
            raise  # the peer went away mid-stream: close the connection
        except Exception:
            _log.exception("handler of %s %s failed", request.method, request.path)
            return _text_response(500)


async def _read_request(reader: asyncio.StreamReader) -> Request | None:
    """The next request on the connection, or None when the peer closed it
    between requests."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial.strip():
            return None
        raise HttpError(400) from None
    except asyncio.LimitOverrunError:  # more than the reader's 64 KiB limit
        raise HttpError(431) from None
    lines = head.decode("latin-1").split("\r\n")
    try:
        method, target, version = lines[0].split(" ")
    except ValueError:
        raise HttpError(400) from None
    if version not in ("HTTP/1.0", "HTTP/1.1"):
        raise HttpError(505)
    headers = Headers()
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep or not name.strip():
            raise HttpError(400)
        headers.setdefault(name.strip().lower(), value.strip())
    if "chunked" in (headers.get("transfer-encoding") or "").lower():
        body = await _read_chunked(reader)
    else:
        try:
            length = int(headers.get("content-length") or 0)
        except ValueError:
            raise HttpError(400) from None
        if length < 0 or length > _MAX_BODY:
            raise HttpError(413 if length > 0 else 400)
        body = await reader.readexactly(length) if length else b""
    return Request(method.upper(), target, version, headers, body)


async def _read_chunked(reader: asyncio.StreamReader) -> bytes:
    parts: list[bytes] = []
    total = 0
    while True:
        line = await reader.readuntil(b"\r\n")
        try:
            size = int(line.split(b";", 1)[0].strip(), 16)
        except ValueError:
            raise HttpError(400) from None
        if size == 0:
            # trailers, up to the empty line that ends the message
            while (await reader.readuntil(b"\r\n")) != b"\r\n":
                pass
            return b"".join(parts)
        total += size
        if total > _MAX_BODY:
            raise HttpError(413)
        chunk = await reader.readexactly(size + 2)
        if chunk[-2:] != b"\r\n":
            raise HttpError(400)
        parts.append(chunk[:-2])


def _write_response(
    writer: asyncio.StreamWriter,
    request: Request | None,
    response: Response,
    keep_alive: bool,
) -> None:
    status = response.status
    head = [f"HTTP/1.1 {status} {HTTPStatus(status).phrase}"]
    names = {name.lower() for name in response.headers}
    for name, value in response.headers.items():
        head.append(f"{name}: {value}")
    if "content-type" not in names:
        head.append(f"Content-Type: {response.content_type}")
    head.append(f"Content-Length: {len(response.body)}")
    head.append(f"Date: {formatdate(usegmt=True)}")
    head.append(f"Server: {_SERVER}")
    if not keep_alive:
        head.append("Connection: close")
    elif request is not None and request.version == "HTTP/1.0":
        head.append("Connection: keep-alive")
    out = ("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
    if request is None or request.method != "HEAD":
        out += response.body
    writer.write(out)

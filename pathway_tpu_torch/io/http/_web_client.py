"""A small HTTP/1.1 client on the standard library's asyncio — the part of
``aiohttp.ClientSession`` that the failover router uses, so the read plane
runs where aiohttp is not installed (the card's machine has none).

What it does: one request at a time per connection, connections kept alive
and reused per ``(host, port)``, a total timeout per request (it raises
``asyncio.TimeoutError``, as aiohttp's ``ClientTimeout(total=...)`` does),
and bodies read whole, sent with ``Content-Length``, chunked, or up to the
close. A request whose task is cancelled (the router's losing hedge) closes
its connection instead of returning it to the pool. Every transport failure
(refused, reset, a peer that closes mid-response, a malformed response)
raises :class:`ClientError`. A request that fails on a REUSED connection
before a byte of the response arrived is sent once more on a new one: the
server may have closed an idle keep-alive connection, which says nothing of
its health.

Requests are made on the event loop that calls; no thread is started.
"""

from __future__ import annotations

import asyncio
import json as _json
from typing import Any, Mapping
from urllib.parse import urlsplit

from pathway_tpu_torch.io.http._web import Headers

_MAX_BODY = 1 << 28
_MAX_IDLE_PER_HOST = 32


class ClientError(Exception):
    """A transport failure: the peer is unreachable or broke the exchange."""


class _Stale(ClientError):
    """A reused connection failed before any response byte arrived."""


class ClientResponse:
    def __init__(self, status: int, headers: Headers, body: bytes):
        self.status = status
        self.headers = headers
        self.body = body

    def json(self) -> Any:
        return _json.loads(self.body.decode("utf-8"))


class ClientSession:
    """Keep-alive connection pool and requests over it."""

    def __init__(self) -> None:
        self._idle: dict[tuple[str, int], list[tuple[asyncio.StreamReader, asyncio.StreamWriter]]] = {}
        self._closed = False

    async def get(self, url: str, *, headers: Mapping[str, str] | None = None, timeout: float) -> ClientResponse:
        return await self.request("GET", url, headers=headers, timeout=timeout)

    async def post(
        self,
        url: str,
        *,
        data: bytes = b"",
        headers: Mapping[str, str] | None = None,
        timeout: float,
    ) -> ClientResponse:
        return await self.request("POST", url, data=data, headers=headers, timeout=timeout)

    async def request(
        self,
        method: str,
        url: str,
        *,
        data: bytes = b"",
        headers: Mapping[str, str] | None = None,
        timeout: float,
    ) -> ClientResponse:
        """One exchange; ``asyncio.TimeoutError`` past ``timeout`` seconds."""
        if self._closed:
            raise ClientError("session is closed")
        parts = urlsplit(url)
        if parts.scheme != "http" or not parts.hostname:
            raise ValueError(f"unsupported URL {url!r} (http://host:port/path only)")
        target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
        addr = (parts.hostname, parts.port or 80)
        head = [f"{method.upper()} {target} HTTP/1.1", f"Host: {parts.netloc}"]
        for name, value in (headers or {}).items():
            head.append(f"{name}: {value}")
        head.append(f"Content-Length: {len(data)}")
        raw = ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + bytes(data)
        return await asyncio.wait_for(self._exchange(addr, raw, method), timeout)

    async def _exchange(self, addr: tuple[str, int], raw: bytes, method: str) -> ClientResponse:
        while True:
            pooled = self._idle.get(addr)
            conn = pooled.pop() if pooled else None
            try:
                return await self._on(addr, conn, raw, method)
            except _Stale:
                continue  # the next try dials or takes another idle one

    async def _on(self, addr, conn, raw: bytes, method: str) -> ClientResponse:
        reused = conn is not None
        writer = None
        try:
            if conn is None:
                conn = await asyncio.open_connection(*addr)
            reader, writer = conn
            try:
                writer.write(raw)
                await writer.drain()
                status_line = await reader.readuntil(b"\r\n")
            except (asyncio.IncompleteReadError, ConnectionError) as e:
                if reused:
                    raise _Stale(str(e)) from None
                raise
            status, headers, body, keep = await _read_response(reader, status_line, method)
        except asyncio.CancelledError:
            if writer is not None:
                writer.close()
            raise
        except _Stale:
            writer.close()
            raise
        except (OSError, asyncio.IncompleteReadError, asyncio.LimitOverrunError, ValueError) as e:
            if writer is not None:
                writer.close()
            raise ClientError(f"{type(e).__name__}: {e}") from e
        if keep and not self._closed:
            idle = self._idle.setdefault(addr, [])
            if len(idle) < _MAX_IDLE_PER_HOST:
                idle.append((reader, writer))
                return ClientResponse(status, headers, body)
        writer.close()
        return ClientResponse(status, headers, body)

    async def close(self) -> None:
        self._closed = True
        for conns in self._idle.values():
            for _reader, writer in conns:
                writer.close()
        self._idle.clear()


async def _read_response(
    reader: asyncio.StreamReader, status_line: bytes, method: str
) -> tuple[int, Headers, bytes, bool]:
    parts = status_line.decode("latin-1").rstrip("\r\n").split(" ", 2)
    if len(parts) < 2 or not parts[0].startswith("HTTP/1."):
        raise ValueError(f"malformed status line {status_line!r}")
    version, status = parts[0], int(parts[1])
    headers = Headers()
    while True:
        line = (await reader.readuntil(b"\r\n")).decode("latin-1")[:-2]
        if not line:
            break
        name, sep, value = line.partition(":")
        if not sep:
            raise ValueError(f"malformed header line {line!r}")
        headers.setdefault(name.strip().lower(), value.strip())
    conn = (headers.get("connection") or "").lower()
    keep = conn == "keep-alive" if version == "HTTP/1.0" else conn != "close"
    if method.upper() == "HEAD" or status in (204, 304) or 100 <= status < 200:
        return status, headers, b"", keep
    if "chunked" in (headers.get("transfer-encoding") or "").lower():
        body = await _read_chunked(reader)
    elif headers.get("content-length") is not None:
        length = int(headers["content-length"])
        if not 0 <= length <= _MAX_BODY:
            raise ValueError(f"content-length {length} out of range")
        body = await reader.readexactly(length)
    else:
        body = await reader.read()  # up to the close
        keep = False
    return status, headers, body, keep


async def _read_chunked(reader: asyncio.StreamReader) -> bytes:
    parts: list[bytes] = []
    total = 0
    while True:
        line = await reader.readuntil(b"\r\n")
        size = int(line.split(b";", 1)[0].strip(), 16)
        if size == 0:
            while (await reader.readuntil(b"\r\n")) != b"\r\n":
                pass
            return b"".join(parts)
        total += size
        if total > _MAX_BODY:
            raise ValueError("chunked body too large")
        chunk = await reader.readexactly(size + 2)
        if chunk[-2:] != b"\r\n":
            raise ValueError("malformed chunk")
        parts.append(chunk[:-2])

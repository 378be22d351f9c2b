"""A small HTTP/1.1 server over ``asyncio.start_server``, from the standard
library only: the transport of :mod:`crane_tpu_torch.serve.api`.

``crane_tpu``'s server is built on ``aiohttp.web``; the machine with the
card has no ``aiohttp``, so the port serves the same ``async`` handlers
through this layer instead. It offers what those handlers use of aiohttp:

- a :class:`Request` with ``json()``, ``read()``, ``multipart()``,
  ``content_type`` and ``match_info``, read from the request line, the
  headers and a ``Content-Length`` body (a body over ``client_max_size``
  is refused with 413 before it is read, as aiohttp refuses it);
- two response shapes: :func:`json_response` / :class:`Response`, sent
  with a ``Content-Length`` on a connection that stays open for the next
  request, and :class:`StreamResponse`, whose ``write`` sends bytes as they
  come and whose ``write_eof`` ends the body by closing the connection;
- :class:`Application` with aiohttp's ``router.add_get`` / ``add_post``,
  paths with ``{name}`` segments, 404 and 405.

A client that hangs up while a streamed response is open cancels the
handler's task, so the handler's ``except asyncio.CancelledError`` runs (the
SSE handlers abort their engine request there), as aiohttp cancels it.
"""

from __future__ import annotations

import asyncio
import email.parser
import email.policy
import json
import logging
import threading
from typing import Awaitable, Callable, Optional
from urllib.parse import unquote, urlsplit

log = logging.getLogger("crane_tpu_torch.http")

REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
           411: "Length Required", 413: "Request Entity Too Large",
           431: "Request Header Fields Too Large", 500: "Internal Server Error"}
MAX_LINE = 64 * 1024  # the request line and each header line
MAX_HEADERS = 128


class HTTPError(Exception):
    """A request the transport refuses before any handler sees it, or one a
    handler refuses by raising it (answered ``{"error": {"message": ...}}``
    with its status)."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class Request:
    def __init__(self, method: str, target: str, version: str, headers: dict[str, str],
                 body: bytes, conn: "_Connection"):
        self.method = method
        self.path = unquote(urlsplit(target).path)  # no handler reads a query
        self.version = version
        self.headers = headers  # names lower-cased
        self.body = body
        self.match_info: dict[str, str] = {}
        self._conn = conn

    @property
    def content_type(self) -> str:
        """The media type of ``Content-Type`` without its parameters."""
        return self.headers.get("content-type", "application/octet-stream").split(";")[0] \
            .strip().lower()

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"

    async def read(self) -> bytes:
        return self.body

    async def text(self) -> str:
        return self.body.decode("utf-8")

    async def json(self):
        return json.loads(await self.text())

    async def multipart(self) -> "_Parts":
        """The parts of a ``multipart/form-data`` body, each with ``name``
        and an ``async read()``."""
        head = f"Content-Type: {self.headers.get('content-type', '')}\r\n\r\n".encode()
        msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(head + self.body)
        if not msg.is_multipart():
            raise HTTPError(400, "not a multipart body")
        return _Parts([_Part(p.get_param("name", header="content-disposition"),
                             p.get_payload(decode=True) or b"") for p in msg.iter_parts()])


class _Part:
    def __init__(self, name: Optional[str], data: bytes):
        self.name = name
        self._data = data

    async def read(self) -> bytes:
        return self._data


class _Parts:
    def __init__(self, parts: list[_Part]):
        self._parts = parts

    def __aiter__(self):
        return self._gen()

    async def _gen(self):
        for p in self._parts:
            yield p


def _head(status: int, headers: dict[str, str]) -> bytes:
    lines = [f"HTTP/1.1 {status} {REASONS.get(status, 'Unknown')}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class Response:
    """A whole body, sent with its ``Content-Length``."""

    def __init__(self, *, body: bytes = b"", status: int = 200,
                 content_type: str = "application/octet-stream",
                 headers: Optional[dict[str, str]] = None):
        self.body = body
        self.status = status
        self.headers = {"Content-Type": content_type, **(headers or {})}

    def encode(self, keep_alive: bool) -> bytes:
        headers = {**self.headers, "Content-Length": str(len(self.body)),
                   "Connection": "keep-alive" if keep_alive else "close"}
        return _head(self.status, headers) + self.body


def json_response(data, *, status: int = 200) -> Response:
    return Response(body=json.dumps(data).encode(), status=status,
                    content_type="application/json; charset=utf-8")


class StreamResponse:
    """A body written as it is produced and ended by closing the connection
    (``Connection: close``, no length). ``prepare`` sends the head and from
    then on watches the connection: a client that hangs up cancels the
    handler's task."""

    def __init__(self, *, status: int = 200, headers: Optional[dict[str, str]] = None):
        self.status = status
        self.headers = dict(headers or {})
        self._writer: Optional[asyncio.StreamWriter] = None

    async def prepare(self, request: Request) -> None:
        conn = request._conn
        self._writer = conn.writer
        conn.streamed = True
        conn.writer.write(_head(self.status, {**self.headers, "Connection": "close"}))
        await conn.writer.drain()
        conn.watch()

    async def write(self, data: bytes) -> None:
        if self._writer.is_closing():
            raise ConnectionResetError("the client closed the connection")
        self._writer.write(data)
        await self._writer.drain()

    async def write_eof(self) -> None:
        await self._writer.drain()


Handler = Callable[[Request], Awaitable[object]]


class Router:
    def __init__(self):
        self.routes: list[tuple[str, list[str], Handler]] = []

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        self.routes.append((method, path.strip("/").split("/"), handler))

    def add_get(self, path: str, handler: Handler) -> None:
        self.add_route("GET", path, handler)

    def add_post(self, path: str, handler: Handler) -> None:
        self.add_route("POST", path, handler)

    def resolve(self, method: str, path: str) -> tuple[Optional[Handler], dict[str, str], int]:
        """(handler, match_info, 200), or (None, {}, 404 or 405)."""
        parts = path.strip("/").split("/")
        allowed = False
        for m, pattern, handler in self.routes:
            if len(pattern) != len(parts):
                continue
            info = {}
            for p, s in zip(pattern, parts):
                if p.startswith("{") and p.endswith("}"):
                    info[p[1:-1]] = s
                elif p != s:
                    break
            else:
                if m == method:
                    return handler, info, 200
                allowed = True
        return None, {}, 405 if allowed else 404


class _Connection:
    """One client connection: reads requests, runs their handlers, writes
    their responses, until the client or a streamed response closes it."""

    def __init__(self, app: "Application", reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.app = app
        self.reader = reader
        self.writer = writer
        self.streamed = False
        self.task: Optional[asyncio.Task] = None
        self._watcher: Optional[asyncio.Task] = None

    def watch(self) -> None:
        """Cancel the running handler when the client hangs up: a streamed
        response ends the connection, so nothing more is read from it."""
        self._watcher = asyncio.get_running_loop().create_task(self._watch(self.task))

    async def _watch(self, task: asyncio.Task) -> None:
        try:
            while await self.reader.read(4096):
                pass
        except ConnectionError:
            pass
        if not task.done():
            log.info("client hung up during a streamed response")
            task.cancel()

    async def serve(self) -> None:
        try:
            while True:
                try:
                    req = await self._read_request()
                except HTTPError as e:
                    self.writer.write(Response(body=e.message.encode(), status=e.status,
                                               content_type="text/plain; charset=utf-8")
                                      .encode(keep_alive=False))
                    await self.writer.drain()
                    return
                if req is None:
                    return
                resp = await self._handle(req)
                if resp is None:  # a streamed response: the connection is spent
                    return
                keep = req.keep_alive
                self.writer.write(resp.encode(keep_alive=keep))
                await self.writer.drain()
                if not keep:
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            if self._watcher is not None:
                self._watcher.cancel()
            self.writer.close()

    async def _read_request(self) -> Optional[Request]:
        try:
            line = await self.reader.readuntil(b"\r\n")
        except asyncio.IncompleteReadError:
            return None  # the client closed between requests
        except asyncio.LimitOverrunError:
            raise HTTPError(431, "request line too long")
        parts = line.decode("latin-1").strip().split()
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            raise HTTPError(400, f"bad request line {line[:80]!r}")
        method, target, version = parts
        headers: dict[str, str] = {}
        for _ in range(MAX_HEADERS + 1):
            try:
                h = await self.reader.readuntil(b"\r\n")
            except asyncio.LimitOverrunError:
                raise HTTPError(431, "header line too long")
            if h == b"\r\n":
                break
            name, sep, value = h.decode("latin-1").partition(":")
            if not sep:
                raise HTTPError(400, f"bad header line {h[:80]!r}")
            headers[name.strip().lower()] = value.strip()
        else:
            raise HTTPError(431, "too many header lines")
        if "chunked" in headers.get("transfer-encoding", "").lower():
            raise HTTPError(411, "a request body needs a Content-Length")
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            raise HTTPError(400, "bad Content-Length")
        if length < 0:
            raise HTTPError(400, "bad Content-Length")
        if length > self.app.client_max_size:
            raise HTTPError(413, f"Maximum request body size {self.app.client_max_size} "
                                 f"exceeded, actual body size {length}")
        body = await self.reader.readexactly(length) if length else b""
        return Request(method, target, version, headers, body, self)

    async def _handle(self, req: Request) -> Optional[Response]:
        """The handler's response, or None once a streamed response ran (it
        wrote itself, or the client went away)."""
        handler, req.match_info, status = self.app.router.resolve(req.method, req.path)
        if handler is None:
            text = "404: Not Found" if status == 404 else "405: Method Not Allowed"
            return Response(body=text.encode(), status=status,
                            content_type="text/plain; charset=utf-8")
        self.task = asyncio.get_running_loop().create_task(handler(req))
        await asyncio.wait({self.task})
        try:
            resp = self.task.result()
        except asyncio.CancelledError:
            return None
        except HTTPError as e:
            return json_response({"error": {"message": e.message}}, status=e.status)
        except Exception:
            log.exception("error handling %s %s", req.method, req.path)
            if self.streamed:
                return None
            return Response(body=b"500 Internal Server Error", status=500,
                            content_type="text/plain; charset=utf-8")
        if isinstance(resp, StreamResponse) or self.streamed:
            return None
        return resp


class Application:
    """A route table and the request-size limit, served by :meth:`start`."""

    def __init__(self, *, client_max_size: int = 1024 ** 2):
        self.client_max_size = client_max_size
        self.router = Router()

    async def start(self, host: str, port: int) -> asyncio.base_events.Server:
        async def on_client(reader, writer):
            await _Connection(self, reader, writer).serve()

        return await asyncio.start_server(on_client, host, port, limit=MAX_LINE)


def run_app(app: Application, *, host: str = "0.0.0.0", port: int = 8000) -> None:
    """Serve ``app`` until interrupted (the counterpart of aiohttp's
    ``web.run_app``)."""

    async def main():
        server = await app.start(host, port)
        log.info("serving on http://%s:%d", host, port)
        async with server:
            await server.serve_forever()

    try:
        asyncio.run(main())
    except KeyboardInterrupt:
        pass


class BackgroundServer:
    """``app`` served on its own thread and event loop, for in-process
    clients (tests, the smoke run): ``port`` is the bound port (``port=0``
    takes a free one), ``close()`` stops the loop and joins the thread."""

    def __init__(self, app: Application, host: str = "127.0.0.1", port: int = 0):
        self.loop = asyncio.new_event_loop()
        started = threading.Event()
        failure: list[BaseException] = []

        def run():
            asyncio.set_event_loop(self.loop)
            try:
                self.server = self.loop.run_until_complete(app.start(host, port))
            except BaseException as e:  # handed to the constructor, which raises it
                failure.append(e)
                started.set()
                return
            started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, name="http", daemon=True)
        self.thread.start()
        started.wait(30)
        if failure:
            self.thread.join(5)
            raise failure[0]
        self.port = self.server.sockets[0].getsockname()[1]

    def close(self) -> None:
        async def shutdown():
            self.server.close()
            tasks = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            self.loop.stop()

        asyncio.run_coroutine_threadsafe(shutdown(), self.loop)
        self.thread.join(30)
        self.loop.close()

    def __enter__(self) -> "BackgroundServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

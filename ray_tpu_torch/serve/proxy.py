"""HTTP proxy: asyncio HTTP/1.1 server routing to deployments.

Role analog: ``python/ray/serve/_private/proxy.py:1112`` (``HTTPProxy``
:748). The reference rides uvicorn/ASGI per node; here a stdlib asyncio
server (no external deps) speaks enough HTTP/1.1 for a real client
matrix — keep-alive, chunked request bodies, 400/404/405/413/500 — and
routes ``/<deployment>`` to the deployment's handle. Runs on a daemon
thread in the driver process (single-node data plane). The gRPC ingress
with the same routing lives in ``grpc_proxy.py``.
"""

from __future__ import annotations

import asyncio
import json
import os
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch import config
from ray_tpu_torch.serve.handle import DeploymentHandle

MAX_BODY = int(config.get("serve_max_body"))
ALLOWED_METHODS = {"GET", "POST", "PUT", "DELETE", "HEAD"}


class _BodyTooLarge(Exception):
    pass


class HTTPProxy:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        self.host = host
        self.port = port
        self._handles: Dict[str, DeploymentHandle] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._stop_event: Optional[asyncio.Event] = None

    def register(self, route: str, handle: DeploymentHandle) -> None:
        self._handles[route.strip("/")] = handle

    # -- server -----------------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter):
        try:
            while True:
                if not await self._handle_one(reader, writer):
                    break
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        except Exception:
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _read_chunked(self, reader: asyncio.StreamReader) -> bytes:
        """Chunked request body (curl --data with unknown length, gRPC-web
        style clients). Trailers are read and dropped."""
        body = b""
        while True:
            szline = await reader.readline()
            if not szline:
                raise asyncio.IncompleteReadError(b"", None)
            size = int(szline.strip().split(b";")[0], 16)
            if size == 0:
                while True:
                    line = await reader.readline()
                    if line in (b"\r\n", b"\n", b""):
                        break
                return body
            if len(body) + size > MAX_BODY:
                raise _BodyTooLarge
            body += await reader.readexactly(size)
            await reader.readexactly(2)  # trailing CRLF

    async def _respond(self, writer, status: str, payload: dict,
                       keep: bool, head_only: bool = False,
                       extra_headers: str = ""):
        data = json.dumps(payload).encode()
        writer.write(
            f"HTTP/1.1 {status}\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(data)}\r\n{extra_headers}"
            f"Connection: {'keep-alive' if keep else 'close'}"
            f"\r\n\r\n".encode() + (b"" if head_only else data))
        await writer.drain()

    async def _handle_one(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> bool:
        """One request/response exchange; returns False to end the
        connection (keep-alive loop otherwise)."""
        request_line = await reader.readline()
        if not request_line or request_line in (b"\r\n", b"\n"):
            return False
        parts = request_line.decode("latin1").rstrip("\r\n").split(" ")
        if len(parts) != 3:
            await self._respond(writer, "400 Bad Request",
                               {"error": "malformed request line"}, False)
            return False
        method, path, version = parts
        headers: Dict[str, str] = {}
        hdr_bytes = 0
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            hdr_bytes += len(line)
            if len(headers) > 256 or hdr_bytes > 64 << 10:
                # headers are attacker-controlled input too: bound them
                await self._respond(
                    writer, "431 Request Header Fields Too Large",
                    {"error": "too many/large headers"}, False)
                return False
            k, _, v = line.decode("latin1").partition(":")
            headers[k.strip().lower()] = v.strip()
        conn_hdr = headers.get("connection", "").lower()
        if version == "HTTP/1.0":
            keep = conn_hdr == "keep-alive"
        else:
            keep = conn_hdr != "close"
        # body — Content-Length or chunked, both bounded by MAX_BODY
        try:
            if "chunked" in headers.get("transfer-encoding", "").lower():
                body = await self._read_chunked(reader)
            else:
                n = int(headers.get("content-length", 0) or 0)
                if n > MAX_BODY:
                    raise _BodyTooLarge
                body = await reader.readexactly(n) if n else b""
        except _BodyTooLarge:
            # the unread body makes the stream unparseable: must close
            await self._respond(writer, "413 Payload Too Large",
                               {"error": f"body exceeds {MAX_BODY} bytes"},
                               False)
            return False
        except ValueError:
            await self._respond(writer, "400 Bad Request",
                               {"error": "bad framing headers"}, False)
            return False
        if method not in ALLOWED_METHODS:
            await self._respond(
                writer, "405 Method Not Allowed",
                {"error": f"method {method} not allowed"}, keep,
                extra_headers="Allow: " + ", ".join(
                    sorted(ALLOWED_METHODS)) + "\r\n")
            return keep
        if "?stream=1" in path or path.endswith("&stream=1"):
            await self._route_streaming(method, path, body, writer)
            return False  # streaming responses close the connection
        status, payload = await self._route(method, path, body)
        await self._respond(writer, status, payload, keep,
                            head_only=(method == "HEAD"))
        return keep

    async def _route(self, method: str, path: str, body: bytes):
        name = path.strip("/").split("?")[0].split("/")[0]
        if name == "-" or name == "":
            return "200 OK", {"status": "ok",
                              "routes": sorted(self._handles)}
        handle = self._handles.get(name)
        if handle is None:
            return "404 Not Found", {"error": f"no deployment {name!r}"}
        arg: Any = None
        if body:
            try:
                arg = json.loads(body)
            except json.JSONDecodeError:
                arg = body.decode()
        loop = asyncio.get_event_loop()
        # manual span, not span(): the await hands this coroutine's frame
        # back to the loop, so a thread-local span context must not stay
        # open across it (graftlint tracing-context-capture)
        from ray_tpu_torch.util import tracing

        ms = tracing.manual_span("serve.proxy::request", {"route": name})
        try:
            # tracing.context: the handle's request span must parent
            # under the proxy span (one reconciled trace per HTTP
            # request), and handle.remote reads the thread-local ctx
            with tracing.context(ms.traceparent if ms else None):
                resp = (handle.remote(arg) if arg is not None
                        else handle.remote())
            result = await loop.run_in_executor(None, resp.result)
            return "200 OK", {"result": result}
        except Exception as e:  # noqa: BLE001
            if ms is not None:
                ms.finish(error=repr(e))
                ms = None
            return "500 Internal Server Error", {"error": str(e)}
        finally:
            if ms is not None:
                ms.finish()

    async def _route_streaming(self, method: str, path: str, body: bytes,
                               writer: asyncio.StreamWriter):
        """Chunked transfer: one JSON line per yielded item (reference
        HTTPProxy streaming responses, proxy.py:748 role)."""
        name = path.strip("/").split("?")[0].split("/")[0]
        handle = self._handles.get(name)
        if handle is None:
            data = json.dumps({"error": f"no deployment {name!r}"}).encode()
            writer.write(
                f"HTTP/1.1 404 Not Found\r\nContent-Length: {len(data)}"
                f"\r\nConnection: close\r\n\r\n".encode() + data)
            await writer.drain()
            return
        arg: Any = None
        if body:
            try:
                arg = json.loads(body)
            except json.JSONDecodeError:
                arg = body.decode()
        writer.write(
            b"HTTP/1.1 200 OK\r\nContent-Type: application/x-ndjson\r\n"
            b"Transfer-Encoding: chunked\r\nConnection: close\r\n\r\n")
        loop = asyncio.get_event_loop()
        from ray_tpu_torch.util import tracing

        ms = tracing.manual_span("serve.proxy::stream", {"route": name})
        items = 0
        try:
            with tracing.context(ms.traceparent if ms else None):
                gen = (handle.options(stream=True).remote(arg)
                       if arg is not None
                       else handle.options(stream=True).remote())
            it = iter(gen)

            def _next():
                try:
                    return True, next(it)
                except StopIteration:
                    return False, None

            while True:
                more, item = await loop.run_in_executor(None, _next)
                if not more:
                    break
                items += 1
                chunk = (json.dumps({"result": item}) + "\n").encode()
                writer.write(f"{len(chunk):x}\r\n".encode() + chunk
                             + b"\r\n")
                await writer.drain()
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        finally:
            if ms is not None:
                ms.finish({"items": items})

    def _run(self):
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def main():
            self._stop_event = asyncio.Event()
            server = await asyncio.start_server(
                self._handle_conn, self.host, self.port)
            if self.port == 0:
                self.port = server.sockets[0].getsockname()[1]
            self._started.set()
            # Wait for stop() rather than serve_forever(): stopping the
            # loop mid-run_until_complete abandons this coroutine (the
            # "coroutine ignored GeneratorExit" teardown warning) and
            # leaks in-flight connection tasks.
            async with server:
                await self._stop_event.wait()

        try:
            self._loop.run_until_complete(main())
            # drain connection handlers still in flight at shutdown
            pending = [t for t in asyncio.all_tasks(self._loop)
                       if not t.done()]
            for t in pending:
                t.cancel()
            if pending:
                self._loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True))
        except (asyncio.CancelledError, RuntimeError):
            pass
        finally:
            self._loop.close()

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve_http_proxy")
        self._thread.start()
        self._started.wait(timeout=10)

    def stop(self) -> None:
        loop, ev = self._loop, self._stop_event
        if loop is not None and ev is not None:
            try:
                loop.call_soon_threadsafe(ev.set)
            except RuntimeError:
                pass  # loop already closed
        if self._thread is not None:
            self._thread.join(timeout=5)

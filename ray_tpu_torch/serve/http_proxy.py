"""HTTP ingress actor (reference: python/ray/serve/http_proxy.py).

An asyncio HTTP/1.1 server (the image has no uvicorn; this is a minimal
event-loop implementation on asyncio.start_server) running on a thread
inside the proxy actor. Connections are coroutines, not threads — idle
keep-alives cost a socket, and an in-flight route parks on a Future fed
by the core's SHARED resolver (one batched directory long-poll for every
outstanding request), so concurrent-connection scale is bounded by the
event loop, not a thread pool. Request body: JSON — either a bare value
(single positional arg) or {"args": [...], "kwargs": {...}}.

The port's copy of ``ray_tpu/serve/http_proxy.py``.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Dict, List, Optional, Tuple

import ray_tpu_torch

_MAX_BODY = 64 << 20
_KEEPALIVE_S = 120.0


class _BadRequest(Exception):
    pass


async def _read_request(reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter):
    """Parse one HTTP/1.1 request; returns (method, path, headers, body)
    or None on clean EOF between requests."""
    try:
        line = await asyncio.wait_for(reader.readline(), _KEEPALIVE_S)
    except asyncio.TimeoutError:
        return None
    if not line:
        return None
    try:
        method, path, _version = line.decode("latin-1").split(None, 2)
    except ValueError:
        raise _BadRequest("malformed request line")
    headers: Dict[str, str] = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        if len(headers) > 100:
            raise _BadRequest("too many headers")
        name, sep, value = line.decode("latin-1").partition(":")
        if sep:
            headers[name.strip().lower()] = value.strip()
    length = int(headers.get("content-length") or 0)
    if length < 0 or length > _MAX_BODY:
        raise _BadRequest("bad content-length")
    if "100-continue" in headers.get("expect", "").lower():
        # curl sends Expect: 100-continue for larger POST bodies and
        # waits ~1s for this interim response before transmitting.
        writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        await writer.drain()
    body = await reader.readexactly(length) if length else b""
    return method.upper(), path, headers, body


def _response(code: int, payload, *, close: bool = False) -> bytes:
    try:
        data = json.dumps(payload).encode()
    except TypeError:
        data = json.dumps({"result": repr(payload)}).encode()
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              405: "Method Not Allowed", 500: "Internal Server Error"}
    head = (f"HTTP/1.1 {code} {reason.get(code, 'OK')}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(data)}\r\n"
            + ("Connection: close\r\n" if close else "")
            + "\r\n")
    return head.encode("latin-1") + data


class HTTPProxyActor:
    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        # route -> (endpoint, methods)
        self.routes: Dict[str, Tuple[str, List[str]]] = {}
        self.router = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._started = threading.Event()
        self._startup_error: Optional[BaseException] = None
        self.thread = threading.Thread(
            target=self._run_loop, name="serve-http", daemon=True)
        self.thread.start()
        self._started.wait(10.0)
        # Surface a bind failure (port in use, bad host) as an actor
        # creation error instead of silently reporting a dead port.
        if self._startup_error is not None:
            raise RuntimeError(
                f"HTTP ingress failed to start: {self._startup_error}")
        if not self._started.is_set():
            raise RuntimeError("HTTP ingress failed to start within 10s")

    # ------------------------------------------------------------ event loop
    def _run_loop(self) -> None:
        loop = self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)

        async def start():
            self._server = await asyncio.start_server(
                self._handle_conn, self.host, self.port)
            self.port = self._server.sockets[0].getsockname()[1]
            self._started.set()

        try:
            loop.run_until_complete(start())
        except BaseException as e:  # noqa: BLE001 - surfaced in __init__
            self._startup_error = e
            self._started.set()
            loop.close()
            return
        try:
            loop.run_forever()
        finally:
            loop.close()   # local ref: stop() nulls self._loop

    async def _route_call(self, endpoint: str, method: str, args, kwargs):
        """One router call: the submit itself does synchronous RPCs (and
        actor-resolution retries on router restart), so it runs in a
        worker thread — ON the event loop it would freeze every
        connection for its duration. The resulting ObjectRef resolves
        through the core's shared future resolver."""
        def submit():
            ref = self.router.route.remote(endpoint, method, args, kwargs)
            return ref.future()

        fut = await asyncio.to_thread(submit)
        return await asyncio.wait_for(asyncio.wrap_future(fut), 600.0)

    # ------------------------------------------------------------ connection
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    req = await _read_request(reader, writer)
                except (_BadRequest, asyncio.IncompleteReadError,
                        UnicodeDecodeError, ValueError):
                    writer.write(_response(
                        400, {"error": "malformed request"}, close=True))
                    break
                if req is None:
                    break
                method, raw_path, headers, body = req
                keep = headers.get("connection", "").lower() != "close"
                try:
                    await self._serve_one(writer, method, raw_path, body)
                    await writer.drain()
                except (ConnectionResetError, BrokenPipeError):
                    return  # client went away: nothing to report
                except Exception as e:  # noqa: BLE001 - reply, keep serving
                    try:
                        writer.write(_response(500, {"error": str(e)}))
                        await writer.drain()
                    except (ConnectionResetError, BrokenPipeError, OSError):
                        return
                if not keep:
                    break
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def _serve_one(self, writer, method: str, raw_path: str,
                         body: bytes) -> None:
        path, _, query = raw_path.partition("?")
        if path == "/-/routes":
            writer.write(_response(200, self.routes))
            return
        entry = self.routes.get(path)
        if entry is None:
            writer.write(_response(404, {"error": f"no route {path}"}))
            return
        endpoint, methods = entry
        if method not in methods:
            writer.write(_response(405, {"error": f"{method} not allowed"}))
            return
        args, kwargs = (), {}
        if body:
            try:
                parsed = json.loads(body)
            except json.JSONDecodeError:
                writer.write(_response(400, {"error": "body must be JSON"}))
                return
            if isinstance(parsed, dict) and ("args" in parsed
                                             or "kwargs" in parsed):
                args = tuple(parsed.get("args", ()))
                kwargs = dict(parsed.get("kwargs", {}))
            else:
                args = (parsed,)
        stream = bool(kwargs.pop("stream", False)) or "stream=1" in query
        try:
            if stream:
                await self._stream(writer, endpoint, args, kwargs)
                return
            result = await self._route_call(endpoint, "", args, kwargs)
            writer.write(_response(200, {"result": result}))
        except (ConnectionResetError, BrokenPipeError):
            raise
        except Exception as e:  # noqa: BLE001
            writer.write(_response(500, {"error": str(e)}))

    async def _stream(self, writer, endpoint: str, args, kwargs) -> None:
        """Chunked transfer: one JSON line per long-poll reply, written as
        tokens arrive. The replica's pump thread decodes independently of
        this loop, so each round-trip drains a batch of buffered tokens.
        Requires a backend with stream_start/stream_poll (serve.lm)."""
        token = await self._route_call(endpoint, "stream_start", args,
                                       kwargs)
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: application/x-ndjson\r\n"
                     b"Transfer-Encoding: chunked\r\n\r\n")

        def chunk(payload: bytes) -> bytes:
            return b"%x\r\n%s\r\n" % (len(payload), payload)

        try:
            while True:
                out = await self._route_call(
                    endpoint, "stream_poll", (token,), {"wait_s": 2.0})
                if out["tokens"] or out["done"]:
                    writer.write(chunk(json.dumps(
                        {"tokens": out["tokens"],
                         "done": out["done"]}).encode() + b"\n"))
                    await writer.drain()
                if out["done"]:
                    break
            writer.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            # Client hung up mid-stream: free the engine slot.
            await self._cancel_stream(endpoint, token)
            raise
        except Exception as e:  # noqa: BLE001 - headers already sent
            await self._cancel_stream(endpoint, token)
            try:
                writer.write(chunk(json.dumps(
                    {"error": str(e)}).encode() + b"\n"))
                writer.write(b"0\r\n\r\n")
            except OSError:
                pass

    async def _cancel_stream(self, endpoint: str, token) -> None:
        try:
            await self._route_call(endpoint, "stream_cancel", (token,), {})
        except Exception:  # noqa: BLE001
            pass

    # ------------------------------------------------------------ actor API
    def ready(self) -> int:
        if self.router is None:
            from .master import ROUTER_NAME

            # Resolve lazily: the router is a sibling actor created by the
            # master; by the time a route is set it exists.
            try:
                self.router = ray_tpu_torch.get_actor(ROUTER_NAME)
            except Exception:  # noqa: BLE001
                pass
        return self.port

    def set_route(self, route: str, endpoint: str, methods: List[str]) -> None:
        self.ready()
        self.routes[route] = (endpoint, [m.upper() for m in methods])

    def remove_route(self, route: str) -> None:
        self.routes.pop(route, None)

    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        loop, self._loop = self._loop, None
        if loop is not None and not loop.is_closed():
            def shutdown():
                if self._server is not None:
                    self._server.close()
                loop.stop()
            loop.call_soon_threadsafe(shutdown)

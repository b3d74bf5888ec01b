"""Asyncio HTTP/1.1 front end: the production-concurrency serving path (the
port's copy of the JAX package's ``serving/aserver.py``).

One event loop accepts connections, parses requests, and awaits the
:class:`~.batcher.ContinuousBatcher` — no thread per request, no GIL convoy
of handler threads contending on one dispatcher. Connections are
keep-alive (HTTP/1.1 default), so a steady client pays connection set-up
once, and the listener can bind with ``SO_REUSEPORT`` so R replica
processes share one port — the kernel spreads new connections across live
listeners, and a dead replica's connections fail fast onto the survivors
(clients retry; see ``loadgen``). An optional admin listener on a private
127.0.0.1 port (never shared) serves the same handler with the operational
endpoints (``/v1/drain``, ``/v1/debug/flightrecorder``,
``/v1/debug/profile``) unlocked.

The HTTP surface is deliberately minimal (request line + headers +
Content-Length bodies — what the serving API needs), stdlib-only, and
instrumented: the ``serve/accept`` fault site fires per accepted
connection and ``serve/replica_kill`` per request with the replica label as
its path context, so a fault plan can kill one targeted replica mid-flight
under load.
"""

from __future__ import annotations

import asyncio
import json
import socket
import threading
import time
from typing import Optional, Tuple

from ..observability.tracecontext import TraceContext
from ..reliability.faults import inject
from .server import (
    BINARY_CONTENT_TYPE,
    DEADLINE_HEADER,
    PRIORITY_HEADER,
    ServingService,
)

MAX_BODY_BYTES = 64 * 1024 * 1024  # one month of a ~10k-stock panel is ~5 MB
MAX_HEADER_LINES = 64


def pick_free_port(host: str = "127.0.0.1") -> int:
    """A currently-free TCP port (bind-0 probe). Racy by nature: use it to
    agree a port before the server binds it — a ``SO_REUSEPORT`` replica
    fleet needs one agreed port, where port 0 would scatter the replicas
    across different ephemeral ports."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


async def _read_request(reader) -> Optional[Tuple[str, str, dict, bytes]]:
    """(method, path, headers, body) or None on clean EOF / bad preamble."""
    line = await reader.readline()
    if not line:
        return None
    try:
        method, path, _version = line.decode("latin-1").split(None, 2)
    except ValueError:
        return None
    headers = {}
    for _ in range(MAX_HEADER_LINES):
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        name, _, value = h.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    else:
        return None  # header section never ended: drop, don't desync
    try:
        length = int(headers.get("content-length") or 0)
    except ValueError:
        return None  # garbage Content-Length: malformed preamble
    if not 0 <= length <= MAX_BODY_BYTES:
        return None
    body = await reader.readexactly(length) if length else b""
    return method, path, headers, body


async def _handle_conn(service: ServingService, reader, writer,
                       admin: bool = False) -> None:
    inject("serve/accept", path=service.replica_label or "")
    rec: dict = {}
    try:
        while True:
            rec = {}
            req = await _read_request(reader)
            if req is None:
                break
            method, path, headers, body = req
            # fault site: kills THIS replica with a request (and typically
            # a whole flush) in the air; matched by replica label so a
            # plan can target one member of the fleet
            inject("serve/replica_kill", path=service.replica_label or "")
            # request-scoped trace context: continue the client's
            # traceparent or mint a fresh edge context; malformed headers
            # fall back, never 500
            trace = TraceContext.from_header(headers.get("traceparent"))
            priority = headers.get(PRIORITY_HEADER)
            deadline_ms = headers.get(DEADLINE_HEADER)
            serialize_s = 0.0
            ctype = b"application/json"
            if (headers.get("content-type") == BINARY_CONTENT_TYPE
                    and method == "POST"
                    and path.split("?", 1)[0].rstrip("/") == "/v1/weights"):
                # raw-f32 hot wire: no JSON anywhere on the path
                status, data = await service.handle_binary_async(
                    body, trace=trace, rec=rec, priority=priority,
                    deadline_ms=deadline_ms)
                ctype = (BINARY_CONTENT_TYPE.encode() if status == 200
                         else b"text/plain")
            else:
                t_parse = time.monotonic()
                payload, parse_error = None, False
                if body:
                    try:
                        payload = json.loads(body)
                    except json.JSONDecodeError:
                        parse_error = True
                pre_parse_s = time.monotonic() - t_parse
                if parse_error:
                    status, resp = 400, {
                        "error": "request body is not valid JSON"}
                else:
                    rec["pre_parse_s"] = pre_parse_s
                    status, resp = await service.handle_async(
                        method, path, payload, raw_body=body or None,
                        trace=trace, rec=rec, admin=admin,
                        priority=priority, deadline_ms=deadline_ms)
                t_ser = time.monotonic()
                if isinstance(resp, dict) and "_raw_text" in resp:
                    # non-JSON response (Prometheus text exposition)
                    data = resp["_raw_text"].encode()
                    ctype = resp.get(
                        "_content_type", "text/plain").encode()
                else:
                    if isinstance(resp, dict):
                        resp.pop("_retry_after", None)
                    data = json.dumps(resp).encode()
                serialize_s = time.monotonic() - t_ser
            keep = headers.get("connection", "").lower() != "close"
            # shed/overload responses carry the Retry-After the admission
            # layer computed (rec["retry_after"]: whole seconds)
            retry_after = rec.get("retry_after")
            extra_hdr = (b"Retry-After: %d\r\n" % int(retry_after)
                         if retry_after is not None else b"")
            t_write = time.monotonic()
            writer.write(
                b"HTTP/1.1 %d %s\r\n"
                b"Content-Type: %s\r\n"
                b"Content-Length: %d\r\n"
                % (status, _REASONS.get(status, b"OK"), ctype, len(data))
                + extra_hdr
                + b"Connection: %s\r\n\r\n"
                % (b"keep-alive" if keep else b"close")
                + data)
            await writer.drain()
            if "status" in rec:
                # the deferred request row: the transport's serialize and
                # socket-write segments land on the row the service filled
                service.emit_request(
                    rec, serialize_s=serialize_s,
                    write_s=time.monotonic() - t_write)
            if not keep:
                break
    except (ConnectionError, asyncio.IncompleteReadError,
            asyncio.TimeoutError):
        pass  # client went away mid-request; nothing to answer
    except Exception:
        # malformed preamble / transport surprise: drop THIS connection
        # quietly — an unhandled task exception answers nobody
        pass
    finally:
        # a connection dropped mid-request must not leak its in-flight
        # flight-recorder entry
        if rec.get("token") is not None and not rec.get("_finished"):
            service.abort_request(rec)
        try:
            writer.close()
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass


_REASONS = {
    200: b"OK", 400: b"Bad Request", 404: b"Not Found",
    405: b"Method Not Allowed", 409: b"Conflict",
    429: b"Too Many Requests",
    500: b"Internal Server Error", 501: b"Not Implemented",
    503: b"Service Unavailable",
}


async def serve_async(
    service: ServingService,
    host: str = "127.0.0.1",
    port: int = 0,
    ready: Optional[asyncio.Event] = None,
    port_out: Optional[list] = None,
    admin_port: Optional[int] = None,
    admin_port_out: Optional[list] = None,
    reuse_port: bool = False,
):
    """Run the asyncio server until cancelled or drained. ``port_out`` (a
    list) receives the bound port, ``admin_port_out`` the admin listener's;
    ``ready`` is set once accepting.

    ``admin_port``: also bind the SAME handler on a private 127.0.0.1 port
    (never ``SO_REUSEPORT``-shared) with the operational endpoints
    unlocked. In a replica fleet every replica shares the serving port —
    the kernel picks who answers — so the rolling update and the
    autoscaler need a per-replica address to target ONE replica.
    ``/v1/drain`` closes the public listener shortly after answering; the
    serve loop then returns (the continuous batcher drains first).
    ``reuse_port``: bind the public listener with ``SO_REUSEPORT``."""
    service.start_async()
    server = await asyncio.start_server(
        lambda r, w: _handle_conn(service, r, w), host=host, port=port,
        reuse_port=reuse_port)
    bound = server.sockets[0].getsockname()[1]
    loop = asyncio.get_running_loop()
    drained = asyncio.Event()

    def _close_public():
        drained.set()
        try:
            server.close()
        except Exception:
            pass  # already closing / loop shutting down

    # graceful-drain hook (admin /v1/drain): close the public listener
    # SHORTLY AFTER the drain response is written, so the answer reaches
    # the caller first
    service._drain_hook = lambda: loop.call_soon_threadsafe(
        loop.call_later, 0.5, _close_public)
    admin_server = None
    if admin_port is not None:
        admin_server = await asyncio.start_server(
            lambda r, w: _handle_conn(service, r, w, admin=True),
            host="127.0.0.1", port=admin_port)
        admin_bound = admin_server.sockets[0].getsockname()[1]
        if admin_port_out is not None:
            admin_port_out.append(admin_bound)
        print(f"admin endpoint on http://127.0.0.1:{admin_bound}"
              + (f" ({service.replica_label})" if service.replica_label
                 else ""), flush=True)
    if port_out is not None:
        port_out.append(bound)
    if ready is not None:
        ready.set()
    service.accepting = True
    if service.heartbeat is not None:
        service.heartbeat.beat("serve/accepting")
    print(f"serving {service.engine.n_members} members on "
          f"http://{host}:{bound} (async"
          + (f", {service.replica_label}" if service.replica_label else "")
          + f", config {service.engine.config_hash[:12]}, "
          f"{service.engine.device}, "
          f"{service.engine.exec_cfg.compute_dtype})", flush=True)
    async with server:
        try:
            await server.serve_forever()
        except asyncio.CancelledError:
            # a drain closed the listener, which cancels serve_forever's
            # own future; a cancellation of this task propagates
            if not drained.is_set() or asyncio.current_task().cancelling():
                raise
        finally:
            if admin_server is not None:
                admin_server.close()
            if service.cbatcher is not None:
                await service.cbatcher.aclose()


def run_async_server(service: ServingService, host: str = "127.0.0.1",
                     port: int = 0, reuse_port: bool = False,
                     admin_port: Optional[int] = None) -> None:
    """Blocking entry: own event loop, runs until KeyboardInterrupt or a
    drain."""
    try:
        asyncio.run(serve_async(service, host, port, admin_port=admin_port,
                                reuse_port=reuse_port))
    except asyncio.CancelledError:
        pass


class AsyncServerThread:
    """The async server on a background thread (tests, chip_smoke.py).

    ``start()`` blocks until the socket accepts and returns the bound
    port (``admin_port`` then holds the admin listener's, when one was
    asked for); ``stop()`` cancels the loop and joins the thread.
    ``returned`` is set once the serve loop has returned (after a drain
    or a stop), ``error`` holds what it raised, if anything."""

    def __init__(self, service: ServingService, host: str = "127.0.0.1",
                 port: int = 0, admin_port: Optional[int] = None):
        self.service = service
        self.host, self.port = host, port
        self.admin_port = admin_port
        self.returned = threading.Event()
        self.error: Optional[BaseException] = None
        self._loop = None
        self._thread = None
        self._task = None

    def start(self, timeout: float = 30.0) -> int:
        started = threading.Event()
        port_out: list = []
        admin_out: list = []

        def run():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            ready = asyncio.Event()

            async def body():
                self._task = asyncio.current_task()
                await serve_async(self.service, self.host, self.port,
                                  ready=ready, port_out=port_out,
                                  admin_port=self.admin_port,
                                  admin_port_out=admin_out)

            async def waiter():
                t = self._loop.create_task(body())
                ready_wait = self._loop.create_task(ready.wait())
                await asyncio.wait({t, ready_wait},
                                   return_when=asyncio.FIRST_COMPLETED)
                started.set()
                ready_wait.cancel()
                try:
                    await t
                except asyncio.CancelledError:
                    pass
                except BaseException as e:  # noqa: BLE001 — reported
                    self.error = e

            try:
                self._loop.run_until_complete(waiter())
            finally:
                self._loop.close()
                self.returned.set()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="serving-async")
        self._thread.start()
        if not started.wait(timeout) or not port_out:
            raise RuntimeError(f"async server failed to start: {self.error}")
        self.port = port_out[0]
        if admin_out:
            self.admin_port = admin_out[0]
        return self.port

    def stop(self, timeout: float = 10.0) -> None:
        if self._loop is not None and self._task is not None \
                and not self.returned.is_set():
            try:
                self._loop.call_soon_threadsafe(self._task.cancel)
            except RuntimeError:
                pass  # the loop closed between the check and the call
        if self._thread is not None:
            self._thread.join(timeout=timeout)

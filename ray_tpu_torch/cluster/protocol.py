"""Cluster wire protocol: length-prefixed messages over TCP.

Plays the role of the reference's gRPC plumbing (``src/ray/rpc/``): typed
request/response with correlation ids, plus server-push messages (pubsub).
A frame is ``[8-byte LE length][body]``. Two body encodings share every
socket:

  * **pickle** (default, any message type): a plain dict with a ``type``
    field, protocol-5 out-of-band buffers for large payloads;
  * **binary fast path** (``wire.py``): struct-packed bodies for the
    highest-frequency control-plane types, detected by a magic first byte
    (pickle bodies start with 0x80, binary with 0xBF).

Receivers always understand both, so old pickle-only peers interoperate on
the same socket; binary is only *sent* to peers that advertised/showed
capability.

Server side: asyncio. Client side: a blocking, thread-safe RpcClient (the
runtime's callers are threads, not coroutines). Oneway messages can be
coalesced into a single scatter-write (``send_oneway_many``) so a
completion wave is one sendmsg, not N.
"""

from __future__ import annotations

import asyncio
import itertools
import pickle
import random
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import wire
from .._native import framepump
from .._private import chaos as _chaos
from .._private.config import get_config

_LEN = struct.Struct("<Q")
MAX_MESSAGE = 1 << 34
# Bulk-read size for the server's recv loop: big enough that a burst of
# small frames arrives as one wakeup, small enough to stay cache-friendly.
_READ_CHUNK = 1 << 18


def _dumps(msg: Dict[str, Any]) -> bytes:
    body = pickle.dumps(msg, protocol=5)
    return _LEN.pack(len(body)) + body


def _loads_body(body: bytes) -> Dict[str, Any]:
    if wire.is_binary(body):
        return wire.decode(body)
    return pickle.loads(body)


def _compact(bufs: List[bytes], small: int = 1 << 14) -> List[bytes]:
    """Merge runs of small buffers into one; keep large blobs standalone
    (they pass through unjoined — the zero-copy part of the scatter
    write). Also keeps iovec counts far under IOV_MAX."""
    out: List[bytes] = []
    acc: Optional[bytearray] = None
    for b in bufs:
        if len(b) < small:
            if acc is None:
                acc = bytearray(b)
            else:
                acc += b
        else:
            if acc is not None:
                out.append(bytes(acc))
                acc = None
            out.append(b)
    if acc is not None:
        out.append(bytes(acc))
    return out


def encode_frames(msg: Dict[str, Any], binary_ok: bool,
                  req_type: Optional[str] = None,
                  peer_wire: int = 1) -> List[bytes]:
    """Encode one message into a list of buffers (length header first).

    ``binary_ok`` gates the fast path; ``req_type`` selects a response
    codec (responses carry no ``type`` field of their own); ``peer_wire``
    is the receiver's advertised wire version — frames the peer could not
    parse (v2 inline-result frames to a v1 peer) fall back per-message to
    pickle, as do types without a binary codec."""
    if binary_ok:
        try:
            bufs = (wire.encode_response(req_type, msg, peer_wire) if req_type
                    else wire.encode(msg, peer_wire))
        except wire.WireError:
            bufs = None
        if bufs is not None:
            total = sum(len(b) for b in bufs)
            return _compact([_LEN.pack(total), *bufs])
    return [_dumps(msg)]


# ---------------------------------------------------------------------------
# asyncio server side
# ---------------------------------------------------------------------------

async def read_frame(reader: asyncio.StreamReader
                     ) -> Optional[tuple]:
    """One frame off the stream: (msg, was_binary), or None at EOF."""
    try:
        header = await reader.readexactly(8)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_MESSAGE:
        raise ValueError(f"message too large: {length}")
    body = await reader.readexactly(length)
    return _loads_body(body), wire.is_binary(body)


async def read_message(reader: asyncio.StreamReader) -> Optional[Dict[str, Any]]:
    frame = await read_frame(reader)
    return None if frame is None else frame[0]


async def write_message(writer: asyncio.StreamWriter, msg: Dict[str, Any]) -> None:
    writer.write(_dumps(msg))
    await writer.drain()


class RpcServer:
    """Asyncio TCP server dispatching requests to handler coroutines.

    Handlers are registered per message type; each gets (msg, connection) and
    returns a response dict (or None for one-way messages). Connections are
    tracked so services can push messages (pubsub, task assignment).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._handlers: Dict[str, Callable] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._on_disconnect: Optional[Callable] = None
        self._conns: set = set()
        # Per-message-type {count, cumulative seconds}: the cProfile-free
        # answer to "where do this service's event-loop cycles go".
        self.handler_stats: Dict[str, list] = {}
        # Frame-pump attribution: socket wakeups vs frames delivered
        # (frames/read >> 1 is the batching win) and whether the native
        # splitter is active. Shipped via debug_stats/stats.
        self.recv_stats: Dict[str, int] = {
            "reads": 0, "frames": 0,
            "native": 1 if framepump.enabled() else 0}

    def handler(self, msg_type: str):
        def deco(fn):
            self._handlers[msg_type] = fn
            return fn
        return deco

    def on_disconnect(self, fn: Callable) -> None:
        self._on_disconnect = fn

    async def start(self) -> int:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter):
        sock = writer.get_extra_info("socket")
        if sock is not None:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = Connection(reader, writer)
        self._conns.add(conn)
        # Batched recv path (framepump.cc): the loop reads in bulk — one
        # await per socket wakeup, not two per frame — and the splitter
        # (native when built, Python twin otherwise) hands back every
        # complete frame at once. Dispatch below stays strictly in frame
        # order, per frame: chaos injection, __hello__, handlers and the
        # pickle/binary dual decode behave exactly as the per-frame loop
        # did.
        framer = framepump.feed_framer(MAX_MESSAGE)
        recv_stats = self.recv_stats
        try:
            while True:
                try:
                    data = await reader.read(_READ_CHUNK)
                except (ConnectionResetError, OSError):
                    break
                if not data:
                    break  # EOF
                try:
                    bodies = framer.feed(data)
                except framepump.FrameError:
                    break  # oversize frame: corrupt/hostile peer, drop it
                if not bodies:
                    continue
                recv_stats["reads"] += 1
                recv_stats["frames"] += len(bodies)
                for body in bodies:
                    await self._dispatch_frame(conn, body)
        finally:
            framer.close()
            self._conns.discard(conn)
            if self._on_disconnect is not None:
                try:
                    res = self._on_disconnect(conn)
                    if asyncio.iscoroutine(res):
                        await res
                except Exception:  # noqa: BLE001
                    pass
            writer.close()

    async def _dispatch_frame(self, conn: "Connection", body) -> None:
        """Decode + handle ONE inbound frame (the per-frame semantics of
        the old read_frame loop, verbatim)."""
        msg = _loads_body(body)
        was_binary = wire.is_binary(body)
        plan = _chaos.get()
        if plan is not None:
            # Fault injection (off unless a chaos plan is installed;
            # the common path pays one module-global None check).
            delay = plan.frame_delay_s()
            if delay > 0.0:
                await asyncio.sleep(delay)
            if plan.should_drop_frame(conn.meta):
                return
        if was_binary:
            # Observed capability: this peer talks binary, so
            # responses/pushes to it may too — but only v1 frames
            # are PROVEN; higher versions must be advertised.
            if not conn.meta.get("wire"):
                conn.meta["wire"] = 1
        mtype = msg.get("type")
        if mtype == "__hello__":
            # Connection-level capability advertisement (sent once
            # by RpcClient on connect): the peer can DECODE this
            # wire version, so responses/pushes may use its frames.
            conn.meta["wire"] = int(msg.get("wire") or 1)
            return
        handler = self._handlers.get(mtype)
        if handler is None:
            resp = {"ok": False, "error": f"unknown type {mtype}"}
        else:
            t0 = time.monotonic()
            try:
                resp = await handler(msg, conn)
            except Exception as e:  # noqa: BLE001 - reported to caller
                import traceback
                resp = {"ok": False,
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()}
            finally:
                cell = self.handler_stats.get(mtype)
                if cell is None:
                    cell = self.handler_stats[mtype] = [0, 0.0]
                cell[0] += 1
                cell[1] += time.monotonic() - t0
        if "rpc_id" in msg and resp is not None:
            resp["rpc_id"] = msg["rpc_id"]
            await conn.send(resp, req_type=mtype)

    async def stop(self):
        if self._server is not None:
            self._server.close()
            # Force live client connections shut, else wait_closed() blocks
            # until every client hangs up on its own.
            for conn in list(self._conns):
                try:
                    conn.writer.close()
                except Exception:  # noqa: BLE001
                    pass
            await self._server.wait_closed()


class Connection:
    """One inbound connection; supports locked writes for server push."""

    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer
        self.meta: Dict[str, Any] = {}  # handler-attached identity (node id...)
        self._wlock = asyncio.Lock()

    async def send(self, msg: Dict[str, Any],
                   req_type: Optional[str] = None):
        """Push/respond on this connection. Binary fast-path encoding is
        used when the peer has advertised or shown wire capability
        (``meta["wire"]``); ``req_type`` selects a response codec."""
        peer = int(self.meta.get("wire") or 0)
        bufs = encode_frames(msg, binary_ok=bool(peer), req_type=req_type,
                             peer_wire=peer or 1)
        async with self._wlock:
            self.writer.writelines(bufs)
            await self.writer.drain()

    def send_nowait(self, msg: Dict[str, Any]) -> None:
        """Synchronous push from the event-loop thread: buffers into the
        transport without awaiting drain. For small high-rate pushes whose
        peer demonstrably consumes (e.g. execute_task to a local worker) —
        the await-per-send of the locked path was pure overhead there.
        writelines() is atomic into the transport buffer, so interleaving
        with concurrent send() calls is safe."""
        peer = int(self.meta.get("wire") or 0)
        bufs = encode_frames(msg, binary_ok=bool(peer),
                             peer_wire=peer or 1)
        self.writer.writelines(bufs)


# ---------------------------------------------------------------------------
# blocking client side
# ---------------------------------------------------------------------------

class RpcClient:
    """Thread-safe blocking RPC client with a reader thread.

    Responses are matched by rpc_id; unsolicited messages (server push) go to
    the ``push_handler``.
    """

    def __init__(self, host: str, port: int,
                 push_handler: Optional[Callable[[Dict], None]] = None,
                 timeout: float = 30.0,
                 on_close: Optional[Callable[[], None]] = None,
                 binary: Optional[bool] = None,
                 io_stats: Optional[Dict[str, int]] = None,
                 push_batch_handler: Optional[
                     Callable[[List[Dict]], None]] = None):
        self._on_close = on_close
        self.addr = (host, port)
        # Send-side wire choice: binary fast path by default (the codec is
        # part of this release; receivers always decode both), pinnable to
        # pickle per client.
        self._binary = True if binary is None else binary
        # frames/writes counters: the coalescing regression guard reads
        # these (one write per completion wave, not one per frame).
        # late_drops counts responses that arrived after their call()
        # timed out and unregistered — dropped, never misrouted to the
        # push handler (node_stats ships this dict, so doctor bundles and
        # handler-stats readers see it).
        self.io_stats = io_stats if io_stats is not None else {
            "frames_sent": 0, "writes": 0}
        self.io_stats.setdefault("late_drops", 0)
        # Reader-thread seconds blocked waiting for bytes (recv/pump
        # wait). The observatory's socket-dwell bucket: time a client
        # spends off-CPU waiting on its peer, which the old wall-clock
        # sampler used to report as self-time.
        self.io_stats.setdefault("recv_dwell_s", 0.0)
        self._sock = socket.create_connection(self.addr, timeout=timeout)
        self._sock.settimeout(None)
        # Small control messages back-to-back must not wait out Nagle +
        # delayed-ACK (a one-way notification followed by a call would
        # stall ~40 ms).
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # Native frame pump (framepump.cc): the reader thread's recv +
        # frame split run in C with the GIL released, frames delivered in
        # batches; None pins the pure-Python per-frame loop
        # (no toolchain). The send twin
        # gates _send_buffers' native scatter-gather path.
        self._pump = framepump.reader_pump(self._sock.fileno(), MAX_MESSAGE)
        self._native_send = framepump.enabled()
        self._wlock = threading.Lock()
        self._pending: Dict[int, "threading.Event"] = {}
        self._responses: Dict[int, Dict] = {}
        self._counter = itertools.count(1)
        self._push_handler = push_handler
        # Optional batched push delivery: a run of consecutive pushes in
        # one recv batch is handed over in ONE call (the worker inbox
        # feed), with order relative to interleaved responses preserved.
        self._push_batch_handler = push_batch_handler
        self._closed = False
        # The highest wire version the SERVER side of this connection can
        # parse: conservative v1 until a handshake (register_* response)
        # reports better — v2-only frames fall back to pickle until then.
        self.peer_wire = 1
        # Advertise our own decode capability so server->client pushes and
        # responses may use this wire version's frames (decode support is
        # unconditional, so this holds even for pickle-pinned senders).
        try:
            with self._wlock:
                self._send_buffers(
                    [_dumps({"type": "__hello__",
                             "wire": wire.WIRE_VERSION})], 1)
        except OSError:
            pass
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _read_loop(self):
        try:
            io_stats = self.io_stats
            if self._pump is not None:
                # Native arm: recv + frame split run in C with the GIL
                # released; each wakeup hands back a whole batch of bodies.
                while not self._closed:
                    t0 = time.perf_counter()
                    batch = self._pump.pump()
                    io_stats["recv_dwell_s"] += time.perf_counter() - t0
                    if batch is None:
                        break  # EOF / socket error / oversize frame
                    self._dispatch_frames(batch)
            else:
                while not self._closed:
                    t0 = time.perf_counter()
                    header = self._recv_exact(8)
                    io_stats["recv_dwell_s"] += time.perf_counter() - t0
                    if header is None:
                        break
                    (length,) = _LEN.unpack(header)
                    if length > MAX_MESSAGE:
                        break  # corrupt/hostile peer: drop the connection
                    body = self._recv_exact(length)
                    if body is None:
                        break
                    self._dispatch_frames((body,))
        except OSError:
            pass
        finally:
            # The pump handle is destroyed HERE, by the one thread that
            # pumps it, never from close() racing a blocked recv.
            if self._pump is not None:
                self._pump.close()
            # Benign race: GIL-atomic latch flag, writers on both sides
            # only ever store True; readers tolerate either order.
            # raylint: disable=thread-shared-state
            self._closed = True
            for ev in list(self._pending.values()):
                ev.set()
            if self._on_close is not None:
                try:
                    self._on_close()
                except Exception:  # noqa: BLE001
                    pass

    # raylint: hotpath — every inbound client frame funnels through here
    def _dispatch_frames(self, bodies) -> None:
        """Route a batch of frame bodies strictly in order. Consecutive
        pushes coalesce into one ``push_batch_handler`` call when one is
        installed, but the batch is always flushed before a later
        response's caller is woken, so global frame order is preserved."""
        push_batch: List[Dict] = []
        batch_h = self._push_batch_handler
        for body in bodies:
            msg = _loads_body(body)
            rpc_id = msg.get("rpc_id")
            if rpc_id is not None:
                if push_batch:
                    self._flush_push_batch(push_batch)
                    push_batch = []
                ev = self._pending.get(rpc_id)
                if ev is not None:
                    self._responses[rpc_id] = msg
                    ev.set()
                else:
                    # Response landed after call() timed out and
                    # unregistered: drop it — routing it to the push
                    # handler would hand an RPC reply to code expecting
                    # server pushes. (Binary pushes never carry rpc_id:
                    # wire.decode strips it when 0, and servers only set
                    # it when echoing a request.)
                    self._responses.pop(rpc_id, None)
                    # Benign race: stats counter bumped off-lock from the
                    # reader thread; a lost increment under contention
                    # costs one tick of a diagnostic number, never a
                    # protocol fault.
                    # raylint: disable=thread-shared-state
                    self.io_stats["late_drops"] += 1
            elif batch_h is not None:
                push_batch.append(msg)
            elif self._push_handler is not None:
                try:
                    self._push_handler(msg)
                except Exception:  # noqa: BLE001
                    pass
        if push_batch:
            self._flush_push_batch(push_batch)

    def _flush_push_batch(self, msgs: List[Dict]) -> None:
        try:
            self._push_batch_handler(msgs)
        except Exception:  # noqa: BLE001
            pass

    # raylint: hotpath — 14% of head / 60% of worker self-time (the reference's profile)
    def _recv_exact(self, n: int) -> Optional[bytes]:
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = self._sock.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf.extend(chunk)
        return bytes(buf)

    # raylint: hotpath — every frame every client sends funnels through here
    def _send_buffers(self, bufs: List[bytes], frames: int) -> None:
        """One scatter-gather write for any number of frames. Caller holds
        ``_wlock``. Partial sendmsg results are continued manually."""
        self.io_stats["frames_sent"] += frames
        self.io_stats["writes"] += 1
        if self._native_send and framepump.sendv(self._sock.fileno(), bufs):
            return
        try:
            sendmsg = self._sock.sendmsg
        except AttributeError:  # platform without sendmsg
            self._sock.sendall(b"".join(bufs))
            return
        views = [memoryview(b) for b in bufs]
        while views:
            # Stay well under IOV_MAX per syscall (EMSGSIZE otherwise).
            sent = sendmsg(views[:512])
            while views and sent >= len(views[0]):
                sent -= len(views[0])
                views.pop(0)
            if sent:
                views[0] = views[0][sent:]

    def call(self, msg: Dict[str, Any], timeout: Optional[float] = 60.0) -> Dict:
        if self._closed:
            raise ConnectionError(f"connection to {self.addr} closed")
        rpc_id = next(self._counter)
        msg = dict(msg, rpc_id=rpc_id)
        ev = threading.Event()
        self._pending[rpc_id] = ev
        bufs = encode_frames(msg, binary_ok=self._binary,
                             peer_wire=self.peer_wire)
        with self._wlock:
            self._send_buffers(bufs, 1)
        if not ev.wait(timeout):
            self._pending.pop(rpc_id, None)
            # The reader may have stored the response between the wait
            # expiring and the pop above; reap it so _responses can't
            # accumulate entries nobody will ever claim.
            self._responses.pop(rpc_id, None)
            raise TimeoutError(f"rpc {msg['type']} to {self.addr} timed out")
        self._pending.pop(rpc_id, None)
        resp = self._responses.pop(rpc_id, None)
        if resp is None:
            raise ConnectionError(f"connection to {self.addr} lost mid-call")
        if resp.get("ok") is False:
            raise RuntimeError(
                f"rpc {msg['type']} failed: {resp.get('error')}\n"
                f"{resp.get('traceback', '')}"
            )
        return resp

    def send_oneway(self, msg: Dict[str, Any]) -> None:
        if self._closed:
            raise ConnectionError(f"connection to {self.addr} closed")
        bufs = encode_frames(msg, binary_ok=self._binary,
                             peer_wire=self.peer_wire)
        with self._wlock:
            self._send_buffers(bufs, 1)

    def probe_wire(self, timeout: float = 5.0) -> int:
        """Probe the server's advertised wire version (any server exposing
        a ``wire_probe`` handler) and lift this client's send floor to it.
        Cached per connection — peers that don't answer stay at the
        conservative v1 floor, so every frame they get is parseable."""
        w = getattr(self, "_srv_wire", None)
        if w is None:
            try:
                resp = self.call({"type": "wire_probe"}, timeout=timeout)
                w = int(resp.get("wire", 1)) if resp.get("ok") else 1
            except Exception:  # noqa: BLE001 - old peer / flaky link => v1
                w = 1
            self._srv_wire = w
            if w > self.peer_wire:
                self.peer_wire = w
        return int(w)

    def send_oneway_many(self, msgs: List[Dict[str, Any]]) -> None:
        """Coalesced oneways: N frames, ONE locked scatter-write. FIFO
        order within the list is preserved on the wire, so e.g. a wave's
        object registrations still precede its task_done batch."""
        if not msgs:
            return
        if self._closed:
            raise ConnectionError(f"connection to {self.addr} closed")
        bufs: List[bytes] = []
        for msg in msgs:
            bufs.extend(encode_frames(msg, binary_ok=self._binary,
                                      peer_wire=self.peer_wire))
        with self._wlock:
            self._send_buffers(bufs, len(msgs))

    def close(self):
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


def _parse_addr_list(spec: str) -> List[Tuple[str, int]]:
    """Parse "host:port,host:port" (the ``gcs_addrs`` config knob /
    RAY_TPU_TORCH_GCS_ADDRS) into an address list; malformed entries are skipped."""
    out: List[Tuple[str, int]] = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or ":" not in part:
            continue
        host, _, port = part.rpartition(":")
        try:
            out.append((host, int(port)))
        except ValueError:
            continue
    return out


class ResilientClient:
    """RpcClient that transparently reconnects across server restarts.

    Used for GCS connections (reference: clients retry against the restarted
    GCS in test_gcs_fault_tolerance.py). A call that hits a dead socket
    re-dials with jittered exponential backoff — sleep =
    min(cap, base * 2^attempt) * uniform[0.5, 1.5) — until ``retry_window``
    elapses; window and backoff shape come from RayConfig
    (``gcs_retry_window_s`` / ``gcs_retry_backoff_base_s`` / ``_cap_s``).

    For head HA the client holds a multi-address list (primary + warm
    standbys, extended by ``addrs`` and the ``gcs_addrs`` knob) and rotates
    through it on every failed dial, so a promoted standby is found without
    reconfiguration. A ``NOT_LEADER`` rejection from a fenced or demoted
    head is treated like a dead socket: drop, rotate, retry. After every
    successful RE-dial (not the first connect) ``on_reconnect`` fires with
    the live client so callers can idempotently re-register themselves
    (re-publish inventory, re-arm rings and long-polls) with the new leader.
    """

    def __init__(self, host: str, port: int,
                 push_handler: Optional[Callable[[Dict], None]] = None,
                 retry_window: Optional[float] = None,
                 addrs: Optional[Sequence[Tuple[str, int]]] = None,
                 on_reconnect: Optional[Callable[["RpcClient"], None]] = None):
        cfg = get_config()
        self._retry_window = (cfg.gcs_retry_window_s if retry_window is None
                              else retry_window)
        self._backoff_base = max(1e-3, cfg.gcs_retry_backoff_base_s)
        self._backoff_cap = max(self._backoff_base, cfg.gcs_retry_backoff_cap_s)
        self._addrs: List[Tuple[str, int]] = [(host, int(port))]
        for cand in list(addrs or []) + _parse_addr_list(cfg.gcs_addrs):
            cand = (cand[0], int(cand[1]))
            if cand not in self._addrs:
                self._addrs.append(cand)
        self._addr_idx = 0
        self.addr = self._addrs[0]  # currently-targeted address
        self._push_handler = push_handler
        self._on_reconnect = on_reconnect
        self._lock = threading.Lock()
        self._client: Optional[RpcClient] = None
        self._closed = False
        self._ever_connected = False
        # Reentrancy latch: an on_reconnect callback typically calls back
        # through this client; a failure inside it must not recurse into
        # another callback invocation.
        self._reconnect_tls = threading.local()
        # Shared across reconnects so coalescing counters survive re-dials.
        self.io_stats: Dict[str, int] = {"frames_sent": 0, "writes": 0}
        self._ensure()

    def _ensure(self) -> RpcClient:
        with self._lock:
            if self._closed:
                raise ConnectionError(f"client to {self.addr} closed")
            if self._client is not None and not self._client._closed:
                return self._client
            self.addr = self._addrs[self._addr_idx]
            self._client = RpcClient(
                *self.addr, push_handler=self._push_handler,
                io_stats=self.io_stats)
            client = self._client
            is_reconnect = self._ever_connected
            self._ever_connected = True
        if (is_reconnect and self._on_reconnect is not None
                and not getattr(self._reconnect_tls, "active", False)):
            # Outside the lock: the callback re-registers through this very
            # client (call() -> _ensure() would deadlock otherwise).
            self._reconnect_tls.active = True
            try:
                self._on_reconnect(client)
            except Exception:  # noqa: BLE001 - re-registration is best-effort
                pass
            finally:
                self._reconnect_tls.active = False
        return client

    def _drop(self, rotate: bool = False) -> None:
        with self._lock:
            if self._client is not None:
                self._client.close()
                self._client = None
            if rotate and len(self._addrs) > 1:
                self._addr_idx = (self._addr_idx + 1) % len(self._addrs)

    def _backoff(self, attempt: int) -> None:
        sleep = min(self._backoff_cap, self._backoff_base * (2 ** attempt))
        time.sleep(sleep * (0.5 + random.random()))

    def call(self, msg: Dict[str, Any], timeout: Optional[float] = 60.0) -> Dict:
        deadline = time.monotonic() + self._retry_window
        attempt = 0
        while True:
            try:
                return self._ensure().call(msg, timeout=timeout)
            except (ConnectionError, OSError, TimeoutError):
                # TimeoutError is retried too: a paused head or a chaos-
                # dropped frame looks like a hang, and every GCS mutation
                # is idempotent/deduped so re-sending is safe.
                self._drop(rotate=True)
                if self._closed or time.monotonic() > deadline:
                    raise
            except RuntimeError as e:
                # A fenced/demoted head rejects mutations with NOT_LEADER;
                # the real leader is (or will be) at another address.
                if "NOT_LEADER" not in str(e):
                    raise
                self._drop(rotate=True)
                if self._closed or time.monotonic() > deadline:
                    raise
            self._backoff(attempt)
            attempt += 1

    def send_oneway(self, msg: Dict[str, Any]) -> None:
        try:
            self._ensure().send_oneway(msg)
        except (ConnectionError, OSError):
            self._drop(rotate=True)
            # one immediate retry; oneway messages are periodic (heartbeats)
            # so a miss is recovered by the next tick anyway
            try:
                self._ensure().send_oneway(msg)
            except (ConnectionError, OSError):
                pass

    def send_oneway_many(self, msgs: List[Dict[str, Any]]) -> None:
        try:
            self._ensure().send_oneway_many(msgs)
        except (ConnectionError, OSError):
            self._drop(rotate=True)
            try:
                self._ensure().send_oneway_many(msgs)
            except (ConnectionError, OSError):
                pass

    def close(self):
        self._closed = True
        self._drop()

"""ctypes wrapper for the native object-transfer plane (src/transfer.cc).

Reference counterpart: the ObjectManager's Push/Pull service
(object_manager.h:213). The server streams object bytes straight from the
shm arena; fetches land straight into the destination arena. All socket I/O
runs in C with the GIL released — Python only initiates transfers.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

from .build import load_native_library
from .shm_store import _pad_id


def _lib() -> Optional[ctypes.CDLL]:
    lib = load_native_library("transfer")
    if lib is None or getattr(lib, "_tts_bound", False):
        return lib
    lib.tps_open.restype = ctypes.c_void_p
    lib.tps_open.argtypes = [ctypes.c_char_p]
    lib.tps_close.argtypes = [ctypes.c_void_p]
    lib.tts_serve_start.restype = ctypes.c_void_p
    lib.tts_serve_start.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tts_serve_port.restype = ctypes.c_int
    lib.tts_serve_port.argtypes = [ctypes.c_void_p]
    lib.tts_serve_stop.argtypes = [ctypes.c_void_p]
    lib.tts_fetch.restype = ctypes.c_int
    lib.tts_fetch.argtypes = [ctypes.c_char_p, ctypes.c_int,
                              ctypes.c_char_p, ctypes.c_void_p]
    lib.tts_connect.restype = ctypes.c_int
    lib.tts_connect.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.tts_disconnect.argtypes = [ctypes.c_int]
    lib.tts_fetch_fd.restype = ctypes.c_int
    lib.tts_fetch_fd.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                 ctypes.c_void_p]
    lib.tts_push.restype = ctypes.c_int
    lib.tts_push.argtypes = [ctypes.c_char_p, ctypes.c_int,
                             ctypes.c_char_p, ctypes.c_void_p]
    lib.tts_fetch_buf.restype = ctypes.c_int64
    lib.tts_fetch_buf.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                  ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    lib.tts_buf_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.tts_fetch_range_fd.restype = ctypes.c_int64
    lib.tts_fetch_range_fd.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
    lib.tts_serve_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64)]
    lib._tts_bound = True
    return lib


class TransferBrokenError(Exception):
    """The sender died (or the stream broke) mid-pull. ``offset`` is the
    number of bytes already landed in the destination buffer — a retry
    against another holder resumes from exactly there."""

    def __init__(self, offset: int, reason: str = "connection broken"):
        super().__init__(f"{reason} at offset {offset}")
        self.offset = offset


class RemoteMissError(Exception):
    """The remote node does not hold (a sealed copy of) the object."""


class TransferServer:
    """Per-node data-plane server bound to the node's shm arena."""

    def __init__(self, store_name: str, port: int = 0):
        lib = _lib()
        if lib is None:
            raise RuntimeError("native transfer library unavailable")
        self._lib = lib
        self._handle = lib.tps_open(store_name.encode())
        if not self._handle:
            raise RuntimeError(f"cannot open store {store_name!r}")
        self._ctx = lib.tts_serve_start(self._handle, port)
        if not self._ctx:
            lib.tps_close(self._handle)
            raise RuntimeError("transfer server failed to start")
        self.port = lib.tts_serve_port(self._ctx)

    def stats(self) -> Tuple[int, int]:
        """(payload bytes served, requests handled) since start — the
        node's authoritative ``transfer_bytes_out`` source."""
        if not self._ctx:
            return (0, 0)
        bytes_out = ctypes.c_uint64(0)
        requests = ctypes.c_uint64(0)
        self._lib.tts_serve_stats(self._ctx, ctypes.byref(bytes_out),
                                  ctypes.byref(requests))
        return (bytes_out.value, requests.value)

    def stop(self) -> None:
        if self._ctx:
            self._lib.tts_serve_stop(self._ctx)
            self._ctx = None
        if self._handle:
            self._lib.tps_close(self._handle)
            self._handle = None


class TransferClient:
    """Fetch/push objects between this host's arena and remote nodes."""

    def __init__(self, store_name: Optional[str] = None):
        lib = _lib()
        if lib is None:
            raise RuntimeError("native transfer library unavailable")
        self._lib = lib
        self._handle = None
        self._conns: dict = {}  # (host, port) -> fd, persistent
        # One request/response in flight per connection: concurrent fetches
        # to the same peer must not interleave on one socket.
        self._conn_locks: dict = {}
        self._meta_lock = threading.Lock()
        if store_name:
            self._handle = lib.tps_open(store_name.encode())
            if not self._handle:
                raise RuntimeError(f"cannot open store {store_name!r}")

    def _conn_lock(self, host: str, port: int):
        with self._meta_lock:
            lock = self._conn_locks.get((host, port))
            if lock is None:
                lock = self._conn_locks[(host, port)] = threading.Lock()
            return lock

    def _conn(self, host: str, port: int) -> int:
        key = (host, port)
        fd = self._conns.get(key, -1)
        if fd < 0:
            fd = self._lib.tts_connect(host.encode(), port)
            if fd >= 0:
                self._conns[key] = fd
        return fd

    def _drop_conn(self, host: str, port: int) -> None:
        fd = self._conns.pop((host, port), -1)
        if fd >= 0:
            self._lib.tts_disconnect(fd)

    def fetch_into_store(self, host: str, port: int, object_id: bytes) -> bool:
        """Pull a remote object into the local arena (sealed on arrival).
        Reuses a persistent connection (serialized per peer); reconnects once
        on a broken one."""
        if self._handle is None:
            raise RuntimeError("client has no local store")
        oid = _pad_id(object_id)
        with self._conn_lock(host, port):
            for _ in range(2):
                fd = self._conn(host, port)
                if fd < 0:
                    return False
                rc = self._lib.tts_fetch_fd(fd, oid, self._handle)
                if rc == -5:
                    self._drop_conn(host, port)
                    continue
                return rc == 0
        return False

    def probe_size(self, host: str, port: int,
                   object_id: bytes) -> Optional[int]:
        """Ask a holder for an object's total size (a zero-length range
        request — no payload moves). None on miss; TransferBrokenError when
        the holder is unreachable."""
        fd = self._lib.tts_connect(host.encode(), port)
        if fd < 0:
            raise TransferBrokenError(0, "connect failed")
        try:
            total = ctypes.c_uint64(0)
            n = self._lib.tts_fetch_range_fd(fd, _pad_id(object_id), 0, 0,
                                             None, ctypes.byref(total))
            if n == -1:
                return None
            if n < 0:
                raise TransferBrokenError(0)
            return total.value
        finally:
            self._lib.tts_disconnect(fd)

    def fetch_chunks(self, host: str, port: int, object_id: bytes,
                     view, offset: int = 0,
                     chunk_size: int = 1 << 20) -> int:
        """Pull ``view[offset:]`` as a pipeline of fixed-size ranges over a
        dedicated connection, writing each chunk into ``view`` (the
        destination's unsealed arena slot) as it lands. Returns the chunk
        count on completion; raises TransferBrokenError carrying the resume
        offset when the sender dies mid-stream, RemoteMissError when the
        holder no longer has the object.

        A dedicated (non-pooled) connection per pull keeps concurrent
        admitted pulls from the same source streaming in parallel instead
        of serializing on the shared request/response socket."""
        total = len(view)
        oid = _pad_id(object_id)
        fd = self._lib.tts_connect(host.encode(), port)
        if fd < 0:
            raise TransferBrokenError(offset, "connect failed")
        chunks = 0
        try:
            while offset < total:
                want = min(chunk_size, total - offset)
                dst = (ctypes.c_ubyte * want).from_buffer(view, offset)
                remote_total = ctypes.c_uint64(0)
                n = self._lib.tts_fetch_range_fd(
                    fd, oid, offset, want, dst, ctypes.byref(remote_total))
                # Release the buffer export before any raise: a traceback
                # pins this frame, and a pinned export blocks arena close.
                del dst
                if n == -1:
                    raise RemoteMissError(object_id.hex())
                if n < 0 or remote_total.value != total:
                    # Broken stream, or the holder's copy disagrees on size
                    # (a different object under the same id would corrupt
                    # the slot — treat as a bad source and resume elsewhere)
                    raise TransferBrokenError(offset)
                if n == 0:
                    raise TransferBrokenError(offset, "empty range response")
                offset += n
                chunks += 1
            return chunks
        finally:
            self._lib.tts_disconnect(fd)

    def fetch_bytes(self, host: str, port: int,
                    object_id: bytes) -> Optional[bytes]:
        """Pull a remote object into process memory (no arena needed)."""
        out = ctypes.POINTER(ctypes.c_uint8)()
        n = self._lib.tts_fetch_buf(host.encode(), port, _pad_id(object_id),
                                    ctypes.byref(out))
        if n < 0:
            return None
        try:
            return ctypes.string_at(out, n)
        finally:
            self._lib.tts_buf_free(out)

    def push(self, host: str, port: int, object_id: bytes) -> bool:
        """Push a local arena object to a remote node's arena."""
        if self._handle is None:
            raise RuntimeError("client has no local store")
        rc = self._lib.tts_push(host.encode(), port, _pad_id(object_id),
                                self._handle)
        return rc == 0

    def close(self) -> None:
        for (host, port) in list(self._conns):
            self._drop_conn(host, port)
        if self._handle:
            self._lib.tps_close(self._handle)
            self._handle = None


def available() -> bool:
    return _lib() is not None

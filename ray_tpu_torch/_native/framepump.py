"""ctypes wrapper for the native frame pump (framepump.cc).

The recv→frame and frame→wire inner loops of the cluster protocol
(``cluster/protocol.py``), moved into C so the per-frame byte-shuffling
runs with the GIL released and frames are delivered to Python in batches
(one call returning N bodies per wakeup) instead of 2+ ``recv`` calls and
a bytearray dance per frame. Python keeps everything semantic: magic-byte
dispatch, pickle fallback, chaos hooks, handlers.

Every hot entry point is ONE foreign call per wakeup into preallocated,
reusable buffers. The first cut of this wrapper paid 4 ctypes crossings
plus fresh ctypes array TYPES per frame batch (``c_char * total`` with a
varying total allocates a new class, ~10 µs, and grows an unbounded
type cache) — measured SLOWER than the pure-Python loops it replaced.

Three entry points, each gated on the g++-built library (pure-Python
behavior is the fallback, never an error; the reference's kill switches
for the pump are not ported):

  * :func:`reader_pump` — fd-owning blocking pump for ``RpcClient``'s
    reader thread (``None`` when the native path is off);
  * :func:`feed_framer` — feed-mode splitter for the asyncio ``RpcServer``
    (the event loop still owns the socket; native when available, else the
    byte-identical :class:`PyFeedFramer`);
  * :func:`sendv` — iovec scatter-gather ``sendmsg`` with IOV-cap
    continuation for ``RpcClient._send_buffers`` (returns False when the
    native path is off so the caller falls through to Python).
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import List, Optional, Sequence

from .build import load_native_library

_LEN = struct.Struct("<Q")

# Frames per take call (sizes arrays hold one extra slot: the C side
# reports leftover-frame count in sizes[taken]).
_TAKE_CAP = 512
# Initial reusable body buffer; grows by powers of two on demand, so the
# ctypes array-type cache sees a handful of sizes over a process life.
_DST_INIT = 256 * 1024

_SIZES_T = ctypes.c_uint64 * (_TAKE_CAP + 1)


class FrameError(Exception):
    """Protocol violation (oversize frame): the connection must drop."""


_lib = None
_lib_tried = False


def _load():
    """Build+dlopen once; None (cached) when the toolchain is missing."""
    global _lib, _lib_tried
    if not _lib_tried:
        _lib_tried = True
        lib = load_native_library("framepump")
        if lib is not None:
            lib.fp_create.restype = ctypes.c_void_p
            lib.fp_create.argtypes = [ctypes.c_int, ctypes.c_uint64]
            lib.fp_destroy.argtypes = [ctypes.c_void_p]
            lib.fp_pump.restype = ctypes.c_int64
            lib.fp_pump.argtypes = [ctypes.c_void_p]
            lib.fp_feed.restype = ctypes.c_int64
            lib.fp_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_uint64]
            lib.fp_pending_frames.restype = ctypes.c_uint64
            lib.fp_pending_frames.argtypes = [ctypes.c_void_p]
            lib.fp_pending_bytes.restype = ctypes.c_uint64
            lib.fp_pending_bytes.argtypes = [ctypes.c_void_p]
            lib.fp_take.restype = ctypes.c_int64
            lib.fp_take.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_uint64,
                                    ctypes.POINTER(ctypes.c_uint64),
                                    ctypes.c_uint64]
            lib.fp_pump_take.restype = ctypes.c_int64
            lib.fp_pump_take.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_uint64,
                                         ctypes.POINTER(ctypes.c_uint64),
                                         ctypes.c_uint64]
            lib.fp_feed_take.restype = ctypes.c_int64
            lib.fp_feed_take.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_uint64, ctypes.c_void_p,
                                         ctypes.c_uint64,
                                         ctypes.POINTER(ctypes.c_uint64),
                                         ctypes.c_uint64]
            lib.fp_sendv.restype = ctypes.c_int
            lib.fp_sendv.argtypes = [ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_char_p),
                                     ctypes.POINTER(ctypes.c_uint64),
                                     ctypes.c_uint64]
        _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def enabled() -> bool:
    """Whether the native library built and loaded."""
    return native_available()


class _PumpBase:
    """Shared batch-take over one native pump handle. NOT thread-safe:
    one pumping thread per handle, destroy only after it exits."""

    def __init__(self, fd: int, max_message: int):
        lib = _load()
        if lib is None:
            raise ImportError("native framepump library unavailable")
        self._lib = lib
        self._h = lib.fp_create(fd, max_message)
        if not self._h:
            raise MemoryError("framepump allocation failed")
        self._cap = _DST_INIT
        self._dst = ctypes.create_string_buffer(self._cap)
        self._mv = memoryview(self._dst)
        self._sizes = _SIZES_T()
        # Bound foreign functions: the hot methods make exactly one
        # attribute-free call per wakeup.
        self._pump_take = lib.fp_pump_take
        self._feed_take = lib.fp_feed_take

    def _grow(self) -> None:
        """Power-of-two growth toward the buffered bytes (big frames are
        rare — blobs ride the arena — so sizes stay few and cached)."""
        need = int(self._lib.fp_pending_bytes(self._h)) or self._cap * 2
        cap = self._cap
        while cap < need:
            cap *= 2
        self._cap = cap
        self._dst = ctypes.create_string_buffer(cap)
        self._mv = memoryview(self._dst)

    # raylint: hotpath — slices one take's bodies out of the shared buffer
    def _slice(self, n: int, out: List[bytes]) -> List[bytes]:
        mv = self._mv
        sizes = self._sizes
        off = 0
        for i in range(n):
            end = off + sizes[i]
            out.append(bytes(mv[off:end]))
            off = end
        return out

    def _drain_rest(self, out: List[bytes]) -> List[bytes]:
        """Rare overflow path: more frames buffered than one take could
        copy (cap overflow or > _TAKE_CAP frames)."""
        lib, h = self._lib, self._h
        while True:
            n = int(lib.fp_take(h, self._dst, self._cap, self._sizes,
                                _TAKE_CAP))
            if n == -1:  # first frame larger than the buffer
                self._grow()
                continue
            if n <= 0:
                return out
            self._slice(n, out)
            if not lib.fp_pending_frames(h):
                return out

    def close(self) -> None:
        if self._h:
            self._lib.fp_destroy(self._h)
            self._h = None


class NativeReaderPump(_PumpBase):
    """fd mode: the pump does the blocking recv (GIL released) and frame
    split; ``pump()`` returns one batch of frame bodies per wakeup."""

    # raylint: hotpath — the RpcClient reader thread's inner loop
    def pump(self) -> Optional[List[bytes]]:
        """One blocking wakeup: a non-empty batch of frame bodies, or
        None on EOF / socket error / oversize frame (drop the conn,
        matching the Python path)."""
        h = self._h
        if not h:
            return None
        n = self._pump_take(h, self._dst, self._cap, self._sizes,
                            _TAKE_CAP)
        if n >= 0:
            out = self._slice(n, [])
            if self._sizes[n]:
                return self._drain_rest(out)
            return out
        if n == -3:  # frame bigger than the reusable buffer
            self._grow()
            return self._drain_rest([])
        return None

    # fp_pump/fp_take kept callable for tests and diagnostics.


class NativeFeedFramer(_PumpBase):
    """feed mode for the asyncio server: the event loop reads in bulk and
    feeds chunks; complete frames come back per feed."""

    def __init__(self, max_message: int):
        super().__init__(-1, max_message)

    # raylint: hotpath — every inbound server byte funnels through here
    def feed(self, data: bytes) -> List[bytes]:
        h = self._h
        if not h:
            raise FrameError("framer closed")
        n = self._feed_take(h, data, len(data), self._dst, self._cap,
                            self._sizes, _TAKE_CAP)
        if n > 0:
            out = self._slice(n, [])
            if self._sizes[n]:
                return self._drain_rest(out)
            return out
        if n == 0:
            return []
        if n == -3:  # frame bigger than the reusable buffer
            self._grow()
            return self._drain_rest([])
        raise FrameError("message too large")


class PyFeedFramer:
    """Pure-Python twin of :class:`NativeFeedFramer` — byte-identical
    split semantics (the equivalence fuzz in test_wire_codec pins this),
    used when the native library is unavailable or killed."""

    def __init__(self, max_message: int):
        self._buf = bytearray()
        self._max = max_message

    # raylint: hotpath — the fallback server framer
    def feed(self, data: bytes) -> List[bytes]:
        buf = self._buf
        buf += data
        out: List[bytes] = []
        off = 0
        n = len(buf)
        while n - off >= 8:
            (length,) = _LEN.unpack_from(buf, off)
            if length > self._max:
                raise FrameError("message too large")
            if n - off - 8 < length:
                break
            out.append(bytes(buf[off + 8:off + 8 + length]))
            off += 8 + length
        if off:
            del buf[:off]
        return out

    def close(self) -> None:
        self._buf.clear()


def reader_pump(fd: int, max_message: int) -> Optional[NativeReaderPump]:
    """fd-owning pump for a blocking reader thread, or None when the
    native path is off (caller keeps its per-frame Python loop)."""
    if not enabled():
        return None
    try:
        return NativeReaderPump(fd, max_message)
    except (ImportError, MemoryError):
        return None


def feed_framer(max_message: int):
    """Framer for an asyncio bulk-read loop: native when available,
    Python otherwise — the caller never branches."""
    if enabled():
        try:
            return NativeFeedFramer(max_message)
        except (ImportError, MemoryError):
            pass
    return PyFeedFramer(max_message)


# Reusable per-thread sendv scratch: pointer + length arrays built ONCE
# (fresh `(c_char_p * n)(*bufs)` per call re-created ctypes array types
# for every new n). Per-thread because concurrent clients send in
# parallel; each RpcClient serializes its own sends under _wlock.
_SEND_CAP = 1024
_send_tls = threading.local()
# Below this buffer count the pure-Python socket.sendmsg path wins (it
# is C inside CPython and pays no per-call env check, scratch fill, or
# foreign-call overhead; measured crossover ~300-500 on the CI box) —
# sendv declines so the caller falls through. Native absorbs the big
# scatter waves: dispatch fan-outs and coalesced task_done batches.
_SENDV_MIN = 256


# raylint: hotpath — every large scatter wave a client sends funnels here
def sendv(fd: int, bufs: Sequence[bytes]) -> bool:
    """Scatter-gather sendmsg of ``bufs`` over blocking ``fd`` with the
    GIL released and IOV-cap continuation in C. False when the list is
    below the native win threshold or the native path is off (caller
    falls back); OSError on a send failure, matching socket.sendmsg."""
    total = len(bufs)
    if total < _SENDV_MIN:
        return False
    if not enabled():
        return False
    lib = _load()
    scratch = getattr(_send_tls, "arrs", None)
    if scratch is None:
        scratch = _send_tls.arrs = (
            (ctypes.c_char_p * _SEND_CAP)(),
            (ctypes.c_uint64 * _SEND_CAP)())
    ptrs, lens = scratch
    fp_sendv = lib.fp_sendv
    i = 0
    while i < total:
        m = min(total - i, _SEND_CAP)
        for j in range(m):
            b = bufs[i + j]
            if type(b) is not bytes:
                # ctypes c_char_p wants real bytes; encoders only emit
                # bytes today (guards a future bytearray/memoryview buf).
                b = bytes(b)
            ptrs[j] = b
            lens[j] = len(b)
        if fp_sendv(fd, ptrs, lens, m) != 0:
            raise OSError("sendv failed")
        i += m
    return True

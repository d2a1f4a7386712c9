"""Per-owner shared-memory completion ring (the result data plane).

Reference counterpart: plasma's notification socket — the owner learns
*which* objects sealed without scanning the store or polling the directory
(src/ray/object_manager/plasma/store.cc, NotificationListener). Here the
notification carries slightly more: a fixed-size completion record
``(oid, flags, size)`` and, for results at or under
``INLINE_RESULT_MAX`` bytes, the serialized result itself — so the
owner's ``get()`` becomes O(completions-this-wave) ring pops instead of an
O(arena) rescan per wake plus a directory long-poll round trip, and small
results never touch an arena slot at all.

Topology: ONE ring per owner (driver or worker core), created by the owner
and named from its 4-byte job id (``rttr-<jobhex>``), which every return
ObjectID embeds at bytes [12:16] — an executing worker derives the ring
name from the oid alone, no task-spec change. The consumer side is single
(the owner); the publisher side may be several worker processes, serialized
by an ``flock`` on the ring file (microseconds per publish; the kernel
releases the lock if a publisher dies, so a crash can never wedge the
ring). Mirrors the ``_native/channel`` ring discipline: monotonic u64
head/tail counters over a byte ring, records may straddle the wrap point.

Commit protocol (crash safety): a publisher writes the record body first —
CRC-32 commit word over everything after itself — and only then advances
``head``. A publisher dying mid-write leaves ``head`` unmoved (the partial
bytes are invisible and get overwritten); a record that IS visible but
fails its CRC (torn commit word — in practice only reachable through the
``_debug_publish_torn`` test hook or memory corruption) marks the ring
*degraded*: the consumer stops harvesting and the owner falls back to the
RPC/directory path for everything, while a header flag tells publishers to
stop appending. Delivery through the ring is an optimization layered over
the normal registration flow (``task_done_batch`` still carries every
registration), so a degraded or full ring costs latency, never results.

Backpressure: a publisher that cannot fit a record returns False and moves
on — it NEVER blocks the worker; the result still reaches the owner through
the directory.

The reference's kill switch for the ring and its inline and capacity
knobs are not ported: the port uses their defaults below.
"""

from __future__ import annotations

import atexit
import fcntl
import mmap
import os
import struct
import threading
import zlib
from typing import List, Optional, Tuple

ID_LEN = 24  # == ObjectID.SIZE

_MAGIC = 0x52435254  # "TRCR"
_VERSION = 1
_HDR = struct.Struct("<IIQQQB")  # magic, version, capacity, head, tail, degraded
_HDR_SIZE = 64                   # header padded to a cache line
_OFF_HEAD = 16
_OFF_TAIL = 24
_OFF_DEGRADED = 32
_U64 = struct.Struct("<Q")

# Record: commit (crc32 of everything after it), total record length,
# oid, flags, object size, inline payload length; inline bytes follow.
_REC = struct.Struct("<II24sBQI")

FLAG_INLINE = 1

_DEFAULT_CAPACITY = 1 << 20


# Results at or under this many serialized bytes ride inside the completion
# record / ``task_done_batch`` item instead of an arena slot.
INLINE_RESULT_MAX = 4096


def ring_name(job_bytes: bytes) -> str:
    """Ring name for an owner's 4-byte job id (pass ``oid[12:16]`` to
    resolve the owner of a return object)."""
    return f"rttr-{job_bytes.hex()}"


def _ring_dir() -> str:
    if os.path.isdir("/dev/shm"):
        return "/dev/shm"
    import tempfile

    return tempfile.gettempdir()


def ring_path(name: str) -> str:
    return os.path.join(_ring_dir(), name)


class _RingBase:
    """Shared mmap plumbing: wrapped reads/writes over the data region."""

    def __init__(self, fd: int, size: int):
        self._mmap = mmap.mmap(fd, size)
        self.capacity = size - _HDR_SIZE
        self._closed = False

    # -- header cells -------------------------------------------------------
    def _u64(self, off: int) -> int:
        return _U64.unpack_from(self._mmap, off)[0]

    def _set_u64(self, off: int, val: int) -> None:
        _U64.pack_into(self._mmap, off, val)

    @property
    def degraded(self) -> bool:
        return self._closed or self._mmap[_OFF_DEGRADED] != 0

    def has_pending(self) -> bool:
        """Unpopped records exist (racy peek — one mmap read, no lock;
        what the owner's ring-first wait loop watches instead of parking
        on the directory long-poll)."""
        if self._closed:
            return False
        return self._u64(_OFF_HEAD) != self._u64(_OFF_TAIL)

    def _mark_degraded(self) -> None:
        if not self._closed:
            self._mmap[_OFF_DEGRADED] = 1

    # -- wrapped data access ------------------------------------------------
    def _write_at(self, pos: int, data: bytes) -> None:
        """Write into the data region at ring position ``pos`` (monotonic
        counter), wrapping across the capacity boundary."""
        off = pos % self.capacity
        first = min(len(data), self.capacity - off)
        base = _HDR_SIZE + off
        self._mmap[base:base + first] = data[:first]
        if first < len(data):
            self._mmap[_HDR_SIZE:_HDR_SIZE + len(data) - first] = data[first:]

    def _read_at(self, pos: int, n: int) -> bytes:
        off = pos % self.capacity
        first = min(n, self.capacity - off)
        base = _HDR_SIZE + off
        out = self._mmap[base:base + first]
        if first < n:
            out += self._mmap[_HDR_SIZE:_HDR_SIZE + n - first]
        return out

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._mmap.close()
            except (BufferError, ValueError):
                pass


class CompletionRing(_RingBase):
    """Owner (consumer) side: creates the segment, pops records.

    Single consumer by contract; ``pop_all`` is additionally guarded by an
    in-process lock so concurrent ``get()``/``wait()``/resolver threads in
    the owner can share one ring safely.
    """

    def __init__(self, name: str, capacity: int = 0, create: bool = True):
        capacity = capacity or _DEFAULT_CAPACITY
        self.name = name
        self.path = ring_path(name)
        self._owner = create
        self._lock_fd = -1
        size = _HDR_SIZE + capacity
        if create:
            # Liveness sidecar: the owner holds an flock on <ring>.lock
            # for its lifetime (kernel-released even on SIGKILL), so
            # sweep_stale_rings can tell a crashed owner's leftover ring
            # from a live one. Taken BEFORE the ring exists: a ring is
            # never visible without its lock held.
            self._lock_fd = os.open(self.path + ".lock",
                                    os.O_RDWR | os.O_CREAT, 0o600)
            fcntl.flock(self._lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            # A stale segment (4-byte job-id collision with a crashed
            # owner) must not feed us someone else's records.
            try:
                os.unlink(self.path)
            except OSError:
                pass
            fd = os.open(self.path, os.O_RDWR | os.O_CREAT | os.O_EXCL, 0o600)
            try:
                os.ftruncate(fd, size)
                super().__init__(fd, size)
            finally:
                os.close(fd)
            _HDR.pack_into(self._mmap, 0, _MAGIC, _VERSION, capacity, 0, 0, 0)
        else:
            fd = os.open(self.path, os.O_RDWR)
            try:
                size = os.fstat(fd).st_size
                super().__init__(fd, size)
            finally:
                os.close(fd)
            self._check_header()
        self._lock = threading.Lock()
        self.torn_records = 0
        if create:
            atexit.register(self.close)

    def _check_header(self) -> None:
        magic, version, capacity = _HDR.unpack_from(self._mmap, 0)[:3]
        if magic != _MAGIC or version != _VERSION \
                or capacity != self.capacity:
            raise OSError(f"bad completion ring header: {self.path}")

    def pop_all(self, limit: int = 1 << 16
                ) -> List[Tuple[bytes, int, int, Optional[bytes]]]:
        """Drain committed records: [(oid, flags, size, inline|None)].
        A CRC mismatch marks the ring degraded and stops the harvest —
        the caller falls back to the RPC/directory path."""
        out: List[Tuple[bytes, int, int, Optional[bytes]]] = []
        if self._closed:
            return out
        with self._lock:
            if self.degraded:
                return out
            head = self._u64(_OFF_HEAD)
            tail = self._u64(_OFF_TAIL)
            while tail < head and len(out) < limit:
                hdr = self._read_at(tail, _REC.size)
                commit, total, oid, flags, size, inline_len = \
                    _REC.unpack(hdr)
                if (total < _REC.size or total > self.capacity
                        or inline_len != total - _REC.size
                        or tail + total > head):
                    self.torn_records += 1
                    self._mark_degraded()
                    break
                body = self._read_at(tail + 4, total - 4)
                if zlib.crc32(body) != commit:
                    self.torn_records += 1
                    self._mark_degraded()
                    break
                inline = body[_REC.size - 4:] if flags & FLAG_INLINE else None
                out.append((oid, flags, size, inline))
                tail += total
            self._set_u64(_OFF_TAIL, tail)
        return out

    # -- test hook ----------------------------------------------------------
    def _debug_publish_torn(self) -> None:
        """Inject a committed-looking record with a corrupt commit word —
        what a worker dying between the head bump and the body write of a
        hypothetical reserve-first protocol would leave behind. Drives the
        crash-safety test for the degraded-ring fallback."""
        with self._lock:
            head = self._u64(_OFF_HEAD)
            rec = _REC.pack(0xDEADBEEF, _REC.size, b"\0" * ID_LEN, 0, 0, 0)
            self._write_at(head, rec)
            self._set_u64(_OFF_HEAD, head + _REC.size)

    def close(self) -> None:
        if self._closed:
            return
        super().close()
        if self._owner:
            for p in (self.path, self.path + ".lock"):
                try:
                    os.unlink(p)
                except OSError:
                    pass
        if self._lock_fd >= 0:
            try:
                os.close(self._lock_fd)
            except OSError:
                pass
            self._lock_fd = -1


class RingPublisher(_RingBase):
    """Worker (producer) side: opens an owner's ring by name and appends
    completion records. Multiple publisher processes are serialized by an
    flock on the ring file (auto-released by the kernel on death)."""

    def __init__(self, name: str):
        self.name = name
        self.path = ring_path(name)
        self._fd = os.open(self.path, os.O_RDWR)
        try:
            size = os.fstat(self._fd).st_size
            super().__init__(self._fd, size)
        except BaseException:
            os.close(self._fd)
            raise
        magic, version, capacity = _HDR.unpack_from(self._mmap, 0)[:3]
        if magic != _MAGIC or version != _VERSION \
                or capacity != self.capacity:
            self.close()
            raise OSError(f"bad completion ring header: {self.path}")
        self._tlock = threading.Lock()  # flock is per-fd, not per-thread

    def publish(self, oid: bytes, size: int,
                inline: Optional[bytes] = None) -> bool:
        """Append one completion record. Returns False — never blocks on
        ring space — when the ring is full/degraded/closed; the caller's
        result still reaches the owner through the directory path."""
        if self._closed:
            return False
        flags = FLAG_INLINE if inline is not None else 0
        payload = inline or b""
        total = _REC.size + len(payload)
        if total > self.capacity // 4:
            return False  # oversized record: directory path serves it
        body = _REC.pack(0, total, oid, flags, size, len(payload))[4:] \
            + payload
        rec = struct.pack("<I", zlib.crc32(body)) + body
        with self._tlock:
            try:
                fcntl.flock(self._fd, fcntl.LOCK_EX)
            except OSError:
                return False
            try:
                if self.degraded:
                    return False
                head = self._u64(_OFF_HEAD)
                tail = self._u64(_OFF_TAIL)
                if total > self.capacity - (head - tail):
                    return False  # full: backpressure == fall back, not block
                self._write_at(head, rec)
                # Publish AFTER the full body (incl. commit word) is in
                # place: a crash before this line leaves head unmoved and
                # the partial record invisible.
                self._set_u64(_OFF_HEAD, head + total)
                return True
            finally:
                try:
                    fcntl.flock(self._fd, fcntl.LOCK_UN)
                except OSError:
                    pass

    def close(self) -> None:
        if not self._closed:
            super().close()
            try:
                os.close(self._fd)
            except OSError:
                pass


def open_publisher(name: str) -> Optional[RingPublisher]:
    """Open an owner's ring for publishing; None when it doesn't exist on
    this host (cross-host owner, ring disabled, or owner gone)."""
    try:
        return RingPublisher(name)
    except OSError:
        return None


def scan_stale_rings() -> int:
    """Non-destructive twin of :func:`sweep_stale_rings`: count rings whose
    owner's liveness flock has lapsed (dead owner, ~1 MiB tmpfs leaked
    each) WITHOUT unlinking anything. The consistency auditor reports the
    count (an ``audit_stale_ring`` finding); the janitor sweep on the next
    controller start — or an operator running it by hand — reclaims them."""
    stale = 0
    try:
        names = os.listdir(_ring_dir())
    except OSError:
        return 0
    for fn in names:
        if not fn.startswith("rttr-") or fn.endswith(".lock"):
            continue
        lock_path = ring_path(fn) + ".lock"
        try:
            lfd = os.open(lock_path, os.O_RDWR)
        except OSError:
            stale += 1  # no liveness lock at all: pre-lock leftover
            continue
        try:
            try:
                fcntl.flock(lfd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                continue  # owner alive
            fcntl.flock(lfd, fcntl.LOCK_UN)
            stale += 1
        finally:
            os.close(lfd)
    return stale


def sweep_stale_rings() -> int:
    """Janitor: unlink rings whose owner died without close() (SIGKILLed
    worker, crashed driver) — each leaks ~1 MiB of tmpfs otherwise. An
    owner holds an flock on ``<ring>.lock`` for its whole lifetime, so
    winning a non-blocking flock proves the owner is gone; a ring with no
    lock file at all predates its owner's lock (impossible in this
    protocol) or lost it — stale either way. Called on node-controller
    start; safe to run concurrently with live rings and with other
    sweepers (unlink is idempotent, the flock serializes the verdict)."""
    removed = 0
    try:
        names = os.listdir(_ring_dir())
    except OSError:
        return 0
    for fn in names:
        if not fn.startswith("rttr-") or fn.endswith(".lock"):
            continue
        path = ring_path(fn)
        lock_path = path + ".lock"
        try:
            lfd = os.open(lock_path, os.O_RDWR)
        except OSError:
            # No liveness lock: pre-lock leftover. Unlink.
            try:
                os.unlink(path)
                removed += 1
            except OSError:
                pass
            continue
        try:
            try:
                fcntl.flock(lfd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                continue  # owner alive
            for p in (path, lock_path):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            removed += 1
        finally:
            os.close(lfd)
    return removed

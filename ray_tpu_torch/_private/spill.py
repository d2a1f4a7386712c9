"""Object spill-to-disk: graceful degradation under memory pressure.

Reference counterpart: plasma's external-store spill interface
(``plasma/external_store.h``) + quota-aware eviction
(``plasma/quota_aware_policy.cc``). The reference evicts cold objects to an
external store when the shared-memory arena runs out; here the external
store is a directory of checksummed files.

The port's copy of the local half of ``ray_tpu/_private/spill.py``, the part
the local runtime's ``MemoryStore`` uses:

``SpillManager``
    An on-disk object directory. Writes are atomic (tmp file + fsync +
    rename) and checksummed (crc32 in a fixed header), so a crash mid-spill
    can never serve torn bytes: the restart scan drops stray ``.tmp`` files
    and truncated entries, and a checksum mismatch at read time deletes the
    file and reports a miss instead of returning garbage.

``put_backpressure``
    Owner-side bounded wait: a producer whose node is over the spill high
    watermark backs off (exponential, capped total wait) instead of racing
    the spiller — a runaway producer slows down rather than OOM-killing
    the node.

``SpillingStore``, the reference's spill policy around a node's
shared-memory arena, comes with that arena in the cluster runtime (A6 of
ROADMAP.md). Spill directories default to ``<tmpdir>/ray_tpu_torch_spill``,
apart from the JAX package's ``<tmpdir>/ray_tpu_spill``.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional

# File layout: header (magic, crc32 of payload, payload size) + payload.
_MAGIC = b"RTPSPL1\n"
_HEADER = struct.Struct("<8sIQ")


class _SpillMetrics:
    """Lazily-registered spill counters (shared across stores in-process)."""

    _instance: Optional["_SpillMetrics"] = None
    _lock = threading.Lock()

    def __init__(self):
        from ..metrics import Count, Histogram, get_or_create

        self.spilled_bytes = get_or_create(
            Count, "object_store_spilled_bytes",
            description="bytes moved from the arena to the spill directory")
        self.restored_bytes = get_or_create(
            Count, "object_store_restored_bytes",
            description="bytes restored from the spill directory")
        self.spill_latency_ms = get_or_create(
            Histogram, "object_store_spill_latency_ms",
            description="per-object spill write latency",
            boundaries=[0.1, 0.5, 1, 5, 10, 50, 100, 500])
        self.restore_latency_ms = get_or_create(
            Histogram, "object_store_restore_latency_ms",
            description="per-object restore read latency",
            boundaries=[0.1, 0.5, 1, 5, 10, 50, 100, 500])
        self.quota_evictions = get_or_create(
            Count, "object_store_quota_evictions",
            description="objects spilled by per-owner quota enforcement")
        self.backpressure_wait_ms = get_or_create(
            Histogram, "object_put_backpressure_wait_ms",
            description="producer-side bounded wait under memory pressure",
            boundaries=[1, 5, 10, 50, 100, 500, 1000, 5000])

    @classmethod
    def get(cls) -> "_SpillMetrics":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance


class SpillManager:
    """Crash-safe on-disk object directory (the external store).

    One file per object (``<oid hex>.obj``), written atomically and
    checksummed. Safe for concurrent use from multiple threads of one
    process; multi-process coordination is the caller's job (each node
    store owns its own directory).
    """

    def __init__(self, spill_dir: str):
        self.dir = spill_dir
        os.makedirs(spill_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._index: Dict[bytes, int] = {}  # oid -> payload size
        self._scan()

    # ------------------------------------------------------------------ paths
    def _path(self, oid: bytes) -> str:
        return os.path.join(self.dir, oid.hex() + ".obj")

    def _scan(self) -> None:
        """Restart scan: index valid entries, drop torn/stray files. Run at
        construction so a crashed node's spilled objects survive a restart
        of its controller (the directory outlives the arena)."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return
        for name in names:
            path = os.path.join(self.dir, name)
            if name.endswith(".tmp"):
                # A writer died mid-spill; the object was still in the
                # arena when this was being written, so the file is pure
                # garbage — never a lost copy.
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            if not name.endswith(".obj"):
                continue
            try:
                with open(path, "rb") as f:
                    hdr = f.read(_HEADER.size)
                magic, _crc, size = _HEADER.unpack(hdr)
                if magic != _MAGIC:
                    raise ValueError("bad magic")
                if os.path.getsize(path) != _HEADER.size + size:
                    raise ValueError("truncated")
                self._index[bytes.fromhex(name[:-4])] = size
            except (OSError, ValueError, struct.error):
                try:
                    os.unlink(path)
                except OSError:
                    pass

    # ------------------------------------------------------------------- ops
    def write(self, oid: bytes, data) -> int:
        """Atomically persist one object; returns payload bytes written.
        Idempotent: an existing entry is kept (objects are immutable)."""
        if not isinstance(data, (bytes, bytearray)):
            data = bytes(data)
        with self._lock:
            if oid in self._index:
                return self._index[oid]
        t0 = time.monotonic()
        path = self._path(oid)
        tmp = f"{path}.{os.getpid()}.tmp"
        header = _HEADER.pack(_MAGIC, zlib.crc32(data) & 0xFFFFFFFF,
                              len(data))
        with open(tmp, "wb") as f:
            f.write(header)
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        with self._lock:
            self._index[oid] = len(data)
        m = _SpillMetrics.get()
        m.spilled_bytes.record(len(data))
        m.spill_latency_ms.record((time.monotonic() - t0) * 1000.0)
        return len(data)

    def read(self, oid: bytes) -> Optional[bytes]:
        """Read + verify one object; a checksum mismatch deletes the entry
        and reports a miss (torn copies must never be served)."""
        t0 = time.monotonic()
        try:
            with open(self._path(oid), "rb") as f:
                hdr = f.read(_HEADER.size)
                magic, crc, size = _HEADER.unpack(hdr)
                if magic != _MAGIC:
                    raise ValueError("bad magic")
                data = f.read(size)
        except (OSError, ValueError, struct.error):
            return None
        if len(data) != size or (zlib.crc32(data) & 0xFFFFFFFF) != crc:
            self.delete(oid)
            return None
        m = _SpillMetrics.get()
        m.restored_bytes.record(len(data))
        m.restore_latency_ms.record((time.monotonic() - t0) * 1000.0)
        return data

    def contains(self, oid: bytes) -> bool:
        with self._lock:
            return oid in self._index

    def delete(self, oid: bytes) -> None:
        with self._lock:
            self._index.pop(oid, None)
        try:
            os.unlink(self._path(oid))
        except OSError:
            pass

    def ids(self) -> List[bytes]:
        with self._lock:
            return list(self._index)

    @property
    def spilled_bytes(self) -> int:
        with self._lock:
            return sum(self._index.values())

    @property
    def num_objects(self) -> int:
        with self._lock:
            return len(self._index)

    def size_of(self, oid: bytes) -> Optional[int]:
        with self._lock:
            return self._index.get(oid)

    def close(self, remove: bool = True) -> None:
        """Normal shutdown removes the directory; crash paths skip this so
        the restart scan can recover the entries."""
        if not remove:
            return
        with self._lock:
            ids, self._index = list(self._index), {}
        for oid in ids:
            try:
                os.unlink(self._path(oid))
            except OSError:
                pass
        try:
            os.rmdir(self.dir)
        except OSError:
            pass  # non-empty (foreign files) or already gone


def resolve_spill_dir(config, store_name: str) -> Optional[str]:
    """The per-store spill directory for this config, or None when spill is
    disabled. Layout:
    <object_spill_dir or $TMPDIR/ray_tpu_torch_spill>/<store>."""
    import tempfile

    if not getattr(config, "object_spill_enabled", False):
        return None
    base = getattr(config, "object_spill_dir", "") or os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch_spill")
    return os.path.join(base, store_name)


def put_backpressure(stats_fn: Callable[[], Dict[str, int]], nbytes: int,
                     high_watermark: float = 0.85,
                     max_wait_s: float = 2.0) -> float:
    """Owner-side bounded wait: while the arena is over its high watermark,
    back off (2 ms doubling to 250 ms) up to ``max_wait_s`` total, giving
    the node's spiller time to make room. Returns seconds waited. Never
    blocks forever — after the bound the put proceeds and the store-side
    spill path absorbs it."""
    waited = 0.0
    delay = 0.002
    while True:
        try:
            st = stats_fn()
        except Exception:  # noqa: BLE001 - stats must never fail a put
            break
        cap = st.get("capacity") or st.get("arena_bytes") or 0
        if cap <= 0 or st.get("used_bytes", 0) + nbytes <= cap * high_watermark:
            break
        if waited >= max_wait_s:
            break
        step = min(delay, max_wait_s - waited)
        time.sleep(step)
        waited += step
        delay = min(delay * 2, 0.25)
    if waited > 0:
        _SpillMetrics.get().backpressure_wait_ms.record(waited * 1000.0)
    return waited

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

``SpillingStore``
    Wraps a node's arena (``ShmObjectStore`` or ``PyObjectStore``) with the
    spill policy: puts that would push the arena over its high watermark
    first spill cold **unpinned sealed** objects (LRU by last wrapper
    access) down to the low watermark; objects that cannot fit even then go
    straight to disk. ``get()`` is arena-first, disk-second — a disk hit is
    transparently restored into the arena (making room the same way) so hot
    objects migrate back. Per-owner byte quotas evict LRU-within-owner.
    The cluster's node controllers use it; the copy of the reference's is
    whole.

Spill directories default to ``<tmpdir>/ray_tpu_torch_spill/<store>``,
apart from the JAX package's.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional

from .._native.shm_store import PinnedBuffer, StoreFullError, _pad_id

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


class _DiskBufferReleaser:
    """Release target for buffers served straight from the spill disk:
    drops only the wrapper's pin, never the arena's — forwarding to the
    arena could steal a pin the arena took for a DIFFERENT reader if the
    object was restored between the disk read and this release."""

    __slots__ = ("wrapper",)

    def __init__(self, wrapper: "SpillingStore"):
        self.wrapper = wrapper

    def _release(self, object_id: bytes) -> None:
        self.wrapper._drop_pin(object_id)


class SpillingStore:
    """Arena + spill policy with the ShmObjectStore interface (put/create/
    seal/get/..., plus owner tags and watermark maintenance)."""

    def __init__(self, base, spill: SpillManager,
                 high_watermark: float = 0.85, low_watermark: float = 0.60,
                 owner_quota: int = 0):
        self.base = base
        self.spill = spill
        self.name = getattr(base, "name", "")
        self.high_watermark = high_watermark
        self.low_watermark = low_watermark
        self.owner_quota = owner_quota
        self._lock = threading.RLock()
        # Policy state for objects that went THROUGH this wrapper. Foreign
        # arena objects (same-host workers write zero-copy) are visible via
        # base.list_ids() and get spilled as coldest-unknown candidates.
        self._meta: Dict[bytes, Dict] = {}  # oid -> {owner,size,used,sealed}
        self._pins: Dict[bytes, int] = {}
        self._owner_bytes: Dict[str, int] = {}
        self._staging: Dict[bytes, bytearray] = {}
        self._clock = 0
        self._num_spills = 0
        self._num_restores = 0
        self._quota_evictions = 0
        self._disk_releaser = _DiskBufferReleaser(self)
        self.on_spill: Optional[Callable[[bytes, int], None]] = None
        self.on_restore: Optional[Callable[[bytes, int], None]] = None

    def set_spill_callbacks(self, on_spill=None, on_restore=None) -> None:
        self.on_spill = on_spill
        self.on_restore = on_restore

    # ------------------------------------------------------------- accounting
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _track(self, oid: bytes, size: int, owner: Optional[str],
               sealed: bool) -> None:
        with self._lock:
            self._meta[oid] = {"owner": owner, "size": size,
                               "used": self._tick(), "sealed": sealed}
            if owner:
                self._owner_bytes[owner] = (
                    self._owner_bytes.get(owner, 0) + size)

    def _untrack(self, oid: bytes) -> None:
        with self._lock:
            meta = self._meta.pop(oid, None)
            if meta and meta.get("owner"):
                owner = meta["owner"]
                left = self._owner_bytes.get(owner, 0) - meta["size"]
                if left > 0:
                    self._owner_bytes[owner] = left
                else:
                    self._owner_bytes.pop(owner, None)

    def _touch(self, oid: bytes) -> None:
        with self._lock:
            meta = self._meta.get(oid)
            if meta is not None:
                meta["used"] = self._tick()

    # ------------------------------------------------------------ spill policy
    def _capacity(self) -> int:
        st = self.base.stats()
        return st.get("capacity") or st.get("arena_bytes") or 0

    def _used(self) -> int:
        return self.base.stats().get("used_bytes", 0)

    def _victims(self, exclude=()) -> List[bytes]:
        """Spill candidates, coldest first: foreign arena objects (unknown
        recency — treated coldest), then wrapper-tracked sealed unpinned
        objects by LRU. Wrapper-pinned objects are NEVER candidates."""
        with self._lock:
            known = []
            for oid, meta in self._meta.items():
                if oid in exclude or not meta["sealed"]:
                    continue
                if self._pins.get(oid, 0) > 0:
                    continue
                known.append((meta["used"], oid))
            known.sort()
            tracked = set(self._meta)
        foreign = [oid for oid in self.base.list_ids()
                   if oid not in tracked and oid not in exclude]
        return foreign + [oid for _, oid in known]

    def _spill_one(self, oid: bytes, quota: bool = False) -> int:
        """Copy one arena object to disk and drop its arena bytes. Returns
        bytes reclaimed (0 = skipped: unsealed, vanished, or natively
        pinned so the delete deferred)."""
        blob = self.base.get_bytes(oid)
        if blob is None:
            return 0
        self.spill.write(oid, blob)
        self.base.delete(oid)
        if self.base.contains(oid):
            # A reader in another process holds a native pin: the delete
            # deferred, so no bytes came back yet. The disk copy is still
            # correct (objects are immutable) and will serve gets once the
            # arena copy goes.
            reclaimed = 0
        else:
            reclaimed = len(blob)
        self._untrack(oid)
        with self._lock:
            self._num_spills += 1
            if quota:
                self._quota_evictions += 1
        if quota:
            _SpillMetrics.get().quota_evictions.record(1)
        if self.on_spill is not None:
            try:
                self.on_spill(oid, len(blob))
            except Exception:  # noqa: BLE001 - telemetry must not fail puts
                pass
        return reclaimed

    def _make_room(self, need: int, exclude=()) -> None:
        """Spill cold objects until ``need`` more bytes fit under the high
        watermark (aiming for the low watermark so puts don't re-trigger
        immediately). Best-effort: stops when out of candidates."""
        cap = self._capacity()
        if cap <= 0:
            return
        # Aim low, but never demand more room than the arena has.
        target = min(int(cap * self.low_watermark),
                     max(0, cap - need - (need // 16) - 4096))
        if self._used() + need <= cap * self.high_watermark:
            return
        for oid in self._victims(exclude=exclude):
            self._spill_one(oid)
            if self._used() <= target:
                break

    def maybe_spill(self) -> int:
        """Watermark maintenance: spill down to the low watermark when the
        arena is above the high one. Called periodically by the controller
        so direct (wrapper-bypassing) writers keep finding headroom instead
        of triggering the native evictor. Returns objects spilled."""
        cap = self._capacity()
        if cap <= 0 or self._used() <= cap * self.high_watermark:
            return 0
        before = self._num_spills
        target = int(cap * self.low_watermark)
        for oid in self._victims():
            self._spill_one(oid)
            if self._used() <= target:
                break
        return self._num_spills - before

    def _enforce_quota(self, owner: Optional[str], exclude=()) -> None:
        if not owner or not self.owner_quota:
            return
        while self._owner_bytes.get(owner, 0) > self.owner_quota:
            with self._lock:
                candidates = sorted(
                    (meta["used"], oid)
                    for oid, meta in self._meta.items()
                    if meta.get("owner") == owner and meta["sealed"]
                    and oid not in exclude
                    and self._pins.get(oid, 0) == 0)
            for _, oid in candidates:
                if self._spill_one(oid, quota=True):
                    break
            else:
                return  # everything left is pinned/unsealed: give up

    # ---------------------------------------------------------------- write
    def put(self, object_id: bytes, data, owner: Optional[str] = None) -> bool:
        oid = _pad_id(object_id)
        if self.spill.contains(oid) or self.base.contains(oid):
            return False  # immutable double-put is a no-op
        if not isinstance(data, (bytes, bytearray)):
            data = bytes(memoryview(data).cast("B"))
        size = len(data)
        # Proactively make room so base.put never reaches the native
        # evictor (which DROPS bytes instead of spilling them).
        self._make_room(size, exclude=(oid,))
        try:
            created = self.base.put(oid, data)
        except StoreFullError:
            # Cannot fit even after spilling (oversized, or all pinned):
            # the object itself goes to disk — degradation, not failure.
            self.spill.write(oid, data)
            with self._lock:
                self._num_spills += 1
            if self.on_spill is not None:
                try:
                    self.on_spill(oid, size)
                except Exception:  # noqa: BLE001
                    pass
            return True
        if created:
            self._track(oid, size, owner, sealed=True)
            self._enforce_quota(owner, exclude=(oid,))
        return created

    def create(self, object_id: bytes, size: int,
               owner: Optional[str] = None) -> Optional[memoryview]:
        oid = _pad_id(object_id)
        if self.spill.contains(oid):
            return None
        self._make_room(size, exclude=(oid,))
        try:
            view = self.base.create(oid, size)
        except StoreFullError:
            # Stage off-arena; seal() spills it.
            buf = bytearray(size)
            with self._lock:
                self._staging[oid] = buf
            return memoryview(buf)
        if view is not None:
            self._track(oid, size, owner, sealed=False)
        return view

    def seal(self, object_id: bytes) -> None:
        oid = _pad_id(object_id)
        with self._lock:
            staged = self._staging.pop(oid, None)
        if staged is not None:
            self.spill.write(oid, bytes(staged))
            with self._lock:
                self._num_spills += 1
            if self.on_spill is not None:
                try:
                    self.on_spill(oid, len(staged))
                except Exception:  # noqa: BLE001
                    pass
            return
        try:
            self.base.seal(oid)
        except StoreFullError:
            # PyObjectStore defers its arena charge to seal time; make room
            # and retry once, then fall back to its staged bytes.
            self._make_room(0, exclude=(oid,))
            try:
                self.base.seal(oid)
            except StoreFullError:
                staged = getattr(self.base, "_staging", None)
                if staged and staged[0] == oid:
                    self.spill.write(oid, bytes(staged[1]))
                    self.base.abort(oid)
                return
        with self._lock:
            meta = self._meta.get(oid)
            owner = meta.get("owner") if meta else None
            if meta is not None:
                meta["sealed"] = True
        self._enforce_quota(owner, exclude=(oid,))

    def abort(self, object_id: bytes) -> None:
        oid = _pad_id(object_id)
        with self._lock:
            if self._staging.pop(oid, None) is not None:
                return
        self._untrack(oid)
        self.base.abort(oid)

    # ----------------------------------------------------------------- read
    def get(self, object_id: bytes) -> Optional[PinnedBuffer]:
        oid = _pad_id(object_id)
        buf = self.base.get(oid)
        if buf is not None:
            self._touch(oid)
            with self._lock:
                self._pins[oid] = self._pins.get(oid, 0) + 1
            # Reroute release through this wrapper so pin accounting (the
            # never-spill-pinned invariant) sees it.
            buf.store = self
            return buf
        data = self._restore(oid)
        if data is None:
            return None
        buf = self.base.get(oid)
        if buf is not None:  # restored into the arena
            self._touch(oid)
            with self._lock:
                self._pins[oid] = self._pins.get(oid, 0) + 1
            buf.store = self
            return buf
        # Arena had no room (all pinned): serve the disk bytes directly.
        with self._lock:
            self._pins[oid] = self._pins.get(oid, 0) + 1
        return PinnedBuffer(self._disk_releaser, oid, memoryview(data))

    def _restore(self, oid: bytes) -> Optional[bytes]:
        """Disk-second half of get(): read + verify, then migrate back into
        the arena when it fits (making room by spilling colder objects)."""
        data = self.spill.read(oid)
        if data is None:
            return None
        self._make_room(len(data), exclude=(oid,))
        try:
            if self.base.put(oid, data):
                self._track(oid, len(data), None, sealed=True)
                self.spill.delete(oid)
                with self._lock:
                    self._num_restores += 1
                if self.on_restore is not None:
                    try:
                        self.on_restore(oid, len(data))
                    except Exception:  # noqa: BLE001
                        pass
        except StoreFullError:
            pass  # serve from the disk copy; it stays authoritative
        return data

    def get_bytes(self, object_id: bytes) -> Optional[bytes]:
        buf = self.get(object_id)
        if buf is None:
            return None
        try:
            return buf.tobytes()
        finally:
            buf.release()

    def contains(self, object_id: bytes) -> bool:
        oid = _pad_id(object_id)
        return self.base.contains(oid) or self.spill.contains(oid)

    def in_arena(self, object_id: bytes) -> bool:
        return self.base.contains(_pad_id(object_id))

    def is_spilled(self, object_id: bytes) -> bool:
        return self.spill.contains(_pad_id(object_id))

    def _drop_pin(self, object_id: bytes) -> None:
        oid = _pad_id(object_id)
        with self._lock:
            n = self._pins.get(oid, 0)
            if n > 1:
                self._pins[oid] = n - 1
            else:
                self._pins.pop(oid, None)

    def _release(self, object_id: bytes) -> None:
        """Release of an arena-backed buffer handed out by get()."""
        oid = _pad_id(object_id)
        self._drop_pin(oid)
        self.base._release(oid)

    # --------------------------------------------------------------- manage
    def delete(self, object_id: bytes) -> None:
        oid = _pad_id(object_id)
        self._untrack(oid)
        self.base.delete(oid)
        self.spill.delete(oid)

    def list_ids(self, max_ids: int = 1 << 16) -> List[bytes]:
        ids = self.base.list_ids(max_ids)
        seen = set(ids)
        for oid in self.spill.ids():
            if oid not in seen and len(ids) < max_ids:
                ids.append(oid)
        return ids

    def stats(self) -> Dict[str, int]:
        st = self.base.stats()
        with self._lock:
            st.update({
                "spilled_bytes": self.spill.spilled_bytes,
                "spilled_objects": self.spill.num_objects,
                "num_spills": self._num_spills,
                "num_restores": self._num_restores,
                "quota_evictions": self._quota_evictions,
            })
        return st

    def close(self) -> None:
        self.base.close()
        self.spill.close(remove=True)


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

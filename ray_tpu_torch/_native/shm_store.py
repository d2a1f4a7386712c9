"""Python view of the C++ shared-memory object store.

Zero-copy contract: the C++ library (shm_store.cc) owns layout, locking and
eviction; this wrapper keeps its *own* mmap of the same ``/dev/shm`` segment
and turns the offsets the library returns into memoryviews, so neither puts
nor gets copy object bytes through a socket or the allocator.

Reference counterpart: plasma client API
(src/ray/object_manager/plasma/client.h) — create/seal/get/release/delete
with pinned buffers; here a `get` returns a context-managed pinned view.

Falls back to `PyObjectStore` (same interface, plain dicts, single-process)
when the native library cannot be built.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import threading
from typing import Dict, List, Optional

from .build import load_native_library

ID_LEN = 24  # == ObjectID.SIZE

_OK = 0
_NOT_FOUND = -1
_OOM = -2
_NOT_SEALED = -3
_EXISTS = -4
_IN_USE = -5


class StoreFullError(Exception):
    """The arena cannot fit the object even after evicting everything idle."""


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u64 = ctypes.c_uint64
    p_u64 = ctypes.POINTER(u64)
    buf = ctypes.c_char_p
    lib.tps_create.restype = ctypes.c_void_p
    lib.tps_create.argtypes = [ctypes.c_char_p, u64]
    lib.tps_open.restype = ctypes.c_void_p
    lib.tps_open.argtypes = [ctypes.c_char_p]
    lib.tps_close.argtypes = [ctypes.c_void_p]
    lib.tps_unlink.argtypes = [ctypes.c_char_p]
    lib.tps_create_obj.argtypes = [ctypes.c_void_p, buf, u64, p_u64]
    lib.tps_seal.argtypes = [ctypes.c_void_p, buf]
    lib.tps_abort.argtypes = [ctypes.c_void_p, buf]
    lib.tps_put.argtypes = [ctypes.c_void_p, buf, ctypes.c_char_p, u64]
    lib.tps_get.argtypes = [ctypes.c_void_p, buf, p_u64, p_u64]
    lib.tps_release.argtypes = [ctypes.c_void_p, buf]
    lib.tps_contains.argtypes = [ctypes.c_void_p, buf]
    lib.tps_delete.argtypes = [ctypes.c_void_p, buf]
    lib.tps_stats.argtypes = [ctypes.c_void_p, p_u64]
    lib.tps_list.restype = ctypes.c_int
    lib.tps_list.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    return lib


def _pad_id(object_id: bytes) -> bytes:
    if len(object_id) == ID_LEN:
        return object_id
    return object_id[:ID_LEN].ljust(ID_LEN, b"\0")


class PinnedBuffer:
    """A pinned, zero-copy view of a sealed object. Use as a context manager
    (or call .release()) so eviction/delete can reclaim the space."""

    __slots__ = ("store", "object_id", "view", "_released")

    def __init__(self, store: "ShmObjectStore", object_id: bytes,
                 view: memoryview):
        self.store = store
        self.object_id = object_id
        self.view = view
        self._released = False

    def __enter__(self) -> memoryview:
        return self.view

    def __exit__(self, *exc) -> None:
        self.release()

    def release(self) -> None:
        if not self._released:
            self._released = True
            self.view.release()
            self.store._release(self.object_id)

    def tobytes(self) -> bytes:
        return bytes(self.view)

    def __len__(self) -> int:
        return len(self.view)


class ShmObjectStore:
    """One node's shared-memory object arena (create via create=True once per
    node; workers attach with create=False)."""

    def __init__(self, name: str, capacity: int = 0, create: bool = False):
        lib = load_native_library("shm_store")
        if lib is None:
            raise OSError("native shm_store library unavailable")
        self._lib = _bind(lib)
        self.name = name
        self._owner = create
        cname = name.encode()
        if create:
            self._handle = self._lib.tps_create(cname, capacity)
        else:
            self._handle = self._lib.tps_open(cname)
        if not self._handle:
            raise OSError(f"could not {'create' if create else 'open'} "
                          f"shm store {name!r}")
        # Private mapping of the same segment for zero-copy views.
        fd = os.open(f"/dev/shm/{name}", os.O_RDWR)
        try:
            size = os.fstat(fd).st_size
            self._mmap = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self._mv = memoryview(self._mmap)
        self._lock = threading.Lock()
        self._closed = False

    # -- write ----------------------------------------------------------------
    def put(self, object_id: bytes, data) -> bool:
        """Stores an immutable object. Returns False if it already exists.
        Raises StoreFullError when the arena can't fit it."""
        object_id = _pad_id(object_id)
        data = memoryview(data).cast("B") if not isinstance(data, bytes) else data
        size = len(data)
        off = ctypes.c_uint64()
        rc = self._lib.tps_create_obj(self._handle, object_id, size,
                                      ctypes.byref(off))
        if rc == _EXISTS:
            return False
        if rc == _OOM:
            raise StoreFullError(
                f"object of {size} bytes does not fit in store {self.name!r}")
        if rc != _OK:
            raise OSError(f"create_obj failed: rc={rc}")
        self._mv[off.value:off.value + size] = data
        self._lib.tps_seal(self._handle, object_id)
        return True

    def create(self, object_id: bytes, size: int) -> Optional[memoryview]:
        """Two-phase create: returns a writable view (or None if the object
        exists); caller fills it and calls seal()."""
        object_id = _pad_id(object_id)
        off = ctypes.c_uint64()
        rc = self._lib.tps_create_obj(self._handle, object_id, size,
                                      ctypes.byref(off))
        if rc == _EXISTS:
            return None
        if rc == _OOM:
            raise StoreFullError(
                f"object of {size} bytes does not fit in store {self.name!r}")
        if rc != _OK:
            raise OSError(f"create_obj failed: rc={rc}")
        return self._mv[off.value:off.value + size]

    def seal(self, object_id: bytes) -> None:
        self._lib.tps_seal(self._handle, _pad_id(object_id))

    def abort(self, object_id: bytes) -> None:
        self._lib.tps_abort(self._handle, _pad_id(object_id))

    # -- read -----------------------------------------------------------------
    def get(self, object_id: bytes) -> Optional[PinnedBuffer]:
        """Returns a pinned zero-copy buffer, or None if absent/unsealed."""
        object_id = _pad_id(object_id)
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.tps_get(self._handle, object_id, ctypes.byref(off),
                               ctypes.byref(size))
        if rc in (_NOT_FOUND, _NOT_SEALED):
            return None
        if rc != _OK:
            raise OSError(f"get failed: rc={rc}")
        view = self._mv[off.value:off.value + size.value]
        return PinnedBuffer(self, object_id, view)

    def get_bytes(self, object_id: bytes) -> Optional[bytes]:
        buf = self.get(object_id)
        if buf is None:
            return None
        try:
            return buf.tobytes()
        finally:
            buf.release()

    def get_bytes_many(self, object_ids) -> Dict[bytes, bytes]:
        """Batched probe: {id: bytes} for every sealed id found. One pair
        of reused ctypes out-params across the whole loop — the per-call
        marshalling allocations dominated large miss-heavy scans (a 5k-ref
        driver harvest probes every pending id per wake)."""
        out: Dict[bytes, bytes] = {}
        lib, handle, mv = self._lib, self._handle, self._mv
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        boff, bsize = ctypes.byref(off), ctypes.byref(size)
        for oid in object_ids:
            pid = _pad_id(oid)
            rc = lib.tps_get(handle, pid, boff, bsize)
            if rc in (_NOT_FOUND, _NOT_SEALED):
                continue
            if rc != _OK:
                raise OSError(f"get failed: rc={rc}")
            try:
                out[oid] = bytes(mv[off.value:off.value + size.value])
            finally:
                lib.tps_release(handle, pid)
        return out

    def contains(self, object_id: bytes) -> bool:
        return self._lib.tps_contains(self._handle, _pad_id(object_id)) == 1

    def _release(self, object_id: bytes) -> None:
        if not self._closed:
            self._lib.tps_release(self._handle, object_id)

    # -- manage ---------------------------------------------------------------
    def delete(self, object_id: bytes) -> None:
        self._lib.tps_delete(self._handle, _pad_id(object_id))

    def list_ids(self, max_ids: int = 1 << 16) -> List[bytes]:
        out = ctypes.create_string_buffer(max_ids * ID_LEN)
        n = self._lib.tps_list(self._handle, out, max_ids)
        raw = out.raw
        return [raw[i * ID_LEN:(i + 1) * ID_LEN] for i in range(max(n, 0))]

    def stats(self) -> Dict[str, int]:
        arr = (ctypes.c_uint64 * 6)()
        self._lib.tps_stats(self._handle, arr)
        return {
            "num_objects": arr[0], "used_bytes": arr[1],
            "arena_bytes": arr[2], "num_evictions": arr[3],
            "table_slots": arr[4], "capacity": arr[5],
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._mv.release()
        self._mmap.close()
        self._lib.tps_close(self._handle)
        self._handle = None
        if self._owner:
            self._lib.tps_unlink(self.name.encode())

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


class PyObjectStore:
    """Pure-Python fallback with the ShmObjectStore interface (one process,
    no sharing — used only when the native build is impossible)."""

    def __init__(self, name: str, capacity: int = 0, create: bool = True):
        self.name = name
        self.capacity = capacity or (1 << 30)
        self._objects: Dict[bytes, bytes] = {}
        self._pins: Dict[bytes, int] = {}
        self._order: List[bytes] = []
        self._used = 0
        self._evictions = 0
        self._lock = threading.Lock()

    def put(self, object_id: bytes, data) -> bool:
        object_id = _pad_id(object_id)
        data = bytes(data)
        with self._lock:
            if object_id in self._objects:
                return False
            while self._used + len(data) > self.capacity:
                victim = next((oid for oid in self._order
                               if not self._pins.get(oid)), None)
                if victim is None:
                    raise StoreFullError(f"{len(data)} bytes do not fit")
                self._order.remove(victim)
                self._used -= len(self._objects.pop(victim))
                self._evictions += 1
            self._objects[object_id] = data
            self._order.append(object_id)
            self._used += len(data)
            return True

    def create(self, object_id: bytes, size: int) -> Optional[memoryview]:
        object_id = _pad_id(object_id)
        with self._lock:
            if object_id in self._objects:
                return None
        buf = bytearray(size)
        self._staging = (object_id, buf)
        return memoryview(buf)

    def seal(self, object_id: bytes) -> None:
        object_id = _pad_id(object_id)
        staged = getattr(self, "_staging", None)
        if staged and staged[0] == object_id:
            self.put(object_id, bytes(staged[1]))
            self._staging = None

    def abort(self, object_id: bytes) -> None:
        self._staging = None

    def get(self, object_id: bytes) -> Optional[PinnedBuffer]:
        object_id = _pad_id(object_id)
        with self._lock:
            data = self._objects.get(object_id)
            if data is None:
                return None
            self._pins[object_id] = self._pins.get(object_id, 0) + 1
        return PinnedBuffer(self, object_id, memoryview(data))

    def get_bytes(self, object_id: bytes) -> Optional[bytes]:
        buf = self.get(object_id)
        if buf is None:
            return None
        try:
            return buf.tobytes()
        finally:
            buf.release()

    def get_bytes_many(self, object_ids) -> Dict[bytes, bytes]:
        """Batched probe (interface parity with ShmObjectStore)."""
        out: Dict[bytes, bytes] = {}
        with self._lock:
            for oid in object_ids:
                data = self._objects.get(_pad_id(oid))
                if data is not None:
                    out[oid] = data
        return out

    def contains(self, object_id: bytes) -> bool:
        with self._lock:
            return _pad_id(object_id) in self._objects

    def _release(self, object_id: bytes) -> None:
        with self._lock:
            n = self._pins.get(object_id, 0)
            if n > 1:
                self._pins[object_id] = n - 1
            else:
                self._pins.pop(object_id, None)

    def delete(self, object_id: bytes) -> None:
        object_id = _pad_id(object_id)
        with self._lock:
            data = self._objects.pop(object_id, None)
            if data is not None:
                self._order.remove(object_id)
                self._used -= len(data)

    def list_ids(self, max_ids: int = 1 << 16) -> List[bytes]:
        with self._lock:
            return list(self._objects)[:max_ids]

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "num_objects": len(self._objects), "used_bytes": self._used,
                "arena_bytes": self.capacity, "num_evictions": self._evictions,
                "table_slots": 0, "capacity": self.capacity,
            }

    def close(self) -> None:
        self._objects.clear()


def create_store(name: str, capacity: int, spill_dir: Optional[str] = None,
                 high_watermark: float = 0.85, low_watermark: float = 0.60,
                 owner_quota: int = 0):
    """Creates a node store, preferring the native arena. With a
    ``spill_dir`` the store is wrapped in the spill policy
    (``_private/spill.SpillingStore``): memory pressure spills cold objects
    to disk instead of surfacing StoreFullError."""
    try:
        base = ShmObjectStore(name, capacity, create=True)
    except OSError:
        base = PyObjectStore(name, capacity)
    if spill_dir:
        from .._private.spill import SpillingStore, SpillManager

        try:
            return SpillingStore(base, SpillManager(spill_dir),
                                 high_watermark=high_watermark,
                                 low_watermark=low_watermark,
                                 owner_quota=owner_quota)
        except OSError:
            return base  # unwritable spill dir: degrade to arena-only
    return base


def open_store(name: str):
    """Attaches to an existing node store; None if unavailable (caller then
    falls back to RPC fetches)."""
    try:
        return ShmObjectStore(name, create=False)
    except OSError:
        return None

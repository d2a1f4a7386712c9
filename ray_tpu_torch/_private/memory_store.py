"""In-process object store.

Plays the role of the reference's ``CoreWorkerMemoryStore`` (reference:
``src/ray/core_worker/store_provider/memory_store/``) for the local runtime:
immutable objects keyed by ObjectID, blocking gets with timeout, async
listeners used by the dependency manager, LRU-ish accounting against a byte
budget. In the cluster backend the same interface fronts the shared-memory
arena (ray_tpu_torch/cluster), so callers never care which plane an object is on.

The port's copy of ``ray_tpu/_private/memory_store.py``. It holds each value
itself, a CUDA tensor too, so ``put`` and ``get`` never copy one. A spilled
value is pickled with cloudpickle and comes back through ``pickle.loads``:
a tensor through torch's own storage reduction, on the device it left, with
its bits.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..exceptions import GetTimeoutError, ObjectStoreFullError
from .ids import ObjectID


class StoredObject:
    """One immutable stored value.

    ``value`` is the in-process deserialized object (stored once; callers must
    not mutate — same contract as plasma's immutable buffers). ``error`` holds
    a TaskError/ActorError to re-raise at get().
    """

    __slots__ = ("value", "error", "nbytes", "created_at")

    def __init__(self, value: Any = None, error: Optional[BaseException] = None,
                 nbytes: int = 0):
        self.value = value
        self.error = error
        self.nbytes = nbytes
        self.created_at = time.monotonic()


class MemoryStore:
    def __init__(self, max_bytes: int = 0, spiller=None):
        """``spiller``: an optional ``_private.spill.SpillManager``. With
        one attached, puts over budget spill the oldest picklable values to
        disk (same graceful-degradation contract as the shared-memory
        arena's SpillingStore) instead of raising ObjectStoreFullError;
        gets transparently restore. Error objects and values that fail to
        pickle stay resident (the budget is best-effort for them)."""
        self._objects: Dict[ObjectID, StoredObject] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._listeners: Dict[ObjectID, List[Callable[[ObjectID], None]]] = {}
        self._max_bytes = max_bytes
        self._used_bytes = 0
        self._spiller = spiller
        self._spilled: Dict[ObjectID, int] = {}  # oid -> spilled nbytes
        self._unspillable: set = set()  # values that failed to pickle

    # -- spill ----------------------------------------------------------------
    def _spill_lru_locked(self, need: int) -> None:
        """Move the oldest spillable values to disk until ``need`` more
        bytes fit (insertion order ~= LRU for an immutable store). Lock
        held by the caller."""
        if self._spiller is None or not self._max_bytes:
            return
        import cloudpickle

        for oid in list(self._objects):
            if self._used_bytes + need <= self._max_bytes:
                return
            obj = self._objects[oid]
            if obj.error is not None or oid in self._unspillable:
                continue  # errors stay resident (tiny, must re-raise)
            try:
                blob = cloudpickle.dumps(obj.value)
            except Exception:  # noqa: BLE001 - unpicklable: pin resident
                self._unspillable.add(oid)
                continue
            try:
                self._spiller.write(oid.binary(), blob)
            except OSError:
                return  # spill disk full/unwritable: stop trying
            self._spilled[oid] = obj.nbytes
            del self._objects[oid]
            self._used_bytes -= obj.nbytes

    def _restore_locked(self, object_id: ObjectID) -> Optional[StoredObject]:
        """Disk-second half of get: unpickle a spilled value back into the
        store (spilling others if the budget demands). Lock held."""
        if self._spiller is None or object_id not in self._spilled:
            return None
        import pickle

        blob = self._spiller.read(object_id.binary())
        nbytes = self._spilled.pop(object_id)
        if blob is None:
            return None  # torn/corrupt copy: lost (recovery is upstream)
        obj = StoredObject(value=pickle.loads(blob), nbytes=nbytes)
        if self._max_bytes and self._used_bytes + nbytes > self._max_bytes:
            self._spill_lru_locked(nbytes)
        self._objects[object_id] = obj
        self._used_bytes += nbytes
        self._spiller.delete(object_id.binary())
        return obj

    # -- write ----------------------------------------------------------------
    def put(self, object_id: ObjectID, obj: StoredObject) -> None:
        with self._lock:
            existing = self._objects.get(object_id)
            if existing is not None or object_id in self._spilled:
                return  # objects are immutable; double-put is a no-op
            if self._max_bytes and self._used_bytes + obj.nbytes > self._max_bytes:
                self._spill_lru_locked(obj.nbytes)
            if self._max_bytes and self._spiller is None \
                    and self._used_bytes + obj.nbytes > self._max_bytes:
                raise ObjectStoreFullError(
                    f"object store over budget: {self._used_bytes + obj.nbytes} "
                    f"> {self._max_bytes} bytes"
                )
            # With a spiller the budget is soft: when even spilling could
            # not make room (everything unspillable) the put still lands —
            # degradation, not failure.
            self._objects[object_id] = obj
            self._used_bytes += obj.nbytes
            listeners = self._listeners.pop(object_id, [])
            self._cv.notify_all()
        for cb in listeners:
            cb(object_id)

    def delete(self, object_ids: Sequence[ObjectID]) -> None:
        with self._lock:
            for oid in object_ids:
                obj = self._objects.pop(oid, None)
                if obj is not None:
                    self._used_bytes -= obj.nbytes
                if self._spilled.pop(oid, None) is not None:
                    self._spiller.delete(oid.binary())
                self._unspillable.discard(oid)

    # -- read -----------------------------------------------------------------
    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._objects or object_id in self._spilled

    def get_if_exists(self, object_id: ObjectID) -> Optional[StoredObject]:
        with self._lock:
            obj = self._objects.get(object_id)
            if obj is None:
                obj = self._restore_locked(object_id)
            return obj

    def get(self, object_ids: Sequence[ObjectID],
            timeout: Optional[float] = None) -> List[StoredObject]:
        """Blocking batched get; raises GetTimeoutError on expiry.

        Walks the objects in order and waits at the first that is not
        there yet, so each put wakes a check of one object. The
        reference rescans every object of the batch on every put, which
        makes a get of an n-task fan-out O(n^2) under the store's lock
        (ROADMAP.md C6). The answer, the errors and the spill behaviour
        are the reference's: a batch that cannot be resident at once
        still waits, and times out, as there (C5)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        n = len(object_ids)
        with self._lock:
            i, rewalked = 0, False
            while True:
                while i < n and (object_ids[i] in self._objects or
                                 self._restore_locked(object_ids[i])
                                 is not None):
                    i += 1
                if i == n:
                    if all(oid in self._objects for oid in object_ids):
                        return [self._objects[oid] for oid in object_ids]
                    # A restore spilled an object this walk had passed:
                    # walk once more, restoring, before waiting.
                    i = 0
                    if not rewalked:
                        rewalked = True
                        continue
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        missing = [oid for oid in object_ids
                                   if oid not in self._objects]
                        raise GetTimeoutError(
                            f"get timed out; {len(missing)} of {len(object_ids)} "
                            f"objects not ready (first missing: {missing[0]})"
                        )
                self._cv.wait(timeout=remaining)
                rewalked = False

    def wait(self, object_ids: Sequence[ObjectID], num_returns: int,
             timeout: Optional[float]) -> Tuple[List[ObjectID], List[ObjectID]]:
        """ray.wait semantics: block until num_returns ready or timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                ready = [oid for oid in object_ids
                         if oid in self._objects or oid in self._spilled]
                if len(ready) >= num_returns:
                    ready_set = set(ready[:num_returns])
                    # preserve input order in both lists
                    ready_list = [o for o in object_ids if o in ready_set]
                    rest = [o for o in object_ids if o not in ready_set]
                    return ready_list, rest
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        ready_set = set(ready)
                        return (
                            [o for o in object_ids if o in ready_set],
                            [o for o in object_ids if o not in ready_set],
                        )
                self._cv.wait(timeout=remaining)

    # -- async notification (dependency manager hook) -------------------------
    def on_available(self, object_id: ObjectID,
                     callback: Callable[[ObjectID], None]) -> None:
        """Invoke callback when object_id becomes available (maybe immediately)."""
        with self._lock:
            if object_id in self._objects or object_id in self._spilled:
                fire = True
            else:
                self._listeners.setdefault(object_id, []).append(callback)
                fire = False
        if fire:
            callback(object_id)

    # -- stats ----------------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "num_objects": len(self._objects),
                "used_bytes": self._used_bytes,
                "max_bytes": self._max_bytes,
                "spilled_objects": len(self._spilled),
                "spilled_bytes": sum(self._spilled.values()),
            }

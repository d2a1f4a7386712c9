"""ObjectRef: the user-facing future (counterpart: ``ray_tpu/object_ref.py``).

Same role as the reference's ``ObjectID``/``ObjectRef`` returned by
``f.remote()`` (reference: ``python/ray/includes/object_id.pxi``): a cheap,
hashable, serializable handle to an immutable object that may not exist yet.
Supports ``await`` so asyncio code can consume task results directly.
"""

from __future__ import annotations

from typing import Optional

from ._private.ids import ObjectID


class ObjectRef:
    __slots__ = ("id", "_owner", "_counted_core")

    def __init__(self, object_id: ObjectID, owner: Optional[bytes] = None):
        self.id = object_id
        self._owner = owner
        # Register with the owner's reference counter so the object can be
        # freed when the last handle dies (reference: reference_count.h:33
        # AddLocalReference in the ObjectRef ctor path).
        self._counted_core = None
        from ._private.worker import global_worker

        worker = global_worker()
        if worker.connected and hasattr(worker.core, "add_local_ref"):
            worker.core.add_local_ref(self.id)
            self._counted_core = worker.core

    def __del__(self):
        core = self._counted_core
        if core is not None:
            try:
                core.remove_local_ref(self.id)
            except Exception:  # noqa: BLE001 - interpreter teardown
                pass

    def binary(self) -> bytes:
        return self.id.binary()

    def hex(self) -> str:
        return self.id.hex()

    def task_id(self):
        return self.id.task_id()

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ObjectRef({self.id.hex()})"

    def __reduce__(self):
        return (ObjectRef, (self.id, self._owner))

    def future(self):
        """A concurrent.futures.Future resolving to the object's value."""
        from ._private.worker import global_worker

        return global_worker().core.as_future(self)

    def __await__(self):
        import asyncio

        return asyncio.wrap_future(self.future()).__await__()

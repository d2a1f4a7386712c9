"""ObjectRef: the user-facing future (counterpart: ``ray_tpu/object_ref.py``).

Same role as the reference's ``ObjectID``/``ObjectRef`` returned by
``f.remote()`` (reference: ``python/ray/includes/object_id.pxi``): a cheap,
hashable, serializable handle to an immutable object that may not exist yet.

The local runtime (worker, object store, reference counting) is not ported
yet: it comes with the local runtime slice (A4) of ROADMAP.md. Until then no
worker is ever connected, so a handle registers with no reference counter,
as the JAX package's handles do before ``init()``, and waiting on a handle
raises NotImplementedError.
"""

from __future__ import annotations

from typing import Optional

from ._private.ids import ObjectID

_NO_RUNTIME = ("waiting on an ObjectRef needs the local runtime, which is "
               "not ported yet; it comes with the local runtime slice (A4) "
               "of ROADMAP.md")


class ObjectRef:
    __slots__ = ("id", "_owner")

    def __init__(self, object_id: ObjectID, owner: Optional[bytes] = None):
        self.id = object_id
        self._owner = owner

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
        raise NotImplementedError(_NO_RUNTIME)

    def __await__(self):
        raise NotImplementedError(_NO_RUNTIME)

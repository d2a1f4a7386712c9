"""Binary IDs for the ray_tpu_torch runtime (a copy of ray_tpu's).

Design follows the reference's ID scheme (reference: ``src/ray/common/id.h`` and
``src/ray/design_docs/id_specification.md``) in *semantics* — IDs are fixed-width
binary strings, task IDs embed their parent lineage hash, and object IDs are
derived from the task that creates them plus a return/put index — but the layout
is simplified: we do not need the legacy transport-type flag bits, and all
derivation is plain BLAKE2b instead of murmur hashes.

Layout:
    JobID     4 bytes   (counter on the driver)
    ActorID   12 bytes  = hash(job, parent_task, parent_counter)[:8] + job(4)
    TaskID    16 bytes  = hash(lineage)[:12] + actor_or_job(4)
    ObjectID  24 bytes  = TaskID(16) + index(4, signed: >0 returns, <0 puts) + pad(4)
    NodeID / WorkerID / PlacementGroupID  16 random bytes
"""

from __future__ import annotations

import hashlib
import os
import threading

_NIL = b"\xff"


def _hash(*parts: bytes, size: int) -> bytes:
    h = hashlib.blake2b(digest_size=size)
    for p in parts:
        h.update(p)
    return h.digest()


class BaseID:
    """A fixed-size immutable binary identifier."""

    SIZE = 16
    __slots__ = ("_binary", "_hash")

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(binary)}"
            )
        self._binary = binary
        self._hash = hash((type(self).__name__, binary))

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def nil(cls):
        return cls(_NIL * cls.SIZE)

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    def binary(self) -> bytes:
        return self._binary

    def hex(self) -> str:
        return self._binary.hex()

    def is_nil(self) -> bool:
        return self._binary == _NIL * self.SIZE

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._binary == self._binary

    def __lt__(self, other):
        return self._binary < other._binary

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._binary,))


class UniqueID(BaseID):
    SIZE = 16


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class PlacementGroupID(BaseID):
    SIZE = 16


class JobID(BaseID):
    SIZE = 4

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(4, "little"))

    def int(self) -> int:
        return int.from_bytes(self._binary, "little")


class ActorID(BaseID):
    SIZE = 12

    @classmethod
    def of(cls, job_id: JobID, parent_task_id: "TaskID", parent_counter: int) -> "ActorID":
        body = _hash(
            job_id.binary(),
            parent_task_id.binary(),
            parent_counter.to_bytes(8, "little"),
            size=8,
        )
        return cls(body + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._binary[8:12])


class TaskID(BaseID):
    SIZE = 16

    @classmethod
    def for_driver_task(cls, job_id: JobID) -> "TaskID":
        return cls(_hash(b"driver", job_id.binary(), size=12) + job_id.binary())

    @classmethod
    def for_normal_task(
        cls, job_id: JobID, parent_task_id: "TaskID", parent_counter: int
    ) -> "TaskID":
        body = _hash(
            b"task",
            job_id.binary(),
            parent_task_id.binary(),
            parent_counter.to_bytes(8, "little"),
            size=12,
        )
        return cls(body + job_id.binary())

    @classmethod
    def for_actor_creation_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(_hash(b"actor_creation", actor_id.binary(), size=12) + actor_id.binary()[8:12])

    @classmethod
    def for_actor_task(
        cls, job_id: JobID, parent_task_id: "TaskID", parent_counter: int, actor_id: ActorID
    ) -> "TaskID":
        body = _hash(
            b"actor_task",
            actor_id.binary(),
            parent_task_id.binary(),
            parent_counter.to_bytes(8, "little"),
            size=12,
        )
        return cls(body + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._binary[12:16])


class ObjectID(BaseID):
    """ObjectID = producing TaskID + signed index.

    index > 0: the index-th return value of the task.
    index < 0: the (-index)-th ``put`` performed by the task.
    """

    SIZE = 24
    MAX_INDEX = 2**31 - 1

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        assert 0 < index <= cls.MAX_INDEX
        return cls(task_id.binary() + index.to_bytes(4, "little", signed=True) + b"\x00" * 4)

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        assert 0 < put_index <= cls.MAX_INDEX
        return cls(
            task_id.binary() + (-put_index).to_bytes(4, "little", signed=True) + b"\x00" * 4
        )

    def task_id(self) -> TaskID:
        return TaskID(self._binary[:16])

    def index(self) -> int:
        return int.from_bytes(self._binary[16:20], "little", signed=True)

    def is_return(self) -> bool:
        return self.index() > 0

    def is_put(self) -> bool:
        return self.index() < 0


class _Counter:
    """Thread-safe monotonically increasing counter."""

    def __init__(self, start: int = 0):
        self._value = start
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value


__all__ = [
    "BaseID",
    "UniqueID",
    "NodeID",
    "WorkerID",
    "PlacementGroupID",
    "JobID",
    "ActorID",
    "TaskID",
    "ObjectID",
]

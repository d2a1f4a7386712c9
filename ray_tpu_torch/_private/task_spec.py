"""Task specifications.

Equivalent of the reference's ``TaskSpecification`` (reference:
``src/ray/common/task/task_spec.h:26``): an immutable record describing one
invocation — function, args (inline values or ObjectID refs), resource demand,
retry policy, actor linkage — plus the interned ``SchedulingClass`` (ref
``task_spec.h:190-192``) that groups tasks with identical resource shapes so
the scheduler and worker pool can treat them as one class.

No protobuf here: specs live in-process or are pickled across the control
socket; the dense scheduling representation is produced by
``resources.dense_matrix`` for the placement kernel instead.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .ids import ActorID, JobID, ObjectID, TaskID
from .resources import ResourceSet


class TaskType(enum.Enum):
    NORMAL_TASK = 0
    ACTOR_CREATION_TASK = 1
    ACTOR_TASK = 2
    DRIVER_TASK = 3


# --- SchedulingClass interning (ref task_spec.h:190-192, static maps) ---------
_sched_class_lock = threading.Lock()
_sched_class_table: Dict[Tuple, int] = {}
_sched_class_rev: List[Tuple] = []


def scheduling_class_of(resources: ResourceSet, fn_key: Optional[str] = None) -> int:
    """Intern (resource shape, function) into a small int id."""
    key = (resources.key(), fn_key)
    with _sched_class_lock:
        sc = _sched_class_table.get(key)
        if sc is None:
            sc = len(_sched_class_rev)
            _sched_class_table[key] = sc
            _sched_class_rev.append(key)
        return sc


def scheduling_class_resources(sc: int) -> ResourceSet:
    key = _sched_class_rev[sc][0]
    predefined, custom = key
    import numpy as np

    return ResourceSet(np.array(predefined), dict(custom))


@dataclass(frozen=True)
class FunctionDescriptor:
    """Identifies a remote function or actor method across processes."""

    module: str
    qualname: str
    function_hash: bytes = b""

    @property
    def repr_name(self) -> str:
        return f"{self.module}.{self.qualname}"


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    task_type: TaskType
    function: FunctionDescriptor
    # Args: list of ("value", pickled_bytes_or_obj) or ("ref", ObjectID).
    args: List[Tuple[str, Any]]
    num_returns: int
    resources: ResourceSet
    parent_task_id: Optional[TaskID] = None
    max_retries: int = 0
    # Actor linkage
    actor_id: Optional[ActorID] = None
    actor_counter: int = 0  # per-caller sequence number for ordered delivery
    max_restarts: int = 0
    max_concurrency: int = 1
    is_asyncio: bool = False
    name: Optional[str] = None
    # Placement hints
    placement_node: Optional[Any] = None
    # Placement-group linkage (observability; the scheduling effect is
    # carried entirely by the translated group-scoped resource names).
    placement_group_id: Optional[bytes] = None
    placement_group_bundle_index: int = -1
    # Deadline: the controller kills the task (SIGTERM -> SIGKILL) once it
    # has executed for timeout_s and fails it with TaskTimeoutError. Deadline
    # kills don't consume max_retries unless retry_on_timeout opts in.
    timeout_s: Optional[float] = None
    retry_on_timeout: bool = False
    metadata: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self.scheduling_class = scheduling_class_of(
            self.resources, self.function.repr_name
        )
        self._return_ids: Optional[List[ObjectID]] = None

    @property
    def is_actor_task(self) -> bool:
        return self.task_type == TaskType.ACTOR_TASK

    @property
    def is_actor_creation(self) -> bool:
        return self.task_type == TaskType.ACTOR_CREATION_TASK

    def return_ids(self) -> List[ObjectID]:
        # Memoized: the submit hot path asks several times per task and the
        # ids are pure functions of (task_id, num_returns).
        rids = self._return_ids
        if rids is None:
            rids = self._return_ids = [
                ObjectID.for_task_return(self.task_id, i + 1)
                for i in range(self.num_returns)
            ]
        return rids

    def dependencies(self) -> List[ObjectID]:
        """ObjectIDs this task needs materialized before it can run.

        Scans positional ref-args AND ObjectRefs passed as kwargs — both must
        gate dispatch, otherwise a task could be admitted and then block
        holding its resources while a kwarg dependency is still pending.
        """
        deps = [arg for kind, arg in self.args if kind == "ref"]
        for v in self.metadata.get("kwargs", {}).values():
            oid = getattr(v, "id", None)
            if isinstance(oid, ObjectID):
                deps.append(oid)
        return deps

    def __repr__(self):
        return (
            f"TaskSpec({self.function.repr_name}, id={self.task_id.hex()[:8]}, "
            f"type={self.task_type.name}, deps={len(self.dependencies())})"
        )

"""Exception hierarchy of the port (counterpart: ``ray_tpu/exceptions.py``).

The same 18 classes as the JAX package, with the same bases and pickling
(``__reduce__``), so an error raised by either package's runtime reads the
same to its caller. Mirrors the user-visible error surface of the reference
(reference: ``python/ray/exceptions.py`` and ``src/ray/common/status.h``):
task errors wrap the remote traceback, actor errors mark a dead/restarting
actor, object loss and worker crashes are distinct so retry/recovery layers
can react differently.
"""

from __future__ import annotations

import traceback
from typing import Optional


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A remote task raised an exception; re-raised at ``get()`` on the caller.

    Holds the remote traceback text so the driver sees where the failure
    happened (reference behavior: RayTaskError in python/ray/exceptions.py).
    """

    def __init__(self, function_name: str, cause: BaseException,
                 remote_traceback: Optional[str] = None):
        self.function_name = function_name
        self.cause = cause
        self.remote_traceback = remote_traceback or "".join(
            traceback.format_exception(type(cause), cause, cause.__traceback__)
        )
        super().__init__(
            f"task {function_name} failed: {type(cause).__name__}: {cause}\n"
            f"remote traceback:\n{self.remote_traceback}"
        )

    def __reduce__(self):
        # Cross-process safe: fall back to a repr stand-in for causes that
        # don't pickle (tracebacks never do; we carry the formatted text).
        import pickle

        try:
            pickle.dumps(self.cause)
            cause = self.cause
        except Exception:  # noqa: BLE001
            cause = RuntimeError(repr(self.cause))
        return (TaskError, (self.function_name, cause, self.remote_traceback))


class ActorError(RayTpuError):
    """An actor task cannot complete because the actor died."""

    def __init__(self, actor_id=None, message="The actor died unexpectedly"):
        self.actor_id = actor_id
        self.message = message
        super().__init__(f"{message} (actor_id={actor_id})")

    def __reduce__(self):
        return (type(self), (self.actor_id, self.message))


class ActorDiedError(ActorError):
    pass


class ActorUnavailableError(ActorError):
    pass


class ObjectLostError(RayTpuError):
    """Object was evicted/lost and could not be reconstructed."""

    def __init__(self, object_id, message="Object lost"):
        self.object_id = object_id
        self.message = message
        super().__init__(f"{message}: {object_id}")

    def __reduce__(self):
        return (type(self), (self.object_id, self.message))


class ObjectStoreFullError(RayTpuError):
    pass


class WorkerCrashedError(RayTpuError):
    """The worker process executing a task died mid-execution."""


class NodeDiedError(RayTpuError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    """``get(timeout=...)`` expired before the object was ready."""


class TaskCancelledError(RayTpuError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(f"Task was cancelled (task_id={task_id})")

    def __reduce__(self):
        return (type(self), (self.task_id,))


class TaskTimeoutError(RayTpuError):
    """A task exceeded its ``.options(timeout_s=...)`` deadline and was
    killed by the controller (SIGTERM, then SIGKILL). Deadline kills are the
    workload's fault, so they do NOT consume ``max_retries`` unless the task
    opted in with ``retry_on_timeout=True``."""

    def __init__(self, task_id=None, timeout_s=None):
        self.task_id = task_id
        self.timeout_s = timeout_s
        super().__init__(
            f"Task exceeded its deadline of {timeout_s}s and was killed "
            f"(task_id={task_id})")

    def __reduce__(self):
        return (type(self), (self.task_id, self.timeout_s))


class TaskPoisonedError(RayTpuError):
    """The function fingerprint was quarantined after repeated worker-fatal
    failures (three strikes); submissions fail fast
    instead of churning worker respawns. Clear with
    ``cli quarantine --clear <fingerprint>``."""

    def __init__(self, fn_id=None, name=None, strikes=0):
        self.fn_id = fn_id
        self.name = name
        self.strikes = strikes
        super().__init__(
            f"Function {name or '?'} (fingerprint="
            f"{fn_id.hex() if isinstance(fn_id, bytes) else fn_id}) is "
            f"quarantined after {strikes} worker-fatal failures; clear with "
            f"`cli quarantine --clear`")

    def __reduce__(self):
        return (type(self), (self.fn_id, self.name, self.strikes))


class ActorExitError(BaseException):
    """Control-flow exception raised by ``exit_actor()`` — intentionally a
    BaseException so user ``except Exception`` blocks can't swallow it
    (reference: actor.py:920 exit_actor raises via SystemExit)."""


class RuntimeEnvError(RayTpuError):
    pass


class PlacementGroupError(RayTpuError):
    """A placement-group operation failed (removed while tasks were
    pending on it, invalid bundle/strategy, or an unknown group)."""


class ClusterUnavailableError(RayTpuError):
    """Cluster infrastructure failure (no reachable nodes, undeliverable
    task) — distinct from user-code errors so callers can retry safely."""


class ReplicaUnavailableError(RayTpuError):
    """A serve request cannot be (re)placed on any live replica.

    Raised by the serve router when a stream's pinned replica died (streams
    fail fast instead of hanging to the idle timeout), when a whole-response
    call exhausted its retry budget across sibling replicas, or when a
    backend has no routable replica at all. Also raised by a poisoned
    backend (e.g. ``serve.LMBackend`` after an engine-step failure) so the
    router treats it as a replica-infrastructure failure — retryable on a
    sibling — rather than an application error."""

    def __init__(self, backend_tag=None, message="no replica available"):
        self.backend_tag = backend_tag
        self.message = message
        super().__init__(f"{message} (backend={backend_tag})")

    def __reduce__(self):
        return (type(self), (self.backend_tag, self.message))


__all__ = [
    "PlacementGroupError",
    "RayTpuError",
    "TaskError",
    "ActorError",
    "ActorDiedError",
    "ActorUnavailableError",
    "ObjectLostError",
    "ObjectStoreFullError",
    "WorkerCrashedError",
    "NodeDiedError",
    "GetTimeoutError",
    "TaskCancelledError",
    "TaskTimeoutError",
    "TaskPoisonedError",
    "RuntimeEnvError",
    "ClusterUnavailableError",
    "ReplicaUnavailableError",
]

"""Exception types of the port (counterpart: ``ray_tpu/exceptions.py``).

Only the two the serving slice raises are carried over; the rest arrive
with the runtime slice.
"""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


class ReplicaUnavailableError(RayTpuError):
    """A serve request cannot be (re)placed on any live replica.

    Raised by a poisoned backend (``serve.LMBackend`` after an engine-step
    failure) so a router treats it as a replica-infrastructure failure,
    retryable on a sibling, rather than an application error."""

    def __init__(self, backend_tag=None, message="no replica available"):
        self.backend_tag = backend_tag
        self.message = message
        super().__init__(f"{message} (backend={backend_tag})")

    def __reduce__(self):
        return (type(self), (self.backend_tag, self.message))


__all__ = ["RayTpuError", "ReplicaUnavailableError"]

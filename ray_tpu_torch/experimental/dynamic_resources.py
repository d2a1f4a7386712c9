"""Dynamic custom resources (reference: python/ray/experimental/dynamic_resources.py).

``set_resource("label", capacity)`` creates/updates/deletes a custom resource
on a node at runtime; subsequently submitted tasks can demand it.
"""

from __future__ import annotations

from typing import Optional

from .._private.worker import global_worker


def set_resource(resource_name: str, capacity: float,
                 node_id: Optional[str] = None) -> None:
    if resource_name in ("CPU", "TPU", "GPU", "memory"):
        raise ValueError(f"cannot dynamically update builtin {resource_name}")
    if capacity < 0:
        raise ValueError("capacity must be >= 0")
    worker = global_worker()
    worker.check_connected()
    core = worker.core
    if hasattr(core, "gcs"):
        core.gcs.call({"type": "set_resource", "name": resource_name,
                       "capacity": capacity, "node_id": node_id})
        return
    core.set_resource(resource_name, capacity)

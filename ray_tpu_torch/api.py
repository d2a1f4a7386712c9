"""Public API surface (reference: python/ray/worker.py + __init__.py).

The port's copy of ``ray_tpu/api.py``: ``num_gpus`` and the ``GPU``
resource in place of ``num_tpus`` and ``TPU``, and ``RAY_TPU_TORCH_ADDRESS``
in place of ``RAY_TPU_ADDRESS``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ._private.config import reset_config
from ._private.resources import ResourceSet
from ._private.runtime import LocalRuntime
from ._private.worker import global_worker
from .object_ref import ObjectRef


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
    object_store_memory: Optional[int] = None,
    _system_config: Optional[Dict[str, Any]] = None,
    ignore_reinit_error: bool = False,
):
    """Start (or connect to) a runtime.

    ``address=None`` starts the in-process local runtime unless
    ``RAY_TPU_TORCH_ADDRESS`` is set in the environment (reference:
    RAY_ADDRESS, python/ray/worker.py:461); ``address="local"`` names the
    local runtime explicitly. ``address="tcp://host:port"`` (or
    ``"host:port"``) connects to a running cluster head
    (``ray_tpu_torch.cluster``).

    ``num_gpus=None`` counts the CUDA devices torch sees; the ``GPU``
    resource is left out when there are none.
    """
    if address is None:
        address = os.environ.get("RAY_TPU_TORCH_ADDRESS") or None
    worker = global_worker()
    if worker.connected:
        if ignore_reinit_error:
            return worker.core
        raise RuntimeError("ray_tpu_torch.init() called twice; use ignore_reinit_error=True")

    config = reset_config(_system_config)
    if object_store_memory is not None:
        config.object_store_memory = object_store_memory

    if address is not None and address != "local":
        from .cluster.client import connect_driver

        worker.core = connect_driver(address, config)
        worker.mode = "driver"
        worker.connected = True
        return worker.core

    if num_cpus is None:
        num_cpus = os.cpu_count() or 1
    res = dict(resources or {})
    res["CPU"] = num_cpus
    if num_gpus is None:
        import torch

        num_gpus = torch.cuda.device_count()
    if num_gpus:
        res["GPU"] = num_gpus
    res.setdefault("memory", config.object_store_memory / (1024**3))

    worker.core = LocalRuntime(ResourceSet.from_dict(res), config)
    worker.mode = "local"
    worker.connected = True
    return worker.core


def is_initialized() -> bool:
    return global_worker().connected


def shutdown():
    worker = global_worker()
    if worker.core is not None:
        worker.core.shutdown()
    worker.core = None
    worker.mode = None
    worker.connected = False


def put(value: Any) -> ObjectRef:
    worker = global_worker()
    worker.check_connected()
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put() on an ObjectRef is not allowed")
    return worker.core.put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        timeout: Optional[float] = None) -> Any:
    worker = global_worker()
    worker.check_connected()
    if isinstance(refs, ObjectRef):
        return worker.core.get([refs], timeout=timeout)[0]
    if not isinstance(refs, (list, tuple)):
        raise TypeError(f"get() expects an ObjectRef or list, got {type(refs)}")
    for r in refs:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() list elements must be ObjectRef, got {type(r)}")
    return worker.core.get(list(refs), timeout=timeout)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    worker = global_worker()
    worker.check_connected()
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    if len(set(refs)) != len(refs):
        raise ValueError("wait() got duplicate ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds number of objects")
    if num_returns <= 0:
        raise ValueError("num_returns must be positive")
    return worker.core.wait(list(refs), num_returns, timeout)


def kill(actor_handle, *, no_restart: bool = True):
    from .actor import ActorHandle

    worker = global_worker()
    worker.check_connected()
    if not isinstance(actor_handle, ActorHandle):
        raise TypeError("kill() expects an ActorHandle")
    worker.core.kill_actor(actor_handle._actor_id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False):
    worker = global_worker()
    worker.check_connected()
    worker.core.cancel(ref, force)


def free(refs: Sequence[ObjectRef]):
    """Eagerly delete objects from every store holding them (reference:
    ray.internal.free). The objects' lineage is dropped too, so they will
    NOT be reconstructed — only free objects you own and are done with."""
    worker = global_worker()
    worker.check_connected()
    if isinstance(refs, ObjectRef):
        refs = [refs]
    worker.core.free(list(refs))


def get_actor(name: str):
    from .actor import ActorHandle

    worker = global_worker()
    worker.check_connected()
    actor_id = worker.core.get_actor(name)
    class_name, module, methods = worker.core.actor_class_info(actor_id)
    return ActorHandle(actor_id, class_name, module, methods)


def nodes() -> List[Dict[str, Any]]:
    worker = global_worker()
    worker.check_connected()
    return worker.core.nodes()


def cluster_resources() -> Dict[str, float]:
    worker = global_worker()
    worker.check_connected()
    return worker.core.cluster_resources()


def available_resources() -> Dict[str, float]:
    worker = global_worker()
    worker.check_connected()
    return worker.core.available_resources()


def timeline(filename: Optional[str] = None,
             limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """Export profile events as chrome://tracing JSON. ``limit`` keeps only
    the newest N spans (fetched server-side in cluster mode).

    Reference: python/ray/state.py:914 timeline() / chrome_tracing_dump.
    """
    worker = global_worker()
    worker.check_connected()
    events = []
    if hasattr(worker.core, "cluster_trace_spans"):
        # Per-task control-plane traces (sampled tasks): each trace becomes
        # one lane whose phase spans show where that task's latency went.
        try:
            spans = worker.core.cluster_trace_spans(limit=limit)
        except Exception:  # noqa: BLE001 - GCS restart window
            spans = []
        for sp in spans:
            events.append({
                "cat": "phase",
                "name": sp["phase"],
                "ph": "X",
                "ts": sp["start"] * 1e6,
                "dur": (sp["end"] - sp["start"]) * 1e6,
                "pid": f"trace:{sp['trace'][:12]}",
                "tid": sp.get("src", "0"),
                "args": {"trace": sp["trace"],
                         "task_id": sp.get("task_id", ""),
                         "src": sp.get("src", "")},
            })
    if hasattr(worker.core, "cluster_profile_events"):
        # Cluster mode: all spans (the driver's included, flushed here)
        # live in the GCS profile table.
        worker.core.flush_events()
        for ev in worker.core.cluster_profile_events(limit=limit):
            events.append({
                "cat": ev["cat"],
                "name": ev["name"],
                "ph": "X",
                "ts": ev["start"] * 1e6,
                "dur": (ev["end"] - ev["start"]) * 1e6,
                "pid": ev["extra"].get(
                    "actor_id",
                    ev["extra"].get(
                        "lane",                    # cluster-unique worker
                        (f"worker-{ev['extra']['worker_pid']}"
                         if "worker_pid" in ev["extra"]
                         else ev.get("origin", "worker")))),
                "tid": ev["extra"].get("task_id", "0"),
                "args": ev["extra"],
            })
    else:
        for kind, name, start, end, extra in list(worker.core.events.events):
            events.append({
                "cat": kind,
                "name": name,
                "ph": "X",
                "ts": start * 1e6,
                "dur": (end - start) * 1e6,
                "pid": (f"trace:{extra['trace'][:12]}" if "trace" in extra
                        else extra.get("actor_id", "driver")),
                "tid": extra.get("task_id", "0"),
                "args": extra,
            })
    if limit is not None and len(events) > limit:
        events = events[-limit:]
    if filename:
        with open(filename, "w") as f:
            json.dump(events, f)
    return events

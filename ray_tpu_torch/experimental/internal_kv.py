"""Internal key/value store (reference: python/ray/experimental/internal_kv.py).

Local mode: a dict on the runtime. Cluster mode: the GCS kv table, so all
drivers/workers see one namespace.
"""

from __future__ import annotations

from typing import List, Optional

from .._private.worker import global_worker


def _backend():
    worker = global_worker()
    worker.check_connected()
    core = worker.core
    if hasattr(core, "gcs"):
        return ("gcs", core.gcs)
    kv = getattr(core, "_internal_kv", None)
    if kv is None:
        kv = {}
        core._internal_kv = kv
    return ("local", kv)


def _internal_kv_put(key: bytes, value: bytes,
                     overwrite: bool = True) -> bool:
    """Returns True if the key already existed."""
    kind, be = _backend()
    key = bytes(key)
    value = bytes(value)
    if kind == "gcs":
        existing = be.call({"type": "kv_get", "key": key.hex()})["value"]
        if existing is not None and not overwrite:
            return True
        be.call({"type": "kv_put", "key": key.hex(), "value": value.hex()})
        return existing is not None
    existed = key in be
    if existed and not overwrite:
        return True
    be[key] = value
    return existed


def _internal_kv_get(key: bytes) -> Optional[bytes]:
    kind, be = _backend()
    key = bytes(key)
    if kind == "gcs":
        value = be.call({"type": "kv_get", "key": key.hex()})["value"]
        return bytes.fromhex(value) if value is not None else None
    return be.get(key)


def _internal_kv_exists(key: bytes) -> bool:
    return _internal_kv_get(key) is not None


def _internal_kv_del(key: bytes) -> None:
    kind, be = _backend()
    key = bytes(key)
    if kind == "gcs":
        be.call({"type": "kv_put", "key": key.hex(), "value": None})
        return
    be.pop(key, None)

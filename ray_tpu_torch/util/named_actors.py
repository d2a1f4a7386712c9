"""Named actor registry (reference: python/ray/util/named_actors.py).

The core runtime already supports ``name=`` at creation and
``ray_tpu_torch.get_actor(name)``; this module adds post-hoc registration via a
detached registry the way the reference stored handles in the GCS.
"""

from __future__ import annotations

from typing import Any

import ray_tpu_torch

_REGISTRY_NAME = "__ray_tpu_torch_named_actor_registry__"


class _Registry:
    def __init__(self):
        self._handles = {}

    def register(self, name: str, handle: Any) -> None:
        self._handles[name] = handle

    def lookup(self, name: str):
        return self._handles.get(name)


def _registry():
    try:
        return ray_tpu_torch.get_actor(_REGISTRY_NAME)
    except Exception:
        try:
            return ray_tpu_torch.remote(num_cpus=0)(_Registry).options(
                name=_REGISTRY_NAME).remote()
        except Exception:
            return ray_tpu_torch.get_actor(_REGISTRY_NAME)


def register_actor(name: str, actor_handle: Any) -> None:
    if not isinstance(name, str):
        raise TypeError(f"name must be str, got {type(name)}")
    ray_tpu_torch.get(_registry().register.remote(name, actor_handle))


def get_actor(name: str):
    # Prefer first-class named actors (created with name=...).
    try:
        return ray_tpu_torch.get_actor(name)
    except Exception:
        pass
    handle = ray_tpu_torch.get(_registry().lookup.remote(name))
    if handle is None:
        raise ValueError(f"Named actor {name!r} was never registered")
    return handle

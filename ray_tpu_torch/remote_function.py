"""@remote functions.

Reference: ``python/ray/remote_function.py`` — a decorated function becomes a
RemoteFunction whose ``.remote(*args)`` builds a TaskSpec and submits it;
``.options(...)`` overrides resources/returns per-call site.

The port's copy of ``ray_tpu/remote_function.py``: ``num_gpus`` and the
``GPU`` resource in place of ``num_tpus`` and ``TPU``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

from ._private.resources import ResourceSet
from ._private.task_spec import FunctionDescriptor, TaskSpec, TaskType
from ._private.worker import global_worker
from .object_ref import ObjectRef


class RemoteFunction:
    def __init__(self, fn: Callable, *, num_returns: int = 1,
                 num_cpus: Optional[float] = None, num_gpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None,
                 max_retries: Optional[int] = None, name: Optional[str] = None):
        self._function = fn
        self._name = name or getattr(fn, "__qualname__", repr(fn))
        self._module = getattr(fn, "__module__", "__main__")
        self._num_returns = num_returns
        res = dict(resources or {})
        res.setdefault("CPU", 1 if num_cpus is None else num_cpus)
        if num_gpus:
            res["GPU"] = num_gpus
        self._resources = ResourceSet.from_dict(res)
        self._max_retries = max_retries
        self._descriptor = FunctionDescriptor(self._module, self._name)
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._name} cannot be called directly; "
            f"use {self._name}.remote()."
        )

    def options(self, *, num_returns: Optional[int] = None,
                num_cpus: Optional[float] = None, num_gpus: Optional[float] = None,
                resources: Optional[Dict[str, float]] = None,
                max_retries: Optional[int] = None, name: Optional[str] = None,
                placement_group=None,
                placement_group_bundle_index: int = -1,
                timeout_s: Optional[float] = None,
                retry_on_timeout: bool = False):
        """Per-call-site overrides; returns a submit-only wrapper.

        ``placement_group`` pins the task into a reserved bundle: its
        demand is rewritten to the group-scoped resource names, so it can
        only run on the bundle's node, consuming the bundle's reservation
        (``placement_group_bundle_index=-1`` = any bundle of the group).

        ``timeout_s`` sets an execution deadline: the controller kills the
        task (SIGTERM, then SIGKILL) once it has run that long and the ref
        resolves to ``TaskTimeoutError``. Deadline kills don't consume
        ``max_retries`` unless ``retry_on_timeout=True``."""
        parent = self

        class _Options:
            def remote(self, *args, **kwargs):
                return parent._remote(
                    args, kwargs,
                    num_returns=num_returns, num_cpus=num_cpus, num_gpus=num_gpus,
                    resources=resources, max_retries=max_retries, name=name,
                    placement_group=placement_group,
                    placement_group_bundle_index=placement_group_bundle_index,
                    timeout_s=timeout_s, retry_on_timeout=retry_on_timeout,
                )

        return _Options()

    def remote(self, *args, **kwargs) -> Any:
        return self._remote(args, kwargs)

    def _remote(self, args, kwargs, *, num_returns=None, num_cpus=None,
                num_gpus=None, resources=None, max_retries=None, name=None,
                placement_group=None, placement_group_bundle_index=-1,
                timeout_s=None, retry_on_timeout=False):
        worker = global_worker()
        worker.check_connected()
        core = worker.core
        from ._private.config import get_config

        if num_cpus is not None or num_gpus is not None or resources is not None:
            res = dict(resources or {})
            res.setdefault("CPU", 1 if num_cpus is None else num_cpus)
            if num_gpus:
                res["GPU"] = num_gpus
            resource_set = ResourceSet.from_dict(res)
        else:
            resource_set = self._resources
        if placement_group is not None:
            resource_set = ResourceSet.from_dict(
                placement_group.translated_resources(
                    resource_set.to_dict(), placement_group_bundle_index))

        task_id = core.next_task_id()
        spec = TaskSpec(
            task_id=task_id,
            job_id=core.job_id,
            task_type=TaskType.NORMAL_TASK,
            function=self._descriptor,
            args=[_pack_arg(a) for a in args],
            num_returns=num_returns if num_returns is not None else self._num_returns,
            resources=resource_set,
            max_retries=(
                max_retries if max_retries is not None
                else (self._max_retries if self._max_retries is not None
                      else get_config().max_retries_default)
            ),
            name=name or self._name,
            metadata={"kwargs": kwargs} if kwargs else {},
            placement_group_id=(placement_group.id
                                if placement_group is not None else None),
            placement_group_bundle_index=placement_group_bundle_index,
            timeout_s=timeout_s,
            retry_on_timeout=retry_on_timeout,
        )
        refs = core.submit_task(self._function, spec)
        if spec.num_returns == 1:
            return refs[0]
        return refs


def _pack_arg(arg):
    if isinstance(arg, ObjectRef):
        return ("ref", arg.id)
    return ("value", arg)


def remote(*args, **kwargs):
    """``@remote`` / ``@remote(num_cpus=..., num_returns=...)`` decorator.

    Dispatches to RemoteFunction for functions and ActorClass for classes
    (reference: python/ray/worker.py:1799 make_decorator).

    Export semantics (cluster mode): a function object is pickled and
    exported ONCE, on its first submission — the same as the reference's
    export-at-decoration (python/ray/function_manager.py). Mutating a
    captured global/closure cell after the first ``.remote()`` call does NOT
    re-export; cluster workers keep executing the first-export snapshot.
    Re-decorate (or define a new function) to ship new captured state.
    """
    from .actor import ActorClass

    def make(target):
        if isinstance(target, type):
            return ActorClass(target, **kwargs)
        return RemoteFunction(target, **kwargs)

    if len(args) == 1 and callable(args[0]) and not kwargs:
        return make(args[0])
    if args:
        raise TypeError("@remote takes keyword arguments only")
    return make

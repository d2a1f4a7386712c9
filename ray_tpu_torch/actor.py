"""Actors: stateful remote classes.

Reference: ``python/ray/actor.py`` — ``@remote`` on a class yields an
ActorClass; ``.remote(...)`` creates the actor and returns an ActorHandle whose
method stubs submit ordered actor tasks. Handles are serializable and can be
passed to other tasks/actors (reference ActorHandle :591).

The port's copy of ``ray_tpu/actor.py``: ``num_gpus`` and the ``GPU``
resource in place of ``num_tpus`` and ``TPU``.
"""

from __future__ import annotations

import inspect
from typing import Dict, Optional

from ._private.ids import ActorID, TaskID
from ._private.resources import ResourceSet
from ._private.task_spec import FunctionDescriptor, TaskSpec, TaskType
from ._private.worker import global_worker
from .object_ref import ObjectRef


def exit_actor() -> None:
    """Terminate the current actor from inside one of its methods
    (reference: actor.py:920). The in-flight call returns None; queued and
    subsequent calls fail with ActorDiedError; no restart is attempted."""
    from .exceptions import ActorExitError

    raise ActorExitError()


class Checkpointable:
    """Opt-in actor checkpointing (reference: actor.py:972 Checkpointable ABC).

    An actor class (created with ``max_restarts != 0``) that subclasses this
    gets: after every method call, ``should_checkpoint(ctx)`` is consulted and
    ``save_checkpoint()``'s blob is retained (last 20, matching the
    reference's keep-last-20 default); after a restart, ``load_checkpoint``
    receives the newest blob before serving calls. Simplified vs the
    reference: blobs live in the runtime, not a user-managed store, so there
    is no checkpoint_expired/checkpoint-id protocol.
    """

    def should_checkpoint(self, checkpoint_context) -> bool:
        return True

    def save_checkpoint(self):
        raise NotImplementedError

    def load_checkpoint(self, checkpoint) -> None:
        raise NotImplementedError


class ActorMethod:
    """Stub for one actor method (reference actor.py:51)."""

    def __init__(self, handle: "ActorHandle", method_name: str, num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method {self._method_name} cannot be called directly; "
            f"use .{self._method_name}.remote()."
        )

    def options(self, *, num_returns: Optional[int] = None):
        parent = self

        class _Options:
            def remote(self, *args, **kwargs):
                return parent._remote(args, kwargs, num_returns=num_returns)

        return _Options()

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs)

    def _remote(self, args, kwargs, num_returns: Optional[int] = None):
        worker = global_worker()
        worker.check_connected()
        core = worker.core
        from ._private.runtime import ensure_context

        ctx = ensure_context(core)
        counter = next(ctx.task_counter)
        task_id = TaskID.for_actor_task(
            core.job_id, ctx.current_task_id, counter, self._handle._actor_id
        )
        spec = TaskSpec(
            task_id=task_id,
            job_id=core.job_id,
            task_type=TaskType.ACTOR_TASK,
            function=FunctionDescriptor(
                self._handle._module, self._method_name
            ),
            args=[("ref", a.id) if isinstance(a, ObjectRef) else ("value", a)
                  for a in args],
            num_returns=num_returns if num_returns is not None else self._num_returns,
            resources=ResourceSet.from_dict({}),
            actor_id=self._handle._actor_id,
            metadata={"kwargs": kwargs} if kwargs else {},
        )
        refs = core.submit_actor_task(spec)
        if spec.num_returns == 1:
            return refs[0]
        return refs


class ActorHandle:
    """Serializable reference to a live actor (reference actor.py:591)."""

    def __init__(self, actor_id: ActorID, class_name: str, module: str,
                 method_names: tuple):
        self._actor_id = actor_id
        self._class_name = class_name
        self._module = module
        self._method_names = method_names

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        if item not in self._method_names:
            raise AttributeError(
                f"actor {self._class_name} has no method {item!r}"
            )
        return ActorMethod(self, item)

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (
            ActorHandle,
            (self._actor_id, self._class_name, self._module, self._method_names),
        )

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id


class ActorClass:
    """Wrapper produced by ``@remote`` on a class (reference actor.py:267)."""

    def __init__(self, cls: type, *, num_cpus: Optional[float] = None,
                 num_gpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None,
                 max_restarts: int = 0, max_concurrency: int = 1,
                 num_returns: int = 1, name: Optional[str] = None,
                 lifetime: Optional[str] = None):
        self._cls = cls
        res = dict(resources or {})
        if num_cpus is not None:
            res["CPU"] = num_cpus
        if num_gpus is not None:
            res["GPU"] = num_gpus
        self._resources = ResourceSet.from_dict(res)
        self._max_restarts = max_restarts
        self._max_concurrency = max_concurrency
        self._default_name = name
        self._lifetime = lifetime
        self._is_asyncio = any(
            inspect.iscoroutinefunction(m)
            for _, m in inspect.getmembers(cls, inspect.isfunction)
        )
        self._method_names = tuple(
            n for n, _ in inspect.getmembers(cls, callable)
            if not n.startswith("__")
        )

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__} cannot be instantiated directly; "
            f"use {self._cls.__name__}.remote()."
        )

    def options(self, *, name: Optional[str] = None,
                num_cpus: Optional[float] = None, num_gpus: Optional[float] = None,
                resources: Optional[Dict[str, float]] = None,
                max_concurrency: Optional[int] = None,
                max_restarts: Optional[int] = None,
                lifetime: Optional[str] = None,
                placement_group=None,
                placement_group_bundle_index: int = -1):
        parent = self

        class _Options:
            def remote(self, *args, **kwargs):
                return parent._remote(
                    args, kwargs, name=name, num_cpus=num_cpus, num_gpus=num_gpus,
                    resources=resources, max_concurrency=max_concurrency,
                    max_restarts=max_restarts, lifetime=lifetime,
                    placement_group=placement_group,
                    placement_group_bundle_index=placement_group_bundle_index,
                )

        return _Options()

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._remote(args, kwargs)

    def _remote(self, args, kwargs, *, name=None, num_cpus=None, num_gpus=None,
                resources=None, max_concurrency=None, max_restarts=None,
                lifetime=None, placement_group=None,
                placement_group_bundle_index=-1) -> ActorHandle:
        worker = global_worker()
        worker.check_connected()
        core = worker.core
        from ._private.runtime import ensure_context

        ctx = ensure_context(core)
        counter = next(ctx.task_counter)
        actor_id = ActorID.of(core.job_id, ctx.current_task_id, counter)
        creation_task_id = TaskID.for_actor_creation_task(actor_id)

        if num_cpus is not None or num_gpus is not None or resources is not None:
            res = dict(resources or {})
            if num_cpus is not None:
                res["CPU"] = num_cpus
            if num_gpus is not None:
                res["GPU"] = num_gpus
            resource_set = ResourceSet.from_dict(res)
        else:
            resource_set = self._resources
        if placement_group is not None:
            # The actor's lifetime resources come out of the bundle's
            # reservation (group-scoped names exist only on its node).
            resource_set = ResourceSet.from_dict(
                placement_group.translated_resources(
                    resource_set.to_dict(), placement_group_bundle_index))

        spec = TaskSpec(
            task_id=creation_task_id,
            job_id=core.job_id,
            task_type=TaskType.ACTOR_CREATION_TASK,
            function=FunctionDescriptor(self._cls.__module__, self._cls.__name__),
            args=[],
            num_returns=1,
            resources=resource_set,
            actor_id=actor_id,
            max_restarts=(max_restarts if max_restarts is not None
                          else self._max_restarts),
            max_concurrency=(max_concurrency if max_concurrency is not None
                             else self._max_concurrency),
            is_asyncio=self._is_asyncio,
            name=name or self._default_name,
            placement_group_id=(placement_group.id
                                if placement_group is not None else None),
            placement_group_bundle_index=placement_group_bundle_index,
        )
        core.create_actor(self._cls, spec, args, kwargs)
        return ActorHandle(
            actor_id, self._cls.__name__, self._cls.__module__, self._method_names
        )

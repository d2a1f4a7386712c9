"""Replica actor wrapping a user backend (reference: python/ray/serve/backend_worker.py).

A replica holds the user's callable (a function, or a class instance whose
``__call__``/named methods serve queries). For accelerator backends the
instance typically owns device-resident params and caches, so keeping the
replica alive between queries is what amortizes weight transfer and
warm-up.

The port's copy of ``ray_tpu/serve/backend_worker.py``. One addition:
``ReplicaActor.__ray_shutdown__`` forwards the runtime's teardown hook to
the user callable, so a killed replica (scale-down, ``delete_backend``,
replacement, ``serve.shutdown()``) closes an ``LMBackend`` and frees its
engine on the card. A kill does not stop a call already running on the
replica, in either package; so that such a call still gets its answer, as
in the reference, the callable is closed when the last one ends.
"""

from __future__ import annotations

import functools
import inspect
import threading
from typing import Any, Callable, List

from .config import ServeRequest

# Reserved method name the master's reconcile loop probes with
# handle_request(HEALTH_CHECK_METHOD, (), {}): it must never collide with a
# user method, so it is dunder-shaped and intercepted before dispatch.
HEALTH_CHECK_METHOD = "__health__"


def _is_batched(fn: Callable) -> bool:
    return bool(getattr(fn, "__serve_accept_batch__", False))


def _in_flight(method: Callable) -> Callable:
    """Count a replica call while it runs; the last call to end after a
    teardown hook arrived closes the callable."""
    @functools.wraps(method)
    def call(self, *args, **kwargs):
        with self._lock:
            self._calls += 1
        try:
            return method(self, *args, **kwargs)
        finally:
            with self._lock:
                self._calls -= 1
                last = self._closing and not self._calls
            if last:
                self._close_callable()
    return call


class ReplicaActor:
    """One backend replica. Created by the ServeMaster as a plain actor."""

    def __init__(self, backend_tag: str, func_or_class: Any, init_args: tuple,
                 user_config: dict, init_kwargs: dict = None):
        self._lock = threading.Lock()
        self._calls = 0          # handle_request/handle_batch under way
        self._closing = False    # the teardown hook arrived
        self._closed = False     # the callable's own hook ran
        self.backend_tag = backend_tag
        init_kwargs = init_kwargs or {}
        if inspect.isclass(func_or_class):
            self.callable = func_or_class(*init_args, **init_kwargs)
        else:
            if init_args or init_kwargs:
                raise ValueError(
                    "init args/kwargs are only valid for class backends")
            self.callable = func_or_class
        self.user_config = user_config
        self.num_queries = 0
        if hasattr(self.callable, "reconfigure"):
            self.callable.reconfigure(user_config)

    def _target(self, method: str) -> Callable:
        if method:
            return getattr(self.callable, method)
        if inspect.isfunction(self.callable) or inspect.ismethod(self.callable):
            return self.callable
        if callable(self.callable):
            # Bound __call__, so markers set on the class's __call__ (e.g.
            # @serve.accept_batch) are visible through getattr.
            return self.callable.__call__
        raise TypeError(
            f"backend {self.backend_tag} is not callable and no method given"
        )

    def check_health(self) -> dict:
        """Typed health probe. Delegates to the user callable's
        ``check_health()`` when it defines one (e.g. a poisoned LMBackend
        reports unhealthy here instead of erroring on every request);
        otherwise a reachable replica is a healthy replica."""
        probe = getattr(self.callable, "check_health", None)
        if callable(probe):
            out = probe()
            if isinstance(out, dict):
                return out
            return {"healthy": bool(out)}
        return {"healthy": True}

    @_in_flight
    def handle_request(self, method: str, args: tuple, kwargs: dict) -> Any:
        if method == HEALTH_CHECK_METHOD:
            return self.check_health()
        self.num_queries += 1
        target = self._target(method)
        if _is_batched(target):
            # A batched callable still accepts singleton batches.
            return target([ServeRequest(args, kwargs)])[0]
        return target(*args, **kwargs)

    @_in_flight
    def handle_batch(self, method: str, requests: List[tuple]) -> List[Any]:
        """Serve a batch collected by the router.

        ``requests`` is a list of (args, kwargs). Batched targets get the whole
        list as ``List[ServeRequest]`` and must return a same-length list;
        unbatched targets are called per-request (the router batches only when
        the backend opted in, so this path is a safety net).
        """
        self.num_queries += len(requests)
        target = self._target(method)
        if _is_batched(target):
            out = target([ServeRequest(a, k) for a, k in requests])
            if not isinstance(out, (list, tuple)) or len(out) != len(requests):
                raise ValueError(
                    f"batched backend {self.backend_tag} must return a list of "
                    f"length {len(requests)}, got {type(out).__name__}"
                )
            return list(out)
        return [target(*a, **k) for a, k in requests]

    def reconfigure(self, user_config: dict) -> None:
        self.user_config = user_config
        if hasattr(self.callable, "reconfigure"):
            self.callable.reconfigure(user_config)

    def stats(self) -> dict:
        return {"backend": self.backend_tag, "num_queries": self.num_queries}

    def ready(self) -> bool:
        return True

    def __ray_shutdown__(self) -> None:
        """The runtime's actor-teardown hook (``LocalActor.kill``): runs the
        user callable's own ``__ray_shutdown__`` once, if it has one, now or,
        when calls are still running, as the last of them ends. In one
        process nothing else frees what a dead replica's callable holds
        (an ``LMBackend``'s KV cache and pump thread)."""
        with self._lock:
            self._closing = True
            busy = self._calls
        if not busy:
            self._close_callable()

    def _close_callable(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        hook = getattr(self.callable, "__ray_shutdown__", None)
        if hook is not None:
            hook()

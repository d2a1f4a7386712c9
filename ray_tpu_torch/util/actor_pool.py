"""Fixed pool of actors with load-balanced submission.

Reference behavior: ``python/ray/util/actor_pool.py`` — ``map``/
``map_unordered`` stream values through idle actors; ``submit``/``get_next``/
``get_next_unordered`` give manual control.

Bookkeeping: ``_index_to_future`` holds every unclaimed result (in submission
order); ``_future_to_actor`` holds only in-flight tasks so their actor can be
recycled the moment the task finishes.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Optional

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._idle_actors = list(actors)
        self._future_to_actor: dict = {}
        self._index_to_future: dict = {}
        self._next_task_index = 0
        self._pending_submits: List[tuple] = []

    def map(self, fn: Callable[[Any, Any], Any], values: Iterable[Any]) -> Iterator[Any]:
        """Apply fn(actor, value) over values; yields results in order."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """Schedule fn(actor, value) on the next idle actor; queues if none."""
        if self._idle_actors:
            actor = self._idle_actors.pop()
            future = fn(actor, value)
            self._future_to_actor[future] = actor
            self._index_to_future[self._next_task_index] = future
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._index_to_future) or bool(self._pending_submits)

    def get_next(self, timeout: Optional[float] = None) -> Any:
        """Next result in submission order (earliest unclaimed index)."""
        if not self.has_next():
            raise StopIteration("No more results to get")
        while not self._index_to_future:
            self._wait_any(timeout)
        idx = min(self._index_to_future)
        future = self._index_to_future.pop(idx)
        ready, _ = ray_tpu_torch.wait([future], num_returns=1, timeout=timeout)
        if not ready:
            self._index_to_future[idx] = future
            raise TimeoutError("Timed out waiting for result")
        self._recycle(future)
        return ray_tpu_torch.get(future)

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        """Next result in completion order."""
        if not self.has_next():
            raise StopIteration("No more results to get")
        while not self._index_to_future:
            self._wait_any(timeout)
        ready, _ = ray_tpu_torch.wait(list(self._index_to_future.values()),
                                num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("Timed out waiting for result")
        future = ready[0]
        for idx, f in self._index_to_future.items():
            if f is future or f == future:
                del self._index_to_future[idx]
                break
        self._recycle(future)
        return ray_tpu_torch.get(future)

    def _wait_any(self, timeout: Optional[float]) -> None:
        """Block until some in-flight task finishes, freeing its actor so a
        queued submit can start (which registers the awaited index)."""
        if not self._future_to_actor:
            raise RuntimeError("Deadlock: pending submits but no running tasks")
        ready, _ = ray_tpu_torch.wait(list(self._future_to_actor),
                                num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("Timed out waiting for an idle actor")
        self._recycle(ready[0])

    def _recycle(self, future) -> None:
        actor = self._future_to_actor.pop(future, None)
        if actor is not None:
            self._return_actor(actor)

    def _return_actor(self, actor) -> None:
        self._idle_actors.append(actor)
        if self._pending_submits:
            fn, value = self._pending_submits.pop(0)
            self.submit(fn, value)

    def has_free(self) -> bool:
        return bool(self._idle_actors) and not self._pending_submits

    def pop_idle(self) -> Optional[Any]:
        if self.has_free():
            return self._idle_actors.pop()
        return None

    def push(self, actor: Any) -> None:
        self._return_actor(actor)

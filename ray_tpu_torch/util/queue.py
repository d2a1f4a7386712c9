"""Distributed FIFO queue backed by a single actor.

Reference behavior: ``python/ray/experimental/queue.py`` — asyncio-free,
``queue.Queue``-style API with Empty/Full; blocking ops poll the actor.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        import collections

        self.maxsize = maxsize
        self._q = collections.deque()

    def qsize(self) -> int:
        return len(self._q)

    def empty(self) -> bool:
        return not self._q

    def full(self) -> bool:
        return self.maxsize > 0 and len(self._q) >= self.maxsize

    def put(self, item: Any) -> bool:
        if self.maxsize > 0 and len(self._q) >= self.maxsize:
            return False
        self._q.append(item)
        return True

    def get(self):
        if not self._q:
            return False, None
        return True, self._q.popleft()


class Queue:
    """Client-side handle; one instance may be shared across tasks/actors."""

    _POLL_S = 0.005

    def __init__(self, maxsize: int = 0, actor: Optional[Any] = None):
        self.maxsize = maxsize
        if actor is not None:
            self.actor = actor
        else:
            self.actor = ray_tpu_torch.remote(num_cpus=0)(_QueueActor).remote(maxsize)

    def __reduce__(self):
        return (Queue, (self.maxsize, self.actor))

    def __len__(self) -> int:
        return self.size()

    def size(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def qsize(self) -> int:
        return self.size()

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if not block:
            if not ray_tpu_torch.get(self.actor.put.remote(item)):
                raise Full
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if ray_tpu_torch.get(self.actor.put.remote(item)):
                return
            if deadline is not None and time.monotonic() >= deadline:
                raise Full
            time.sleep(self._POLL_S)

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = ray_tpu_torch.get(self.actor.get.remote())
            if ok:
                return item
            if not block:
                raise Empty
            if deadline is not None and time.monotonic() >= deadline:
                raise Empty
            time.sleep(self._POLL_S)

    def get_nowait(self) -> Any:
        return self.get(block=False)

"""``multiprocessing.Pool``-compatible API over actors.

Reference behavior: ``python/ray/util/multiprocessing/pool.py`` — a pool of
PoolActor actors; ``map``-family calls chunk the iterable and round-robin
chunks over actors; ``AsyncResult`` wraps the outstanding futures.
"""

from __future__ import annotations

import itertools
import math
import threading
import time
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


class TimeoutError(Exception):
    pass


class PoolTaskError(Exception):
    def __init__(self, underlying: BaseException):
        super().__init__(str(underlying))
        self.underlying = underlying


class _PoolActor:
    def __init__(self, initializer: Optional[Callable] = None,
                 initargs: Optional[tuple] = None):
        if initializer:
            initializer(*(initargs or ()))

    def ping(self) -> str:
        return "ok"

    def run_batch(self, func: Callable, batch: List[tuple]) -> List[Any]:
        return [func(*args, **kwargs) for args, kwargs in batch]


class AsyncResult:
    """Handle over the chunk futures of one map/apply call."""

    def __init__(self, chunk_refs: List[Any], callback: Optional[Callable] = None,
                 error_callback: Optional[Callable] = None, single: bool = False):
        self._chunk_refs = chunk_refs
        self._single = single
        self._callback = callback
        self._error_callback = error_callback
        self._result = None
        self._done = False
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        if callback is not None or error_callback is not None:
            # Callers like joblib block on the callback rather than get();
            # deliver it from a background thread.
            t = threading.Thread(target=self._collect, daemon=True)
            t.start()

    def wait(self, timeout: Optional[float] = None) -> None:
        if not self._chunk_refs:
            self._collect()
            return
        ready, _ = ray_tpu_torch.wait(self._chunk_refs,
                                num_returns=len(self._chunk_refs),
                                timeout=timeout)
        if len(ready) == len(self._chunk_refs):
            self._collect()

    def _collect(self) -> None:
        with self._lock:
            self._collect_locked()

    def _collect_locked(self) -> None:
        if self._done:
            return
        try:
            chunks = ray_tpu_torch.get(self._chunk_refs)
            flat = [x for chunk in chunks for x in chunk]
            self._result = flat[0] if self._single else flat
            if self._callback:
                self._callback(self._result)
        except Exception as e:
            self._error = e
            if self._error_callback:
                self._error_callback(e)
        self._done = True

    def get(self, timeout: Optional[float] = None) -> Any:
        self.wait(timeout)
        if not self._done:
            raise TimeoutError("Result not ready")
        if self._error is not None:
            raise self._error
        return self._result

    def ready(self) -> bool:
        if self._done:
            return True
        if not self._chunk_refs:
            return True
        ready, _ = ray_tpu_torch.wait(self._chunk_refs,
                                num_returns=len(self._chunk_refs), timeout=0)
        return len(ready) == len(self._chunk_refs)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("Result is not ready")
        self._collect()
        return self._error is None


def _chunk(iterable: Iterable, chunksize: int):
    it = iter(iterable)
    while True:
        block = list(itertools.islice(it, chunksize))
        if not block:
            return
        yield block


class Pool:
    """Drop-in replacement for multiprocessing.Pool running on actors."""

    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: Optional[tuple] = None,
                 maxtasksperchild: Optional[int] = None,
                 ray_address: Optional[str] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=ray_address)
        if processes is None:
            processes = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
        if processes < 1:
            raise ValueError("processes must be >= 1")
        self._processes = processes
        actor_cls = ray_tpu_torch.remote(num_cpus=1)(_PoolActor)
        self._actors = [actor_cls.remote(initializer, initargs)
                        for _ in range(processes)]
        ray_tpu_torch.get([a.ping.remote() for a in self._actors])
        self._rr = itertools.cycle(range(processes))
        self._closed = False

    def _check_running(self) -> None:
        if self._closed:
            raise ValueError("Pool not running")

    def _default_chunksize(self, n: int) -> int:
        return max(1, math.ceil(n / (self._processes * 4)))

    def _submit_chunks(self, func, arg_batches: List[List[tuple]]) -> List[Any]:
        refs = []
        for batch in arg_batches:
            actor = self._actors[next(self._rr)]
            refs.append(actor.run_batch.remote(func, batch))
        return refs

    # -- apply -------------------------------------------------------------

    def apply(self, func: Callable, args: tuple = (), kwds: Optional[dict] = None) -> Any:
        return self.apply_async(func, args, kwds).get()

    def apply_async(self, func: Callable, args: tuple = (),
                    kwds: Optional[dict] = None,
                    callback: Optional[Callable] = None,
                    error_callback: Optional[Callable] = None) -> AsyncResult:
        self._check_running()
        refs = self._submit_chunks(func, [[(tuple(args), kwds or {})]])
        return AsyncResult(refs, callback, error_callback, single=True)

    # -- map ---------------------------------------------------------------

    def map(self, func: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(func, iterable, chunksize).get()

    def map_async(self, func: Callable, iterable: Iterable,
                  chunksize: Optional[int] = None,
                  callback: Optional[Callable] = None,
                  error_callback: Optional[Callable] = None) -> AsyncResult:
        self._check_running()
        items = [((x,), {}) for x in iterable]
        chunksize = chunksize or self._default_chunksize(len(items))
        refs = self._submit_chunks(func, list(_chunk(items, chunksize)))
        return AsyncResult(refs, callback, error_callback)

    def starmap(self, func: Callable, iterable: Iterable[tuple],
                chunksize: Optional[int] = None) -> List[Any]:
        return self.starmap_async(func, iterable, chunksize).get()

    def starmap_async(self, func: Callable, iterable: Iterable[tuple],
                      chunksize: Optional[int] = None,
                      callback: Optional[Callable] = None,
                      error_callback: Optional[Callable] = None) -> AsyncResult:
        self._check_running()
        items = [(tuple(x), {}) for x in iterable]
        chunksize = chunksize or self._default_chunksize(len(items))
        refs = self._submit_chunks(func, list(_chunk(items, chunksize)))
        return AsyncResult(refs, callback, error_callback)

    # -- imap --------------------------------------------------------------

    def imap(self, func: Callable, iterable: Iterable,
             chunksize: int = 1):
        self._check_running()
        items = [((x,), {}) for x in iterable]
        refs = self._submit_chunks(func, list(_chunk(items, chunksize)))
        for ref in refs:  # submission order
            yield from ray_tpu_torch.get(ref)

    def imap_unordered(self, func: Callable, iterable: Iterable,
                       chunksize: int = 1):
        self._check_running()
        items = [((x,), {}) for x in iterable]
        refs = self._submit_chunks(func, list(_chunk(items, chunksize)))
        pending = list(refs)
        while pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            yield from ray_tpu_torch.get(ready[0])

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass

    def join(self) -> None:
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()

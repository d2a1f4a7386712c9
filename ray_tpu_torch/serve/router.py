"""Asyncio router actor (reference: python/ray/serve/router.py + policy.py).

One router actor fronts all endpoints: it applies the endpoint's traffic
split, enforces per-replica ``max_concurrent_queries`` with semaphores, and —
for backends that opted in — coalesces queries into batches so the backend can
feed the accelerator one big matmul instead of many small ones. Everything is
a single event loop; replica calls are awaited ObjectRefs, so slow replicas
never block routing decisions.

Failover (the self-healing fleet's data-plane half): a replica call that
fails with an *infrastructure* error (the actor died, or the backend raised
``ReplicaUnavailableError`` — e.g. a poisoned LM engine) marks that replica
DOWN, purges the streams pinned to it (their next poll fails fast with
``ReplicaUnavailableError`` instead of hanging to the idle timeout), and
retries the call on a sibling replica under a per-request retry budget:

* ``RAY_TPU_TORCH_SERVE_RETRY_MAX_ATTEMPTS`` — replicas tried per call
  (default 3);
* ``RAY_TPU_TORCH_SERVE_RETRY_DEADLINE_S``  — wall budget per call
  (default 30);
* ``RAY_TPU_TORCH_SERVE_RETRY_BACKOFF_S``   — initial backoff, doubles per
  retry (default 0.05).

Application errors are never retried — the backend already executed the
request once, and re-running user code is the caller's policy decision.
Whole-response and batched calls are treated as idempotent under *replica
death* (a dead replica can't have delivered a result); see docs/serve.md for
the at-least-once caveat when a replica dies mid-execution.

The port's copy of ``ray_tpu/serve/router.py``; its knobs read the
``RAY_TPU_TORCH_`` prefix.
"""

from __future__ import annotations

import asyncio
import os
import random
import time
from typing import Any, Dict, List, Optional, Tuple

from ..exceptions import (
    ActorDiedError,
    ActorUnavailableError,
    ReplicaUnavailableError,
    TaskError,
)

# Tokens of streams whose pinned replica vanished are remembered so the
# client's next poll gets the typed error, not a confusing KeyError. Bounded:
# oldest tombstones fall off first (a client that never re-polls would
# otherwise leak one entry per failed stream forever).
_MAX_STREAM_TOMBSTONES = 4096


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _is_unavailable(exc: BaseException) -> bool:
    """True for failures that mean "this replica cannot serve", as opposed
    to application errors raised by user code. TaskError is unwrapped one
    level: a backend raising ReplicaUnavailableError (poisoned engine)
    arrives wrapped by the replica's task execution."""
    if isinstance(exc, (ActorDiedError, ActorUnavailableError,
                        ReplicaUnavailableError)):
        return True
    if isinstance(exc, TaskError) and isinstance(
            exc.cause, ReplicaUnavailableError):
        return True
    return False


class _Replica:
    def __init__(self, handle: Any, max_concurrent: int):
        self.handle = handle
        self.sem = asyncio.Semaphore(max_concurrent)
        self.inflight = 0
        self.down = False
        self.down_reason = ""
        # Draining: the master retired this replica — no new calls or
        # stream starts route here, but already-pinned streams keep
        # polling until they finish (graceful scale-down).
        self.draining = False

    @property
    def routable(self) -> bool:
        return not (self.down or self.draining)


class _Backend:
    def __init__(self, config: dict):
        self.config = config
        self.replicas: List[_Replica] = []
        self.rr = 0  # round-robin cursor among replicas
        self.queue: Optional[asyncio.Queue] = None
        self.batch_task: Optional[asyncio.Task] = None


class Router:
    """Routes (endpoint, query) -> backend replica. Runs as an asyncio actor."""

    def __init__(self):
        from .metric import MetricRecorder

        self.backends: Dict[str, _Backend] = {}
        self.traffic: Dict[str, Dict[str, float]] = {}  # endpoint -> backend -> w
        self.num_routed: Dict[str, int] = {}
        self.num_errors: Dict[str, int] = {}
        self.metrics = MetricRecorder()
        # Stream affinity: a stream's state lives inside ONE replica, so
        # every poll must hit the replica that started it. Keyed by a
        # ROUTER-scoped token (backend tokens are only unique per replica
        # — two replicas of the same backend happily mint the same id).
        # router token -> [backend_tag, _Replica, last_used, backend_token]
        self._streams: Dict[str, list] = {}
        self._stream_seq = 0
        # stream token -> reason; the next poll raises the typed error.
        self._stream_failed: Dict[str, str] = {}
        self.stream_idle_timeout_s = 300.0
        self.retry_max_attempts = max(
            1, int(_env_f("RAY_TPU_TORCH_SERVE_RETRY_MAX_ATTEMPTS", 3)))
        self.retry_deadline_s = _env_f(
            "RAY_TPU_TORCH_SERVE_RETRY_DEADLINE_S", 30.0)
        self.retry_backoff_s = _env_f(
            "RAY_TPU_TORCH_SERVE_RETRY_BACKOFF_S", 0.05)
        # Fleet counters (down/retry/failover): surfaced by stats() and
        # mirrored into the metrics registry by the master's reconcile loop.
        self.counters: Dict[str, int] = {
            "replicas_down": 0,   # replicas this router marked DOWN
            "retries": 0,         # calls re-dispatched after a down-mark
            "failovers": 0,       # calls that SUCCEEDED on a sibling
            "stream_failfast": 0,  # streams failed fast (vs the idle hang)
        }

    # ---- control plane (called by ServeMaster) ----

    def _drain(self, old: Optional[_Backend], new: Optional[_Backend],
               reason: str) -> None:
        """Stop an old backend's batch loop; migrate queued queries to the
        new backend's queue, or fail them if there is nowhere to go."""
        if old is None:
            return
        if old.batch_task is not None:
            old.batch_task.cancel()
        if old.queue is None:
            return
        while not old.queue.empty():
            item = old.queue.get_nowait()
            if new is not None and new.queue is not None:
                new.queue.put_nowait(item)
            elif new is not None and new.replicas:
                method, args, kwargs, fut = item
                task = asyncio.get_event_loop().create_task(
                    self._call_one(None, new, method, args, kwargs))

                def _copy(t, f=fut):
                    if f.done() or t.cancelled():
                        return
                    if t.exception() is not None:
                        f.set_exception(t.exception())
                    else:
                        f.set_result(t.result())

                task.add_done_callback(_copy)
            else:
                fut = item[3]
                if not fut.done():
                    fut.set_exception(RuntimeError(reason))

    def _fail_streams(self, match, reason: str) -> int:
        """Purge every stream whose entry matches ``match(entry)``; its next
        poll raises ReplicaUnavailableError(reason) instead of routing to a
        stale/dead replica until the 300 s idle timeout."""
        failed = 0
        for tok, ent in list(self._streams.items()):
            if not match(ent):
                continue
            del self._streams[tok]
            self._stream_failed[tok] = reason
            failed += 1
        self.counters["stream_failfast"] += failed
        while len(self._stream_failed) > _MAX_STREAM_TOMBSTONES:
            self._stream_failed.pop(next(iter(self._stream_failed)))
        return failed

    async def set_backend(self, backend_tag: str, replica_handles: List[Any],
                          config: dict) -> None:
        b = _Backend(config)
        maxc = int(config.get("max_concurrent_queries", 8))
        b.replicas = [_Replica(h, maxc) for h in replica_handles]
        if config.get("max_batch_size", 0) and b.replicas:
            b.queue = asyncio.Queue()
            b.batch_task = asyncio.get_event_loop().create_task(
                self._batch_loop(backend_tag, b))
        old = self.backends.get(backend_tag)
        self.backends[backend_tag] = b
        # Re-pin live streams to the new _Replica wrapping the same actor;
        # purge streams whose replica is not in the new set (they would
        # otherwise keep polling the stale handle until the idle timeout).
        by_handle = {rep.handle: rep for rep in b.replicas}
        for tok, ent in list(self._streams.items()):
            if ent[0] != backend_tag:
                continue
            kept = by_handle.get(ent[1].handle)
            if kept is not None:
                ent[1] = kept
        self._fail_streams(
            lambda ent: ent[0] == backend_tag
            and ent[1].handle not in by_handle,
            f"stream's replica was removed from backend {backend_tag!r}")
        self._drain(old, b, f"backend {backend_tag!r} lost all replicas")

    async def remove_backend(self, backend_tag: str) -> None:
        self._fail_streams(lambda ent: ent[0] == backend_tag,
                           f"backend {backend_tag!r} was deleted")
        self._drain(self.backends.pop(backend_tag, None), None,
                    f"backend {backend_tag!r} was deleted")
        # Drop its metric window too, or churn leaks one window (and one
        # forever-reported Prometheus series) per ever-seen tag.
        self.metrics.backends.pop(backend_tag, None)

    async def set_traffic(self, endpoint: str, traffic: Dict[str, float]) -> None:
        self.traffic[endpoint] = dict(traffic)

    async def remove_endpoint(self, endpoint: str) -> None:
        self.traffic.pop(endpoint, None)
        self.metrics.endpoints.pop(endpoint, None)
        self.num_routed.pop(endpoint, None)
        self.num_errors.pop(endpoint, None)

    async def drain_replica(self, backend_tag: str, replica_handle: Any) -> bool:
        """Master scale-down hook: stop routing NEW work (calls and stream
        starts) to this replica; pinned streams keep polling. Returns True
        when the replica was found."""
        b = self.backends.get(backend_tag)
        if b is None:
            return False
        for r in b.replicas:
            if r.handle == replica_handle:
                r.draining = True
                return True
        return False

    async def replica_load(self, backend_tag: str, replica_handle: Any) -> dict:
        """Inflight calls + pinned live streams of one replica — the
        master polls this to zero before killing a draining replica."""
        b = self.backends.get(backend_tag)
        if b is None:
            return {"inflight": 0, "streams": 0, "found": False}
        for r in b.replicas:
            if r.handle == replica_handle:
                streams = sum(1 for ent in self._streams.values()
                              if ent[1] is r)
                return {"inflight": r.inflight, "streams": streams,
                        "found": True}
        return {"inflight": 0, "streams": 0, "found": False}

    # ---- data plane ----

    def _mark_down(self, backend_tag: str, r: _Replica,
                   exc: BaseException) -> None:
        if r.down:
            return
        r.down = True
        r.down_reason = f"{type(exc).__name__}: {exc}"
        self.counters["replicas_down"] += 1
        self._fail_streams(
            lambda ent: ent[1] is r,
            f"stream's replica on backend {backend_tag!r} became "
            f"unavailable ({r.down_reason})")

    async def route(self, endpoint: str, method: str, args: tuple,
                    kwargs: dict) -> Any:
        if method in ("stream_poll", "stream_cancel"):
            # Pinned calls: the stream's replica was chosen at start time,
            # so the traffic policy (and even the endpoint registration —
            # the backend may have been deleted mid-stream, which is
            # exactly when the tombstone must surface) is not consulted.
            return await self._route_stream_pinned(
                endpoint, method, args, kwargs)
        traffic = self.traffic.get(endpoint)
        if not traffic:
            raise ValueError(f"no traffic policy for endpoint {endpoint!r}")
        backend_tag = self._pick_backend(traffic)
        b = self.backends.get(backend_tag)
        if b is None or not b.replicas:
            raise ReplicaUnavailableError(
                backend_tag,
                f"backend for endpoint {endpoint!r} has no replicas")
        self.num_routed[endpoint] = self.num_routed.get(endpoint, 0) + 1
        t0 = time.monotonic()
        try:
            if method == "stream_start":
                result = await self._route_stream(
                    endpoint, backend_tag, b, method, args, kwargs)
            elif b.queue is not None:
                fut = asyncio.get_event_loop().create_future()
                await b.queue.put((method, args, kwargs, fut))
                result = await fut
            else:
                result = await self._call_with_failover(
                    backend_tag, b, method, args, kwargs)
        except Exception:
            self.num_errors[endpoint] = self.num_errors.get(endpoint, 0) + 1
            self.metrics.record(endpoint, backend_tag,
                                time.monotonic() - t0, error=True)
            raise
        self.metrics.record(endpoint, backend_tag, time.monotonic() - t0)
        return result

    async def _call_with_failover(self, backend_tag: str, b: _Backend,
                                  method: str, args: tuple,
                                  kwargs: dict) -> Any:
        """One whole-response call, retried on sibling replicas when the
        target replica is unavailable, under the per-request retry budget
        (max attempts + deadline + exponential backoff)."""
        loop = asyncio.get_event_loop()
        deadline = loop.time() + self.retry_deadline_s
        backoff = self.retry_backoff_s
        attempt = 0
        while True:
            attempt += 1
            r = self._next_replica(b, backend_tag)
            try:
                result = await self._call_replica(r, method, args, kwargs)
            except Exception as e:  # noqa: BLE001 - classified below
                if not _is_unavailable(e):
                    raise
                self._mark_down(backend_tag, r, e)
                if (attempt >= self.retry_max_attempts
                        or loop.time() + backoff > deadline):
                    raise ReplicaUnavailableError(
                        backend_tag,
                        f"call {method or '__call__'!r} failed on {attempt} "
                        f"replica(s) within the retry budget "
                        f"(max_attempts={self.retry_max_attempts}, "
                        f"deadline={self.retry_deadline_s}s)") from e
                self.counters["retries"] += 1
                await asyncio.sleep(backoff)
                backoff *= 2
                continue
            if attempt > 1:
                self.counters["failovers"] += 1
            return result

    async def _route_stream(self, endpoint: str, backend_tag: str,
                            b: _Backend, method: str, args: tuple,
                            kwargs: dict) -> Any:
        """stream_start: skips the batch queue (the engine batches streams
        internally) and pins the stream to the replica that accepted it."""
        # Abandoned streams (no poll-to-done, no cancel — e.g. a SIGKILLed
        # caller) must not pin replica entries forever; replicas expire the
        # engine slot themselves on the same kind of timeout.
        now = time.monotonic()
        for tok, ent in list(self._streams.items()):
            if now - ent[2] > self.stream_idle_timeout_s:
                del self._streams[tok]
        # Starting a stream is idempotent under replica death (a dead
        # replica holds no visible state for it), so it rides the same
        # failover budget as whole-response calls.
        return await self._stream_start_with_failover(
            backend_tag, b, args, kwargs)

    async def _route_stream_pinned(self, endpoint: str, method: str,
                                   args: tuple, kwargs: dict) -> Any:
        """stream_poll / stream_cancel: routed by the stream's pin, not
        the traffic policy — the stream's state lives inside ONE replica."""
        token = str(args[0]) if args else str(kwargs.get("token"))
        entry = self._streams.get(token)
        if entry is None:
            reason = self._stream_failed.pop(token, None)
            if reason is not None:
                if method == "stream_cancel":
                    return False  # already gone; cancel is best-effort
                raise ReplicaUnavailableError(None, reason)
            raise KeyError(f"unknown or finished stream {token!r}")
        entry[2] = time.monotonic()
        r = entry[1]
        pinned_tag = entry[0]
        # Forward the replica's OWN token, not the router-scoped one.
        if args:
            args = (entry[3],) + tuple(args[1:])
        else:
            kwargs = dict(kwargs)
            kwargs["token"] = entry[3]
        if r.down:
            self._streams.pop(token, None)
            raise ReplicaUnavailableError(
                pinned_tag,
                f"stream's replica is down ({r.down_reason})")
        self.num_routed[endpoint] = self.num_routed.get(endpoint, 0) + 1
        t0 = time.monotonic()
        # Polls/cancels bypass the per-replica semaphore: a LONG-POLL parks
        # at the replica doing no work (its pump thread decodes regardless),
        # so letting it hold a max_concurrent_queries slot for up to wait_s
        # would starve whole-response traffic. Inflight polls are naturally
        # bounded at one per live stream; the replica's own max_concurrency
        # (BackendConfig.replica_concurrency) bounds actual execution.
        try:
            out = await self._call_replica(r, method, args, kwargs,
                                           limit=False)
        except Exception as e:  # noqa: BLE001 - classified below
            self.num_errors[endpoint] = self.num_errors.get(endpoint, 0) + 1
            self.metrics.record(endpoint, pinned_tag,
                                time.monotonic() - t0, error=True)
            if not _is_unavailable(e):
                raise
            # Fail fast, not after a 300 s hang: the stream's state died
            # with its replica, so there is nothing to fail over to.
            # (Popped before the down-mark so _fail_streams doesn't count
            # this stream a second time.)
            self._streams.pop(token, None)
            self._mark_down(pinned_tag, r, e)
            self._stream_failed.pop(token, None)
            self.counters["stream_failfast"] += 1
            raise ReplicaUnavailableError(
                pinned_tag,
                f"stream's replica died mid-stream "
                f"({type(e).__name__}: {e})") from e
        self.metrics.record(endpoint, pinned_tag, time.monotonic() - t0)
        if method == "stream_cancel" or (
                isinstance(out, dict) and out.get("done")):
            self._streams.pop(token, None)
        return out

    async def _stream_start_with_failover(self, backend_tag: str,
                                          b: _Backend, args: tuple,
                                          kwargs: dict) -> Any:
        loop = asyncio.get_event_loop()
        deadline = loop.time() + self.retry_deadline_s
        backoff = self.retry_backoff_s
        attempt = 0
        while True:
            attempt += 1
            r = self._next_replica(b, backend_tag)
            try:
                token = await self._call_replica(
                    r, "stream_start", args, kwargs)
            except Exception as e:  # noqa: BLE001 - classified below
                if not _is_unavailable(e):
                    raise
                self._mark_down(backend_tag, r, e)
                if (attempt >= self.retry_max_attempts
                        or loop.time() + backoff > deadline):
                    raise ReplicaUnavailableError(
                        backend_tag,
                        f"stream_start failed on {attempt} replica(s) "
                        f"within the retry budget") from e
                self.counters["retries"] += 1
                await asyncio.sleep(backoff)
                backoff *= 2
                continue
            if attempt > 1:
                self.counters["failovers"] += 1
            self._stream_seq += 1
            rtoken = f"st-{self._stream_seq}"
            self._streams[rtoken] = [backend_tag, r, time.monotonic(),
                                     token]
            return rtoken

    async def _call_replica(self, r: _Replica, method: str, args: tuple,
                            kwargs: dict, *, limit: bool = True) -> Any:
        if not limit:
            r.inflight += 1
            try:
                return await r.handle.handle_request.remote(
                    method, args, kwargs)
            finally:
                r.inflight -= 1
        async with r.sem:
            r.inflight += 1
            try:
                return await r.handle.handle_request.remote(
                    method, args, kwargs)
            finally:
                r.inflight -= 1

    def _pick_backend(self, traffic: Dict[str, float]) -> str:
        tags = list(traffic.keys())
        if len(tags) == 1:
            return tags[0]
        weights = [traffic[t] for t in tags]
        if sum(weights) <= 0:
            # random.choices raises a bare ValueError on total weight 0;
            # surface the actual routing condition instead.
            raise ReplicaUnavailableError(
                None, "no routable backend: every traffic weight is zero "
                      f"(backends: {tags})")
        return random.choices(tags, weights=weights, k=1)[0]

    def _next_replica(self, b: _Backend, backend_tag: str = "") -> _Replica:
        # Round-robin over ROUTABLE replicas (down/draining are skipped),
        # preferring an un-saturated one when it exists (the reference's
        # "least loaded among round robin" refinement).
        up = [r for r in b.replicas if r.routable]
        if not up:
            raise ReplicaUnavailableError(
                backend_tag or None,
                f"backend {backend_tag!r} has no live replica "
                f"({len(b.replicas)} known, all down or draining)")
        n = len(up)
        for i in range(n):
            r = up[(b.rr + i) % n]
            if not r.sem.locked():
                b.rr = (b.rr + i + 1) % n
                return r
        r = up[b.rr % n]
        b.rr = (b.rr + 1) % n
        return r

    async def _call_one(self, backend_tag: Optional[str], b: _Backend,
                        method: str, args: tuple, kwargs: dict) -> Any:
        return await self._call_with_failover(
            backend_tag or "", b, method, args, kwargs)

    async def _batch_loop(self, backend_tag: str, b: _Backend) -> None:
        max_bs = int(b.config.get("max_batch_size", 1))
        wait_s = float(b.config.get("batch_wait_timeout_s", 0.01))
        while True:
            first = await b.queue.get()
            batch: List[Tuple[str, tuple, dict, asyncio.Future]] = [first]
            deadline = asyncio.get_event_loop().time() + wait_s
            while len(batch) < max_bs:
                remaining = deadline - asyncio.get_event_loop().time()
                if remaining <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(b.queue.get(), remaining))
                except asyncio.TimeoutError:
                    break
            # A batch must be method-homogeneous: group before dispatch so a
            # concurrent .options(method=...) call can't ride along and be
            # executed against the wrong target.
            by_method: Dict[str, list] = {}
            for item in batch:
                by_method.setdefault(item[0], []).append(item)
            for group in by_method.values():
                asyncio.get_event_loop().create_task(
                    self._dispatch_batch(backend_tag, b, group))

    async def _dispatch_batch(self, backend_tag: str, b: _Backend,
                              batch) -> None:
        method = batch[0][0]
        requests = [(args, kwargs) for _, args, kwargs, _ in batch]
        futs = [fut for _, _, _, fut in batch]
        loop = asyncio.get_event_loop()
        deadline = loop.time() + self.retry_deadline_s
        backoff = self.retry_backoff_s
        attempt = 0
        while True:
            attempt += 1
            try:
                r = self._next_replica(b, backend_tag)
                async with r.sem:
                    r.inflight += 1
                    try:
                        results = await r.handle.handle_batch.remote(
                            method, requests)
                    finally:
                        r.inflight -= 1
                if attempt > 1:
                    self.counters["failovers"] += 1
                for fut, res in zip(futs, results):
                    if not fut.done():
                        fut.set_result(res)
                return
            except Exception as e:  # noqa: BLE001 - classified below
                retryable = (_is_unavailable(e)
                             and not isinstance(e, ReplicaUnavailableError))
                if retryable:
                    self._mark_down(backend_tag, r, e)
                if (retryable and attempt < self.retry_max_attempts
                        and loop.time() + backoff <= deadline):
                    self.counters["retries"] += 1
                    await asyncio.sleep(backoff)
                    backoff *= 2
                    continue
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(e)
                return

    # ---- observability ----

    async def stats(self) -> dict:
        return {
            "endpoints": {
                ep: {"routed": self.num_routed.get(ep, 0),
                     "errors": self.num_errors.get(ep, 0),
                     "traffic": self.traffic.get(ep, {})}
                for ep in self.traffic
            },
            "backends": {
                tag: {"num_replicas": len(b.replicas),
                      "up": sum(1 for r in b.replicas if r.routable),
                      "down": sum(1 for r in b.replicas if r.down),
                      "draining": sum(1 for r in b.replicas if r.draining),
                      "inflight": sum(r.inflight for r in b.replicas),
                      "queued": b.queue.qsize() if b.queue is not None else 0,
                      "batched": b.queue is not None}
                for tag, b in self.backends.items()
            },
            "counters": dict(self.counters),
            "streams": len(self._streams),
        }

    async def load_snapshot(self) -> dict:
        """Per-backend demand for the master's autoscale loop: queue depth
        + inflight (+ pinned streams, which occupy replica capacity)."""
        out = {}
        for tag, b in self.backends.items():
            streams = sum(1 for ent in self._streams.values()
                          if any(ent[1] is r for r in b.replicas))
            out[tag] = {
                "queued": b.queue.qsize() if b.queue is not None else 0,
                "inflight": sum(r.inflight for r in b.replicas),
                "streams": streams,
                "replicas_up": sum(1 for r in b.replicas if r.routable),
            }
        return out

    async def metric_snapshot(self) -> dict:
        return self.metrics.snapshot()

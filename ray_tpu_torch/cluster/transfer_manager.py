"""Pull-based cross-node transfer manager — the data plane's scheduler.

Reference counterpart: src/ray/object_manager/pull_manager.cc (admission-
controlled pulls) + object_buffer_pool.cc (chunked receive). The native
layer (``_native/transfer.py``) moves bytes: a pull is a pipeline of
fixed-size ranges received straight into the destination arena slot, with
the per-chunk offset doubling as a resume cursor. This module decides
WHICH pulls run WHEN:

* **Admission**: at most ``DEFAULT_MAX_INFLIGHT`` concurrent
  pulls per SOURCE node (N reducers draining one mapper's output must not
  thundering-herd its transfer server). Excess pulls queue FIFO; equal
  arrival order breaks ties largest-first (big objects hide more latency
  behind them, so they go first — the classic SRPT inversion for
  bandwidth-bound streams). ``enabled=False`` bypasses admission entirely
  (every pull runs immediately, chunked path intact).

* **Failover**: a sender dying mid-stream surfaces as a broken chunk
  stream; the pull keeps its landed prefix and resumes at the same offset
  against the next holder (counted in ``transfer_chunk_retries``, event-
  logged as ``transfer_sender_death``). Only when every holder is
  exhausted does the pull fail — the controller's fetch loop then re-polls
  the directory, which re-drives lineage if the object is truly gone.

* **Accounting**: ``transfer_bytes_in`` (landed payload bytes, partial
  pulls included), ``transfer_bytes_out`` (served by this node's native
  server), ``transfer_inflight``, ``transfer_queue_depth``,
  ``transfer_chunk_retries`` — all riding the heartbeat's node_stats into
  the head's time-series store and Prometheus. ``inventory()`` is the
  auditor's view: every inflight/queued pull with its source and age, so
  ``run_audit`` can flag stuck and orphaned transfers.
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

DEFAULT_MAX_INFLIGHT = 4
DEFAULT_CHUNK = 1 << 20
_MAX_EVENTS = 256


class PullFailedError(Exception):
    """Every candidate source was tried (with resume) and none completed
    the stream. The landed prefix has been aborted; the caller should
    re-poll locations (lineage re-drive happens head-side)."""


class TransferManager:
    """One per controller. Owns admission + failover for chunked pulls.

    ``store`` is the node's (spilling) object store; ``client`` the native
    TransferClient (or any object with ``probe_size``/``fetch_chunks``);
    ``server`` optionally the native TransferServer whose ``stats()``
    supplies bytes_out. All coroutine methods run on the controller's
    event loop; blocking socket work is pushed to worker threads."""

    def __init__(self, store, client, server=None,
                 max_inflight: int = DEFAULT_MAX_INFLIGHT,
                 chunk: int = DEFAULT_CHUNK,
                 enabled: bool = True):
        self.store = store
        self.client = client
        self.server = server
        self.max_inflight = max_inflight
        self.chunk = chunk
        self.enabled = enabled
        self._seq = itertools.count()
        self._tie = itertools.count()
        self._inflight_by_src: Dict[str, int] = {}
        # Per-source admission queue: heap of (seq, -size, tie, entry).
        self._waiting: Dict[str, List[Tuple[int, int, int, dict]]] = {}
        self._inflight_info: Dict[int, Dict[str, Any]] = {}
        self._queued_info: Dict[int, Dict[str, Any]] = {}
        self._token = itertools.count()
        self._events: List[Dict[str, Any]] = []
        # Counters (monotonic; deltas derived head-side).
        self.bytes_in = 0
        self.chunk_retries = 0
        self.sender_deaths = 0
        self.pulls_ok = 0
        self.pulls_failed = 0
        self.queued_total = 0

    # ------------------------------------------------------------ admission
    def _slot_free(self, src: str) -> bool:
        return self._inflight_by_src.get(src, 0) < self.max_inflight

    async def _acquire(self, src: str, size: int, seq: int,
                       deadline: float, oid: bytes) -> int:
        """Take (or queue for) a pull slot against source ``src``. Returns
        an inventory token; raises asyncio.TimeoutError when the deadline
        passes while still queued."""
        token = next(self._token)
        if not self.enabled:
            self._inflight_by_src[src] = self._inflight_by_src.get(src, 0) + 1
            self._inflight_info[token] = {
                "object_id": oid.hex(), "source": src, "ts": time.time(),
                "size": size}
            return token
        heap = self._waiting.setdefault(src, [])
        if self._slot_free(src) and not heap:
            self._inflight_by_src[src] = self._inflight_by_src.get(src, 0) + 1
        else:
            entry = {"event": asyncio.Event(), "cancelled": False,
                     "token": token}
            heapq.heappush(heap, (seq, -size, next(self._tie), entry))
            self.queued_total += 1
            self._queued_info[token] = {
                "object_id": oid.hex(), "source": src, "ts": time.time(),
                "size": size}
            try:
                await asyncio.wait_for(entry["event"].wait(),
                                       max(0.0, deadline - time.time()))
            except asyncio.TimeoutError:
                entry["cancelled"] = True
                self._queued_info.pop(token, None)
                if entry["event"].is_set():
                    # The slot was handed to us in the same tick we gave
                    # up: pass it straight on instead of leaking it.
                    self._release(src, token)
                raise
            finally:
                if not entry["cancelled"]:
                    self._queued_info.pop(token, None)
            # _release incremented the inflight count on our behalf.
        self._inflight_info[token] = {
            "object_id": oid.hex(), "source": src, "ts": time.time(),
            "size": size}
        return token

    def _release(self, src: str, token: int) -> None:
        self._inflight_info.pop(token, None)
        n = self._inflight_by_src.get(src, 0) - 1
        if n <= 0:
            self._inflight_by_src.pop(src, None)
        else:
            self._inflight_by_src[src] = n
        heap = self._waiting.get(src)
        while heap:
            _, _, _, entry = heapq.heappop(heap)
            if entry["cancelled"]:
                continue
            # Hand the freed slot straight to the best waiter (FIFO by
            # seq, largest-first among equals) before anyone new can take
            # it — incrementing here, not in the waiter, closes the race.
            self._inflight_by_src[src] = self._inflight_by_src.get(src, 0) + 1
            entry["event"].set()
            break
        if heap is not None and not heap:
            self._waiting.pop(src, None)

    # ---------------------------------------------------------------- pull
    async def pull(self, object_id: bytes,
                   sources: Sequence[Tuple[str, str, int]],
                   size_hint: int = 0, timeout: float = 30.0,
                   seq: Optional[int] = None) -> bool:
        """Pull ``object_id`` from one of ``sources`` (``(node_id, host,
        transfer_port)`` triples) into the local store, chunked and
        resumable. True when the object is local (sealed or spill-staged)
        on return. Raises PullFailedError when every source failed, and
        asyncio.TimeoutError when the admission queue outwaited
        ``timeout``."""
        if not sources:
            return False
        if seq is None:
            seq = next(self._seq)
        deadline = time.time() + timeout
        pending = list(sources)
        attempts = 0
        max_attempts = 2 * len(sources) + 1
        total: Optional[int] = None
        view = None
        offset = 0
        try:
            while pending and attempts < max_attempts \
                    and time.time() < deadline:
                node_id, host, port = pending.pop(0)
                attempts += 1
                token = await self._acquire(
                    node_id, size_hint or (total or 0), seq, deadline,
                    object_id)
                try:
                    if total is None:
                        total = await asyncio.to_thread(
                            self.client.probe_size, host, port, object_id)
                        if total is None:
                            continue  # stale location: no copy there
                    if view is None:
                        view = self.store.create(object_id, total)
                        if view is None:
                            # Raced another fetcher / already spill-staged.
                            self.pulls_ok += 1
                            return True
                    start = offset
                    self._inflight_info[token]["offset"] = offset
                    await asyncio.to_thread(
                        self.client.fetch_chunks, host, port, object_id,
                        view, offset, self.chunk)
                    self.bytes_in += total - start
                    offset = total
                    view = None  # ownership passes to the store on seal
                    self.store.seal(object_id)
                    self.pulls_ok += 1
                    return True
                except Exception as exc:  # noqa: BLE001
                    name = type(exc).__name__
                    if name == "RemoteMissError":
                        continue  # holder lost the copy; try the next one
                    if name != "TransferBrokenError":
                        raise
                    landed = max(getattr(exc, "offset", offset), offset)
                    self.bytes_in += landed - offset
                    resumed = landed > offset or total is not None
                    offset = landed
                    self.chunk_retries += 1
                    self.sender_deaths += 1
                    self._event("transfer_sender_death",
                                object_id=object_id.hex()[:16],
                                source=node_id, offset=offset,
                                total=total or 0, resumed=bool(resumed))
                    # Second pass: the source may only have blipped.
                    pending.append((node_id, host, port))
                finally:
                    self._release(node_id, token)
        finally:
            if view is not None:
                try:
                    self.store.abort(object_id)
                except Exception:  # noqa: BLE001
                    pass
        self.pulls_failed += 1
        self._event("transfer_pull_failed", object_id=object_id.hex()[:16],
                    sources=len(sources), offset=offset, total=total or 0)
        raise PullFailedError(
            f"pull of {object_id.hex()[:16]} failed after {attempts} "
            f"attempts over {len(sources)} source(s)")

    # ------------------------------------------------------- observability
    def _event(self, kind: str, **data) -> None:
        if len(self._events) < _MAX_EVENTS:
            self._events.append({"kind": kind, "ts": time.time(), **data})

    def drain_events(self) -> List[Dict[str, Any]]:
        out, self._events = self._events, []
        return out

    def stats(self) -> Dict[str, Any]:
        """Counter/gauge snapshot riding node_stats each heartbeat."""
        bytes_out = requests = 0
        if self.server is not None:
            try:
                bytes_out, requests = self.server.stats()
            except Exception:  # noqa: BLE001
                pass
        return {
            "bytes_in": self.bytes_in,
            "bytes_out": bytes_out,
            "requests_served": requests,
            "inflight": len(self._inflight_info),
            "queue_depth": len(self._queued_info),
            "chunk_retries": self.chunk_retries,
            "sender_deaths": self.sender_deaths,
            "pulls_ok": self.pulls_ok,
            "pulls_failed": self.pulls_failed,
            "queued_total": self.queued_total,
            "max_inflight": self.max_inflight,
            "sched_enabled": self.enabled,
        }

    def inventory(self) -> Dict[str, List[Dict[str, Any]]]:
        """The auditor's transfer block: every inflight and queued pull
        with source + age, so the head can flag stuck/orphaned pulls."""
        now = time.time()
        return {
            "inflight": [
                {"object_id": e["object_id"], "source": e["source"],
                 "age_s": round(now - e["ts"], 3),
                 "size": e.get("size", 0), "offset": e.get("offset", 0)}
                for e in self._inflight_info.values()],
            "queued": [
                {"object_id": e["object_id"], "source": e["source"],
                 "age_s": round(now - e["ts"], 3), "size": e.get("size", 0)}
                for e in self._queued_info.values()],
        }

    def close(self) -> None:
        for heap in self._waiting.values():
            while heap:
                _, _, _, entry = heapq.heappop(heap)
                entry["cancelled"] = True
                entry["event"].set()
        self._waiting.clear()
        self._queued_info.clear()

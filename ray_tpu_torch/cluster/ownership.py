"""Ownership object plane: owner tables, the consistent-hash owner
directory, and the per-driver owner-serve loop.

The GCS object table was the last hot-path funnel through the head event
loop: every inline result was shipped head-ward, stored under the inline
budget, and served back through ``locations_batch`` long-polls. This
module moves that plane to the edges, following the ownership model Ray's
lineage stores evolved into (arXiv:1712.05889):

- Every object id carries its creating job's 4 id bytes at ``oid[12:16]``
  (task-execution contexts keep the SUBMITTING driver's job, so a whole
  nested job tree shares one owner). The **owner** of an object is the
  driver core_worker of that job.
- Each driver runs an :class:`OwnerServer` — a tiny RPC endpoint on a
  daemon thread — backed by a budget-bounded :class:`OwnerTable`.
  Controllers push completed inline results to it (``owner_publish``)
  and borrowers pull (``owner_fetch``) or probe (``owner_locate``)
  without the head ever seeing the bytes.
- The GCS keeps only membership: a **consistent-hash directory of owner
  shards** (:class:`OwnerRing`) mapping job -> owner endpoint, replicated
  through the epoch-fenced HA log like every other membership table.

Kill switch: ``RAY_TPU_TORCH_OWNERSHIP=0`` (see ``wire.ownership_enabled``)
stops drivers registering as owners, which reverts every downstream
decision (controller divert, GCS dep staging, recovery) to the legacy
GCS-tracked path per-object.
"""
from __future__ import annotations

import asyncio
import hashlib
import os
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from . import wire
from .protocol import RpcServer

# 4-byte job id suffix length inside a 16-byte object id.
_JOB_BYTES = 4


def owner_key(oid: bytes) -> bytes:
    """The owner-routing key of an object id: its job id bytes. Matches
    the completion-ring naming (``cring.ring_name(oid[12:16])``), so the
    owner endpoint and the owner ring always agree."""
    return oid[12:12 + _JOB_BYTES]


def owner_shards() -> int:
    """Directory shard count (``RAY_TPU_TORCH_OWNER_SHARDS``). Shards bound the
    per-lookup scan and give the audit a stable unit to reason about;
    they are virtual — one GCS process serves all of them — but the
    consistent-hash split keeps the layout stable as owners come and go
    and is the seam a multi-process directory would split along."""
    try:
        n = int(os.environ.get("RAY_TPU_TORCH_OWNER_SHARDS", "8"))
    except ValueError:
        n = 8
    return max(1, min(n, 4096))


# Byte budget for one driver's owner table (64 MiB: the same budget the
# GCS inline store used, now paid per driver instead of once at the head).
# Eviction drops the oldest blobs; borrowers that miss recover through
# lineage re-drive.
OWNER_TABLE_BUDGET_BYTES = 64 << 20

# Grace window before an owner-missing probe re-drives lineage: a finished
# task's publish may still be in flight controller->owner, so the GCS only
# reconstructs when the finish is older than this.
OWNER_GRACE_S = 1.0


class OwnerRing:
    """Consistent-hash ring assigning owner keys (job ids) to directory
    shards. Classic fixed-point construction: each shard projects
    ``replicas`` virtual points onto the 64-bit ring; a key maps to the
    first point clockwise. Adding/removing a shard moves only ~1/N of the
    keyspace, so a resize never reshuffles the whole directory."""

    __slots__ = ("shards", "_points", "_hashes")

    def __init__(self, shards: Optional[int] = None, replicas: int = 64):
        self.shards = shards if shards is not None else owner_shards()
        points: List[Tuple[int, int]] = []
        for shard in range(self.shards):
            for rep in range(replicas):
                digest = hashlib.blake2b(
                    b"owner-shard:%d:%d" % (shard, rep),
                    digest_size=8).digest()
                points.append((int.from_bytes(digest, "big"), shard))
        points.sort()
        self._points = points
        self._hashes = [p[0] for p in points]

    def lookup(self, key: bytes) -> int:
        """Shard index for an owner key."""
        import bisect

        h = int.from_bytes(
            hashlib.blake2b(key, digest_size=8).digest(), "big")
        idx = bisect.bisect_right(self._hashes, h)
        if idx == len(self._points):
            idx = 0
        return self._points[idx][1]


class OwnerTable:
    """One driver's authoritative record of the objects it owns.

    Entries are ``oid -> (size, blob|None, node_addr|None)``: the blob is
    present when the bytes were pushed owner-to-owner (remote producer),
    absent when the same-host completion ring already carried them (then
    ``node_addr`` points at the producing controller's inline stash as the
    fetch fallback). Inserts are idempotent — duplicate deliveries from
    the ring and the publish path collapse onto one entry. Blob bytes are
    budget-bounded with FIFO eviction; tracking entries (size+location)
    are cheap and capped only by count."""

    __slots__ = ("_entries", "_lock", "_budget", "_blob_bytes", "arrived",
                 "inserted", "evicted", "max_entries")

    def __init__(self, budget: Optional[int] = None,
                 max_entries: int = 1 << 20):
        self._entries: "OrderedDict[bytes, Tuple[int, Optional[bytes], Optional[Tuple[str, int]]]]" = OrderedDict()
        self._lock = threading.Lock()
        self._budget = OWNER_TABLE_BUDGET_BYTES if budget is None else budget
        self._blob_bytes = 0
        self.max_entries = max_entries
        # Arrival latch: the driver's get() loop clears+rechecks this
        # instead of burning a GCS long-poll timeout when a publish lands
        # between ring waits.
        self.arrived = threading.Event()
        self.inserted = 0
        self.evicted = 0

    def insert(self, oid: bytes, size: int, blob: Optional[bytes],
               addr: Optional[Tuple[str, int]] = None) -> bool:
        """Record one owned object; returns True when the entry is new or
        was upgraded (gained bytes it lacked)."""
        with self._lock:
            cur = self._entries.get(oid)
            if cur is not None:
                if blob is not None and cur[1] is None:
                    self._entries[oid] = (size, blob, cur[2] or addr)
                    self._blob_bytes += len(blob)
                    self._evict_locked()
                    return True
                return False
            self._entries[oid] = (size, blob, addr)
            if blob is not None:
                self._blob_bytes += len(blob)
            self.inserted += 1
            self._evict_locked()
        return True

    def _evict_locked(self) -> None:
        # Oldest-first blob eviction keeps the tracking entry (size/addr)
        # so locate still answers; a borrower needing the bytes falls back
        # to the node stash or lineage re-drive.
        while self._blob_bytes > self._budget and self._entries:
            for oid, (size, blob, addr) in self._entries.items():
                if blob is None:
                    continue
                self._entries[oid] = (size, None, addr)
                self._blob_bytes -= len(blob)
                self.evicted += 1
                break
            else:
                break
        while len(self._entries) > self.max_entries:
            _, (_, blob, _) = self._entries.popitem(last=False)
            if blob is not None:
                self._blob_bytes -= len(blob)
            self.evicted += 1

    def get_blob(self, oid: bytes) -> Optional[bytes]:
        with self._lock:
            ent = self._entries.get(oid)
            return ent[1] if ent is not None else None

    def locate(self, oid: bytes) -> Optional[Dict[str, Any]]:
        with self._lock:
            ent = self._entries.get(oid)
        if ent is None:
            return None
        return {"size": ent[0], "inline": ent[1] is not None,
                "addr": ent[2]}

    def discard(self, oids) -> None:
        with self._lock:
            for oid in oids:
                ent = self._entries.pop(oid, None)
                if ent is not None and ent[1] is not None:
                    self._blob_bytes -= len(ent[1])

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries),
                    "blob_bytes": self._blob_bytes,
                    "inserted": self.inserted, "evicted": self.evicted}


class OwnerServer:
    """The driver-side owner-serve loop: an :class:`RpcServer` on its own
    daemon thread answering ``owner_publish`` / ``owner_fetch`` /
    ``owner_locate`` (plus ``wire_probe`` so peers can lift their send
    floor to v9). Handlers touch only the thread-safe
    :class:`OwnerTable` and the optional publish callback, so they never
    contend with the driver's submit/get path."""

    def __init__(self, table: OwnerTable, host: str = "127.0.0.1",
                 on_publish=None):
        self.table = table
        self.host = host
        self.port = 0
        self._on_publish = on_publish
        self._server: Optional[RpcServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self.stats: Dict[str, int] = {
            "publishes": 0, "published_items": 0,
            "fetches": 0, "fetch_hits": 0, "locates": 0}

    # ------------------------------------------------------------- lifecycle
    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._run, name="owner-serve", daemon=True)
        self._thread.start()
        if not self._started.wait(10.0):
            raise RuntimeError("owner-serve loop failed to start")
        return self.port

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        server = RpcServer(host=self.host, port=0)
        self._register(server)
        self._server = server

        async def _up():
            self.port = await server.start()

        loop.run_until_complete(_up())
        self._started.set()
        try:
            loop.run_forever()
        finally:
            loop.run_until_complete(server.stop())
            loop.close()

    def stop(self) -> None:
        loop = self._loop
        if loop is not None and loop.is_running():
            loop.call_soon_threadsafe(loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # -------------------------------------------------------------- handlers
    def _register(self, s: RpcServer) -> None:
        table = self.table
        stats = self.stats

        @s.handler("wire_probe")
        async def wire_probe(msg, conn):
            return {"ok": True, "wire": wire.WIRE_VERSION}

        @s.handler("owner_publish")
        async def owner_publish(msg, conn):
            addr = msg.get("address")
            if addr is not None:
                addr = (str(addr[0]), int(addr[1]))
            items = msg.get("items") or []
            fresh = []
            for ent in items:
                oid, size = ent[0], int(ent[1])
                blob = ent[2] if len(ent) > 2 else None
                if table.insert(oid, size, blob, addr):
                    fresh.append((oid, size, blob))
            stats["publishes"] += 1
            stats["published_items"] += len(items)
            if fresh:
                table.arrived.set()
                if self._on_publish is not None:
                    try:
                        self._on_publish(fresh)
                    except Exception:  # noqa: BLE001 - ring is best-effort
                        pass
            return {"ok": True, "count": len(items)}

        @s.handler("owner_fetch")
        async def owner_fetch(msg, conn):
            blobs: Dict[bytes, bytes] = {}
            locations: Dict[bytes, list] = {}
            for oid in msg.get("object_ids") or []:
                info = table.locate(oid)
                if info is None:
                    continue
                if info["inline"]:
                    blob = table.get_blob(oid)
                    if blob is not None:
                        blobs[oid] = blob
                        continue
                if info["addr"] is not None:
                    locations[oid] = [info["addr"][0], info["addr"][1]]
            stats["fetches"] += 1
            stats["fetch_hits"] += len(blobs) + len(locations)
            return {"ok": True, "blobs": blobs, "locations": locations}

        @s.handler("owner_locate")
        async def owner_locate(msg, conn):
            objects: Dict[bytes, Dict[str, Any]] = {}
            for oid in msg.get("object_ids") or []:
                info = table.locate(oid)
                if info is not None:
                    objects[oid] = {"size": info["size"],
                                    "inline": info["inline"]}
            stats["locates"] += 1
            return {"ok": True, "objects": objects}

        @s.handler("owner_stats")
        async def owner_stats(msg, conn):
            st = dict(self.stats)
            st.update(table.stats())
            return {"ok": True, "stats": st}

"""GCS storage clients: pluggable snapshot persistence backends
(reference: ``src/ray/gcs/store_client/`` — redis_store_client /
in_memory_store_client behind one StoreClient interface; no redis in this
image, so the durable backends are an atomic-rename file and a
transactional sqlite history).

Selected by the ``--persist`` URI:
    /path/snap.pkl            -> FileStorage (atomic replace, 1 snapshot)
    sqlite:///path/snap.db    -> SqliteStorage (transactional, keeps the
                                 last N snapshots; a torn write can never
                                 corrupt the previous one)

Beyond snapshots, both backends carry the two records head HA is built on:

* **Replication log** — ``append_log``/``read_log``/``truncate_log``:
  sequence-numbered opaque entries (the GCS appends one wire-framed record
  per state-mutating RPC), so recovery is *last snapshot + log replay*
  instead of losing everything since the 1 Hz snapshot. A torn tail entry
  (the crash landed mid-write) is detected by length+CRC framing and
  dropped, never fatal.

* **Leadership lease** — an epoch-numbered ``{epoch, holder, expires}``
  record. The leader renews it; a standby may steal it only after expiry,
  which bumps the epoch. Every log append is fenced by the writer's epoch:
  an append with an epoch older than the lease raises :class:`LeaseFenced`,
  so a deposed leader's writes are rejected at the store (the classic
  fencing-token design; split-brain cannot corrupt the log).
"""

from __future__ import annotations

import json
import os
import sqlite3
import struct
import threading
import time
import zlib
from typing import List, Optional, Tuple

# File-log entry framing: [u32 length of (seq + body)][u32 crc32][u64 seq]
# [body]. The CRC covers seq+body so a torn or bit-rotted tail entry is
# detected and dropped instead of replayed as garbage.
_LOG_HEAD = struct.Struct("<IIQ")


class LeaseFenced(RuntimeError):
    """A write carried an epoch older than the current leadership lease
    (the writer was deposed); the store rejected it."""


class GcsStorageClient:
    # ---- snapshots ----
    def write(self, payload: bytes) -> None:
        raise NotImplementedError

    def read(self) -> Optional[bytes]:
        raise NotImplementedError

    # ---- replication log ----
    def append_log(self, entries: List[Tuple[int, bytes]],
                   epoch: int = 0) -> None:
        """Durably append ``(seq, record)`` entries. Raises LeaseFenced
        when ``epoch`` is older than the current lease's epoch."""
        raise NotImplementedError

    def read_log(self, after_seq: int = 0) -> List[Tuple[int, bytes]]:
        """Entries with seq > after_seq, in order. A torn tail entry is
        truncated (dropped), not fatal."""
        raise NotImplementedError

    def truncate_log(self, upto_seq: int) -> None:
        """Drop entries with seq <= upto_seq (they are covered by a
        completed snapshot)."""
        raise NotImplementedError

    def log_size_bytes(self) -> int:
        return 0

    # ---- leadership lease ----
    def read_lease(self) -> Optional[dict]:
        """Current ``{"epoch", "holder", "expires"}`` record, or None."""
        return None

    def acquire_lease(self, holder: str, ttl_s: float) -> Optional[int]:
        """Take leadership: allowed when no lease exists, the lease has
        expired, or ``holder`` already owns it. Always bumps the epoch (a
        re-acquire after restart must invalidate any stale writer). Returns
        the new epoch, or None when a live lease belongs to someone else."""
        raise NotImplementedError

    def renew_lease(self, holder: str, epoch: int, ttl_s: float) -> bool:
        """Extend the lease; False when it was stolen (different holder or
        newer epoch) — the caller must stop acting as leader."""
        raise NotImplementedError

    def close(self) -> None:
        pass

    # Shared lease arbitration used by both backends: given the current
    # record, decide the outcome of an acquire attempt.
    @staticmethod
    def _arbitrate(cur: Optional[dict], holder: str,
                   now: float) -> Optional[int]:
        if cur is not None and cur.get("holder") != holder \
                and float(cur.get("expires", 0.0)) > now:
            return None  # live lease held by someone else
        return int(cur.get("epoch", 0) if cur else 0) + 1


def _pack_log_entry(seq: int, body: bytes) -> bytes:
    crc = zlib.crc32(_U64_PACK(seq) + body)
    return _LOG_HEAD.pack(8 + len(body), crc, seq) + body


def _U64_PACK(v: int) -> bytes:
    return struct.pack("<Q", v)


def _scan_log(buf: bytes, after_seq: int) -> Tuple[List[Tuple[int, bytes]],
                                                   int]:
    """Parse a log byte stream; returns (entries, good_extent). Stops at
    the first torn/corrupt entry — everything after it is unreadable (the
    stream has no resync marker), which is exactly the crash-tail case."""
    out: List[Tuple[int, bytes]] = []
    off = 0
    n = len(buf)
    while off + _LOG_HEAD.size <= n:
        length, crc, seq = _LOG_HEAD.unpack_from(buf, off)
        body_end = off + _LOG_HEAD.size + (length - 8)
        if length < 8 or body_end > n:
            break  # torn tail: header landed, body didn't
        body = buf[off + _LOG_HEAD.size:body_end]
        if zlib.crc32(_U64_PACK(seq) + body) != crc:
            break  # corrupt entry: stop replay here
        if seq > after_seq:
            out.append((seq, bytes(body)))
        off = body_end
    return out, off


class FileStorage(GcsStorageClient):
    """Single-snapshot file with atomic rename (the original backend).

    The replication log is a sidecar ``<path>.log`` (append-only,
    length+CRC framed) and the lease a ``<path>.lease`` JSON written with
    the same atomic-replace discipline as the snapshot. Lease acquisition
    is read-modify-write: on a shared filesystem without file locking two
    racing stealers could both think they won — deploy the sqlite backend
    when the lease must arbitrate true concurrent stealers (its acquire is
    one transaction). The epoch fence on appends still bounds the damage:
    whichever stealer writes with the older epoch is rejected.
    """

    def __init__(self, path: str):
        self.path = path
        self._log_path = path + ".log"
        self._lease_path = path + ".lease"
        self._log_f = None
        self._log_lock = threading.Lock()

    def write(self, payload: bytes) -> None:
        # Unique per writing thread: the shutdown snapshot (loop thread)
        # can overlap an in-flight periodic write (to_thread worker).
        tmp = f"{self.path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                f.write(payload)
            os.replace(tmp, self.path)  # atomic
        except OSError:
            pass

    def read(self) -> Optional[bytes]:
        try:
            with open(self.path, "rb") as f:
                return f.read()
        except OSError:
            return None

    # ---- replication log ----
    def _open_log(self):
        """Lazily open for append, first repairing any torn tail left by a
        crash (appending after torn bytes would poison the stream)."""
        if self._log_f is None:
            try:
                with open(self._log_path, "rb") as f:
                    buf = f.read()
                _, good = _scan_log(buf, after_seq=-1)
                if good != len(buf):
                    os.truncate(self._log_path, good)
            except OSError:
                pass
            self._log_f = open(self._log_path, "ab")
        return self._log_f

    def _check_fence(self, epoch: int) -> None:
        lease = self.read_lease()
        if lease is not None and epoch < int(lease.get("epoch", 0)):
            raise LeaseFenced(
                f"append fenced: writer epoch {epoch} < lease epoch "
                f"{lease['epoch']} (held by {lease.get('holder')!r})")

    def append_log(self, entries: List[Tuple[int, bytes]],
                   epoch: int = 0) -> None:
        with self._log_lock:
            self._check_fence(epoch)
            f = self._open_log()
            f.write(b"".join(_pack_log_entry(s, b) for s, b in entries))
            f.flush()

    def read_log(self, after_seq: int = 0) -> List[Tuple[int, bytes]]:
        try:
            with open(self._log_path, "rb") as f:
                buf = f.read()
        except OSError:
            return []
        entries, _ = _scan_log(buf, after_seq)
        return entries

    def truncate_log(self, upto_seq: int) -> None:
        """Rewrite keeping only entries newer than the snapshot point.
        The log between two 1 Hz snapshots is seconds of traffic, so the
        rewrite is small; done under the append lock so no entry is lost."""
        with self._log_lock:
            if self._log_f is not None:
                self._log_f.close()
                self._log_f = None
            try:
                with open(self._log_path, "rb") as f:
                    keep, _ = _scan_log(f.read(), upto_seq)
            except OSError:
                return
            tmp = f"{self._log_path}.tmp.{os.getpid()}.{threading.get_ident()}"
            try:
                with open(tmp, "wb") as f:
                    f.write(b"".join(
                        _pack_log_entry(s, b) for s, b in keep))
                os.replace(tmp, self._log_path)
            except OSError:
                pass

    def log_size_bytes(self) -> int:
        try:
            return os.path.getsize(self._log_path)
        except OSError:
            return 0

    # ---- lease ----
    def read_lease(self) -> Optional[dict]:
        try:
            with open(self._lease_path, "r") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _write_lease(self, rec: dict) -> None:
        tmp = f"{self._lease_path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "w") as f:
                json.dump(rec, f)
            os.replace(tmp, self._lease_path)
        except OSError:
            pass

    def acquire_lease(self, holder: str, ttl_s: float) -> Optional[int]:
        now = time.time()
        epoch = self._arbitrate(self.read_lease(), holder, now)
        if epoch is None:
            return None
        self._write_lease({"epoch": epoch, "holder": holder,
                           "expires": now + ttl_s})
        return epoch

    def renew_lease(self, holder: str, epoch: int, ttl_s: float) -> bool:
        cur = self.read_lease()
        if cur is None or cur.get("holder") != holder \
                or int(cur.get("epoch", 0)) != epoch:
            return False
        self._write_lease({"epoch": epoch, "holder": holder,
                           "expires": time.time() + ttl_s})
        return True

    def close(self) -> None:
        with self._log_lock:
            if self._log_f is not None:
                self._log_f.close()
                self._log_f = None


class SqliteStorage(GcsStorageClient):
    """Versioned snapshots in one sqlite database (stdlib).

    Each write is a transaction appending a new row and pruning beyond
    ``keep``; crash-consistency comes from sqlite's journal, so a torn
    write never damages the previous snapshot. ``read`` returns the
    newest complete row.

    The replication log and the leadership lease live in the same
    database. Lease acquire/renew run as single IMMEDIATE transactions, so
    two concurrent stealers serialize and exactly one wins — this is the
    backend to deploy when leader and standby race over a shared store.
    Every ``append_log`` re-checks the lease inside its transaction: a
    deposed leader's appends raise :class:`LeaseFenced`.
    """

    def __init__(self, path: str, keep: int = 5):
        self.path = path
        self.keep = keep
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS snapshots ("
            " id INTEGER PRIMARY KEY AUTOINCREMENT,"
            " ts REAL NOT NULL,"
            " payload BLOB NOT NULL)")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS replog ("
            " seq INTEGER PRIMARY KEY,"
            " epoch INTEGER NOT NULL,"
            " body BLOB NOT NULL)")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS lease ("
            " id INTEGER PRIMARY KEY CHECK (id = 1),"
            " epoch INTEGER NOT NULL,"
            " holder TEXT NOT NULL,"
            " expires REAL NOT NULL)")
        self._conn.commit()

    def write(self, payload: bytes) -> None:
        try:
            with self._lock, self._conn:
                self._conn.execute(
                    "INSERT INTO snapshots (ts, payload) VALUES (?, ?)",
                    (time.time(), sqlite3.Binary(payload)))
                self._conn.execute(
                    "DELETE FROM snapshots WHERE id NOT IN ("
                    " SELECT id FROM snapshots ORDER BY id DESC LIMIT ?)",
                    (self.keep,))
        except sqlite3.Error:
            pass

    def read(self) -> Optional[bytes]:
        try:
            with self._lock:
                row = self._conn.execute(
                    "SELECT payload FROM snapshots "
                    "ORDER BY id DESC LIMIT 1").fetchone()
            return bytes(row[0]) if row else None
        except sqlite3.Error:
            return None

    def history(self) -> int:
        with self._lock:
            return self._conn.execute(
                "SELECT COUNT(*) FROM snapshots").fetchone()[0]

    # ---- replication log ----
    def _lease_row(self) -> Optional[tuple]:
        return self._conn.execute(
            "SELECT epoch, holder, expires FROM lease WHERE id = 1"
        ).fetchone()

    def append_log(self, entries: List[Tuple[int, bytes]],
                   epoch: int = 0) -> None:
        with self._lock, self._conn:
            row = self._lease_row()
            if row is not None and epoch < int(row[0]):
                raise LeaseFenced(
                    f"append fenced: writer epoch {epoch} < lease epoch "
                    f"{row[0]} (held by {row[1]!r})")
            self._conn.executemany(
                "INSERT OR REPLACE INTO replog (seq, epoch, body) "
                "VALUES (?, ?, ?)",
                [(s, epoch, sqlite3.Binary(b)) for s, b in entries])

    def read_log(self, after_seq: int = 0) -> List[Tuple[int, bytes]]:
        # sqlite rows are transactional: a torn entry never commits, so
        # there is no tail to repair here.
        try:
            with self._lock:
                rows = self._conn.execute(
                    "SELECT seq, body FROM replog WHERE seq > ? "
                    "ORDER BY seq", (after_seq,)).fetchall()
            return [(int(s), bytes(b)) for s, b in rows]
        except sqlite3.Error:
            return []

    def truncate_log(self, upto_seq: int) -> None:
        try:
            with self._lock, self._conn:
                self._conn.execute(
                    "DELETE FROM replog WHERE seq <= ?", (upto_seq,))
        except sqlite3.Error:
            pass

    def log_size_bytes(self) -> int:
        try:
            with self._lock:
                row = self._conn.execute(
                    "SELECT COALESCE(SUM(LENGTH(body)), 0) FROM replog"
                ).fetchone()
            return int(row[0])
        except sqlite3.Error:
            return 0

    # ---- lease ----
    def read_lease(self) -> Optional[dict]:
        try:
            with self._lock:
                row = self._lease_row()
            if row is None:
                return None
            return {"epoch": int(row[0]), "holder": row[1],
                    "expires": float(row[2])}
        except sqlite3.Error:
            return None

    def acquire_lease(self, holder: str, ttl_s: float) -> Optional[int]:
        now = time.time()
        try:
            with self._lock:
                # IMMEDIATE: take the write lock before reading, so two
                # concurrent stealers serialize and the loser sees the
                # winner's row.
                self._conn.execute("BEGIN IMMEDIATE")
                try:
                    row = self._lease_row()
                    cur = None if row is None else {
                        "epoch": row[0], "holder": row[1],
                        "expires": row[2]}
                    epoch = self._arbitrate(cur, holder, now)
                    if epoch is None:
                        self._conn.execute("ROLLBACK")
                        return None
                    self._conn.execute(
                        "INSERT OR REPLACE INTO lease "
                        "(id, epoch, holder, expires) VALUES (1, ?, ?, ?)",
                        (epoch, holder, now + ttl_s))
                    self._conn.execute("COMMIT")
                    return epoch
                except BaseException:
                    self._conn.execute("ROLLBACK")
                    raise
        except sqlite3.Error:
            return None

    def renew_lease(self, holder: str, epoch: int, ttl_s: float) -> bool:
        try:
            with self._lock, self._conn:
                cur = self._conn.execute(
                    "UPDATE lease SET expires = ? "
                    "WHERE id = 1 AND holder = ? AND epoch = ?",
                    (time.time() + ttl_s, holder, epoch))
                return cur.rowcount == 1
        except sqlite3.Error:
            return False

    def close(self) -> None:
        with self._lock:
            self._conn.close()


def open_storage(uri: str) -> GcsStorageClient:
    if uri.startswith("sqlite://"):
        return SqliteStorage(uri[len("sqlite://"):])
    return FileStorage(uri)

"""Binary hot-path wire codec for the cluster control plane.

The default wire format (``protocol.py``) is a length-prefixed pickle —
general, but on the per-task hot path the pickle of nested dicts is the
single largest control-plane CPU line on both ends of every edge. This
module gives the highest-frequency message types a compact struct-packed
encoding:

  * ``submit_batch``      driver -> GCS      (task specs, the submit wave)
  * ``task_done_batch``   controller -> GCS  (completion wave)
  * ``locations_batch``   driver -> GCS      (+ its response; the get() loop)
  * ``fetch_batch``       driver -> node     (+ its response; result blobs)
  * ``object_added``      worker/driver -> controller (arena registrations)

plus the two relay messages that carry task specs onward:

  * ``assign_batch``      GCS -> controller  (raw spec blobs, forwarded)
  * ``execute_task``      controller -> worker (one raw spec blob)
  * ``task_done``         worker -> controller (singular completion)

**Frame layout.** The transport frame stays ``[8-byte LE length][body]``.
A binary body begins with ``MAGIC`` (0xBF) + a message-code byte; anything
else (pickle bodies start with 0x80) is decoded as pickle. Receivers always
understand both, so a pickle-only peer can share a socket with a
binary-capable one; senders only emit binary for the types above, and only
once the peer is known-capable (advertised ``wire`` version on
register_node/register_worker, or observed binary traffic on the
connection). The reference's send-side pickle-only switch is not
ported; decode support is unconditional.

**Opaque task-spec relay.** ``encode_task_spec`` packs a task payload once
on the driver. The GCS decodes only the fixed header (ids, deps, resources —
what placement and lineage need) and keeps the original bytes in
``payload["_spec"]``; the dispatch path forwards those bytes verbatim inside
``assign_batch``/``execute_task`` frames, so the args/kwargs blobs are
deserialized exactly once, at the executing worker. Zero task-spec
re-serializations happen on the GCS (pinned by ``relay:opaque`` /
``relay:pickled`` counters in its handler stats).

Encoders return a *list of buffers* so callers can scatter-write
(``sendmsg`` / ``writelines``) without copying large blobs (protocol-5
out-of-band spirit: result blobs and spec bytes are passed through, not
re-joined).
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Optional, Tuple

MAGIC = 0xBF
# v2 adds the inline-result frames (TASK_DONE2 / TASK_DONE_BATCH2 and the
# _LOC_INLINE location flag); v3 adds the PROFILE_STACKS stats frame; v4
# adds the state-API frames (LIST_TASKS / LIST_TASKS_RESP); v5 adds the
# head-HA frames (REPL_RECORD / REPL_TAIL / REPL_TAIL_RESP / HA_STATUS /
# HA_STATUS_RESP); v6 adds the cancellation frame (CANCEL_TASK), the
# deadline fields of task-spec v3, and the forensics task-row frame
# (LIST_TASKS_RESP2); v7 adds the exec-stamp completion twins
# (TASK_DONE3 / TASK_DONE_BATCH3): every completion carries worker-side
# wall-clock ts_exec_start/ts_exec_end so the job profiler can attribute
# queue vs exec vs registration time exactly, not just on the 1/64 trace
# sample; v8 adds the columnar hot-path frames (SUBMIT_BATCH_COLS /
# DISPATCH_WAVE): a homogeneous submit wave travels as ONE spec template
# (shared header segments) plus packed per-task columns (ids, return ids,
# arg tails) instead of N per-task structs, and the GCS relays each node's
# whole wave the same way — receivers rebuild byte-identical spec blobs by
# concatenating the template segments around the varying columns;
# v9 adds the ownership frames (OWNER_LOCATE / OWNER_FETCH /
# OWNER_PUBLISH and their responses): object results are tracked by the
# driver that created them (the owner) instead of the GCS object table —
# controllers publish completed results owner-to-owner and borrowers
# locate/fetch from the owner, so the head keeps only membership.
# v10 adds the data-plane frames (GET_OBJ_LOCATIONS /
# GET_OBJ_LOCATIONS_RESP): the per-pull directory lookup — the hottest RPC
# of a shuffle's reduce wave — carries the object id and its holders'
# native transfer endpoints (plus the directory's size column, the transfer
# scheduler's largest-first key) without pickle.
# Senders emit each frame only to peers that advertised a wire version
# that can parse it; everything else still goes out as older frames or
# pickle, so mixed-version peers interoperate per-message.
WIRE_VERSION = 10

# Message codes (one byte each). Codes are part of the wire contract:
# never renumber, only append.
SUBMIT_BATCH = 0x01
SUBMIT_BATCH_RESP = 0x02
TASK_DONE_BATCH = 0x03
LOCATIONS_BATCH = 0x04
LOCATIONS_BATCH_RESP = 0x05
FETCH_BATCH = 0x06
FETCH_BATCH_RESP = 0x07
OBJECT_ADDED = 0x08
ASSIGN_BATCH = 0x09
EXECUTE_TASK = 0x0A
TASK_DONE = 0x0B
# v2 twins of the completion frames: each "added" registration item may
# carry the serialized result inline (the small-result data plane).
TASK_DONE2 = 0x0C
TASK_DONE_BATCH2 = 0x0D
# Placement-group control ops (create / remove / status+list). Rare
# messages, but framed so a binary-only deployment never needs pickle for
# the pg control surface.
PG_CREATE = 0x0E
PG_REMOVE = 0x0F
PG_STATUS = 0x10
PG_OK = 0x11
PG_STATUS_RESP = 0x12
# Stats frame: a flight-recorder drain (folded stacks + counts) shipped to
# the GCS profile-stacks table on the 2 s stats cadence. Framed so the
# periodic observability traffic never re-enters pickle on busy links.
PROFILE_STACKS = 0x13
# State-API frames (v4): the bounded/filterable/paginated task-table query
# and its row response — framed so dashboards and `cli tasks` polling a
# busy head never re-enter pickle on the state path.
LIST_TASKS = 0x14
LIST_TASKS_RESP = 0x15
# Head-HA frames (v5). REPL_RECORD wraps one state-mutating RPC body with
# its (epoch, seq) fencing header — the unit of both the on-disk
# replication log and the over-the-wire standby tail. REPL_TAIL is the
# standby's cursor poll; its response either carries the records after the
# cursor or a full-snapshot resync when the leader's ring no longer covers
# it. HA_STATUS is the leadership probe (`cli status`, monitor, peers
# learning the leader).
REPL_RECORD = 0x16
REPL_TAIL = 0x17
REPL_TAIL_RESP = 0x18
HA_STATUS = 0x19
HA_STATUS_RESP = 0x1A
# Cancellation frame (v6): driver->GCS carries the object id of the ref
# being cancelled; GCS->controller carries the resolved task id. Framed so
# a cancel storm (a driver tearing down a large batch) doesn't re-enter
# pickle on the control path.
CANCEL_TASK = 0x1B
# v6 twin of LIST_TASKS_RESP: each row additionally carries the failure
# forensics pair (failure_cause, failure_error) — who killed the task and
# why, attributed by the containment machinery.
LIST_TASKS_RESP2 = 0x1C
# v7 twins of the completion frames: every completion additionally carries
# the worker's wall-clock execution window (ts_exec_start/ts_exec_end, two
# f64 epoch stamps) so per-job timeline assembly is exact on all tasks.
# Both use the v2 "added" item layout (has-blob flag), so they subsume the
# inline-result twins when the peer speaks v7.
TASK_DONE3 = 0x1D
TASK_DONE_BATCH3 = 0x1E
# v7 twin of LIST_TASKS_RESP2: each row additionally carries the exec
# window (ts_exec_start/ts_exec_end f64 pair) and exec_s, so the state
# API and the job profiler see worker-side stamps without pickle.
LIST_TASKS_RESP3 = 0x1F
# Columnar hot-path frames (v8). SUBMIT_BATCH_COLS carries a driver's
# submit flush as template runs (one shared spec header per run of
# same-function/same-options tasks + packed task-id / return-id / arg-tail
# columns) plus any non-conforming tasks as legacy per-task spec blobs —
# one frame either way. DISPATCH_WAVE is its GCS->controller twin: each
# node's whole dispatch wave rides as runs + singles in ONE scatter frame
# that the controller explodes locally into byte-identical spec blobs.
SUBMIT_BATCH_COLS = 0x20
DISPATCH_WAVE = 0x21
# Ownership frames (v9). The object plane moves out of the GCS: each
# driver owns the objects its job tree creates and serves them from an
# in-process owner table. OWNER_PUBLISH is the controller->owner push of
# completed inline results (bytes when the owner is remote, size+location
# only when the completion ring on the same host already carried the
# bytes); OWNER_FETCH is the borrower's pull (answered with bytes or a
# node location redirect); OWNER_LOCATE is the lightweight existence /
# size probe the consistency auditor and doctor use to verify owner-shard
# invariants without moving payloads.
OWNER_LOCATE = 0x22
OWNER_LOCATE_RESP = 0x23
OWNER_FETCH = 0x24
OWNER_FETCH_RESP = 0x25
OWNER_PUBLISH = 0x26
OWNER_PUBLISH_RESP = 0x27
# Data-plane frames (v10). GET_OBJ_LOCATIONS is the controller's per-pull
# directory lookup (object id + wait/timeout); its response carries the
# holder node ids, their RPC addresses, their native transfer endpoints
# (port 0 = no native plane: spilled/python-store holders restore over
# RPC), and the directory's size column — or the error/inline blob
# short-circuits the directory already serves.
GET_OBJ_LOCATIONS = 0x28
GET_OBJ_LOCATIONS_RESP = 0x29

# Minimum peer wire version able to parse each frame — the declarative
# manifest the static lint (raylint wire-discipline) audits: every frame
# must appear here, encoders emitting a >v1 frame must gate on peer_wire
# with a pickle fallback, and max(values) must equal WIRE_VERSION (adding
# a frame without bumping the version is a lint error).
FRAME_MIN_WIRE = {
    SUBMIT_BATCH: 1,
    SUBMIT_BATCH_RESP: 1,
    TASK_DONE_BATCH: 1,
    LOCATIONS_BATCH: 1,
    LOCATIONS_BATCH_RESP: 1,
    FETCH_BATCH: 1,
    FETCH_BATCH_RESP: 1,
    OBJECT_ADDED: 1,
    ASSIGN_BATCH: 1,
    EXECUTE_TASK: 1,
    TASK_DONE: 1,
    TASK_DONE2: 2,
    TASK_DONE_BATCH2: 2,
    PG_CREATE: 1,
    PG_REMOVE: 1,
    PG_STATUS: 1,
    PG_OK: 1,
    PG_STATUS_RESP: 1,
    PROFILE_STACKS: 3,
    LIST_TASKS: 4,
    LIST_TASKS_RESP: 4,
    REPL_RECORD: 5,
    REPL_TAIL: 5,
    REPL_TAIL_RESP: 5,
    HA_STATUS: 5,
    HA_STATUS_RESP: 5,
    CANCEL_TASK: 6,
    LIST_TASKS_RESP2: 6,
    TASK_DONE3: 7,
    TASK_DONE_BATCH3: 7,
    LIST_TASKS_RESP3: 7,
    SUBMIT_BATCH_COLS: 8,
    DISPATCH_WAVE: 8,
    OWNER_LOCATE: 9,
    OWNER_LOCATE_RESP: 9,
    OWNER_FETCH: 9,
    OWNER_FETCH_RESP: 9,
    OWNER_PUBLISH: 9,
    OWNER_PUBLISH_RESP: 9,
    GET_OBJ_LOCATIONS: 10,
    GET_OBJ_LOCATIONS_RESP: 10,
}

_PG_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")
_PG_STATES = ("PENDING", "CREATED", "RESCHEDULING", "REMOVED")
_TASK_STATES = ("PENDING", "DISPATCHED", "FINISHED", "FAILED")
_TASK_KINDS = ("task", "actor")

# Task-spec versions. v1 is the base header; v2 appends a trace context
# (sampled tasks only — unsampled specs still encode as v1, so the hot
# path's bytes are unchanged and pre-tracing decoders keep reading them);
# v3 appends the deadline fields (timeout_s + retry_on_timeout), emitted
# only for tasks that set a deadline — deadline-free specs keep their v1/v2
# bytes so pre-v6 decoders and the hot path are unchanged.
SPEC_VERSION = 1
SPEC_VERSION_TRACED = 2
SPEC_VERSION_DEADLINE = 3
# v3 flag bits.
SPEC_F_TRACE = 1
SPEC_F_RETRY_ON_TIMEOUT = 2

# Hard caps, enforced on decode: a corrupt count/length field must fail the
# frame instead of driving a multi-GB allocation.
MAX_ITEMS = 1 << 22
MAX_BLOB = 1 << 34

_U8 = struct.Struct("<B")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_I32 = struct.Struct("<i")
_F32 = struct.Struct("<f")
_F64 = struct.Struct("<d")


def ownership_enabled() -> bool:
    """Kill switch for the ownership object plane
    (``RAY_TPU_TORCH_OWNERSHIP=0`` reverts to GCS-tracked results: drivers stop
    registering as owners, so controllers fall back to the legacy
    inline-to-GCS registration path per-object)."""
    return os.environ.get("RAY_TPU_TORCH_OWNERSHIP", "1") != "0"


class WireError(ValueError):
    """Malformed binary frame (truncated, garbage, or over a cap)."""


# --------------------------------------------------------------------------
# primitive readers (all raise WireError on truncation)
# --------------------------------------------------------------------------

class _Reader:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes, off: int = 0):
        self.buf = buf
        self.off = off

    def _take(self, st: struct.Struct):
        try:
            (v,) = st.unpack_from(self.buf, self.off)
        except struct.error as e:
            raise WireError(f"truncated frame: {e}") from None
        self.off += st.size
        return v

    def u8(self) -> int:
        return self._take(_U8)

    def u16(self) -> int:
        return self._take(_U16)

    def u32(self) -> int:
        return self._take(_U32)

    def u64(self) -> int:
        return self._take(_U64)

    def i32(self) -> int:
        return self._take(_I32)

    def f32(self) -> float:
        return self._take(_F32)

    def f64(self) -> float:
        return self._take(_F64)

    def raw(self, n: int) -> bytes:
        if n < 0 or n > MAX_BLOB:
            raise WireError(f"blob length {n} out of range")
        end = self.off + n
        if end > len(self.buf):
            raise WireError("truncated frame: blob overruns body")
        out = self.buf[self.off:end]
        self.off = end
        return bytes(out) if not isinstance(out, bytes) else out

    def b8(self) -> bytes:          # small id: u8 length prefix
        return self.raw(self.u8())

    def b32(self) -> bytes:         # payload blob: u32 length prefix
        return self.raw(self.u32())

    def b64(self) -> bytes:         # large blob: u64 length prefix
        return self.raw(self.u64())

    def s(self) -> str:             # short utf-8 string
        try:
            return self.raw(self.u16()).decode("utf-8")
        except UnicodeDecodeError as e:
            raise WireError(f"bad utf-8 in frame: {e}") from None

    def count(self, n: int) -> int:
        if n > MAX_ITEMS:
            raise WireError(f"item count {n} over cap")
        return n

    def done(self) -> None:
        if self.off != len(self.buf):
            raise WireError(
                f"{len(self.buf) - self.off} trailing bytes after frame")


def _b8(b: bytes) -> bytes:
    if len(b) > 255:
        raise WireError(f"id too long for u8 prefix: {len(b)}")
    return _U8.pack(len(b)) + b


def _s(v: str) -> bytes:
    raw = v.encode("utf-8")
    return _U16.pack(len(raw)) + raw


def _resources(res: Dict[str, float]) -> bytes:
    parts = [_U8.pack(len(res))]
    for k in res:
        parts.append(_s(k))
        parts.append(_F64.pack(float(res[k])))
    return b"".join(parts)


def _read_resources(r: _Reader) -> Dict[str, float]:
    n = r.u8()
    return {r.s(): r.f64() for _ in range(n)}


def _read_id_list(r: _Reader, n: int) -> List[bytes]:
    """Fast parse of n u8-length-prefixed ids: direct offset arithmetic
    (the per-id _Reader method chain dominated decode of 1k-oid polls)."""
    buf, off = r.buf, r.off
    end = len(buf)
    out = []
    for _ in range(n):
        if off >= end:
            raise WireError("truncated frame: id list overruns body")
        ln = buf[off]
        off += 1
        nxt = off + ln
        if nxt > end:
            raise WireError("truncated frame: id overruns body")
        out.append(bytes(buf[off:nxt]))
        off = nxt
    r.off = off
    return out


def _read_oids(r: _Reader) -> List[bytes]:
    return _read_id_list(r, r.count(r.u16()))


def _oids(ids) -> bytes:
    parts = [_U16.pack(len(ids))]
    for oid in ids:
        parts.append(_b8(oid))
    return b"".join(parts)


# --------------------------------------------------------------------------
# task spec codec
# --------------------------------------------------------------------------

def encode_spec_segments(p: Dict[str, Any]) -> Tuple[bytes, bytes]:
    """The two spec-header segments shared by every task of a columnar run:
    ``seg_a`` (fn_id | name | max_retries — the bytes between the task id
    and the return ids) and ``seg_b`` (deps | pin_refs | resources — the
    bytes between the return ids and the args tail). Only v1 specs (no
    trace, no deadline extension) split this way; the columnar path keeps
    traced/deadline tasks on the per-task frames."""
    seg_a = b"".join((
        _b8(p.get("fn_id", b"")),
        _s(p.get("name", "") or ""),
        _I32.pack(int(p.get("max_retries", 0))),
    ))
    seg_b = b"".join((
        _oids(p.get("deps", ())),
        _oids(p.get("pin_refs", ())),
        _resources(p.get("resources", {})),
    ))
    return seg_a, seg_b


def encode_spec_tail(p: Dict[str, Any]) -> bytes:
    """The per-task varying suffix of a spec: the args + kwargs sections."""
    args = p.get("args", ())
    parts = [_U16.pack(len(args))]
    for kind, payload in args:
        parts.append(_U8.pack(1 if kind == "ref" else 0))
        parts.append(_U32.pack(len(payload)))
        parts.append(payload)
    kwargs = p.get("kwargs", {}) or {}
    parts.append(_U16.pack(len(kwargs)))
    for key, (kind, payload) in kwargs.items():
        parts.append(_s(key))
        parts.append(_U8.pack(1 if kind == "ref" else 0))
        parts.append(_U32.pack(len(payload)))
        parts.append(payload)
    return b"".join(parts)


def build_spec(ver: int, seg_a: bytes, seg_b: bytes, task_id: bytes,
               return_ids, tail: bytes) -> bytes:
    """Reassemble one task's full spec bytes from its run template —
    byte-identical to ``encode_task_spec`` of the original payload (the
    run is just the spec split at its task-varying fields)."""
    return b"".join((_U8.pack(ver), _b8(task_id), seg_a,
                     _oids(return_ids), seg_b, tail))


def build_spec_from_run(run: Dict[str, Any], i: int) -> bytes:
    """Task ``i`` of a decoded columnar run, as full spec bytes."""
    return build_spec(int(run.get("ver", SPEC_VERSION)),
                      run["seg_a"], run["seg_b"], run["task_ids"][i],
                      run["return_oids"][i], run["tails"][i])


def encode_task_spec(p: Dict[str, Any]) -> bytes:
    """Pack a task payload once, on the owner. Header fields (what the GCS
    and controllers need) come first so relays parse them without touching
    the args; args/kwargs blobs are appended verbatim. A sampled task's
    trace context rides as a versioned header extension (v2)."""
    trace = p.get("trace")
    timeout_s = p.get("timeout_s")
    if timeout_s is not None:
        ver = SPEC_VERSION_DEADLINE
    elif trace:
        ver = SPEC_VERSION_TRACED
    else:
        ver = SPEC_VERSION
    seg_a, seg_b = encode_spec_segments(p)
    parts = [
        _U8.pack(ver),
        _b8(p["task_id"]),
        seg_a,
        _oids(p.get("return_ids", ())),
        seg_b,
    ]
    if ver == SPEC_VERSION_DEADLINE:
        flags = (SPEC_F_TRACE if trace else 0) \
            | (SPEC_F_RETRY_ON_TIMEOUT if p.get("retry_on_timeout") else 0)
        parts.append(_U8.pack(flags))
        parts.append(_F64.pack(float(timeout_s)))
        if trace:
            parts.append(_b8(trace))
    elif trace:
        parts.append(_b8(trace))
    parts.append(encode_spec_tail(p))
    return b"".join(parts)


def _decode_spec_header(r: _Reader) -> Dict[str, Any]:
    ver = r.u8()
    if ver not in (SPEC_VERSION, SPEC_VERSION_TRACED, SPEC_VERSION_DEADLINE):
        raise WireError(f"unknown task-spec version {ver}")
    out = {
        "task_id": r.b8(),
        "fn_id": r.b8(),
        "name": r.s(),
        "max_retries": r.i32(),
        "return_ids": _read_oids(r),
        "deps": _read_oids(r),
        "pin_refs": _read_oids(r),
        "resources": _read_resources(r),
    }
    if ver == SPEC_VERSION_DEADLINE:
        flags = r.u8()
        out["timeout_s"] = r.f64()
        if flags & SPEC_F_RETRY_ON_TIMEOUT:
            out["retry_on_timeout"] = True
        if flags & SPEC_F_TRACE:
            out["trace"] = r.b8()
    elif ver == SPEC_VERSION_TRACED:
        out["trace"] = r.b8()
    return out


def decode_task_spec_header(blob: bytes) -> Dict[str, Any]:
    """Relay-side parse: ids/deps/resources only; the original bytes ride
    along as ``_spec`` so dispatch can forward them without re-encoding."""
    out = _decode_spec_header(_Reader(blob))
    out["_spec"] = blob
    return out


def decode_task_spec(blob: bytes) -> Dict[str, Any]:
    """Executing-worker parse: the full spec, args included."""
    r = _Reader(blob)
    out = _decode_spec_header(r)
    n_args = r.count(r.u16())
    out["args"] = [("ref" if r.u8() else "value", r.b32())
                   for _ in range(n_args)]
    n_kw = r.count(r.u16())
    kwargs = {}
    for _ in range(n_kw):
        key = r.s()
        kwargs[key] = ("ref" if r.u8() else "value", r.b32())
    out["kwargs"] = kwargs
    r.done()
    return out


# --------------------------------------------------------------------------
# message encoders — each returns a list of buffers (no length header)
# --------------------------------------------------------------------------

def _head(code: int, rpc_id) -> bytes:
    return struct.pack("<BBQ", MAGIC, code, int(rpc_id or 0))


def _enc_submit_batch(msg, peer_wire: int = WIRE_VERSION) -> List[bytes]:
    tasks = msg["tasks"]
    out = [_head(SUBMIT_BATCH, msg.get("rpc_id")), _U32.pack(len(tasks))]
    for t in tasks:
        blob = t.get("_spec") if isinstance(t, dict) else t
        if blob is None:
            blob = encode_task_spec(t)
        out.append(_U32.pack(len(blob)))
        out.append(blob)
    return out


def _dec_submit_batch(r: _Reader, rpc_id) -> Dict[str, Any]:
    n = r.count(r.u32())
    tasks = [decode_task_spec_header(r.b32()) for _ in range(n)]
    r.done()
    return {"type": "submit_batch", "tasks": tasks, "rpc_id": rpc_id}


def _enc_submit_batch_resp(msg, peer_wire: int = WIRE_VERSION) -> List[bytes]:
    return [_head(SUBMIT_BATCH_RESP, msg.get("rpc_id")),
            _U32.pack(int(msg.get("count", 0)))]


def _dec_submit_batch_resp(r: _Reader, rpc_id) -> Dict[str, Any]:
    count = r.u32()
    r.done()
    return {"ok": True, "count": count, "rpc_id": rpc_id}


def _added_has_blob(added) -> bool:
    return any(len(ent) > 2 and ent[2] is not None for ent in added)


def _enc_added_v1(out: List[bytes], added) -> None:
    out.append(_U16.pack(len(added)))
    for ent in added:
        out.append(_b8(ent[0]))
        out.append(_U64.pack(int(ent[1])))


def _enc_added_v2(out: List[bytes], added) -> None:
    """v2 added item: oid, size, has-blob flag, optional inline result."""
    out.append(_U16.pack(len(added)))
    for ent in added:
        out.append(_b8(ent[0]))
        out.append(_U64.pack(int(ent[1])))
        blob = ent[2] if len(ent) > 2 else None
        if blob is None:
            out.append(_U8.pack(0))
        else:
            out.append(_U8.pack(1))
            out.append(_U32.pack(len(blob)))
            out.append(blob)    # pass-through buffer: no copy on encode


def _dec_added_v1(r: _Reader) -> list:
    n = r.count(r.u16())
    return [[r.b8(), r.u64()] for _ in range(n)]


def _dec_added_v2(r: _Reader) -> list:
    n = r.count(r.u16())
    out = []
    for _ in range(n):
        oid = r.b8()
        size = r.u64()
        blob = r.b32() if r.u8() else None
        out.append([oid, size, blob])
    return out


def _enc_task_done_batch(msg, peer_wire: int = WIRE_VERSION) -> List[bytes]:
    items = msg["items"]
    v3 = any(float(it.get("ts_exec_end") or 0.0) > 0.0 for it in items)
    if v3 and peer_wire < 7:
        return None  # pre-v7 peer can't parse exec stamps: pickle carries it
    v2 = any(_added_has_blob(it.get("added") or ()) for it in items)
    if v2 and peer_wire < 2:
        return None  # v1 peer can't parse inline items: pickle carries it
    code = TASK_DONE_BATCH3 if v3 \
        else (TASK_DONE_BATCH2 if v2 else TASK_DONE_BATCH)
    out = [_head(code, msg.get("rpc_id")), _s(msg["node_id"]),
           _U32.pack(len(items))]
    enc_added = _enc_added_v2 if (v2 or v3) else _enc_added_v1
    for it in items:
        out.append(_b8(it.get("task_id") or b""))
        out.append(_resources(it.get("resources") or {}))
        out.append(_F32.pack(float(it.get("exec_s", 0.0))))
        out.append(_F32.pack(float(it.get("reg_s", 0.0))))
        if v3:
            out.append(_F64.pack(float(it.get("ts_exec_start") or 0.0)))
            out.append(_F64.pack(float(it.get("ts_exec_end") or 0.0)))
        enc_added(out, it.get("added") or ())
    return out


def _dec_task_done_batch(r: _Reader, rpc_id, v2: bool = False,
                         v3: bool = False) -> Dict[str, Any]:
    node_id = r.s()
    n = r.count(r.u32())
    dec_added = _dec_added_v2 if (v2 or v3) else _dec_added_v1
    items = []
    for _ in range(n):
        tid = r.b8()
        item = {"task_id": tid or None,
                "resources": _read_resources(r),
                "exec_s": r.f32(), "reg_s": r.f32()}
        if v3:
            item["ts_exec_start"] = r.f64()
            item["ts_exec_end"] = r.f64()
        item["added"] = dec_added(r)
        items.append(item)
    r.done()
    return {"type": "task_done_batch", "node_id": node_id, "items": items,
            "rpc_id": rpc_id}


def _dec_task_done_batch2(r: _Reader, rpc_id) -> Dict[str, Any]:
    return _dec_task_done_batch(r, rpc_id, v2=True)


def _dec_task_done_batch3(r: _Reader, rpc_id) -> Dict[str, Any]:
    return _dec_task_done_batch(r, rpc_id, v3=True)


def _enc_locations_batch(msg, peer_wire: int = WIRE_VERSION) -> List[bytes]:
    oids = msg["object_ids"]
    out = [_head(LOCATIONS_BATCH, msg.get("rpc_id")),
           _F64.pack(float(msg.get("wait_s") or 0.0)),
           _F32.pack(float(msg.get("wave_s") or 0.0)),
           _U8.pack(1 if msg.get("probe", True) else 0),
           _U32.pack(len(oids))]
    for oid in oids:
        out.append(_b8(oid))
    return out


def _dec_locations_batch(r: _Reader, rpc_id) -> Dict[str, Any]:
    wait_s = r.f64()
    wave_s = r.f32()
    probe = bool(r.u8())
    oids = _read_id_list(r, r.count(r.u32()))
    r.done()
    return {"type": "locations_batch", "object_ids": oids,
            "wait_s": wait_s, "wave_s": wave_s, "probe": probe,
            "rpc_id": rpc_id}


_LOC_ERROR = 1
_LOC_SPILLED = 2
_LOC_INLINE = 4


def _enc_locations_batch_resp(msg, peer_wire: int = WIRE_VERSION
                              ) -> List[bytes]:
    objects = msg.get("objects", {})
    if peer_wire < 2 and any(info.get("inline_blob") is not None
                             for info in objects.values()):
        return None  # v1 peer can't parse _LOC_INLINE: pickle carries it
    out = [_head(LOCATIONS_BATCH_RESP, msg.get("rpc_id")),
           _U32.pack(len(objects))]
    for oid, info in objects.items():
        out.append(_b8(oid))
        blob = info.get("error_blob")
        if blob is not None:
            out.append(_U8.pack(_LOC_ERROR))
            out.append(_U64.pack(len(blob)))
            out.append(blob)
            continue
        blob = info.get("inline_blob")
        if blob is not None:
            # Inline small result: the bytes ride the completion push —
            # the caller needs no address and no fetch RPC at all.
            out.append(_U8.pack(_LOC_INLINE))
            out.append(_U64.pack(len(blob)))
            out.append(blob)
            continue
        out.append(_U8.pack(_LOC_SPILLED if info.get("spilled") else 0))
        addrs = info.get("addresses", [])
        transfer = info.get("transfer_addresses", [])
        out.append(_U8.pack(len(addrs)))
        for i, addr in enumerate(addrs):
            t = transfer[i] if i < len(transfer) else [addr[0], 0]
            out.append(_s(addr[0]))
            out.append(_U32.pack(int(addr[1])))
            out.append(_s(t[0]))
            out.append(_U32.pack(int(t[1])))
    return out


def _dec_locations_batch_resp(r: _Reader, rpc_id) -> Dict[str, Any]:
    n = r.count(r.u32())
    objects = {}
    for _ in range(n):
        oid = r.b8()
        flags = r.u8()
        if flags & _LOC_ERROR:
            objects[oid] = {"error_blob": r.b64()}
            continue
        if flags & _LOC_INLINE:
            objects[oid] = {"inline_blob": r.b64()}
            continue
        n_addr = r.u8()
        addrs, transfer = [], []
        for _ in range(n_addr):
            addrs.append([r.s(), r.u32()])
            transfer.append([r.s(), r.u32()])
        info = {"addresses": addrs, "transfer_addresses": transfer}
        if flags & _LOC_SPILLED:
            info["spilled"] = True
        objects[oid] = info
    r.done()
    return {"ok": True, "objects": objects, "rpc_id": rpc_id}


def _enc_fetch_batch(msg, peer_wire: int = WIRE_VERSION) -> List[bytes]:
    oids = msg["object_ids"]
    out = [_head(FETCH_BATCH, msg.get("rpc_id")), _U32.pack(len(oids))]
    for oid in oids:
        out.append(_b8(oid))
    return out


def _dec_fetch_batch(r: _Reader, rpc_id) -> Dict[str, Any]:
    oids = _read_id_list(r, r.count(r.u32()))
    r.done()
    return {"type": "fetch_batch", "object_ids": oids, "rpc_id": rpc_id}


def _enc_fetch_batch_resp(msg, peer_wire: int = WIRE_VERSION) -> List[bytes]:
    blobs = msg.get("blobs", {})
    out = [_head(FETCH_BATCH_RESP, msg.get("rpc_id")), _U32.pack(len(blobs))]
    for oid, blob in blobs.items():
        out.append(_b8(oid))
        out.append(_U64.pack(len(blob)))
        out.append(blob)    # pass-through buffer: no copy on encode
    return out


def _dec_fetch_batch_resp(r: _Reader, rpc_id) -> Dict[str, Any]:
    n = r.count(r.u32())
    blobs = {}
    for _ in range(n):
        oid = r.b8()
        blobs[oid] = r.b64()
    r.done()
    return {"ok": True, "blobs": blobs, "rpc_id": rpc_id}


def _enc_object_added(msg, peer_wire: int = WIRE_VERSION) -> List[bytes]:
    return [_head(OBJECT_ADDED, msg.get("rpc_id")),
            _b8(msg["object_id"]), _U64.pack(int(msg.get("size", 0)))]


def _dec_object_added(r: _Reader, rpc_id) -> Dict[str, Any]:
    oid = r.b8()
    size = r.u64()
    r.done()
    return {"type": "object_added", "object_id": oid, "size": size,
            "rpc_id": rpc_id}


def _enc_assign_batch(msg, peer_wire: int = WIRE_VERSION) -> List[bytes]:
    tasks = msg["tasks"]
    blobs = []
    for t in tasks:
        blob = t.get("_spec")
        if blob is None:
            return None  # mixed batch: pickle carries it
        blobs.append(blob)
    out = [_head(ASSIGN_BATCH, msg.get("rpc_id")), _U32.pack(len(blobs))]
    for blob in blobs:
        out.append(_U32.pack(len(blob)))
        out.append(blob)    # raw relay: spec bytes forwarded verbatim
    return out


def _dec_assign_batch(r: _Reader, rpc_id) -> Dict[str, Any]:
    n = r.count(r.u32())
    tasks = [decode_task_spec_header(r.b32()) for _ in range(n)]
    r.done()
    return {"type": "assign_batch", "tasks": tasks, "rpc_id": rpc_id}


def _enc_execute_task(msg, peer_wire: int = WIRE_VERSION) -> Optional[List[bytes]]:
    blob = msg.get("_spec")
    if blob is None:
        return None
    return [_head(EXECUTE_TASK, msg.get("rpc_id")),
            _U64.pack(len(blob)), blob]


def _dec_execute_task(r: _Reader, rpc_id) -> Dict[str, Any]:
    blob = r.b64()
    r.done()
    # Terminal hop: the executing worker is the only receiver, so the full
    # spec (args included) is decoded here — the one decode in the relay.
    out = decode_task_spec(blob)
    out["type"] = "execute_task"
    out["rpc_id"] = rpc_id
    return out


def _enc_task_done(msg, peer_wire: int = WIRE_VERSION) -> List[bytes]:
    added = msg.get("added", ())
    v3 = float(msg.get("ts_exec_end") or 0.0) > 0.0
    if v3 and peer_wire < 7:
        return None  # pre-v7 peer can't parse exec stamps: pickle carries it
    v2 = _added_has_blob(added)
    if v2 and peer_wire < 2:
        return None  # v1 peer can't parse inline items: pickle carries it
    code = TASK_DONE3 if v3 else (TASK_DONE2 if v2 else TASK_DONE)
    out = [_head(code, msg.get("rpc_id")),
           _U32.pack(int(msg.get("pid", 0))),
           _oids(msg.get("return_ids", ()))]
    (_enc_added_v2 if (v2 or v3) else _enc_added_v1)(out, added)
    out.append(_F32.pack(float(msg.get("exec_s", 0.0))))
    out.append(_F32.pack(float(msg.get("reg_s", 0.0))))
    if v3:
        out.append(_F64.pack(float(msg.get("ts_exec_start") or 0.0)))
        out.append(_F64.pack(float(msg.get("ts_exec_end") or 0.0)))
    return out


def _dec_task_done(r: _Reader, rpc_id, v2: bool = False,
                   v3: bool = False) -> Dict[str, Any]:
    pid = r.u32()
    return_ids = _read_oids(r)
    added = (_dec_added_v2 if (v2 or v3) else _dec_added_v1)(r)
    exec_s = r.f32()
    reg_s = r.f32()
    out = {"type": "task_done", "pid": pid, "return_ids": return_ids,
           "added": added, "exec_s": exec_s, "reg_s": reg_s,
           "rpc_id": rpc_id}
    if v3:
        out["ts_exec_start"] = r.f64()
        out["ts_exec_end"] = r.f64()
    r.done()
    return out


def _dec_task_done2(r: _Reader, rpc_id) -> Dict[str, Any]:
    return _dec_task_done(r, rpc_id, v2=True)


def _dec_task_done3(r: _Reader, rpc_id) -> Dict[str, Any]:
    return _dec_task_done(r, rpc_id, v3=True)


def _enc_pg_create(msg, peer_wire: int = WIRE_VERSION) -> Optional[List[bytes]]:
    try:
        strat = _PG_STRATEGIES.index(msg.get("strategy", "PACK"))
    except ValueError:
        return None  # unknown strategy: let pickle carry it (server errors)
    out = [_head(PG_CREATE, msg.get("rpc_id")), _b8(msg["pg_id"]),
           _U8.pack(strat), _s(msg.get("name") or ""),
           _U16.pack(len(msg.get("bundles", ())))]
    for bundle in msg.get("bundles", ()):
        out.append(_resources(bundle))
    return out


def _dec_pg_create(r: _Reader, rpc_id) -> Dict[str, Any]:
    pg_id = r.b8()
    strat = r.u8()
    if strat >= len(_PG_STRATEGIES):
        raise WireError(f"unknown pg strategy code {strat}")
    name = r.s()
    n = r.count(r.u16())
    bundles = [_read_resources(r) for _ in range(n)]
    r.done()
    return {"type": "create_placement_group", "pg_id": pg_id,
            "strategy": _PG_STRATEGIES[strat], "name": name,
            "bundles": bundles, "rpc_id": rpc_id}


def _enc_pg_remove(msg, peer_wire: int = WIRE_VERSION) -> List[bytes]:
    return [_head(PG_REMOVE, msg.get("rpc_id")), _b8(msg["pg_id"])]


def _dec_pg_remove(r: _Reader, rpc_id) -> Dict[str, Any]:
    pg_id = r.b8()
    r.done()
    return {"type": "remove_placement_group", "pg_id": pg_id,
            "rpc_id": rpc_id}


def _enc_pg_status(msg, peer_wire: int = WIRE_VERSION) -> List[bytes]:
    return [_head(PG_STATUS, msg.get("rpc_id"))]


def _dec_pg_status(r: _Reader, rpc_id) -> Dict[str, Any]:
    r.done()
    return {"type": "list_placement_groups", "rpc_id": rpc_id}


def _enc_pg_ok(msg, peer_wire: int = WIRE_VERSION) -> List[bytes]:
    return [_head(PG_OK, msg.get("rpc_id")),
            _U8.pack(1 if msg.get("removed") else 0)]


def _dec_pg_ok(r: _Reader, rpc_id) -> Dict[str, Any]:
    removed = r.u8()
    r.done()
    return {"ok": True, "removed": bool(removed), "rpc_id": rpc_id}


def _enc_profile_stacks(msg, peer_wire: int = WIRE_VERSION
                        ) -> Optional[List[bytes]]:
    stacks = msg.get("stacks") or {}
    if peer_wire < 3 or len(stacks) > 0xFFFF:
        # Pre-v3 peer (can't parse 0x13) or an absurd drain: pickle
        # carries it instead.
        return None
    if msg.get("stacks_oncpu") or msg.get("thread_cpu"):
        # Observatory-era drains (on-CPU stack weights, per-thread CPU
        # window) exceed what the 0x13 frame carries; the pickle body is
        # the designated ride-along path for new stats payloads — no new
        # frame id for a 2 s cadence message.
        return None
    out = [_head(PROFILE_STACKS, msg.get("rpc_id")),
           _s(msg.get("component") or ""),
           _U32.pack(int(msg.get("samples") or 0)),
           _U16.pack(len(stacks))]
    for stack, n in stacks.items():
        if len(stack) > 0xFFF0:
            # One pathological stack must not fail the whole drain.
            stack = stack[-0xFF00:]
        out.append(_s(stack))
        out.append(_U32.pack(int(n)))
    return out


def _dec_profile_stacks(r: _Reader, rpc_id) -> Dict[str, Any]:
    component = r.s()
    samples = r.u32()
    n = r.count(r.u16())
    stacks = {}
    for _ in range(n):
        key = r.s()
        stacks[key] = stacks.get(key, 0) + r.u32()
    r.done()
    return {"type": "add_profile_stacks", "component": component,
            "samples": samples, "stacks": stacks, "rpc_id": rpc_id}


def _enc_list_tasks(msg, peer_wire: int = WIRE_VERSION
                    ) -> Optional[List[bytes]]:
    if peer_wire < 4:
        return None  # pre-v4 peer: pickle carries the query
    return [_head(LIST_TASKS, msg.get("rpc_id")),
            _s(msg.get("state") or ""),
            _s(msg.get("kind") or ""),
            _s(msg.get("node_id") or ""),
            _s(msg.get("reason") or ""),
            _s(msg.get("name_contains") or ""),
            _U32.pack(int(msg.get("limit") or 0)),
            _U32.pack(int(msg.get("offset") or 0))]


def _dec_list_tasks(r: _Reader, rpc_id) -> Dict[str, Any]:
    out: Dict[str, Any] = {"type": "list_tasks", "rpc_id": rpc_id}
    for key in ("state", "kind", "node_id", "reason", "name_contains"):
        val = r.s()
        if val:
            out[key] = val
    limit = r.u32()
    offset = r.u32()
    r.done()
    if limit:
        out["limit"] = limit
    if offset:
        out["offset"] = offset
    return out


def _enc_list_tasks_resp(msg, peer_wire: int = WIRE_VERSION
                         ) -> Optional[List[bytes]]:
    if peer_wire < 4:
        return None
    # v7 peers get the exec-window twin (ts_exec_start/ts_exec_end/exec_s
    # per row); v6 peers get the forensics twin (failure_cause/
    # failure_error); v4-v5 peers still parse the original layout.
    forensic = peer_wire >= 6
    stamped = peer_wire >= 7
    if stamped:
        code = LIST_TASKS_RESP3
    elif forensic:
        code = LIST_TASKS_RESP2
    else:
        code = LIST_TASKS_RESP
    tasks = msg.get("tasks", ())
    out = [_head(code, msg.get("rpc_id")),
           _U32.pack(int(msg.get("total", 0))),
           _U8.pack(1 if msg.get("truncated") else 0),
           _U32.pack(len(tasks))]
    for t in tasks:
        try:
            state = _TASK_STATES.index(t["state"])
            kind = _TASK_KINDS.index(t["kind"])
            tid = bytes.fromhex(t["task_id"])
        except ValueError:
            return None  # unknown enum/id shape: pickle carries it
        out.append(_b8(tid))
        out.append(_U8.pack(kind))
        out.append(_U8.pack(state))
        out.append(_s(t.get("name") or ""))
        out.append(_s(t.get("node_id") or ""))
        out.append(_s(t.get("pending_reason") or ""))
        out.append(_I32.pack(int(t.get("retries_left", 0))))
        out.append(_U8.pack(1 if t.get("cancelled") else 0))
        out.append(_F64.pack(float(t.get("ts_submit", 0.0))))
        out.append(_F64.pack(float(t.get("ts_dispatch", 0.0))))
        out.append(_F64.pack(float(t.get("ts_finish", 0.0))))
        if forensic:
            out.append(_s(t.get("failure_cause") or ""))
            out.append(_s(t.get("failure_error") or ""))
        if stamped:
            out.append(_F64.pack(float(t.get("ts_exec_start", 0.0))))
            out.append(_F64.pack(float(t.get("ts_exec_end", 0.0))))
            out.append(_F64.pack(float(t.get("exec_s", 0.0))))
    return out


def _dec_list_tasks_resp_rows(r: _Reader, rpc_id, forensic: bool,
                              stamped: bool = False) -> Dict[str, Any]:
    total = r.u32()
    truncated = bool(r.u8())
    n = r.count(r.u32())
    tasks = []
    for _ in range(n):
        tid = r.b8()
        kind = r.u8()
        state = r.u8()
        if kind >= len(_TASK_KINDS) or state >= len(_TASK_STATES):
            raise WireError("bad task kind/state code")
        row = {
            "task_id": tid.hex(), "kind": _TASK_KINDS[kind],
            "state": _TASK_STATES[state], "name": r.s(),
            "node_id": r.s(), "pending_reason": r.s(),
            "retries_left": r.i32(), "cancelled": bool(r.u8()),
            "ts_submit": r.f64(), "ts_dispatch": r.f64(),
            "ts_finish": r.f64(),
        }
        if forensic:
            row["failure_cause"] = r.s()
            row["failure_error"] = r.s()
        if stamped:
            row["ts_exec_start"] = r.f64()
            row["ts_exec_end"] = r.f64()
            row["exec_s"] = r.f64()
        tasks.append(row)
    r.done()
    return {"ok": True, "tasks": tasks, "total": total,
            "truncated": truncated, "rpc_id": rpc_id}


def _dec_list_tasks_resp(r: _Reader, rpc_id) -> Dict[str, Any]:
    return _dec_list_tasks_resp_rows(r, rpc_id, forensic=False)


def _dec_list_tasks_resp2(r: _Reader, rpc_id) -> Dict[str, Any]:
    return _dec_list_tasks_resp_rows(r, rpc_id, forensic=True)


def _dec_list_tasks_resp3(r: _Reader, rpc_id) -> Dict[str, Any]:
    return _dec_list_tasks_resp_rows(r, rpc_id, forensic=True, stamped=True)


def _enc_pg_status_resp(msg, peer_wire: int = WIRE_VERSION) -> List[bytes]:
    groups = msg.get("groups", {})
    out = [_head(PG_STATUS_RESP, msg.get("rpc_id")),
           _U16.pack(len(groups))]
    for pg_hex, info in groups.items():
        out.append(_b8(bytes.fromhex(pg_hex)))
        out.append(_U8.pack(_PG_STATES.index(info["state"])))
        out.append(_U8.pack(_PG_STRATEGIES.index(info["strategy"])))
        out.append(_s(info.get("name") or ""))
        out.append(_s(info.get("reason") or ""))
        out.append(_U16.pack(len(info.get("bundles", ()))))
        for bundle in info.get("bundles", ()):
            out.append(_resources(bundle))
        nodes = info.get("nodes", ())
        out.append(_U16.pack(len(nodes)))
        for nid in nodes:
            out.append(_s(nid))
    return out


def _dec_pg_status_resp(r: _Reader, rpc_id) -> Dict[str, Any]:
    n = r.count(r.u16())
    groups = {}
    for _ in range(n):
        pg_id = r.b8()
        state = r.u8()
        strat = r.u8()
        if state >= len(_PG_STATES) or strat >= len(_PG_STRATEGIES):
            raise WireError("bad pg state/strategy code")
        name = r.s()
        reason = r.s()
        bundles = [_read_resources(r) for _ in range(r.count(r.u16()))]
        nodes = [r.s() for _ in range(r.count(r.u16()))]
        groups[pg_id.hex()] = {
            "state": _PG_STATES[state], "strategy": _PG_STRATEGIES[strat],
            "name": name, "reason": reason, "bundles": bundles,
            "nodes": nodes}
    r.done()
    return {"ok": True, "groups": groups, "rpc_id": rpc_id}


# --------------------------------------------------------------------------
# head-HA frames (v5)
# --------------------------------------------------------------------------

def _enc_repl_record(msg, peer_wire: int = WIRE_VERSION
                     ) -> Optional[List[bytes]]:
    """One replication-log entry: the (epoch, seq) fencing header plus the
    original mutating RPC's frame body, carried opaquely. This is the
    record envelope on the standby's over-the-wire tail (repl_tail
    responses); the on-disk log carries the same fields in the
    persistence layer's own fenced header."""
    if peer_wire < 5:
        return None
    body = msg["body"]
    return [_head(REPL_RECORD, msg.get("rpc_id")),
            _U32.pack(int(msg["epoch"])),
            _U64.pack(int(msg["seq"])),
            _U32.pack(len(body)), body]


def _dec_repl_record(r: _Reader, rpc_id) -> Dict[str, Any]:
    epoch = r.u32()
    seq = r.u64()
    body = r.b32()
    r.done()
    return {"type": "repl_record", "epoch": epoch, "seq": seq,
            "body": body, "rpc_id": rpc_id}


def _enc_repl_tail(msg, peer_wire: int = WIRE_VERSION
                   ) -> Optional[List[bytes]]:
    if peer_wire < 5:
        return None
    return [_head(REPL_TAIL, msg.get("rpc_id")),
            _U64.pack(int(msg.get("after_seq") or 0)),
            _U32.pack(int(msg.get("max_records") or 0))]


def _dec_repl_tail(r: _Reader, rpc_id) -> Dict[str, Any]:
    after = r.u64()
    max_records = r.u32()
    r.done()
    return {"type": "repl_tail", "after_seq": after,
            "max_records": max_records, "rpc_id": rpc_id}


def _enc_repl_tail_resp(msg, peer_wire: int = WIRE_VERSION
                        ) -> Optional[List[bytes]]:
    if peer_wire < 5:
        return None
    records = msg.get("records") or []
    snapshot = msg.get("snapshot")
    out = [_head(REPL_TAIL_RESP, msg.get("rpc_id")),
           _U32.pack(int(msg.get("epoch") or 0)),
           _U64.pack(int(msg.get("last_seq") or 0)),
           _U8.pack(1 if msg.get("resync") else 0),
           _U8.pack(1 if snapshot is not None else 0)]
    if snapshot is not None:
        out.append(_U64.pack(len(snapshot)))
        out.append(snapshot)
        out.append(_U64.pack(int(msg.get("snapshot_seq") or 0)))
    out.append(_U32.pack(len(records)))
    for rec in records:
        out.append(_U32.pack(len(rec)))
        out.append(rec)
    return out


def _dec_repl_tail_resp(r: _Reader, rpc_id) -> Dict[str, Any]:
    epoch = r.u32()
    last_seq = r.u64()
    resync = bool(r.u8())
    snapshot = None
    snapshot_seq = 0
    if r.u8():
        snapshot = r.b64()
        snapshot_seq = r.u64()
    n = r.count(r.u32())
    records = [r.b32() for _ in range(n)]
    r.done()
    return {"ok": True, "epoch": epoch, "last_seq": last_seq,
            "resync": resync, "snapshot": snapshot,
            "snapshot_seq": snapshot_seq, "records": records,
            "rpc_id": rpc_id}


def _enc_ha_status(msg, peer_wire: int = WIRE_VERSION
                   ) -> Optional[List[bytes]]:
    if peer_wire < 5:
        return None
    return [_head(HA_STATUS, msg.get("rpc_id"))]


def _dec_ha_status(r: _Reader, rpc_id) -> Dict[str, Any]:
    r.done()
    return {"type": "ha_status", "rpc_id": rpc_id}


def _enc_ha_status_resp(msg, peer_wire: int = WIRE_VERSION
                        ) -> Optional[List[bytes]]:
    if peer_wire < 5:
        return None
    peers = msg.get("peers") or []
    if len(peers) > 0xFF:
        return None
    out = [_head(HA_STATUS_RESP, msg.get("rpc_id")),
           _U32.pack(int(msg.get("epoch") or 0)),
           _U8.pack(1 if msg.get("is_leader") else 0),
           _s(msg.get("role") or ""),
           _U32.pack(int(msg.get("failover_count") or 0)),
           _U64.pack(int(msg.get("standby_lag_bytes") or 0)),
           _F64.pack(float(msg.get("time_to_recover_s") or 0.0)),
           _U64.pack(int(msg.get("repl_seq") or 0)),
           _U8.pack(len(peers))]
    for p in peers:
        out.append(_s(p))
    return out


def _dec_ha_status_resp(r: _Reader, rpc_id) -> Dict[str, Any]:
    epoch = r.u32()
    is_leader = bool(r.u8())
    role = r.s()
    failover_count = r.u32()
    lag = r.u64()
    ttr = r.f64()
    repl_seq = r.u64()
    peers = [r.s() for _ in range(r.u8())]
    r.done()
    return {"ok": True, "epoch": epoch, "is_leader": is_leader,
            "role": role, "failover_count": failover_count,
            "standby_lag_bytes": lag, "time_to_recover_s": ttr,
            "repl_seq": repl_seq, "peers": peers, "rpc_id": rpc_id}


# CANCEL_TASK field-presence flags.
_CANCEL_TASK_ID = 1
_CANCEL_OBJECT_ID = 2
_CANCEL_FORCE = 4


def _enc_cancel_task(msg, peer_wire: int = WIRE_VERSION
                     ) -> Optional[List[bytes]]:
    if peer_wire < 6:
        return None  # pre-v6 peer can't parse 0x1B: pickle carries it
    task_id = msg.get("task_id")
    object_id = msg.get("object_id")
    flags = ((_CANCEL_TASK_ID if task_id is not None else 0)
             | (_CANCEL_OBJECT_ID if object_id is not None else 0)
             | (_CANCEL_FORCE if msg.get("force") else 0))
    out = [_head(CANCEL_TASK, msg.get("rpc_id")), _U8.pack(flags)]
    if task_id is not None:
        out.append(_b8(task_id))
    if object_id is not None:
        out.append(_b8(object_id))
    return out


def _dec_cancel_task(r: _Reader, rpc_id) -> Dict[str, Any]:
    flags = r.u8()
    out: Dict[str, Any] = {"type": "cancel_task",
                           "force": bool(flags & _CANCEL_FORCE),
                           "rpc_id": rpc_id}
    if flags & _CANCEL_TASK_ID:
        out["task_id"] = r.b8()
    if flags & _CANCEL_OBJECT_ID:
        out["object_id"] = r.b8()
    r.done()
    return out


def _enc_spec_runs(out: List[bytes], runs, singles) -> None:
    """Shared body of the columnar frames: template runs (one header per
    run, columnar task ids / return ids / arg tails) followed by legacy
    per-task spec blobs for tasks that didn't fit a template."""
    out.append(_U16.pack(len(runs)))
    for run in runs:
        task_ids = run["task_ids"]
        return_oids = run["return_oids"]
        tails = run["tails"]
        out.append(_U8.pack(int(run.get("ver", SPEC_VERSION))))
        seg_a = run["seg_a"]
        out.append(_U32.pack(len(seg_a)))
        out.append(seg_a)
        seg_b = run["seg_b"]
        out.append(_U32.pack(len(seg_b)))
        out.append(seg_b)
        out.append(_U32.pack(len(task_ids)))
        for tid in task_ids:
            out.append(_b8(tid))
        for oids in return_oids:
            out.append(_oids(oids))
        for tail in tails:
            out.append(_U32.pack(len(tail)))
            out.append(tail)
    out.append(_U32.pack(len(singles)))
    for t in singles:
        blob = t.get("_spec") if isinstance(t, dict) else t
        if blob is None:
            blob = encode_task_spec(t)
        out.append(_U32.pack(len(blob)))
        out.append(blob)


def _dec_spec_runs(r: _Reader) -> Tuple[List[Dict[str, Any]],
                                        List[Dict[str, Any]]]:
    n_runs = r.count(r.u16())
    runs: List[Dict[str, Any]] = []
    for _ in range(n_runs):
        ver = r.u8()
        if ver != SPEC_VERSION:
            raise WireError("columnar run requires v1 specs, got %d" % ver)
        seg_a = r.b32()
        seg_b = r.b32()
        n = r.count(r.u32())
        task_ids = [r.b8() for _ in range(n)]
        return_oids = [_read_oids(r) for _ in range(n)]
        tails = [r.b32() for _ in range(n)]
        ra = _Reader(seg_a)
        fn_id = ra.b8()
        name = ra.s()
        max_retries = ra.i32()
        ra.done()
        rb = _Reader(seg_b)
        deps = _read_oids(rb)
        pin_refs = _read_oids(rb)
        resources = _read_resources(rb)
        rb.done()
        runs.append({
            "ver": ver, "seg_a": seg_a, "seg_b": seg_b,
            "fn_id": fn_id, "name": name, "max_retries": max_retries,
            "deps": deps, "pin_refs": pin_refs, "resources": resources,
            "task_ids": task_ids, "return_oids": return_oids,
            "tails": tails,
        })
    n_singles = r.count(r.u32())
    singles = [decode_task_spec_header(r.b32()) for _ in range(n_singles)]
    return runs, singles


def _enc_submit_batch_cols(msg, peer_wire: int = WIRE_VERSION
                           ) -> Optional[List[bytes]]:
    if peer_wire < 8:
        return None  # pre-v8 peer can't parse 0x20: pickle carries it
    out = [_head(SUBMIT_BATCH_COLS, msg.get("rpc_id"))]
    _enc_spec_runs(out, msg["runs"], msg.get("singles") or ())
    return out


def _dec_submit_batch_cols(r: _Reader, rpc_id) -> Dict[str, Any]:
    runs, singles = _dec_spec_runs(r)
    r.done()
    return {"type": "submit_batch_cols", "runs": runs,
            "singles": singles, "rpc_id": rpc_id}


def _enc_dispatch_wave(msg, peer_wire: int = WIRE_VERSION
                       ) -> Optional[List[bytes]]:
    if peer_wire < 8:
        return None  # pre-v8 peer can't parse 0x21: pickle carries it
    out = [_head(DISPATCH_WAVE, msg.get("rpc_id"))]
    _enc_spec_runs(out, msg["runs"], msg.get("singles") or ())
    return out


def _dec_dispatch_wave(r: _Reader, rpc_id) -> Dict[str, Any]:
    runs, singles = _dec_spec_runs(r)
    r.done()
    return {"type": "dispatch_wave", "runs": runs,
            "singles": singles, "rpc_id": rpc_id}


def _enc_owner_locate(msg, peer_wire: int = WIRE_VERSION
                      ) -> Optional[List[bytes]]:
    if peer_wire < 9:
        return None  # pre-v9 peer can't parse 0x22: pickle carries it
    oids = msg["object_ids"]
    out = [_head(OWNER_LOCATE, msg.get("rpc_id")), _U32.pack(len(oids))]
    for oid in oids:
        out.append(_b8(oid))
    return out


def _dec_owner_locate(r: _Reader, rpc_id) -> Dict[str, Any]:
    oids = _read_id_list(r, r.count(r.u32()))
    r.done()
    return {"type": "owner_locate", "object_ids": oids, "rpc_id": rpc_id}


def _enc_owner_locate_resp(msg, peer_wire: int = WIRE_VERSION
                           ) -> Optional[List[bytes]]:
    if peer_wire < 9:
        return None  # pre-v9 peer can't parse 0x23: pickle carries it
    objects = msg.get("objects", {})
    out = [_head(OWNER_LOCATE_RESP, msg.get("rpc_id")),
           _U32.pack(len(objects))]
    for oid, info in objects.items():
        out.append(_b8(oid))
        out.append(_U64.pack(int(info.get("size", 0))))
        out.append(_U8.pack(1 if info.get("inline") else 0))
    return out


def _dec_owner_locate_resp(r: _Reader, rpc_id) -> Dict[str, Any]:
    n = r.count(r.u32())
    objects = {}
    for _ in range(n):
        oid = r.b8()
        objects[oid] = {"size": r.u64(), "inline": bool(r.u8())}
    r.done()
    return {"ok": True, "objects": objects, "rpc_id": rpc_id}


def _enc_owner_fetch(msg, peer_wire: int = WIRE_VERSION
                     ) -> Optional[List[bytes]]:
    if peer_wire < 9:
        return None  # pre-v9 peer can't parse 0x24: pickle carries it
    oids = msg["object_ids"]
    out = [_head(OWNER_FETCH, msg.get("rpc_id")), _U32.pack(len(oids))]
    for oid in oids:
        out.append(_b8(oid))
    return out


def _dec_owner_fetch(r: _Reader, rpc_id) -> Dict[str, Any]:
    oids = _read_id_list(r, r.count(r.u32()))
    r.done()
    return {"type": "owner_fetch", "object_ids": oids, "rpc_id": rpc_id}


def _enc_owner_fetch_resp(msg, peer_wire: int = WIRE_VERSION
                          ) -> Optional[List[bytes]]:
    if peer_wire < 9:
        return None  # pre-v9 peer can't parse 0x25: pickle carries it
    blobs = msg.get("blobs", {})
    locations = msg.get("locations", {})
    out = [_head(OWNER_FETCH_RESP, msg.get("rpc_id")), _U32.pack(len(blobs))]
    for oid, blob in blobs.items():
        out.append(_b8(oid))
        out.append(_U64.pack(len(blob)))
        out.append(blob)    # pass-through buffer: no copy on encode
    out.append(_U32.pack(len(locations)))
    for oid, addr in locations.items():
        out.append(_b8(oid))
        out.append(_s(str(addr[0])))
        out.append(_U16.pack(int(addr[1])))
    return out


def _dec_owner_fetch_resp(r: _Reader, rpc_id) -> Dict[str, Any]:
    n = r.count(r.u32())
    blobs = {}
    for _ in range(n):
        oid = r.b8()
        blobs[oid] = r.b64()
    m = r.count(r.u32())
    locations = {}
    for _ in range(m):
        oid = r.b8()
        locations[oid] = [r.s(), r.u16()]
    r.done()
    return {"ok": True, "blobs": blobs, "locations": locations,
            "rpc_id": rpc_id}


def _enc_owner_publish(msg, peer_wire: int = WIRE_VERSION
                       ) -> Optional[List[bytes]]:
    if peer_wire < 9:
        return None  # pre-v9 peer can't parse 0x26: pickle carries it
    items = msg["items"]
    addr = msg.get("address")
    out = [_head(OWNER_PUBLISH, msg.get("rpc_id")),
           _s(msg.get("node_id") or "")]
    if addr:
        out.append(_U8.pack(1))
        out.append(_s(str(addr[0])))
        out.append(_U16.pack(int(addr[1])))
    else:
        out.append(_U8.pack(0))
    out.append(_U32.pack(len(items)))
    for ent in items:
        out.append(_b8(ent[0]))
        out.append(_U64.pack(int(ent[1])))
        blob = ent[2] if len(ent) > 2 else None
        if blob is None:
            out.append(_U8.pack(0))
        else:
            out.append(_U8.pack(1))
            out.append(_U32.pack(len(blob)))
            out.append(blob)    # pass-through buffer: no copy on encode
    return out


def _dec_owner_publish(r: _Reader, rpc_id) -> Dict[str, Any]:
    node_id = r.s()
    addr = [r.s(), r.u16()] if r.u8() else None
    n = r.count(r.u32())
    items = []
    for _ in range(n):
        oid = r.b8()
        size = r.u64()
        blob = r.b32() if r.u8() else None
        items.append([oid, size, blob])
    r.done()
    return {"type": "owner_publish", "node_id": node_id, "address": addr,
            "items": items, "rpc_id": rpc_id}


def _enc_owner_publish_resp(msg, peer_wire: int = WIRE_VERSION
                            ) -> Optional[List[bytes]]:
    if peer_wire < 9:
        return None  # pre-v9 peer can't parse 0x27: pickle carries it
    return [_head(OWNER_PUBLISH_RESP, msg.get("rpc_id")),
            _U32.pack(int(msg.get("count", 0)))]


def _dec_owner_publish_resp(r: _Reader, rpc_id) -> Dict[str, Any]:
    count = r.u32()
    r.done()
    return {"ok": True, "count": count, "rpc_id": rpc_id}


def _enc_get_obj_locations(msg, peer_wire: int = WIRE_VERSION
                           ) -> Optional[List[bytes]]:
    if peer_wire < 10:
        return None  # pre-v10 peer can't parse 0x28: pickle carries it
    return [_head(GET_OBJ_LOCATIONS, msg.get("rpc_id")),
            _b8(msg["object_id"]),
            _U8.pack(1 if msg.get("wait") else 0),
            _F64.pack(float(msg.get("timeout", 60.0)))]


def _dec_get_obj_locations(r: _Reader, rpc_id) -> Dict[str, Any]:
    oid = r.b8()
    wait = bool(r.u8())
    timeout = r.f64()
    r.done()
    return {"type": "get_object_locations", "object_id": oid,
            "wait": wait, "timeout": timeout, "rpc_id": rpc_id}


def _enc_get_obj_locations_resp(msg, peer_wire: int = WIRE_VERSION
                                ) -> Optional[List[bytes]]:
    if peer_wire < 10:
        return None  # pre-v10 peer can't parse 0x29: pickle carries it
    blob = msg.get("error_blob")
    if blob is not None:
        return [_head(GET_OBJ_LOCATIONS_RESP, msg.get("rpc_id")),
                _U8.pack(1), _U64.pack(len(blob)), blob]
    blob = msg.get("inline_blob")
    if blob is not None:
        return [_head(GET_OBJ_LOCATIONS_RESP, msg.get("rpc_id")),
                _U8.pack(2), _U64.pack(len(blob)), blob]
    locations = msg.get("locations", [])
    addrs = msg.get("addresses", [])
    transfer = msg.get("transfer_addresses", [])
    out = [_head(GET_OBJ_LOCATIONS_RESP, msg.get("rpc_id")), _U8.pack(0),
           _U32.pack(len(locations))]
    for nid in locations:
        out.append(_s(str(nid)))
    out.append(_U32.pack(len(addrs)))
    for host, port in addrs:
        out.append(_s(str(host)))
        out.append(_U16.pack(int(port)))
    out.append(_U32.pack(len(transfer)))
    for host, port in transfer:
        out.append(_s(str(host)))
        out.append(_U16.pack(int(port)))
    out.append(_U64.pack(int(msg.get("size") or 0)))
    return out


def _dec_get_obj_locations_resp(r: _Reader, rpc_id) -> Dict[str, Any]:
    flag = r.u8()
    if flag == 1:
        blob = r.b64()
        r.done()
        return {"ok": True, "locations": [], "addresses": [],
                "error_blob": blob, "rpc_id": rpc_id}
    if flag == 2:
        blob = r.b64()
        r.done()
        return {"ok": True, "locations": [], "addresses": [],
                "inline_blob": blob, "rpc_id": rpc_id}
    locations = [r.s() for _ in range(r.count(r.u32()))]
    addrs = [[r.s(), r.u16()] for _ in range(r.count(r.u32()))]
    transfer = [[r.s(), r.u16()] for _ in range(r.count(r.u32()))]
    size = r.u64()
    r.done()
    return {"ok": True, "locations": locations, "addresses": addrs,
            "transfer_addresses": transfer, "size": size, "rpc_id": rpc_id}


# Request/push encoders keyed by message "type".
_ENCODERS = {
    "submit_batch": _enc_submit_batch,
    "task_done_batch": _enc_task_done_batch,
    "locations_batch": _enc_locations_batch,
    "fetch_batch": _enc_fetch_batch,
    "object_added": _enc_object_added,
    "assign_batch": _enc_assign_batch,
    "execute_task": _enc_execute_task,
    "task_done": _enc_task_done,
    "create_placement_group": _enc_pg_create,
    "remove_placement_group": _enc_pg_remove,
    "list_placement_groups": _enc_pg_status,
    "add_profile_stacks": _enc_profile_stacks,
    "list_tasks": _enc_list_tasks,
    "repl_record": _enc_repl_record,
    "repl_tail": _enc_repl_tail,
    "ha_status": _enc_ha_status,
    "cancel_task": _enc_cancel_task,
    "submit_batch_cols": _enc_submit_batch_cols,
    "dispatch_wave": _enc_dispatch_wave,
    "owner_locate": _enc_owner_locate,
    "owner_fetch": _enc_owner_fetch,
    "owner_publish": _enc_owner_publish,
    "get_object_locations": _enc_get_obj_locations,
}

# Response encoders keyed by the *request* type they answer.
_RESP_ENCODERS = {
    "submit_batch": _enc_submit_batch_resp,
    "locations_batch": _enc_locations_batch_resp,
    "fetch_batch": _enc_fetch_batch_resp,
    "create_placement_group": _enc_pg_ok,
    "remove_placement_group": _enc_pg_ok,
    "list_placement_groups": _enc_pg_status_resp,
    "list_tasks": _enc_list_tasks_resp,
    "repl_tail": _enc_repl_tail_resp,
    "ha_status": _enc_ha_status_resp,
    "submit_batch_cols": _enc_submit_batch_resp,
    "owner_locate": _enc_owner_locate_resp,
    "owner_fetch": _enc_owner_fetch_resp,
    "owner_publish": _enc_owner_publish_resp,
    "get_object_locations": _enc_get_obj_locations_resp,
}

_DECODERS = {
    SUBMIT_BATCH: _dec_submit_batch,
    SUBMIT_BATCH_RESP: _dec_submit_batch_resp,
    TASK_DONE_BATCH: _dec_task_done_batch,
    LOCATIONS_BATCH: _dec_locations_batch,
    LOCATIONS_BATCH_RESP: _dec_locations_batch_resp,
    FETCH_BATCH: _dec_fetch_batch,
    FETCH_BATCH_RESP: _dec_fetch_batch_resp,
    OBJECT_ADDED: _dec_object_added,
    ASSIGN_BATCH: _dec_assign_batch,
    EXECUTE_TASK: _dec_execute_task,
    TASK_DONE: _dec_task_done,
    TASK_DONE2: _dec_task_done2,
    TASK_DONE3: _dec_task_done3,
    TASK_DONE_BATCH2: _dec_task_done_batch2,
    TASK_DONE_BATCH3: _dec_task_done_batch3,
    PG_CREATE: _dec_pg_create,
    PG_REMOVE: _dec_pg_remove,
    PG_STATUS: _dec_pg_status,
    PG_OK: _dec_pg_ok,
    PG_STATUS_RESP: _dec_pg_status_resp,
    PROFILE_STACKS: _dec_profile_stacks,
    LIST_TASKS: _dec_list_tasks,
    LIST_TASKS_RESP: _dec_list_tasks_resp,
    LIST_TASKS_RESP2: _dec_list_tasks_resp2,
    LIST_TASKS_RESP3: _dec_list_tasks_resp3,
    REPL_RECORD: _dec_repl_record,
    REPL_TAIL: _dec_repl_tail,
    REPL_TAIL_RESP: _dec_repl_tail_resp,
    HA_STATUS: _dec_ha_status,
    HA_STATUS_RESP: _dec_ha_status_resp,
    CANCEL_TASK: _dec_cancel_task,
    SUBMIT_BATCH_COLS: _dec_submit_batch_cols,
    DISPATCH_WAVE: _dec_dispatch_wave,
    OWNER_LOCATE: _dec_owner_locate,
    OWNER_LOCATE_RESP: _dec_owner_locate_resp,
    OWNER_FETCH: _dec_owner_fetch,
    OWNER_FETCH_RESP: _dec_owner_fetch_resp,
    OWNER_PUBLISH: _dec_owner_publish,
    OWNER_PUBLISH_RESP: _dec_owner_publish_resp,
    GET_OBJ_LOCATIONS: _dec_get_obj_locations,
    GET_OBJ_LOCATIONS_RESP: _dec_get_obj_locations_resp,
}


def encode(msg: Dict[str, Any],
           peer_wire: int = WIRE_VERSION) -> Optional[List[bytes]]:
    """Binary-encode a request/push message; None when the type has no
    fast-path codec (caller falls back to pickle). ``peer_wire`` is the
    receiver's advertised wire version: messages that would need a frame
    the peer cannot parse (e.g. inline-result items to a v1 peer) return
    None so the universally-decodable pickle body carries them."""
    enc = _ENCODERS.get(msg.get("type"))
    if enc is None:
        return None
    return enc(msg, peer_wire)


def encode_response(req_type: str, msg: Dict[str, Any],
                    peer_wire: int = WIRE_VERSION) -> Optional[List[bytes]]:
    """Binary-encode a response to ``req_type``; only ok-responses have a
    binary form (error dicts carry tracebacks and stay pickled)."""
    if msg.get("ok") is False:
        return None
    enc = _RESP_ENCODERS.get(req_type)
    if enc is None:
        return None
    return enc(msg, peer_wire)


def is_binary(body) -> bool:
    return len(body) > 0 and body[0] == MAGIC


def decode(body: bytes) -> Dict[str, Any]:
    """Decode one binary frame body into the dict the pickle path would
    have produced. Raises WireError on truncated/garbage frames."""
    if len(body) < 10:
        raise WireError(f"binary frame too short: {len(body)} bytes")
    if body[0] != MAGIC:
        raise WireError(f"bad magic byte 0x{body[0]:02x}")
    code = body[1]
    dec = _DECODERS.get(code)
    if dec is None:
        raise WireError(f"unknown message code 0x{code:02x}")
    (rpc_id,) = _U64.unpack_from(body, 2)
    msg = dec(_Reader(body, 10), rpc_id or None)
    if msg.get("rpc_id") is None:
        msg.pop("rpc_id", None)
    return msg

"""ClusterCoreWorker: the per-process runtime in cluster mode.

Reference counterpart: ``src/ray/core_worker/core_worker.h:262`` — the object
ops (Put/Get/Wait), task ops (SubmitTask/CreateActor/SubmitActorTask) and
bookkeeping embedded in every driver and worker process. Implements the same
interface the local-mode LocalRuntime exposes to the public API, but routes:

  placement     -> GCS batch placement service (the kernel)
  task dispatch -> placed node's NodeController
  objects       -> node object stores, located via the GCS directory
  actors        -> GCS actor table + the owning node's controller
"""

from __future__ import annotations

import hashlib
import itertools
import os
import pickle
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import cloudpickle

from .._private import tracing
from .._private.ids import ActorID, JobID, ObjectID, TaskID
from .._private.runtime import _EventLog, ensure_context
from .._private.serialization import SerializedObject, get_context
from .._private.task_spec import TaskSpec
from ..exceptions import ActorDiedError, GetTimeoutError
from ..object_ref import ObjectRef
from . import wire
from .protocol import ResilientClient, RpcClient

ERR_PREFIX = b"E"
VAL_PREFIX = b"V"

# Shared staleness window for owner-pushed direct refs the owner never
# observed: both the submit-side backlog guard and the lease janitor use it,
# and both confirm with the GCS that the result was actually produced before
# dropping an entry (see _expire_direct_outstanding).
DIRECT_STALE_S = 60.0


class ClusterCoreWorker:
    def __init__(self, gcs_addr: Tuple[str, int],
                 controller_addr: Optional[Tuple[str, int]] = None,
                 role: str = "driver", config=None):
        from .._private.config import get_config

        self.config = config or get_config()
        self.role = role
        self.gcs = ResilientClient(*gcs_addr,
                                   on_reconnect=self._on_gcs_reconnect)
        self.gcs_addr = gcs_addr
        # Random, NOT time-derived: two drivers initialized within the
        # same second would otherwise share a job id — and therefore the
        # whole deterministic task/object id sequence — so the GCS's
        # idempotent submit_task dedupe would silently serve one driver
        # the other's stale results (observed as cross-test contamination
        # against a shared cluster).
        self.job_id = JobID.from_random()
        self.driver_task_id = TaskID.for_driver_task(self.job_id)
        self.events = _EventLog(self.config.event_log_enabled)
        self._thread_scope_counter = itertools.count(1 << 31)
        self._ser = get_context()
        self._exported_fns: set = set()
        self._fn_id_by_obj: "weakref.WeakKeyDictionary" = (
            weakref.WeakKeyDictionary())
        self._fn_lock = threading.Lock()
        self._controllers: Dict[Tuple[str, int], RpcClient] = {}
        self._controller_lock = threading.Lock()
        self._home_addr = controller_addr  # workers: their own node
        self._actor_addr_cache: Dict[bytes, Tuple[str, int]] = {}
        self._actor_resources: Dict[bytes, Dict[str, float]] = {}
        self._blob_cache: Dict[bytes, bytes] = {}
        self._blob_cache_order: deque = deque()
        # Objects THIS process put that contain no nested ObjectRefs: the
        # only ones safe to inline as task args (inlining a container of
        # refs would drop the dep pin that transitively protects its
        # children — contained refs are not recoverable from the blob).
        self._inline_ok: set = set()
        self._inline_ok_order: deque = deque()
        # Same-host shared-memory arena, when one is reachable (workers get
        # it from their controller's env; drivers attach lazily — shm
        # existence doubles as the same-host check).
        self.local_store = None
        # Same-host result data plane: a per-owner shm completion ring
        # (see _native/completion_ring.py). Consumer side: THIS process's
        # ring, harvested by get()/wait()/the future resolver — O(wave)
        # ring pops instead of O(arena) rescans. Publisher side: rings of
        # OTHER owners this process executes tasks for, opened by name
        # derived from the return oid's job bytes (False = probed absent;
        # re-probed after _PUB_RETRY_S so a late-created ring is found).
        self._ring: Any = None
        self._ring_ready: set = set()          # oids known sealed in arena
        self._ring_ready_order: deque = deque()
        self._pub_rings: Dict[str, Any] = {}
        self._pub_lock = threading.Lock()
        if role == "driver":
            self._ensure_ring()
        # Ownership plane (wire v9): this process OWNS every object its
        # job tree creates. Drivers run an owner table + serve loop and
        # register with the GCS owner directory; controllers then publish
        # results owner-to-owner and the head keeps only the membership
        # row (reference: the per-worker ownership table of
        # reference_count.h — the owner, not the GCS, resolves its refs).
        self._owner_table: Any = None
        self._owner_server: Any = None
        self._transfer_cli: Any = None  # None=unprobed, False=unavailable
        self._transfer_has_store = False
        self._sub_client = None
        # Pipelined task submission: specs buffer here and move to the GCS
        # in batched, idempotent submit_batch calls (reference: the owner's
        # async submission queue in direct_task_transport.h:46).
        self._submit_buf: List[Dict] = []
        self._submit_lock = threading.Lock()
        self._submit_timer: Any = None
        # Driver-side phase profiler cells: name -> [count, seconds]. The
        # three phases measured here (driver_serialize, submit_rpc,
        # driver_fetch) join the four server-side ones (GCS debug_stats)
        # for the 7-phase per-task breakdown scripts/cluster_lat.py prints.
        self.phase_stats: Dict[str, list] = {}
        # Per-task tracing: spans recorded in THIS process —
        # driver phases (serialize/submit/fetch) or, inside workers, the
        # exec/register phases — buffered here and flushed to the GCS
        # trace table with the profile events. _trace_by_oid maps a
        # sampled task's return oids to its trace so get() can close the
        # driver_fetch span on arrival.
        self.trace_spans: List[Dict] = []
        self._trace_span_lock = threading.Lock()
        self._trace_by_oid: Dict[bytes, Tuple[bytes, bytes]] = {}
        self._trace_by_oid_order: deque = deque()
        self._bp_event_last = 0.0  # log_event throttle for backpressure
        # Distributed reference counting (reference: reference_count.h:33;
        # the owner<->borrower WaitForRefRemoved protocol of
        # core_worker.proto:322 collapses into holder registration with the
        # GCS, which already owns the object directory + task lifecycle).
        # Every process holding a live ObjectRef is a registered holder;
        # transitions ship as batched one-way ref_updates, and a periodic
        # full-set refresh doubles as a lease so holders that die without
        # dec'ing (SIGKILL) expire at the GCS.
        import uuid as _uuid

        self.worker_uid = _uuid.uuid4().hex
        # Owner worker leases for direct push (reference: the per-
        # SchedulingKey lease map in direct_task_transport.h:46): one lease
        # per resource class; idle leases are returned by a janitor thread.
        self._direct_lock = threading.Lock()
        self._direct_leases: Dict[Tuple, Dict] = {}
        self._direct_outstanding: Dict[bytes, float] = {}  # rid -> push time
        self._direct_expire_last = 0.0
        self._direct_janitor: Any = None
        # Shared as_future resolver (one thread + one directory long-poll
        # for every outstanding future).
        self._future_lock = threading.Lock()
        self._future_waiters: Dict[bytes, list] = {}
        self._future_thread: Any = None
        self._future_event = threading.Event()
        self._future_probe_last = 0.0
        self._ref_lock = threading.Lock()
        self._ref_counts: Dict[bytes, int] = {}
        self._ref_inc: List[bytes] = []
        self._ref_dec: List[bytes] = []
        self._ref_dirty = threading.Event()  # wakes the flusher
        self._ref_flusher: Any = None
        self._ref_refresher: Any = None
        self._ref_shutdown = threading.Event()
        # Driver-side observability flush (flight-recorder drains, result-
        # path counter deltas, phase-histogram deltas to the GCS
        # time-series, trace-sample kv poll) — see _stats_flush_loop.
        self._stats_stop = threading.Event()
        self._stats_thread: Any = None
        self._stats_counter_last: Dict[str, float] = {}
        self._stats_hist_last: Dict[str, Dict] = {}
        if role == "driver":
            self._subscribe_logs()
            try:
                # Attach to a same-host shm arena early: get() then reads
                # results zero-copy instead of over RPC.
                self._home_controller()
            except Exception:  # noqa: BLE001 - no nodes yet; attach lazily
                pass
            if getattr(self.config, "flight_recorder", True):
                from .._private import flight_recorder

                flight_recorder.start("driver")
            self._stats_thread = threading.Thread(
                target=self._stats_flush_loop, daemon=True,
                name="driver-stats-flush")
            self._stats_thread.start()
            if wire.ownership_enabled():
                self._init_ownership()

    # ------------------------------------------------------------- refcount
    def add_local_ref(self, oid) -> None:
        """0->1 transitions register this process as a holder with the GCS
        (batched one-way). Called from ObjectRef.__init__."""
        if not self.config.ref_counting_enabled:
            return
        b = oid.binary()
        with self._ref_lock:
            n = self._ref_counts.get(b, 0) + 1
            self._ref_counts[b] = n
            if n == 1:
                self._ref_inc.append(b)
                self._arm_ref_timer()

    def remove_local_ref(self, oid) -> None:
        if not self.config.ref_counting_enabled:
            return
        b = oid.binary()
        with self._ref_lock:
            n = self._ref_counts.get(b, 0) - 1
            if n > 0:
                self._ref_counts[b] = n
                return
            self._ref_counts.pop(b, None)
            if n == 0:
                self._ref_dec.append(b)
                self._arm_ref_timer()

    def _arm_ref_timer(self) -> None:
        # Caller holds _ref_lock. One persistent flusher thread batches
        # transitions on a 20ms cadence (a Timer per window would churn
        # ~50 OS threads/s under ref-heavy loops).
        self._ref_dirty.set()
        if self._ref_flusher is None:
            self._ref_flusher = threading.Thread(
                target=self._ref_flush_loop, daemon=True)
            self._ref_flusher.start()
        if self._ref_refresher is None:
            self._ref_refresher = threading.Thread(
                target=self._ref_refresh_loop, daemon=True)
            self._ref_refresher.start()

    def _ref_flush_loop(self) -> None:
        while not self._ref_shutdown.is_set():
            self._ref_dirty.wait()
            if self._ref_shutdown.is_set():
                return
            time.sleep(0.02)  # batch the window's transitions
            self._ref_dirty.clear()
            self._flush_refs()

    def _flush_refs(self) -> None:
        with self._ref_lock:
            inc, self._ref_inc = self._ref_inc, []
            dec, self._ref_dec = self._ref_dec, []
        if not inc and not dec:
            return
        try:
            self.gcs.send_oneway({"type": "ref_update",
                                  "worker": self.worker_uid,
                                  "inc": inc, "dec": dec})
        except (ConnectionError, OSError):
            pass  # the next refresh re-asserts the authoritative held set

    def _ref_refresh_loop(self) -> None:
        """Lease heartbeat: periodically re-assert the full held set. The
        GCS treats it as authoritative for this worker (drops stale holds)
        and expires workers that stop refreshing."""
        while not self._ref_shutdown.wait(2.0):
            with self._ref_lock:
                held = list(self._ref_counts)
            try:
                self.gcs.send_oneway({"type": "ref_refresh",
                                      "worker": self.worker_uid,
                                      "held": held})
            except (ConnectionError, OSError):
                pass

    def _report_contained(self, parent_oid: bytes, children: List[bytes]):
        """Refs pickled inside a stored object pin their targets while the
        containing object lives (reference: AddNestedObjectIds)."""
        if children and self.config.ref_counting_enabled:
            try:
                self.gcs.send_oneway({"type": "ref_contained",
                                      "parent": parent_oid,
                                      "children": children})
            except (ConnectionError, OSError):
                pass

    def _on_gcs_reconnect(self, client) -> None:
        """After a re-dial (head restart or failover to the standby):
        re-assert this process's state on the new leader. Everything here
        is idempotent — the GCS treats ref_refresh as the authoritative
        held set, and the log subscription is per-connection so the old
        one died with the old head. Exported functions need no replay:
        put_function is replicated, so the new leader already has them."""
        if self._ref_shutdown.is_set():
            return
        with self._ref_lock:
            held = list(self._ref_counts)
        try:
            client.send_oneway({"type": "ref_refresh",
                               "worker": self.worker_uid, "held": held})
        except (ConnectionError, OSError):
            pass  # the periodic refresh loop re-asserts in <= 2 s
        # Owner directory row: replicated, so a failover restored it — but
        # a cold head restart did not. Registration is idempotent.
        if self._owner_server is not None:
            self._register_owner(client)
        if self._sub_client is not None:
            try:
                self._sub_client.close()
            except Exception:  # noqa: BLE001
                pass
            self._sub_client = None
            self._subscribe_logs()

    def _subscribe_logs(self) -> None:
        """Stream worker stdout/stderr lines to this driver's console
        (reference: worker.py:960 print_logs over redis pubsub)."""
        import sys as _sys

        def on_push(msg):
            if msg.get("type") != "pubsub" or msg.get("channel") != "logs":
                return
            data = msg.get("data", {})
            prefix = f"({data.get('node_id', '')[:8]} pid={data.get('pid')})"
            for line in data.get("lines", []):
                print(f"{prefix} {line}", file=_sys.stderr)

        try:
            # self.gcs.addr, not self.gcs_addr: after a failover the live
            # head is whatever address the ResilientClient rotated to.
            self._sub_client = RpcClient(*self.gcs.addr, push_handler=on_push)
            self._sub_client.call({"type": "subscribe", "channel": "logs"})
        except (ConnectionError, OSError):
            self._sub_client = None

    # ---------------------------------------------------------------- helpers
    def _controller(self, addr: Tuple[str, int]) -> RpcClient:
        addr = tuple(addr)
        with self._controller_lock:
            client = self._controllers.get(addr)
            if client is None or client._closed:
                client = RpcClient(*addr,
                                   push_handler=self._on_controller_push)
                self._controllers[addr] = client
            return client

    def _on_controller_push(self, msg: Dict) -> None:
        """Unsolicited controller messages; currently lease-loss
        notifications (the leased worker died while the controller stayed
        reachable, so no connection error tells us)."""
        if msg.get("type") == "lease_lost":
            lease_id = msg.get("lease_id")
            with self._direct_lock:
                for key, lease in list(self._direct_leases.items()):
                    if lease.get("lease_id") == lease_id:
                        del self._direct_leases[key]

    def _home_controller(self) -> RpcClient:
        if self._home_addr is not None:
            return self._controller(self._home_addr)
        nodes = self.gcs.call({"type": "list_nodes"})["nodes"]
        for n in nodes:
            if not n["Alive"]:
                continue
            try:
                client = self._controller(tuple(n["Address"]))
                self._home_addr = tuple(n["Address"])
                if self.local_store is None and n.get("StoreName"):
                    # Attach to the node's shm arena if it exists on this
                    # host (open failure == different host).
                    from .._native import open_store

                    self.local_store = open_store(n["StoreName"])
                return client
            except (ConnectionError, OSError):
                self.gcs.call({"type": "report_node_dead",
                               "node_id": n["NodeID"]})
        from ..exceptions import ClusterUnavailableError

        raise ClusterUnavailableError("no reachable nodes in cluster")

    def _export_fn(self, fn: Callable) -> bytes:
        # Export-once semantics (reference: FunctionActorManager exports at
        # decoration time, not per call): the same function object submitted
        # N times must not pay N cloudpickles — at cluster task rates the
        # serialization dominates driver CPU. Keyed by object identity;
        # a WeakKeyDictionary so defining-and-dropping lambdas can't leak.
        try:
            cached = self._fn_id_by_obj.get(fn)
        except TypeError:  # unhashable/unweakreferenceable callable
            cached = None
        if cached is not None:
            return cached
        blob = cloudpickle.dumps(fn)
        fn_id = hashlib.blake2b(blob, digest_size=16).digest()
        with self._fn_lock:
            if fn_id not in self._exported_fns:
                self.gcs.call({"type": "put_function", "fn_id": fn_id,
                               "blob": blob})
                self._exported_fns.add(fn_id)
        try:
            self._fn_id_by_obj[fn] = fn_id
        except TypeError:
            pass
        return fn_id

    def _pack_value(self, value: Any,
                    pins: Optional[List[bytes]] = None) -> Tuple[str, bytes]:
        sobj = self._ser.serialize(value)
        if pins is not None and sobj.contained_refs:
            pins.extend(sobj.contained_refs)
        return ("value", sobj.to_bytes())

    def _pack_ref_arg(self, oid: bytes, deps: List[bytes]):
        """Ref arg fast path (reference: the dependency resolver's
        small-object inlining, max_direct_call_object_size): a small value
        blob already available locally ships inline in the task spec —
        no directory lookup, no dep staging, no fetch on the other side."""
        limit = self.config.max_direct_call_object_size
        if oid in self._inline_ok:
            blob = self._local_blob(oid)
            if (blob is not None and blob[:1] == VAL_PREFIX
                    and len(blob) - 1 <= limit):
                return ("value", blob[1:])
        deps.append(oid)
        return ("ref", oid)

    def _pack_args(self, spec: TaskSpec):
        args = []
        deps: List[bytes] = []
        pins: List[bytes] = []  # refs nested inside plain-value args
        for kind, payload in spec.args:
            if kind == "ref":
                args.append(self._pack_ref_arg(payload.binary(), deps))
            else:
                args.append(self._pack_value(payload, pins))
        kwargs = {}
        for key, val in spec.metadata.get("kwargs", {}).items():
            if isinstance(val, ObjectRef):
                kwargs[key] = self._pack_ref_arg(val.id.binary(), deps)
            else:
                kwargs[key] = self._pack_value(val, pins)
        return args, kwargs, deps, pins

    def record_trace_span(self, trace: bytes, task_id, phase: str,
                          start_mono: float, end_mono: float,
                          via: str = "") -> None:
        """Buffer one phase span of a sampled task (flushed in batches).
        ``via`` attributes a driver_fetch span to its delivery path
        (ring / inline / inline_push / rpc)."""
        sp = tracing.make_span(trace, task_id, phase, start_mono, end_mono,
                               src=self.role, via=via)
        with self._trace_span_lock:
            self.trace_spans.append(sp)
            if len(self.trace_spans) > 50_000:
                del self.trace_spans[:10_000]

    # ------------------------------------------------ driver stats flush
    def _stats_deltas(self) -> Tuple[Dict[str, float], Dict[str, Dict]]:
        """Per-flush deltas of the driver's phase/result counters and the
        trace_phase_ms histogram — the GCS time-series merges deltas
        additively, so each flush ships only what happened since the last."""
        from ..metrics import histogram_cells

        counters: Dict[str, float] = {}
        for name, cell in list(self.phase_stats.items()):
            if name.startswith("result:"):
                pairs = [(name, float(cell[0]))]
            else:
                # Driver-side phases join the GCS-side phase_* series so
                # the time-series holds the full 7-phase view.
                pairs = [(f"phase_count:{name}", float(cell[0])),
                         (f"phase_seconds:{name}", cell[1])]
            for key, cur in pairs:
                last = self._stats_counter_last.get(key, 0.0)
                if cur > last:
                    counters[key] = cur - last
                self._stats_counter_last[key] = cur
        hists: Dict[str, Dict] = {}
        for tags, cell in histogram_cells("trace_phase_ms").items():
            phase = dict(tags).get("phase") or "unknown"
            name = f"trace_phase_ms:{phase}"
            last = self._stats_hist_last.get(name, {})
            delta_buckets = {
                bound: n - last.get("buckets", {}).get(bound, 0)
                for bound, n in cell["buckets"].items()
                if n - last.get("buckets", {}).get(bound, 0) > 0}
            if delta_buckets:
                hists[name] = {
                    "buckets": delta_buckets,
                    "sum": cell["sum"] - last.get("sum", 0.0),
                    "count": cell["count"] - last.get("count", 0)}
            self._stats_hist_last[name] = cell
        return counters, hists

    def _stats_flush_loop(self) -> None:
        from .._private import flight_recorder, loopmon, tracing

        trace_kv_last: Any = ("\0unset",)
        cpu_sampler = loopmon.cpu_sampler("driver")
        dwell_last = 0.0
        while not self._stats_stop.wait(2.0):
            try:
                msg: Dict[str, Any] = {"type": "driver_stats",
                                       "worker": self.worker_uid}
                counters, hists = self._stats_deltas()
                if counters:
                    msg["counters"] = counters
                if hists:
                    msg["hists"] = hists
                rec = flight_recorder.get()
                if rec is not None:
                    stacks, stacks_cpu = rec.drain_tagged()
                    if stacks:
                        msg["stacks"] = stacks
                        msg["stacks_oncpu"] = stacks_cpu
                        msg["component"] = rec.component
                        msg["samples"] = sum(stacks.values())
                        flight_recorder.flush_metrics(rec, msg["samples"])
                # Observatory ride-alongs: per-thread CPU/ctx-switch
                # window + the GCS-link reader's blocked-in-recv delta
                # (the conservation ledger's socket_dwell numerator).
                if cpu_sampler is not None:
                    tc = cpu_sampler.drain()
                    if tc:
                        tc["component"] = cpu_sampler.component or "driver"
                        msg["thread_cpu"] = tc
                dwell = float(
                    self.gcs.io_stats.get("recv_dwell_s", 0.0))
                if dwell > dwell_last:
                    msg["socket_dwell_s"] = dwell - dwell_last
                    dwell_last = dwell
                if len(msg) > 2:
                    self.gcs.send_oneway(msg)
                # Runtime-adjustable trace sampling: the driver makes the
                # per-task sampling decision, so it polls the kv cell
                # `cli trace --sample` writes.
                resp = self.gcs.call(
                    {"type": "kv_get",
                     "key": tracing.TRACE_SAMPLE_KV_KEY}, timeout=5.0)
                raw = resp.get("value")
                if raw != trace_kv_last:
                    trace_kv_last = raw
                    tracing.apply_kv_rate(raw)
            except (ConnectionError, OSError):
                continue  # GCS restart window: next tick retries
            except Exception:  # noqa: BLE001 - observability never kills
                continue

    def _phase_add(self, name: str, seconds: float, n: int = 1) -> None:
        """Accumulate one phase-profiler cell (GIL-tolerant; a lost sample
        under a rare race is acceptable for a profiler)."""
        cell = self.phase_stats.get(name)
        if cell is None:
            cell = self.phase_stats[name] = [0, 0.0]
        cell[0] += n
        cell[1] += seconds

    # ------------------------------------------------- result data plane
    def _ensure_ring(self):
        """Create this owner's completion ring (idempotent). Drivers do it
        eagerly; worker cores only when they first own results (nested
        submissions), so short-lived workers don't litter /dev/shm."""
        from .._native import completion_ring as cring

        if self._ring is None:
            try:
                self._ring = cring.CompletionRing(
                    cring.ring_name(self.job_id.binary()), create=True)
            except OSError:
                self._ring = False  # creation failed: old path serves
        return self._ring or None

    def _ring_active(self) -> bool:
        ring = self._ring
        return bool(ring) and not ring.degraded

    def publish_completion(self, oid: bytes, size: int,
                           inline: Optional[bytes] = None) -> bool:
        """Publish one sealed result straight into its owner's completion
        ring (the ring name is derived from the oid's job bytes). Best
        effort: False when the owner is cross-host, the ring is
        full or degraded — the result then reaches
        the owner through the normal directory path."""
        from .._native import completion_ring as cring

        if len(oid) < 16:
            return False
        name = cring.ring_name(oid[12:16])
        with self._pub_lock:
            pub = self._pub_rings.get(name)
            if pub is None or (isinstance(pub, float)
                               and time.monotonic() > pub):
                opened = cring.open_publisher(name)
                if opened is None:
                    # Probed absent: cross-host owner (common) or a ring
                    # created after our probe — re-probe after a beat.
                    self._pub_rings[name] = time.monotonic() + 5.0
                    if len(self._pub_rings) > 256:
                        self._pub_rings.pop(next(iter(self._pub_rings)))
                    return False
                pub = self._pub_rings[name] = opened
            elif isinstance(pub, float):
                return False
        try:
            ok = pub.publish(oid, size, inline=inline)
        except (OSError, ValueError):
            ok = False
        if not ok and pub.degraded:
            with self._pub_lock:
                self._pub_rings[name] = time.monotonic() + 30.0
            pub.close()
        return ok

    def _count_result(self, via: str, n: int = 1, nbytes: int = 0) -> None:
        """Attribute n result deliveries to one path (ring / inline /
        fetch_rpc ...): a phase-stats cell (read by the A/B script and the
        message-count tests) plus the exported metrics."""
        if n <= 0:
            return
        self._phase_add(f"result:{via}", 0.0, n)
        m = getattr(self, "_rp_metrics", None)
        if m is None:
            from ..metrics import result_plane_metrics

            m = self._rp_metrics = result_plane_metrics()
        m["records"].record(n, tags={"via": via})
        if nbytes:
            m["inline_bytes"].record(nbytes)

    def _ring_wait(self, budget_s: float,
                   deadline: Optional[float]) -> bool:
        """Ring-first wait (the plasma notification-socket discipline):
        watch the ring's head word — one mmap read per tick — instead of
        parking on the directory long-poll, so a same-host completion is
        picked up in sub-millisecond time and the GCS never builds a wake
        response for it. Returns True as soon as unpopped records exist;
        False after ``budget_s`` of silence (the caller then falls back to
        the long-poll, which remains the path for cross-host results,
        worker crashes, and ring-full fallbacks)."""
        ring = self._ring
        if not ring or ring.degraded:
            return False
        end = time.monotonic() + budget_s
        if deadline is not None and deadline < end:
            end = deadline
        sleep_s = 0.0002
        while True:
            if ring.has_pending():
                return True
            if time.monotonic() >= end:
                return False
            time.sleep(sleep_s)
            if sleep_s < 0.001:
                sleep_s *= 2

    def _ring_harvest(self, pending: Optional[set] = None
                      ) -> List[Tuple[bytes, bytes, str]]:
        """Drain this owner's completion ring. Records matching ``pending``
        resolve to (oid, blob, via) for the caller; everything else parks
        in the blob cache (inline payloads) or the ring-ready set (arena
        slots) for whichever get()/wait()/future asks next."""
        ring = self._ring
        if not ring or ring.degraded:
            return []
        recs = ring.pop_all()
        if not recs:
            return []
        out: List[Tuple[bytes, bytes, str]] = []
        ready_new: List[bytes] = []
        store = self.local_store
        n_ring = n_inline = inline_bytes = 0
        for oid, flags, size, inline in recs:
            if inline is not None:
                n_inline += 1
                inline_bytes += len(inline)
                if pending is not None and oid in pending:
                    out.append((oid, inline, "inline"))
                else:
                    self._cache_blob(oid, inline)
                continue
            n_ring += 1
            if pending is not None and oid in pending and store is not None:
                blob = store.get_bytes(oid)
                if blob is not None:
                    out.append((oid, blob, "ring"))
                    continue
            ready_new.append(oid)
        if ready_new:
            # Batched bookkeeping: one set.update + one deque.extend + a
            # single trim pass instead of per-record churn (the harvest is
            # on the get() hot path).
            self._ring_ready.update(ready_new)
            self._ring_ready_order.extend(ready_new)
            for _ in range(len(self._ring_ready_order) - 65536):
                self._ring_ready.discard(self._ring_ready_order.popleft())
        if ring.degraded:
            # Torn record detected mid-harvest (worker died mid-publish):
            # everything already popped is intact; the rest of this job
            # rides the RPC/directory path.
            from ..metrics import result_plane_metrics

            result_plane_metrics()["ring_torn"].record(1.0)
        self._count_result("ring", n_ring)
        self._count_result("inline", n_inline, inline_bytes)
        return out

    # ------------------------------------------------------ ownership plane
    def _init_ownership(self) -> None:
        """Stand up this driver's owner table + serve loop and register
        with the GCS owner directory. Failure anywhere (pre-v9 head, bind
        error) leaves ownership off for this driver — results then ride
        the legacy GCS-tracked path, which stays fully supported."""
        from . import ownership

        try:
            if self._gcs_wire_version() < 9:
                return  # pre-v9 head has no owner directory
            table = ownership.OwnerTable()
            server = ownership.OwnerServer(
                table, host="0.0.0.0", on_publish=self._owner_republish)
            server.start()
            self._owner_table = table
            self._owner_server = server
            self._register_owner()
            # Keep the owner lease warm from t0: the ref refresher doubles
            # as the owner heartbeat, and an idle driver (registered but
            # not yet submitting) must not expire before its first task.
            with self._ref_lock:
                self._arm_ref_timer()
        except Exception:  # noqa: BLE001 - ownership is an optimization
            if self._owner_server is not None:
                try:
                    self._owner_server.stop()
                except Exception:  # noqa: BLE001
                    pass
            self._owner_table = None
            self._owner_server = None

    def _owner_address(self) -> list:
        """Routable address of the owner-serve loop: the IP the GCS
        connection uses locally (correct across hosts), loopback when it
        can't be read."""
        host = "127.0.0.1"
        try:
            host = self.gcs._ensure()._sock.getsockname()[0]
            if host in ("0.0.0.0", ""):
                host = "127.0.0.1"
        except Exception:  # noqa: BLE001 - single-host fallback
            pass
        return [host, self._owner_server.port]

    def _register_owner(self, client=None) -> None:
        """Idempotent directory registration (replicated at the GCS, so a
        failover restores it; re-asserted on every reconnect anyway)."""
        if self._owner_server is None:
            return
        msg = {"type": "register_owner",
               "job_id": self.job_id.binary(),
               "address": self._owner_address(),
               "worker": self.worker_uid,
               "node_id": ""}
        try:
            if client is not None:
                client.call(msg, timeout=5.0)
            else:
                self.gcs.call(msg, timeout=10.0)
        except Exception:  # noqa: BLE001 - re-asserted on reconnect
            pass

    def _owner_republish(self, fresh) -> None:
        """Owner-serve callback: a controller just published records into
        this driver's owner table. Blob-bearing records re-enter the ring
        data plane so get()/wait()/futures wake through the exact harvest
        path same-host results already use; blob-less records are
        address-only pointers (the completion ring carried the bytes, or a
        fetch from the named node will) and need no delivery here."""
        for oid, size, blob in fresh:
            if blob is None:
                continue
            try:
                if not self.publish_completion(oid, size, inline=blob):
                    self._cache_blob(oid, blob)
            except Exception:  # noqa: BLE001 - table consult is the backstop
                self._cache_blob(oid, blob)

    def _owner_pointer_fetch(self, oids) -> Dict[bytes, dict]:
        """Locations for pending oids the owner table tracks ADDRESS-ONLY
        (ring record lost to a full/disabled ring): shaped like directory
        infos so _fetch_many pulls them from the holding node directly —
        the GCS never saw these objects."""
        table = self._owner_table
        if table is None or not len(table):
            return {}
        infos: Dict[bytes, dict] = {}
        for oid in oids:
            loc = table.locate(oid)
            if loc is not None and not loc["inline"] \
                    and loc["addr"] is not None:
                infos[oid] = {"addresses": [list(loc["addr"])]}
        return infos

    # ---------------------------------------------------------- submit pipe
    def _queue_submit(self, msg: Dict) -> None:
        with self._submit_lock:
            self._submit_buf.append(msg)
            n = len(self._submit_buf)
            if self._submit_timer is None:
                # Arm a short flush timer so a lone submit still departs
                # quickly even if the caller never get()s.
                self._submit_timer = threading.Timer(
                    0.003, self._flush_submits)
                self._submit_timer.daemon = True
                self._submit_timer.start()
        if n >= 128:
            # Inline (blocking) flush ON PURPOSE: the round trip paces the
            # submitter to what the GCS can absorb. A/B'd against a
            # background pump thread (callers never block, buffer caps of
            # 256 and 2048): both measured WORSE warm 5k throughput
            # (1,083-1,145 vs 1,270 tasks/s) — an unpaced submitter floods
            # the placement/dispatch queues and the whole pipeline pays.
            self._flush_submits()

    def _flush_submits(self) -> None:
        with self._submit_lock:
            timer, self._submit_timer = self._submit_timer, None
            buf, self._submit_buf = self._submit_buf, []
        if timer is not None:
            timer.cancel()
        if not buf:
            return
        msg: Optional[Dict] = None
        if len(buf) > 1 and self._gcs_wire_version() >= 8:
            # Columnar hot path: same-template tasks share ONE spec header
            # (fn_id/name/retries/resources encoded once per run); only the
            # task ids, return ids and arg tails travel per task. Falls
            # back to the per-task frames when no run forms.
            t0 = time.perf_counter()
            msg = self._build_columnar_submit(buf)
            self._phase_add("driver_serialize", time.perf_counter() - t0, 0)
        if msg is None:
            # Serialize each spec ONCE into its wire blob: the submit
            # frame carries these bytes, the GCS keeps them opaque, and
            # the executing worker is the only decoder (zero
            # re-serialization along the relay).
            t0 = time.perf_counter()
            for t in buf:
                if "_spec" not in t:
                    t["_spec"] = wire.encode_task_spec(t)
            self._phase_add("driver_serialize",
                            time.perf_counter() - t0, 0)
            msg = {"type": "submit_batch", "tasks": buf}
        try:
            t0 = time.perf_counter()
            t0m = time.monotonic()
            self.gcs.call(msg)
            self._phase_add("submit_rpc", time.perf_counter() - t0, len(buf))
            t1m = time.monotonic()
            for t in buf:
                tr = t.get("trace")
                if tr is not None:
                    # The batch RPC carried this sampled task: its
                    # submit_rpc span is the batch's wire window.
                    self.record_trace_span(tr, t["task_id"], "submit_rpc",
                                           t0m, t1m)
        except (ConnectionError, OSError):
            # Put them back and re-arm the retry timer; submit_batch is
            # idempotent per task_id so a re-send is safe. Without the
            # timer, a blocked get() would poll forever for tasks that
            # were never delivered.
            with self._submit_lock:
                self._submit_buf = buf + self._submit_buf
                if self._submit_timer is None:
                    self._submit_timer = threading.Timer(
                        0.25, self._flush_submits)
                    self._submit_timer.daemon = True
                    self._submit_timer.start()

    def _gcs_wire_version(self) -> int:
        """The GCS's advertised wire version, probed once per connection
        and cached on the underlying RpcClient (a reconnect builds a new
        client, so the probe naturally re-runs against a new leader).
        Pre-v8 and unknown peers report 1: the caller keeps the per-task
        legacy frames, which every peer parses."""
        try:
            cli = self.gcs._ensure()
        except Exception:  # noqa: BLE001 - can't dial; legacy path is safe
            return 1
        w = getattr(cli, "_srv_wire", None)
        if w is None:
            try:
                resp = self.gcs.call({"type": "wire_probe"}, timeout=5.0)
                w = int(resp.get("wire", 1)) if resp.get("ok") else 1
            except Exception:  # noqa: BLE001 - old GCS / flaky link => v1
                w = 1
            try:
                cli = self.gcs._ensure()
                cli._srv_wire = w
                if w > cli.peer_wire:
                    # The ResilientClient never handshakes wire versions
                    # (the GCS advertises to nodes/workers at registration
                    # only), so lift the client's peer floor here: without
                    # it encode() would pickle the columnar frame.
                    cli.peer_wire = w
            except Exception:  # noqa: BLE001 - reconnected mid-probe
                pass
        return int(w)

    @staticmethod
    def _template_key(t: Dict) -> Optional[Tuple]:
        """Grouping key for the columnar submit: tasks sharing a key share
        one spec template. None = ineligible (trace/deadline extensions
        need the v2/v3 per-task header; dep/pin lists are almost never
        shared, so they ride the legacy singles rather than fragment the
        runs)."""
        if t.get("trace") is not None or t.get("timeout_s") is not None \
                or t.get("deps") or t.get("pin_refs"):
            return None
        res = t.get("resources") or {}
        return (t.get("fn_id"), t.get("name"), int(t.get("max_retries", 0)),
                tuple(sorted(res.items())))

    def _build_columnar_submit(self, buf: List[Dict]) -> Optional[Dict]:
        """Partition a submit buffer into template runs (>=2 tasks sharing
        a template) + legacy singles; None when no run forms (the per-task
        frame is then strictly better — no run headers to pay for)."""
        groups: Dict[Tuple, List[Dict]] = {}
        singles: List[Dict] = []
        for t in buf:
            key = self._template_key(t)
            if key is None:
                singles.append(t)
            else:
                groups.setdefault(key, []).append(t)
        runs = []
        for ts in groups.values():
            if len(ts) < 2:
                singles.extend(ts)
                continue
            seg_a, seg_b = wire.encode_spec_segments(ts[0])
            runs.append({
                "ver": wire.SPEC_VERSION, "seg_a": seg_a, "seg_b": seg_b,
                "task_ids": [t["task_id"] for t in ts],
                "return_oids": [t.get("return_ids", ()) for t in ts],
                "tails": [wire.encode_spec_tail(t) for t in ts],
            })
        if not runs:
            return None
        for t in singles:
            if "_spec" not in t:
                t["_spec"] = wire.encode_task_spec(t)
        return {"type": "submit_batch_cols", "runs": runs,
                "singles": singles}

    # ------------------------------------------------------------------ tasks
    def next_task_id(self) -> TaskID:
        ctx = ensure_context(self)
        return TaskID.for_normal_task(
            ctx.job_id, ctx.current_task_id, next(ctx.task_counter)
        )

    def _place_and_send(self, resources: Dict[str, float], message: Dict,
                        attempts: int = 5) -> Dict:
        """Request placement and deliver to the granted node; a node that
        refuses connections is reported dead and placement retried."""
        last_err: Optional[BaseException] = None
        for _ in range(attempts):
            placement = self.gcs.call({
                "type": "request_placement", "resources": resources,
                "locality": None, "timeout": 60.0,
            }, timeout=90.0)
            addr = tuple(placement["address"])
            try:
                node = self._controller(addr)
                node.call(message)
                return placement
            except (ConnectionError, OSError, TimeoutError) as e:
                last_err = e
                self.gcs.call({"type": "report_node_dead",
                               "node_id": placement["node_id"]})
        from ..exceptions import ClusterUnavailableError

        raise ClusterUnavailableError(
            f"could not deliver task after {attempts} placements: {last_err}")

    def submit_task(self, fn: Callable, spec: TaskSpec) -> List[ObjectRef]:
        """Submit a task. Two paths (reference: direct task transport vs
        the queued raylet path):

        * **direct push** — dependency-free tasks, while few results are
          outstanding, go straight to a worker this owner leased from a
          node controller (one RPC hop, no GCS queue on the critical
          path); a lineage record is sent to the GCS first so
          worker-death retries / reconstruction still work;
        * **queued** — everything else goes to the GCS task table, which
          owns placement (batch kernel), dispatch, and retry.
        """
        if self._ring is None:
            # Worker cores create their ring on first ownership (nested
            # submissions) — before the spec leaves, so the executing
            # worker's publish probe finds it.
            self._ensure_ring()
        trace = tracing.maybe_sample()
        t0 = time.perf_counter()
        t0m = time.monotonic() if trace is not None else 0.0
        fn_id = self._export_fn(fn)
        args, kwargs, deps, pins = self._pack_args(spec)
        return_ids = [oid.binary() for oid in spec.return_ids()]
        resources = spec.resources.to_dict()
        payload = {
            "task_id": spec.task_id.binary(),
            "name": spec.function.repr_name,
            "fn_id": fn_id, "args": args, "kwargs": kwargs,
            "deps": deps, "pin_refs": pins, "return_ids": return_ids,
            "resources": resources, "max_retries": spec.max_retries,
        }
        if getattr(spec, "timeout_s", None) is not None:
            # Deadline fields ride the spec (wire: v3 header extension) so
            # the controller can enforce expiry; deadline-free tasks keep
            # the v1/v2 bytes.
            payload["timeout_s"] = float(spec.timeout_s)
            if spec.retry_on_timeout:
                payload["retry_on_timeout"] = True
        self._phase_add("driver_serialize", time.perf_counter() - t0)
        if trace is not None:
            # Trace context rides inside the spec (wire: v2 header
            # extension) so every hop can stamp its phase span.
            payload["trace"] = trace
            self.record_trace_span(trace, payload["task_id"],
                                   "driver_serialize", t0m, time.monotonic())
            with self._trace_span_lock:
                for rid in return_ids:
                    self._trace_by_oid[rid] = (trace, payload["task_id"])
                    self._trace_by_oid_order.append(rid)
                while len(self._trace_by_oid_order) > 8192:
                    self._trace_by_oid.pop(
                        self._trace_by_oid_order.popleft(), None)
        if not deps and self.config.direct_call_enabled \
                and self._direct_submit(payload):
            return [ObjectRef(oid) for oid in spec.return_ids()]
        self._queue_submit(payload)
        return [ObjectRef(oid) for oid in spec.return_ids()]

    # ------------------------------------------------------ direct push path
    def _direct_submit(self, payload: Dict) -> bool:
        """Push a dependency-free task to a leased worker; False => caller
        uses the queued path. Never blocks on lease acquisition: a missing
        lease is requested in the background so the NEXT submit hits it."""
        key = tuple(sorted(payload["resources"].items()))
        now = time.monotonic()
        # Backlog guard: a leased worker executes serially, so a large
        # fan-out belongs to the queued path where the kernel spreads it
        # over the cluster. Stale entries (refs never get()ed) expire once
        # the GCS confirms their results exist (outside the lock — the
        # expiry makes an RPC).
        if len(self._direct_outstanding) >= \
                self.config.direct_call_max_outstanding:
            self._expire_direct_outstanding(now)
        with self._direct_lock:
            if len(self._direct_outstanding) >= \
                    self.config.direct_call_max_outstanding:
                return False
            lease = self._direct_leases.get(key)
            if lease is None or lease.get("acquiring"):
                if lease is None:
                    self._direct_leases[key] = {"acquiring": True}
                    threading.Thread(
                        target=self._acquire_lease, args=(key,),
                        daemon=True).start()
                return False
            lease["last_used"] = now
            for rid in payload["return_ids"]:
                self._direct_outstanding[rid] = now
        try:
            # Record BEFORE push: when the leased worker dies mid-task the
            # controller reports task_failed against this record and the
            # GCS re-drives it on the queued path (max_retries preserved).
            self.gcs.send_oneway(dict(
                payload, type="record_direct_task",
                node_id=lease["node_id"]))
            lease["client"].send_oneway(dict(
                payload, type="push_task", lease_id=lease["lease_id"]))
            return True
        except (ConnectionError, OSError):
            with self._direct_lock:
                dead = self._direct_leases.pop(key, None)
                for rid in payload["return_ids"]:
                    self._direct_outstanding.pop(rid, None)
            if dead is not None and not dead.get("acquiring"):
                # Best-effort controller-side release: if only the GCS leg
                # failed, the controller is still holding a worker + shares
                # for this lease (the controller also reaps leases when the
                # owner's connection drops).
                threading.Thread(target=self._release_lease, args=(dead,),
                                 daemon=True).start()
            # The record may already be at the GCS: convert it into a
            # queued task. If the record never arrived either (requeued
            # False), fall back to a normal submission — returning True
            # with no record anywhere would strand the ObjectRefs forever.
            try:
                resp = self.gcs.call({"type": "requeue_task",
                                      "task_id": payload["task_id"],
                                      "node_id": lease["node_id"]})
                return bool(resp.get("requeued"))
            except (ConnectionError, OSError):
                return False

    def _acquire_lease(self, key: Tuple) -> None:
        """Background lease acquisition (one thread per resource class)."""
        import uuid as _uuid

        resources = dict(key)
        placement = None
        leased = False
        try:
            placement = self.gcs.call({
                "type": "request_placement", "resources": resources,
                "locality": None, "timeout": 10.0,
            }, timeout=15.0)
            addr = tuple(placement["address"])
            lease_id = _uuid.uuid4().bytes
            client = self._controller(addr)
            resp = client.call({"type": "lease_worker",
                                "lease_id": lease_id,
                                "resources": resources}, timeout=15.0)
            if not resp.get("ok", True):
                raise RuntimeError(resp.get("error", "lease denied"))
            leased = True
            with self._direct_lock:
                self._direct_leases[key] = {
                    "lease_id": lease_id, "client": client,
                    "addr": addr, "node_id": placement["node_id"],
                    "last_used": time.monotonic(),
                }
            self._start_direct_janitor()
        except Exception:  # noqa: BLE001 - lease denied: queued path serves
            with self._direct_lock:
                self._direct_leases.pop(key, None)
        finally:
            if placement is not None and not leased:
                # Placement reserved a cluster-side share the lease never
                # claimed: give it back.
                try:
                    self.gcs.send_oneway({
                        "type": "release_resources",
                        "node_id": placement["node_id"],
                        "resources": resources})
                except (ConnectionError, OSError):
                    pass

    def _start_direct_janitor(self) -> None:
        with self._direct_lock:
            if self._direct_janitor is not None:
                return
            self._direct_janitor = threading.Thread(
                target=self._direct_janitor_loop, daemon=True)
            self._direct_janitor.start()

    def _direct_janitor_loop(self) -> None:
        """Return idle leases (reference: lease returns on idle in
        direct_task_transport.cc ReturnWorker)."""
        while not self._ref_shutdown.wait(1.0):
            idle_s = self.config.direct_lease_idle_s
            now = time.monotonic()
            to_release = []
            # Expire completed-but-never-observed entries first: an owner
            # that pushes a few tasks and never get()/wait()s their refs
            # must not pin the leased worker and its shares forever.
            self._expire_direct_outstanding(now)
            with self._direct_lock:
                if self._direct_outstanding:
                    # Pushed work may still be running on a leased worker;
                    # releasing now would idle that worker into the queued
                    # dispatch pool mid-task.
                    continue
                for key, lease in list(self._direct_leases.items()):
                    if lease.get("acquiring"):
                        continue
                    if now - lease["last_used"] > idle_s:
                        to_release.append(lease)
                        del self._direct_leases[key]
            for lease in to_release:
                self._release_lease(lease)

    def _expire_direct_outstanding(self, now: float) -> None:
        """Drop outstanding direct refs older than DIRECT_STALE_S that the
        owner never observed — but ONLY once the GCS confirms the result
        (or its error blob) was actually produced. Age alone cannot
        distinguish an unfetched completed task from a long-running one,
        and treating a running task as stale would let the janitor release
        its lease (and the node shares it occupies) mid-execution."""
        if now - self._direct_expire_last < 5.0:
            return  # throttle BEFORE the scan: this runs per submit when
            #         the outstanding window is full
        with self._direct_lock:
            stale = [rid for rid, t in self._direct_outstanding.items()
                     if now - t > DIRECT_STALE_S]
        if not stale:
            return
        self._direct_expire_last = now
        try:
            resp = self.gcs.call({"type": "locations_batch",
                                  "object_ids": stale}, timeout=5.0)
        except Exception:  # noqa: BLE001 - GCS unreachable: keep entries
            return
        produced = resp.get("objects", {})
        if not produced:
            return
        with self._direct_lock:
            for rid in stale:
                if rid in produced:
                    self._direct_outstanding.pop(rid, None)

    def _release_lease(self, lease: Dict) -> None:
        try:
            lease["client"].call({"type": "release_lease",
                                  "lease_id": lease["lease_id"]},
                                 timeout=10.0)
        except Exception:  # noqa: BLE001 - node died: GCS reaps its shares
            pass

    def _direct_observed(self, oid: bytes) -> None:
        """A result arrived: shrink the outstanding window."""
        if self._direct_outstanding:
            with self._direct_lock:
                self._direct_outstanding.pop(oid, None)

    def _release_all_leases(self) -> None:
        with self._direct_lock:
            leases, self._direct_leases = \
                list(self._direct_leases.values()), {}
        for lease in leases:
            if not lease.get("acquiring"):
                self._release_lease(lease)

    # ------------------------------------------------------ placement groups
    def create_placement_group(self, pg_id: bytes, bundles, strategy: str,
                               name: str = "") -> None:
        """Register the group with the GCS; gang admission is async (the
        GCS admits all bundles atomically when capacity allows)."""
        self._flush_submits()
        resp = self.gcs.call({
            "type": "create_placement_group", "pg_id": pg_id,
            "bundles": bundles, "strategy": strategy, "name": name})
        if not resp.get("ok", True):
            raise ValueError(resp.get("error", "create_placement_group"))

    def remove_placement_group(self, pg_id: bytes) -> None:
        self.gcs.call({"type": "remove_placement_group", "pg_id": pg_id})

    def placement_group_wait(self, pg_id: bytes,
                             timeout: Optional[float] = None) -> bool:
        """Long-poll the GCS until the group is CREATED (or the timeout /
        a terminal REMOVED state)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            step = 30.0 if deadline is None else \
                min(30.0, deadline - time.monotonic())
            if step <= 0:
                return False
            resp = self.gcs.call({"type": "wait_placement_group",
                                  "pg_id": pg_id, "timeout": step},
                                 timeout=step + 30.0)
            if resp.get("created"):
                return True
            if resp.get("state") == "REMOVED" \
                    or not resp.get("known", True):
                return False
            if deadline is not None and time.monotonic() >= deadline:
                return False

    def placement_group_table(self) -> Dict[str, Dict]:
        return self.gcs.call({"type": "list_placement_groups"})["groups"]

    # ----------------------------------------------------------------- actors
    def create_actor(self, cls: type, spec: TaskSpec, args, kwargs) -> ActorID:
        self._flush_submits()
        actor_id = spec.actor_id
        methods = tuple(n for n in dir(cls) if not n.startswith("_"))
        fn_id = self._export_fn(cls)
        packed_args = []
        deps: List[bytes] = []
        pins: List[bytes] = []
        for a in args:
            if isinstance(a, ObjectRef):
                packed_args.append(self._pack_ref_arg(a.id.binary(), deps))
            else:
                packed_args.append(self._pack_value(a, pins))
        packed_kwargs = {}
        for key, val in (kwargs or {}).items():
            if isinstance(val, ObjectRef):
                packed_kwargs[key] = self._pack_ref_arg(val.id.binary(), deps)
            else:
                packed_kwargs[key] = self._pack_value(val, pins)
        resources = spec.resources.to_dict()
        self._actor_resources[actor_id.binary()] = resources
        self.gcs.call({
            "type": "create_actor", "actor_id": actor_id.binary(),
            "name": spec.name, "class_name": cls.__name__,
            "module": cls.__module__, "methods": methods,
            "fn_id": fn_id, "args": packed_args, "kwargs": packed_kwargs,
            "deps": deps, "pin_refs": pins,
            "return_ids": [spec.return_ids()[0].binary()],
            "resources": resources,
            "max_restarts": spec.max_restarts,
            "max_concurrency": spec.max_concurrency,
            "is_asyncio": spec.is_asyncio,
        })
        return actor_id

    def _actor_address(self, actor_id: bytes) -> Optional[Tuple[str, int]]:
        info = self.gcs.call({"type": "get_actor", "actor_id": actor_id})
        if info.get("state") == "ALIVE" and info.get("address"):
            addr = tuple(info["address"])
            self._actor_addr_cache[actor_id] = addr
            return addr
        return self._actor_addr_cache.get(actor_id) \
            if info.get("state") != "DEAD" else None

    def submit_actor_task(self, spec: TaskSpec) -> List[ObjectRef]:
        self._flush_submits()
        actor_id = spec.actor_id.binary()
        args, kwargs, deps, pins = self._pack_args(spec)
        return_ids = [oid.binary() for oid in spec.return_ids()]
        refs = [ObjectRef(oid) for oid in spec.return_ids()]
        msg = {
            "type": "actor_call", "actor_id": actor_id,
            "method": spec.function.qualname,
            "args": args, "kwargs": kwargs, "deps": deps,
            "pin_refs": pins, "return_ids": return_ids,
            "name": spec.function.repr_name,
        }
        # Fast path: the cached address (no GCS round trip per call). Only
        # on a miss/failure do we fall into the resolve loop below.
        cached = self._actor_addr_cache.get(actor_id)
        if cached is not None:
            try:
                self._controller(cached).call(msg)
                return refs
            except (ConnectionError, OSError, TimeoutError, RuntimeError):
                self._actor_addr_cache.pop(actor_id, None)
                self._controllers.pop(cached, None)
        # The actor may be restarting or have moved nodes: resolve its
        # address fresh per attempt (reference: handles learn the new
        # address via the actor pubsub channel). An unreachable home node is
        # reported dead so the GCS starts the restart instead of waiting out
        # the heartbeat timeout.
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            try:
                info = self.gcs.call({"type": "get_actor",
                                      "actor_id": actor_id, "timeout": 30.0},
                                     timeout=45.0)
            except (ConnectionError, OSError, TimeoutError, RuntimeError):
                break
            state = info.get("state")
            if state == "DEAD":
                break
            if state != "ALIVE" or not info.get("address"):
                time.sleep(0.1)     # still PENDING/RESTARTING past the wait
                continue
            addr = tuple(info["address"])
            self._actor_addr_cache[actor_id] = addr
            try:
                self._controller(addr).call(msg)
                return refs
            except (ConnectionError, OSError, TimeoutError):
                self._actor_addr_cache.pop(actor_id, None)
                self._controllers.pop(addr, None)
                if info.get("node_id"):
                    try:
                        self.gcs.call({"type": "report_node_dead",
                                       "node_id": info["node_id"]})
                    except (ConnectionError, OSError):
                        pass
                time.sleep(0.2)
        self._store_error_blobs(
            return_ids, ActorDiedError(spec.actor_id.hex()[:12])
        )
        return refs

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        addr = self._actor_address(actor_id.binary())
        resources = self._actor_resources.get(actor_id.binary(), {})
        if addr is not None:
            self._controller(addr).call({
                "type": "kill_actor", "actor_id": actor_id.binary(),
                "resources": resources, "no_restart": no_restart,
            })
        if no_restart:
            self.gcs.call({"type": "update_actor",
                           "actor_id": actor_id.binary(),
                           "state": "DEAD", "no_restart": True})
        self._actor_addr_cache.pop(actor_id.binary(), None)

    def get_actor(self, name: str) -> ActorID:
        info = self.gcs.call({"type": "get_actor", "name": name})
        return ActorID(info["actor_id"])

    def actor_class_info(self, actor_id: ActorID):
        info = self.gcs.call({"type": "get_actor",
                              "actor_id": actor_id.binary()})
        return info["class_name"], info["module"], tuple(info["methods"])

    def actor_handle_alive(self, actor_id: ActorID) -> bool:
        info = self.gcs.call({"type": "get_actor",
                              "actor_id": actor_id.binary()})
        return info.get("state") == "ALIVE"

    def _store_error_blobs(self, return_ids: List[bytes], err: BaseException):
        blob = ERR_PREFIX + pickle.dumps(err)
        for oid in return_ids:
            self.put_blob(oid, blob)

    # ---------------------------------------------------------------- objects
    def _put_backpressure(self, nbytes: int) -> None:
        """Owner-side bounded wait while this node's arena is over its
        spill high watermark (reference: plasma client create retries under
        quota pressure). Gives the controller's spiller time to make room;
        never blocks past the configured bound — the store-side spill path
        absorbs what still doesn't fit."""
        if self.local_store is None:
            return
        cfg = self.config
        max_wait = getattr(cfg, "put_backpressure_max_wait_s", 0.0)
        if not getattr(cfg, "object_spill_enabled", False) or max_wait <= 0:
            return
        from .._private.spill import put_backpressure

        waited = put_backpressure(
            self.local_store.stats, nbytes,
            high_watermark=getattr(cfg, "object_spill_high_watermark", 0.85),
            max_wait_s=max_wait)
        if waited > 0.05:
            # Lifecycle event (throttled): this owner is being held back by
            # arena pressure — the forensic breadcrumb for "why did puts
            # slow down at 14:03".
            now = time.monotonic()
            if now - self._bp_event_last > 5.0:
                self._bp_event_last = now
                try:
                    self.gcs.send_oneway({
                        "type": "log_event", "kind": "backpressure_engaged",
                        "role": self.role, "waited_s": round(waited, 3),
                        "nbytes": nbytes})
                except (ConnectionError, OSError):
                    pass

    def arena_admits(self, nbytes: int) -> bool:
        """Whether a direct (zero-copy) arena write of ``nbytes`` stays
        under the spill high watermark. Over it, writers must route through
        the controller so pressure lands on the spiller (which preserves
        bytes on disk) instead of the native evictor (which drops them)."""
        if self.local_store is None:
            return False
        if not getattr(self.config, "object_spill_enabled", False):
            return True
        try:
            st = self.local_store.stats()
        except Exception:  # noqa: BLE001 - stats must never fail a put
            return True
        cap = st.get("capacity") or st.get("arena_bytes") or 0
        high = getattr(self.config, "object_spill_high_watermark", 0.85)
        return cap <= 0 or st.get("used_bytes", 0) + nbytes <= cap * high

    def put_blob(self, oid: bytes, blob: bytes) -> None:
        """Store one serialized blob: straight into the same-host shm arena
        (notifying the controller) when attached, else over RPC. The single
        write path for puts, task results, and error blobs."""
        controller = self._home_controller()
        self._put_backpressure(len(blob))
        if self.local_store is not None and self.arena_admits(len(blob)):
            try:
                self.local_store.put(oid, blob)
                # One-way: the blob is already durable in the arena; the
                # notification only wakes waiters / updates the directory.
                controller.send_oneway({"type": "object_added",
                                        "object_id": oid,
                                        "size": len(blob)})
                return
            except ConnectionError:
                raise
            except Exception:  # noqa: BLE001 - arena full: RPC/overflow path
                pass
        controller.call({"type": "store_object", "object_id": oid,
                         "blob": blob, "owner": self.worker_uid})

    def put(self, value: Any) -> ObjectRef:
        ctx = ensure_context(self)
        oid = ObjectID.for_put(ctx.current_task_id, next(ctx.put_counter))
        sobj = self._ser.serialize(value)
        self._report_contained(oid.binary(), sobj.contained_refs)
        if not sobj.contained_refs:
            self._inline_ok.add(oid.binary())
            self._inline_ok_order.append(oid.binary())
            while len(self._inline_ok_order) > 65536:
                self._inline_ok.discard(self._inline_ok_order.popleft())
        controller = self._home_controller()
        if self.local_store is not None:
            # Serialize straight into a created arena slot (plasma
            # create/seal), skipping the intermediate flat bytes copy.
            size = 1 + sobj.framed_size()
            try:
                # Over the high watermark the direct write is skipped and
                # put_blob below takes over (backpressure wait + the
                # controller spill-to-make-room route) instead of the
                # native evictor dropping cold objects.
                view = (self.local_store.create(oid.binary(), size)
                        if self.arena_admits(size) else None)
            except Exception:  # noqa: BLE001 - arena full etc.
                view = None
            if view is not None:
                view[0:1] = VAL_PREFIX
                sobj.write_into(view[1:])
                self.local_store.seal(oid.binary())
                controller.send_oneway({"type": "object_added",
                                        "object_id": oid.binary(),
                                        "size": size})
                return ObjectRef(oid)
        self.put_blob(oid.binary(), VAL_PREFIX + sobj.to_bytes())
        return ObjectRef(oid)

    def _transfer_client(self):
        """Lazy native data-plane client (reference: object manager Pull).
        Bound to this host's arena when one is attached, else buffer mode."""
        if self._transfer_cli is False:  # probed and unavailable
            return None
        if self._transfer_cli is None:
            try:
                from .._native.transfer import TransferClient

                store_name = os.environ.get("RAY_TPU_TORCH_STORE_NAME") or None
                if store_name is None and self.local_store is not None:
                    store_name = getattr(self.local_store, "name", None)
                self._transfer_cli = TransferClient(store_name)
                self._transfer_has_store = store_name is not None
            except Exception:  # noqa: BLE001
                self._transfer_cli = False
                return None
        return self._transfer_cli

    def _native_fetch(self, taddr, oid: bytes) -> Optional[bytes]:
        cli = self._transfer_client()
        if cli is None or not taddr or not taddr[1]:
            return None
        host, port = taddr[0], int(taddr[1])
        try:
            if self._transfer_has_store and self.local_store is not None:
                if cli.fetch_into_store(host, port, oid):
                    return self.local_store.get_bytes(oid)
                return None
            return cli.fetch_bytes(host, port, oid)
        except Exception:  # noqa: BLE001
            return None

    def _fetch_from(self, oid: bytes, addresses, transfer) -> Optional[bytes]:
        """Fetch one blob given directory addresses: native plane first
        (bulk bytes move C-to-C, GIL released), RPC fallback."""
        for i, addr in enumerate(addresses):
            blob = self._native_fetch(
                transfer[i] if i < len(transfer) else None, oid)
            if blob is not None:
                if not self._transfer_has_store:
                    self._cache_blob(oid, blob)
                return blob
            try:
                fetched = self._controller(tuple(addr)).call(
                    {"type": "fetch_object", "object_id": oid}
                )
                blob = fetched["blob"]
                self._cache_blob(oid, blob)
                return blob
            except (RuntimeError, ConnectionError, TimeoutError):
                continue
        return None

    def _fetch_many(self, infos: Dict[bytes, dict]) -> Dict[bytes, bytes]:
        """Fetch a set of located blobs, coalescing per-node fetch_batch
        RPCs (one reply carries a whole completion wave of small results);
        anything the batch misses — evicted, oversized reply cap, node
        error — falls back to the per-oid path, which also serves the
        native zero-copy plane."""
        out: Dict[bytes, bytes] = {}
        by_addr: Dict[tuple, list] = {}
        for oid, info in infos.items():
            # Inline small result carried in the directory response: the
            # bytes are already in hand, no node round trip needed.
            blob = info.get("inline_blob")
            if blob is not None:
                out[oid] = blob
                self._count_result("inline_push")
                continue
            # Same-host results live in the shared shm arena already — a
            # direct read beats ANY fetch RPC (measured: the 5k-fan-out
            # client previously round-tripped fetch_batch to its own
            # controller for blobs sitting in its own arena).
            blob = self._local_blob(oid)
            if blob is not None:
                out[oid] = blob
                continue
            addrs = info.get("addresses", [])
            if addrs:
                by_addr.setdefault(tuple(addrs[0]), []).append(oid)
        for addr, oids in by_addr.items():
            for i in range(0, len(oids), 1024):
                chunk = oids[i:i + 1024]
                try:
                    resp = self._controller(addr).call(
                        {"type": "fetch_batch", "object_ids": chunk},
                        timeout=60.0)
                except (RuntimeError, ConnectionError, TimeoutError):
                    continue
                fetched = resp.get("blobs", {})
                self._count_result("fetch_rpc", len(fetched))
                for oid, blob in fetched.items():
                    out[oid] = blob
                    self._cache_blob(oid, blob)
        for oid, info in infos.items():
            if oid in out:
                continue
            blob = self._fetch_from(
                oid, info.get("addresses", []),
                info.get("transfer_addresses", []))
            if blob is not None:
                out[oid] = blob
                self._count_result("fetch_rpc")
        return out

    def _fetch_blob(self, oid: bytes, timeout: Optional[float]) -> bytes:
        if self._ring_active():
            self._ring_harvest()  # drain into the caches checked below
        if self.local_store is not None:
            blob = self.local_store.get_bytes(oid)
            if blob is not None:
                return blob
        cached = self._blob_cache.get(oid)
        if cached is not None:
            return cached
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            step = 5.0 if deadline is None else min(5.0, deadline - time.monotonic())
            if step <= 0:
                raise GetTimeoutError(f"object {oid.hex()[:16]} not ready")
            if self._ring_active():
                self._ring_harvest()
            blob = self._local_blob(oid)
            if blob is not None:
                return blob
            infos = self._owner_pointer_fetch([oid])
            if infos:
                blob = self._fetch_many(infos).get(oid)
                if blob is not None:
                    return blob
            resp = self.gcs.call({
                "type": "get_object_locations", "object_id": oid,
                "wait": True, "timeout": step,
            }, timeout=step + 30.0)
            if resp.get("error_blob") is not None:
                # Terminal task failure recorded in the GCS task table
                # (retries exhausted / cancelled): no node holds a copy.
                return resp["error_blob"]
            if resp.get("inline_blob") is not None:
                # Small result carried inline by the directory itself.
                self._count_result("inline_push")
                return resp["inline_blob"]
            blob = self._fetch_from(
                oid, resp.get("addresses", []),
                resp.get("transfer_addresses", []))
            if blob is not None:
                return blob

    def _cache_blob(self, oid: bytes, blob: bytes):
        self._blob_cache[oid] = blob
        self._blob_cache_order.append(oid)
        while len(self._blob_cache_order) > 4096:
            old = self._blob_cache_order.popleft()
            self._blob_cache.pop(old, None)

    def _blob_value(self, blob: bytes) -> Any:
        if blob[:1] == ERR_PREFIX:
            raise pickle.loads(blob[1:])
        return self._ser.deserialize(SerializedObject.from_bytes(blob[1:]))

    def get_blob_value(self, oid: bytes, timeout: Optional[float] = None) -> Any:
        self._flush_submits()
        return self._blob_value(self._fetch_blob(oid, timeout))

    def _local_blob(self, oid: bytes) -> Optional[bytes]:
        if self.local_store is not None:
            blob = self.local_store.get_bytes(oid)
            if blob is not None:
                return blob
        blob = self._blob_cache.get(oid)
        if blob is None and self._owner_table is not None:
            # Owner-published inline result whose ring republish was
            # missed (ring full/disabled): the table itself holds bytes.
            blob = self._owner_table.get_blob(oid)
        return blob

    def get(self, refs: Sequence[ObjectRef],
            timeout: Optional[float] = None) -> List[Any]:
        """Batched get: one locations_batch poll covers every still-missing
        ref per cycle instead of a blocking directory round trip per ref."""
        self._flush_submits()
        oids = [r.id.binary() for r in refs]
        blobs: Dict[bytes, bytes] = {}
        pending = set(oids)
        deadline = None if timeout is None else time.monotonic() + timeout
        first = True
        last_probe = 0.0
        # Sampled-task fetch spans: arrival of a traced oid closes its
        # driver_fetch span (wait start = this get()'s entry). `traced`
        # empty => one falsy check per arrival, nothing else.
        traced = ({o for o in pending if o in self._trace_by_oid}
                  if self._trace_by_oid else None)
        t_get = time.monotonic() if traced else 0.0

        def _trace_note(oid, via=""):
            traced.discard(oid)
            ent = self._trace_by_oid.pop(oid, None)
            if ent is not None:
                self.record_trace_span(ent[0], ent[1], "driver_fetch",
                                       t_get, time.monotonic(), via=via)

        def _resolve(oid, blob, via=""):
            blobs[oid] = blob
            pending.discard(oid)
            self._direct_observed(oid)
            if traced:
                _trace_note(oid, via)
        ring_hot = False  # ring delivered on the previous cycle
        while pending:
            t0 = time.perf_counter()
            n0 = len(pending)
            store = self.local_store
            ring_on = self._ring_active()
            if ring_on:
                # Result data plane: O(completions-this-wave) ring pops —
                # each record names a sealed (or inline-carried) result,
                # so nothing is scanned and small results need no arena.
                got = self._ring_harvest(pending)
                for oid, blob, via in got:
                    _resolve(oid, blob, via)
                ring_hot = bool(got)
                ring_on = self._ring_active()
            if first or not ring_on:
                # No ring (kill switch / degraded / non-owner results):
                # the full local scan per wake is INTENTIONAL on this
                # path: same-host workers deposit results into the shared
                # arena ahead of the (batched) directory registration, so
                # each long-poll wake harvests the whole arena backlog,
                # not just the registered slice. Two A/Bs confirmed:
                # restricting to direct-push oids measured 14% WORSE warm
                # throughput (CLUSTER_LAT.json 1785482430 vs 1785482520),
                # and a frontier window with a 512-miss cutoff measured
                # 11% worse — a starved scan just shifts the load onto
                # extra directory long-polls. (With the ring carrying the
                # common path, the scan runs once, on entry, to pick up
                # results that landed before this get().)
                if store is not None and hasattr(store, "get_bytes_many"):
                    for oid, blob in store.get_bytes_many(
                            list(pending)).items():
                        _resolve(oid, blob)
                    if self._blob_cache and pending:
                        for oid in list(pending):
                            blob = self._blob_cache.get(oid)
                            if blob is not None:
                                _resolve(oid, blob)
                else:
                    for oid in list(pending):
                        blob = self._local_blob(oid)
                        if blob is not None:
                            _resolve(oid, blob)
            elif pending and not ring_hot:
                # Ring active but quiet this cycle: results can still
                # arrive via other paths (controller-stored blobs, another
                # thread's fetch) — a cache sweep costs dict lookups, not
                # arena syscalls. Skipped while the ring is delivering:
                # with per-record wakeups an O(pending) sweep per cycle
                # would be quadratic over a fan-out.
                for oid in list(pending):
                    blob = self._blob_cache.get(oid)
                    if blob is None and oid in self._ring_ready:
                        self._ring_ready.discard(oid)
                        blob = (store.get_bytes(oid)
                                if store is not None else None)
                        if blob is not None:
                            _resolve(oid, blob, "ring")
                            continue
                    if blob is not None:
                        _resolve(oid, blob)
            self._phase_add("driver_fetch", time.perf_counter() - t0,
                            n0 - len(pending))
            if not pending:
                break
            # LONG-POLL: the GCS parks until one of the requested objects
            # lands (or the window closes) instead of us sleeping and
            # re-asking — at large fan-outs the 50 Hz re-scan of every
            # pending oid dominated GCS CPU. First cycle asks with no wait
            # so an all-ready get never blocks.
            wait_s = 0.0 if first else 1.0
            if len(pending) <= 4 and (ring_on or store is not None) and (
                    not first or all(o in self._direct_outstanding
                                     for o in pending)):
                # Small-get fast path: the result hits the same-host data
                # plane a full worker->controller->GCS->driver chain
                # BEFORE the directory can wake our long-poll — a ~2 ms
                # spin (ring pops when active, else an arena probe) shaves
                # that tail off every serial round trip (A/B'd: removing
                # it measured p50 1.02 ms vs 0.85 ms with it). On the
                # FIRST cycle it only runs when every ref was
                # direct-pushed (the result is expected imminently; the
                # wait_s=0 directory poll would be a wasted round trip).
                spin_end = time.monotonic() + 0.002
                while pending and time.monotonic() < spin_end:
                    if ring_on:
                        for oid, blob, via in self._ring_harvest(pending):
                            _resolve(oid, blob, via)
                        ring_on = self._ring_active()
                    if pending and store is not None:
                        for oid, blob in store.get_bytes_many(
                                list(pending)).items():
                            _resolve(oid, blob)
                    if pending:
                        time.sleep(0.0001)
                if not pending:
                    break
            was_first = first
            first = False
            if not was_first and ring_on and self._ring_wait(
                    0.025 if ring_hot else 0.002, deadline):
                # Ring-first wait paid off: records landed — loop back to
                # harvest them without a directory round trip. The long-
                # poll below only runs once the ring goes quiet (~25 ms
                # while it is delivering, ~2 ms when results are arriving
                # some other way, e.g. cross-host), so the GCS stops
                # building per-wave wake responses for results the ring
                # already delivered.
                continue
            if deadline is not None:
                wait_s = max(0.0, min(wait_s,
                                      deadline - time.monotonic()))
            # Probe lineage recovery at most every 2 s (not per wake): a
            # lost object must be re-driven even while OTHER objects keep
            # completing, but the O(pending) probe can't run per tick.
            now = time.monotonic()
            probe = now - last_probe >= 2.0
            if probe:
                last_probe = now
            # Poll the completion FRONTIER, not the whole pending set: the
            # oldest 1024 unfinished refs in submission order. get() needs
            # every object anyway, so a window only shapes discovery order
            # while capping both the request encode and the GCS park cost
            # at O(window) instead of O(pending) (measured: 5k-oid polls
            # dominated GCS cycles at fan-out).
            ask, seen = [], set()
            for oid in oids:
                if oid in pending and oid not in seen:
                    seen.add(oid)
                    ask.append(oid)
                    if len(ask) >= 1024:
                        break
            infos = self._owner_pointer_fetch(ask)
            if infos:
                # Address-only owner-table pointers (ring record lost):
                # fetch straight from the holding node — the directory
                # has no row for owner-tracked results.
                t0 = time.perf_counter()
                fetched = self._fetch_many(infos)
                for oid, blob in fetched.items():
                    _resolve(oid, blob, "owner")
                self._phase_add("driver_fetch", time.perf_counter() - t0,
                                len(fetched))
                if not pending:
                    break
                ask = [o for o in ask if o in pending]
                if not ask:
                    continue  # window fully owner-served: refill it
            resp = self.gcs.call(
                {"type": "locations_batch", "object_ids": ask,
                 "wait_s": wait_s, "probe": probe,
                 # Wave coalescing only pays off for fan-outs; a small
                 # get() keeps the first-landing wake (serial latency).
                 "wave_s": 0.004 if len(pending) > 64 else 0.0},
                timeout=wait_s + 30.0)
            n_before = len(pending)
            to_fetch = {}
            n_push = 0
            for oid, info in resp.get("objects", {}).items():
                if info.get("error_blob") is not None:
                    blobs[oid] = info["error_blob"]
                    pending.discard(oid)
                    if traced:
                        _trace_note(oid)
                    continue
                blob = info.get("inline_blob")
                if blob is not None:
                    # Inline small result pushed WITH the completion (the
                    # GCS carried the bytes): no fetch RPC at all — this
                    # is how cross-host owners ride the new data plane.
                    if oid in pending:
                        _resolve(oid, blob, "inline_push")
                        n_push += 1
                    continue
                to_fetch[oid] = info
            self._count_result("inline_push", n_push)
            t0 = time.perf_counter()
            fetched = self._fetch_many(to_fetch)
            for oid, blob in fetched.items():
                blobs[oid] = blob
                pending.discard(oid)
                self._direct_observed(oid)
                if traced:
                    _trace_note(oid, "rpc")
            if to_fetch or n_push:
                # inline_push arrivals count as (zero-cost) fetches so the
                # driver_fetch phase cell still reflects every delivery.
                self._phase_add("driver_fetch", time.perf_counter() - t0,
                                len(fetched) + n_push)
            if not pending:
                break
            progressed = len(pending) < n_before
            if deadline is not None and time.monotonic() >= deadline:
                some = next(iter(pending))
                raise GetTimeoutError(
                    f"{len(pending)} objects not ready "
                    f"(e.g. {some.hex()[:16]})")
            if resp.get("objects") and not progressed:
                # Located but unfetchable (holder died / blob evicted
                # before the directory caught up): the long-poll returns
                # instantly on the stale location, so back off here or
                # this loop hot-spins connection attempts until the
                # heartbeat reaper updates the directory.
                time.sleep(0.05)
        t0 = time.perf_counter()
        values: Dict[bytes, Any] = {}
        out = []
        for oid in oids:
            if oid not in values:
                values[oid] = self._blob_value(blobs[oid])
            out.append(values[oid])
        self._phase_add("driver_fetch", time.perf_counter() - t0, 0)
        return out

    def wait(self, refs: Sequence[ObjectRef], num_returns: int,
             timeout: Optional[float]) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        self._flush_submits()
        deadline = None if timeout is None else time.monotonic() + timeout
        pending = {r.id.binary(): r for r in refs}
        ready: set = set()
        last_probe = 0.0
        while True:
            if self._ring_active():
                # Drain completions into the caches _local_blob consults
                # (inline payloads -> blob cache; slot records are covered
                # by the arena probe itself).
                self._ring_harvest()
            unknown = []
            for oid in list(pending):
                if oid in ready:
                    continue
                if self._local_blob(oid) is not None:
                    ready.add(oid)
                    self._direct_observed(oid)
                    continue
                if self._owner_table is not None \
                        and self._owner_table.locate(oid) is not None:
                    # Owner-tracked pointer: the bytes are one node fetch
                    # away, which is as ready as a directory location.
                    ready.add(oid)
                    self._direct_observed(oid)
                    continue
                unknown.append(oid)
            if unknown:
                # Long-poll only once nothing new is ready this cycle and
                # more readies are still needed (same rationale as get()).
                wait_s = 0.5 if len(ready) < num_returns else 0.0
                if deadline is not None:
                    wait_s = max(0.0, min(wait_s,
                                          deadline - time.monotonic()))
                now = time.monotonic()
                probe = now - last_probe >= 2.0
                if probe:
                    last_probe = now
                resp = self.gcs.call(
                    {"type": "locations_batch", "object_ids": unknown,
                     "wait_s": wait_s, "probe": probe},
                    timeout=wait_s + 30.0)
                ready.update(resp.get("objects", {}).keys())
            expired = deadline is not None and time.monotonic() >= deadline
            if len(ready) >= num_returns or expired:
                # at most num_returns in the ready list, input order preserved
                out_ready = [r for r in refs if r.id.binary() in ready]
                out_ready = out_ready[:num_returns]
                taken = {r.id.binary() for r in out_ready}
                out_rest = [r for r in refs if r.id.binary() not in taken]
                return out_ready, out_rest

    def as_future(self, ref: ObjectRef):
        """Future that resolves when the object lands — via ONE shared
        resolver thread batch-long-polling the directory for every
        outstanding future, not a thread per ref: an async ingress with N
        in-flight requests costs one poll connection, not N threads."""
        from concurrent.futures import Future

        self._flush_submits()   # the producing task may still be buffered
        fut: Future = Future()
        oid = ref.id.binary()
        blob = self._local_blob(oid)
        if blob is not None:
            self._resolve_future(fut, blob)
            self._direct_observed(oid)
            return fut
        with self._future_lock:
            self._future_waiters.setdefault(oid, []).append(fut)
            if self._future_thread is None \
                    or not self._future_thread.is_alive():
                self._future_thread = threading.Thread(
                    target=self._future_resolver_loop, daemon=True,
                    name="future-resolver")
                self._future_thread.start()
        self._future_event.set()
        return fut

    def _resolve_future(self, fut, blob: bytes) -> None:
        """Settle one future; tolerant of caller-side cancellation (e.g.
        asyncio.wait_for timing out wrap_future) — an InvalidStateError
        here must never escape into the SHARED resolver thread, where it
        would strand every other outstanding future."""
        try:
            value, exc = self._blob_value(blob), None
        except BaseException as e:  # noqa: BLE001 - error blob -> exception
            value, exc = None, e
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(value)
        except Exception:  # noqa: BLE001 - cancelled/already settled
            pass

    def _future_resolver_loop(self) -> None:
        while not self._ref_shutdown.is_set():
            try:
                self._future_resolver_tick()
            except Exception:  # noqa: BLE001 - resolver must survive
                import traceback

                traceback.print_exc()
                time.sleep(0.5)

    def _future_resolver_tick(self) -> None:
        with self._future_lock:
            # Prune futures the caller abandoned (cancelled): their oids
            # must not pin the poll set forever.
            for oid in list(self._future_waiters):
                live = [f for f in self._future_waiters[oid]
                        if not f.cancelled()]
                if live:
                    self._future_waiters[oid] = live
                else:
                    del self._future_waiters[oid]
            pending = dict(self._future_waiters)
        if not pending:
            self._future_event.wait(timeout=5.0)
            self._future_event.clear()
            return

        settled = 0

        def settle(oid: bytes, blob: bytes) -> None:
            nonlocal settled
            with self._future_lock:
                futs = self._future_waiters.pop(oid, [])
            for f in futs:
                self._resolve_future(f, blob)
            self._direct_observed(oid)
            settled += 1

        if self._ring_active():
            self._ring_harvest()  # inline results land in the blob cache
        for oid in list(pending):
            blob = self._local_blob(oid)
            if blob is not None:
                settle(oid, blob)
                del pending[oid]
        if not pending:
            return
        now = time.monotonic()
        probe = now - self._future_probe_last >= 2.0
        if probe:
            self._future_probe_last = now
        try:
            # wait_s = 0.25, not 1.0: a future registered AFTER this poll
            # started is invisible to it (the park cannot be interrupted),
            # so the window is the worst-case added latency for every new
            # request — 4 idle RPCs/s while futures are outstanding buys a
            # 250 ms tail bound.
            resp = self.gcs.call(
                {"type": "locations_batch",
                 "object_ids": list(pending), "wait_s": 0.25,
                 "probe": probe}, timeout=31.0)
        except (ConnectionError, OSError):
            time.sleep(0.5)
            return
        before_rpc = settled
        to_fetch = {}
        for oid, info in resp.get("objects", {}).items():
            if info.get("error_blob") is not None:
                settle(oid, info["error_blob"])
                continue
            to_fetch[oid] = info
        for oid, blob in self._fetch_many(to_fetch).items():
            settle(oid, blob)
        if resp.get("objects") and settled == before_rpc:
            # Located but unfetchable (dead holder / evicted blob): the
            # long-poll returns instantly on the stale location — back off
            # or this loop hot-spins until the reaper fixes the directory.
            # Compared per-RPC (not tick-wide): pre-RPC local settles must
            # not mask the stall (same guard as get()'s progressed flag).
            time.sleep(0.05)

    def free(self, refs: Sequence[ObjectRef]) -> None:
        """Eagerly delete objects cluster-wide: the GCS drops directory
        entries + lineage (no reconstruction) and tells holder nodes to
        evict (reference: ray.internal.free -> FreeObjects broadcast)."""
        self._flush_submits()
        oids = [r.id.binary() for r in refs]
        for oid in oids:
            self._blob_cache.pop(oid, None)
        if self._owner_table is not None:
            self._owner_table.discard(oids)
        try:
            self.gcs.call({"type": "free_objects", "object_ids": oids})
        except (ConnectionError, OSError):
            pass

    def cancel(self, ref: ObjectRef, force: bool = False):
        """Cancel the task producing ``ref`` (reference:
        core_worker.h:588-595): queued tasks fail immediately at the GCS,
        dispatched ones are interrupted on their node."""
        self._flush_submits()
        self.gcs.call({"type": "cancel_task",
                       "object_id": ref.id.binary(), "force": force})

    # ------------------------------------------------------------------ state
    def cluster_resources(self) -> Dict[str, float]:
        return self.gcs.call({"type": "cluster_resources"})["total"]

    def available_resources(self) -> Dict[str, float]:
        return self.gcs.call({"type": "cluster_resources"})["available"]

    def nodes(self) -> List[Dict[str, Any]]:
        return self.gcs.call({"type": "list_nodes"})["nodes"]

    def actors(self) -> Dict[str, Dict[str, Any]]:
        raw = self.gcs.call({"type": "list_actors"})["actors"]
        return {
            aid.hex(): {"ActorID": aid.hex(), "State": info["state"],
                        "Name": info.get("name")}
            for aid, info in raw.items()
        }

    def flush_events(self) -> int:
        """Push locally recorded profile spans to the GCS profile table
        (reference: core_worker/profiling.cc batched flush). Returns count.

        Spans are recorded in time.monotonic() (exact durations) but each
        process has its own monotonic epoch — cross-machine lanes would be
        hours apart. Anchor to wall clock here: the offset is constant per
        process, so durations stay exact while epochs become comparable."""
        offset = time.time() - time.monotonic()
        batch = []
        while self.events.events:
            try:
                kind, name, start, end, extra = self.events.events.popleft()
            except IndexError:
                break
            batch.append({
                "cat": kind, "name": name,
                "start": start + offset, "end": end + offset,
                "extra": {k: v for k, v in extra.items()
                          if isinstance(v, (str, int, float, bool))},
                "origin": self.role,
            })
            if len(batch) >= 10_000:
                break
        if batch:
            try:
                self.gcs.call({"type": "add_profile_data", "events": batch})
            except (ConnectionError, OSError):
                return 0
        self.flush_traces()
        return len(batch)

    def flush_traces(self) -> int:
        """Push buffered per-task trace spans to the GCS trace table."""
        with self._trace_span_lock:
            spans, self.trace_spans = self.trace_spans, []
        if not spans:
            return 0
        try:
            for i in range(0, len(spans), 10_000):
                self.gcs.send_oneway({"type": "add_trace_data",
                                      "spans": spans[i:i + 10_000]})
        except (ConnectionError, OSError):
            return 0
        return len(spans)

    def cluster_profile_events(self, limit: Optional[int] = None):
        msg = {"type": "get_profile_data"}
        if limit:
            msg["limit"] = int(limit)
        return self.gcs.call(msg)["events"]

    def cluster_trace_spans(self, limit: Optional[int] = None):
        """Raw phase spans from the GCS trace table (this process's own
        buffered spans are flushed first so a fresh submit is visible)."""
        self.flush_traces()
        msg = {"type": "get_trace_data"}
        if limit:
            msg["limit"] = int(limit)
        return self.gcs.call(msg)["spans"]

    def cluster_timeseries(self, last: Optional[int] = 60,
                           names: Optional[list] = None) -> Dict[str, Any]:
        """Rollup snapshot from the GCS time-series store (`cli top`,
        dashboard sparklines): {bucket_s, series, driver_totals, ...}."""
        msg: Dict[str, Any] = {"type": "get_timeseries"}
        if last:
            msg["last"] = int(last)
        if names:
            msg["names"] = list(names)
        return self.gcs.call(msg)

    def cluster_profile_stacks(self, component: Optional[str] = None):
        """Cumulative flight-recorder folded-stack counts per component."""
        msg: Dict[str, Any] = {"type": "get_profile_stacks"}
        if component:
            msg["component"] = component
        return self.gcs.call(msg)["components"]

    def cluster_events(self, limit: Optional[int] = None,
                       kind: Optional[str] = None):
        """Structured lifecycle events from the GCS cluster event log."""
        return self.cluster_events_page(limit=limit, kind=kind)["events"]

    def cluster_events_page(self, limit: Optional[int] = None,
                            kind: Optional[str] = None,
                            after_seq: Optional[int] = None
                            ) -> Dict[str, Any]:
        """Full event-log response (events + drop accounting + seq
        cursors). ``after_seq`` makes it a tail read: only events newer
        than the cursor come back (`cli events --follow`)."""
        msg: Dict[str, Any] = {"type": "get_events"}
        if limit:
            msg["limit"] = int(limit)
        if kind:
            msg["kind"] = kind
        if after_seq is not None:
            msg["after_seq"] = int(after_seq)
        return self.gcs.call(msg)

    # ------------------------------------------------------ state API v2
    def list_tasks(self, state: Optional[str] = None,
                   kind: Optional[str] = None,
                   node_id: Optional[str] = None,
                   reason: Optional[str] = None,
                   name_contains: Optional[str] = None,
                   limit: int = 1000, offset: int = 0) -> Dict[str, Any]:
        """Bounded/filterable/paginated query over the GCS task table:
        {tasks, total, truncated}."""
        msg: Dict[str, Any] = {"type": "list_tasks",
                               "limit": int(limit), "offset": int(offset)}
        for key, val in (("state", state), ("kind", kind),
                         ("node_id", node_id), ("reason", reason),
                         ("name_contains", name_contains)):
            if val:
                msg[key] = val
        return self.gcs.call(msg)

    def task_summary(self) -> Dict[str, Any]:
        """Per-state/kind/pending-reason counts over the GCS task table."""
        return self.gcs.call({"type": "task_summary"})

    def get_task(self, task_id: str) -> Dict[str, Any]:
        """One task's full record by id (hex prefix accepted)."""
        return self.gcs.call({"type": "get_task", "task_id": task_id})

    def run_audit(self, verify: bool = True,
                  timeout: float = 120.0) -> Dict[str, Any]:
        """On-demand GCS consistency audit: {findings, summary}."""
        return self.gcs.call({"type": "run_audit", "verify": verify},
                             timeout=timeout)

    def list_jobs(self) -> Dict[str, Any]:
        """Per-job rollup over the GCS task table: {jobs: [...]}, each
        row task/state counts, submit/finish bounds, and — for jobs the
        profiler tick already analyzed — efficiency figures."""
        return self.gcs.call({"type": "list_jobs"})

    def job_profile(self, job_id: Optional[str] = None,
                    include_rows: bool = False,
                    timeout: float = 120.0) -> Dict[str, Any]:
        """Critical-path profile of one job (hex prefix accepted;
        omitted = the only job): {profile, rows?}. ``include_rows``
        pulls every task row too — the Chrome-trace export's input."""
        msg: Dict[str, Any] = {"type": "job_profile",
                               "include_rows": bool(include_rows)}
        if job_id:
            msg["job_id"] = str(job_id)
        return self.gcs.call(msg, timeout=timeout)

    def shutdown(self):
        self._flush_submits()
        self._release_all_leases()
        self._stats_stop.set()
        if self._stats_thread is not None:
            self._stats_thread.join(timeout=0.5)
            self._stats_thread = None
        from .._private import flight_recorder

        rec = flight_recorder.get()
        if rec is not None and self.role == "driver" \
                and rec.component == "driver":
            # Sampler thread must not outlive the runtime (init()/
            # shutdown() cycles restart it; pinned by tests).
            flight_recorder.stop()
        self._ref_shutdown.set()
        self._ref_dirty.set()  # unblock the flusher so it can exit
        self._flush_refs()
        if self._owner_server is not None:
            try:
                self._owner_server.stop()
            except Exception:  # noqa: BLE001
                pass
            self._owner_server = None
            self._owner_table = None
        # Exiting process drops all its holds (reference: owner death).
        with self._ref_lock:
            held, self._ref_counts = list(self._ref_counts), {}
        if held and self.config.ref_counting_enabled:
            try:
                self.gcs.send_oneway({"type": "ref_update",
                                      "worker": self.worker_uid,
                                      "inc": [], "dec": held})
            except (ConnectionError, OSError):
                pass
        self.flush_events()
        if self._ring:
            self._ring.close()  # owner side unlinks the shm segment
        with self._pub_lock:
            pubs, self._pub_rings = list(self._pub_rings.values()), {}
        for pub in pubs:
            if not isinstance(pub, float):
                pub.close()
        for client in self._controllers.values():
            client.close()
        if self._sub_client is not None:
            self._sub_client.close()
        self.gcs.close()

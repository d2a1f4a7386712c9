"""NodeController: the per-host runtime (raylet equivalent).

Reference counterpart: ``src/ray/raylet/node_manager.{h,cc}`` + worker_pool +
local object store. Responsibilities here:

  - register with the GCS, heartbeat loop (liveness; the GCS owns resource
    accounting because placement is centralized in the batch kernel);
  - local object store: serialized blobs keyed by ObjectID, with waiters;
    remote fetch on demand (the ObjectManager Pull path, object_manager.h:213);
  - worker pool: spawn/respawn python worker processes, route tasks to idle
    workers, pin workers to actors, detect worker death and fail their tasks
    (HandleUnexpectedWorkerFailure, node_manager.h:149);
  - dependency staging: fetch all ref-args locally before dispatching.
"""

from __future__ import annotations

import asyncio
import os
import select
import signal as _signal
import subprocess
import sys
import time
import uuid
from typing import Any, Dict, List, Optional, Set, Tuple

from .._private.config import Config
from .._native import create_store
from . import wire
from .protocol import Connection, ResilientClient, RpcClient, RpcServer

ERR_PREFIX = b"E"
VAL_PREFIX = b"V"


def _payload(msg):
    """Strip transport fields so forwards cannot resurrect the old type."""
    return {k: v for k, v in msg.items() if k not in ("type", "rpc_id")}


QUEUE_PIPELINE_DEPTH = 2  # queued-task executes in flight per worker


class WorkerHandle:
    def __init__(self, proc: subprocess.Popen):
        self.proc = proc
        self.conn: Optional[Connection] = None
        self.idle = True
        self.actor_id: Optional[bytes] = None
        self.lease_id: Optional[bytes] = None  # owner-leased (direct push)
        self.current_task: Optional[Dict] = None  # actor creation in flight
        # Queued-task executes outstanding on this worker (<= DEPTH): depth
        # 2 lets the next admitted task sit in the worker's inbox while the
        # current one runs, so a completion starts its successor without a
        # controller round trip (on a contended host the execute/done
        # ping-pong's process switches were a top per-task cost).
        self.qdepth = 0
        self.last_done = time.monotonic()  # stall detector for the rescue
        self.ready = asyncio.Event()
        self.killed_deliberately = False  # ray.kill: suppress restart
        # The creation task of the actor this worker hosts, once created:
        # its shares are held until the worker exits.
        self.actor_task: Optional[Dict] = None
        # Actor method calls, leased direct tasks AND queued tasks in
        # flight on this worker, keyed by first return id: on worker death
        # every one of them must be failed.
        self.inflight: Dict[bytes, Dict] = {}
        # Deadline bookkeeping for tasks dispatched with timeout_s:
        # task_id -> [timeout_s, expiry]. expiry stays None until the task
        # reaches the head of this worker's inbox (the worker executes
        # FIFO, so the oldest inflight entry is the running one) — queued
        # pipeline time never counts against the deadline.
        self.deadlines: Dict[bytes, list] = {}


class NodeController:
    def __init__(self, config: Config, gcs_addr: Tuple[str, int],
                 resources: Dict[str, float], num_workers: int = 2,
                 host: str = "127.0.0.1", port: int = 0,
                 worker_env: Optional[Dict[str, str]] = None,
                 label: str = ""):
        self.config = config
        self.node_id = uuid.uuid4().hex
        self.label = label
        self.gcs_addr = gcs_addr
        self.resources = resources
        self.num_workers = num_workers
        self.worker_env = worker_env or {}
        self.server = RpcServer(host, port)
        # Shared-memory arena (the plasma equivalent, ray_tpu_torch/_native):
        # workers on this host attach by name and read/write zero-copy.
        # With spill enabled the arena is wrapped in the spill policy
        # (_private/spill.SpillingStore): memory pressure moves cold
        # unpinned objects to the node's spill directory instead of
        # surfacing StoreFullError; get() restores arena-first/disk-second.
        self.store_name = f"rtts-{self.node_id[:12]}"
        from .._private.spill import resolve_spill_dir

        self.store = create_store(
            self.store_name, config.object_store_memory,
            spill_dir=resolve_spill_dir(config, self.store_name),
            high_watermark=getattr(config, "object_spill_high_watermark",
                                   0.85),
            low_watermark=getattr(config, "object_spill_low_watermark", 0.60),
            owner_quota=getattr(config, "object_store_owner_quota", 0))
        self._spilling = hasattr(self.store, "set_spill_callbacks")
        if self._spilling:
            self.store.set_spill_callbacks(on_spill=self._on_object_spilled,
                                           on_restore=self._on_object_restored)
        self._overflow: Dict[bytes, bytes] = {}  # blobs too big for the arena
        # Inline small results (the new result data plane): bytes carried
        # in task_done "added" items are cached here so local dep staging
        # and fetch_batch serve them without an arena slot. LRU under a
        # byte budget; the GCS directory keeps its own inline copy, so an
        # eviction here costs a directory round trip, never the object.
        from collections import deque as _deque

        self._inline: Dict[bytes, bytes] = {}
        self._inline_order: Any = _deque()
        self._inline_bytes = 0
        self._inline_budget = 32 << 20
        # Native data plane (reference: ObjectManager's dedicated transfer
        # service): a C++ thread streaming arena bytes peer-to-peer. Absent
        # (port 0) when the arena fell back to the Python store.
        self.transfer_server = None
        self.transfer_port = 0
        try:
            from .._native.transfer import TransferServer

            self.transfer_server = TransferServer(self.store_name)
            self.transfer_port = self.transfer_server.port
        except Exception:  # noqa: BLE001 - python-store fallback path
            self.transfer_server = None
            self.transfer_port = 0
        # Transfer manager: admission (per-source inflight cap + FIFO/
        # largest-first queue) and chunked resumable pulls over the native
        # plane. None on the python-store fallback — pulls then ride the
        # RPC fetch path unscheduled.
        self.transfer_manager = None
        if self.transfer_server is not None:
            try:
                from .._native.transfer import TransferClient
                from .transfer_manager import TransferManager

                self._transfer_cli = TransferClient(self.store_name)
                self.transfer_manager = TransferManager(
                    self.store, self._transfer_cli, self.transfer_server)
            except Exception:  # noqa: BLE001
                self.transfer_manager = None
        # The arena outlives SIGKILL'd processes (/dev/shm persists); make
        # every normal exit path unlink it, even when stop() never runs
        # (e.g. the head's colocated controller thread dying with the
        # process).
        import atexit

        atexit.register(self.store.close)
        self._store_waiters: Dict[bytes, List[asyncio.Event]] = {}
        # Local strict admission (reference: DispatchTasks against the
        # node's available resources, node_manager.cc:993): the GCS may
        # queue more work here than fits; execution waits for headroom.
        # Class-indexed FIFO queues drained by ONE pump task — a per-task
        # wait on a shared event would wake every queued task per release
        # (O(N^2) for N queued).
        self.local_avail: Dict[str, float] = dict(resources)
        self._admit_event = asyncio.Event()
        self._admit_queues: Dict[Tuple, Any] = {}
        self._admit_pump_running = False
        self.workers: Dict[int, WorkerHandle] = {}  # pid -> handle
        self._spawning = 0  # async spawns in flight (bounds worker growth)
        self._idle_event = asyncio.Event()
        self._gcs: Optional[RpcClient] = None
        self._peer_clients: Dict[Tuple[str, int], RpcClient] = {}
        self._actor_queues: Dict[bytes, "asyncio.Queue"] = {}
        # Owner worker leases (reference: raylet worker leases granted to
        # the direct task transport, node_manager.cc HandleRequestWorkerLease):
        # lease_id -> {"worker": WorkerHandle, "task": admission record}.
        self._leases: Dict[bytes, Dict] = {}
        self._done_buf: List[Dict] = []  # coalesced task_done reports
        # Coalesced oneway GCS messages (registrations, done batches): one
        # scatter-write per event-loop pass instead of one syscall each —
        # a completion wave is one sendmsg, not N.
        self._gcs_out: List[Dict] = []
        self._tasks: List[asyncio.Task] = []
        self._bg: Set[asyncio.Task] = set()  # strong refs: avoid mid-run GC
        self._shutting_down = False
        self._cancelled: Set[bytes] = set()  # task_ids cancelled pre-dispatch
        # Blast-radius containment state (see docs/fault_tolerance.md).
        # Deliberate kills awaiting the reaper, so worker death can be
        # classified (deadline / oom / cancelled) instead of reported as a
        # bare crash: pid -> {"cause", "task_id", "detail", ...}.
        self._kill_causes: Dict[int, Dict] = {}
        # SIGTERM'd workers in their grace window: pid -> monotonic time at
        # which the reap loop escalates to SIGKILL.
        self._term_deadline: Dict[int, float] = {}
        # OOM guard: pid -> monotonic time its RSS first exceeded the
        # watermark (the kill waits out the grace window).
        self._oom_over_since: Dict[int, float] = {}
        self._oom_watermark = 1.0
        self._oom_grace_s = 2.0
        self._kill_grace_s = 1.0
        self._inflight_fetch: Dict[bytes, asyncio.Task] = {}  # pull dedupe
        # Ownership plane (wire v9): inline results are published straight
        # to their owning driver's table instead of the GCS object table.
        # _owner_dir caches GCS get_owner lookups per job key (positive
        # hits live longer than misses); _owner_clients holds one RpcClient
        # per owner-serve address, used from to_thread only.
        self._ownership_on = wire.ownership_enabled()
        self._owner_dir: Dict[bytes, Tuple[float, Any]] = {}
        self._owner_clients: Dict[Tuple[str, int], RpcClient] = {}
        # Diverted entries flow through ONE publisher thread (started
        # lazily): the completion hot path only strips + enqueues, never
        # waits on an owner round trip.
        self._owner_pub_q: Any = None
        self._owner_pub_thread: Any = None
        # Borrower-side holds for actor-call args: actor calls bypass the
        # GCS task table (no dep pins there), so this node registers as
        # holder of the call's ref args from enqueue until the call
        # resolves — closing the window where the caller drops its handle
        # while the call is staged/running (reference: borrower registration,
        # reference_count.h:33).
        self._ref_held_calls: Dict[bytes, List[bytes]] = {}
        self._ref_uid = f"node-{self.node_id[:12]}"
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._register_handlers()

    def _spawn_bg(self, coro) -> None:
        task = asyncio.create_task(coro)
        self._bg.add(task)

        def done(t: asyncio.Task):
            self._bg.discard(t)
            if not t.cancelled() and t.exception() is not None:
                import traceback
                traceback.print_exception(t.exception())

        task.add_done_callback(done)

    # ------------------------------------------------------------------ setup
    async def start(self) -> int:
        port = await self.server.start()
        self.address = (self.server.host, port)
        self._loop = asyncio.get_running_loop()
        # The GCS pushes dispatches (assign_task/create_actor/cancel_task)
        # over this same connection; the reader thread hops them onto the
        # event loop (reference: raylet receiving leases over its GCS link).
        self._gcs = ResilientClient(*self.gcs_addr,
                                    push_handler=self._on_gcs_push,
                                    on_reconnect=self._on_gcs_reconnect)
        self._register_with_gcs(self._gcs)
        # Reap completion rings left by SIGKILLed owners (each pins ~1 MiB
        # of tmpfs); flock liveness keeps live rings untouched.
        from .._native import completion_ring as _cring

        _cring.sweep_stale_rings()
        await asyncio.gather(
            *(self._spawn_worker_async() for _ in range(self.num_workers)))
        if getattr(self.config, "flight_recorder", True):
            from .._private import flight_recorder

            # Worker-node processes sample as "controller"; the head's
            # colocated controller thread shares the GCS's sampler.
            flight_recorder.start("controller")
        # Event-loop observatory on the controller loop (on the head this
        # is a SEPARATE loop from the GCS's, so per-loop attribution
        # stays clean even colocated). The process-wide thread-CPU
        # sampler is shared, flight-recorder style.
        from .._private import loopmon

        self._loopmon = loopmon.install("controller")
        self._cpu_sampler = loopmon.cpu_sampler("controller")
        self._tasks.append(asyncio.create_task(self._heartbeat_loop()))
        self._tasks.append(asyncio.create_task(self._reap_loop()))
        return port

    def _register_with_gcs(self, client) -> None:
        """Send register_node over ``client``. Idempotent on the GCS side
        (same node_id updates in place, rebinds the push connection), so it
        doubles as the reconnect re-registration after a head failover."""
        reg = client.call({
            "type": "register_node", "node_id": self.node_id,
            "address": list(self.address), "resources": self.resources,
            "store_name": self.store_name,
            "transfer_port": self.transfer_port,
            "label": self.label,
            "wire": wire.WIRE_VERSION,
        })
        # The GCS's advertised version gates the v2 inline-result frames
        # on the task_done_batch relay (a v1 GCS gets pickle instead).
        client.peer_wire = int(reg.get("wire") or 1)

    def _on_gcs_reconnect(self, client) -> None:
        """After the ResilientClient re-dials (head restart or failover to
        the standby): re-register so the new leader learns this node and
        binds the fresh connection for dispatch pushes. Runs on the calling
        thread of whatever RPC triggered the re-dial; the TLS latch in the
        client prevents recursion if this call itself has to re-dial."""
        if self._shutting_down:
            return
        try:
            self._register_with_gcs(client)
        except Exception:  # noqa: BLE001 — next heartbeat retries
            pass

    async def stop(self):
        self._shutting_down = True
        from .._private import flight_recorder, loopmon

        rec = flight_recorder.get()
        if rec is not None and rec.component == "controller":
            flight_recorder.stop()  # never a sampler another role started
        if getattr(self, "_loopmon", None) is not None:
            loopmon.uninstall("controller")
            self._loopmon = None
        for t in self._tasks:
            t.cancel()
        for w in self.workers.values():
            if w.proc.poll() is None:
                w.proc.terminate()
        await self.server.stop()
        if self._owner_pub_q is not None:
            self._owner_pub_q.put(None)  # publisher thread exit sentinel
        for cli in list(self._owner_clients.values()):
            try:
                cli.close()
            except Exception:  # noqa: BLE001
                pass
        self._owner_clients.clear()
        if self._gcs:
            self._gcs.close()
        if self.transfer_manager is not None:
            self.transfer_manager.close()
        if getattr(self, "_transfer_cli", None) is not None:
            try:
                self._transfer_cli.close()
            except Exception:  # noqa: BLE001
                pass
        if self.transfer_server is not None:
            self.transfer_server.stop()
        self.store.close()

    def _launch_worker_proc(self) -> subprocess.Popen:
        """The blocking half of a worker spawn (fork+exec, milliseconds on
        a loaded host). Only called from worker threads — the event loop
        spawns via _spawn_worker_async."""
        import ray_tpu_torch

        pkg_root = os.path.dirname(
            os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        env["RAY_TPU_TORCH_STORE_NAME"] = self.store_name
        env.update(self.worker_env)
        return subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.cluster.worker_main",
             "--controller", f"{self.address[0]}:{self.address[1]}",
             "--gcs", f"{self.gcs_addr[0]}:{self.gcs_addr[1]}"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )

    def _adopt_worker(self, proc: subprocess.Popen) -> WorkerHandle:
        handle = WorkerHandle(proc)
        self.workers[proc.pid] = handle
        self._start_log_pump(proc)
        return handle

    async def _spawn_worker_async(self) -> WorkerHandle:
        """Spawn a worker without stalling the event loop: Popen runs in a
        worker thread (raylint async-blocking flagged the inline fork+exec
        — every connection stalled for its duration), bookkeeping lands
        back on the loop. ``_spawning`` keeps the grow-under-load bound
        honest while spawns are in flight."""
        self._spawning += 1
        try:
            proc = await asyncio.to_thread(self._launch_worker_proc)
        finally:
            self._spawning -= 1
        return self._adopt_worker(proc)

    def _start_log_pump(self, proc: subprocess.Popen) -> None:
        """Forward the worker's stdout/stderr to the GCS logs channel so
        drivers can print them (reference: log_monitor.py tailing per-proc
        files + worker.py:960 print_logs)."""
        import threading

        # raylint: hotpath — was 43% of head self-time in the reference's live
        # profile as a per-line iterator over a line-buffered text pipe;
        # now one 64 KiB os.read per wakeup + one split, same 20-line /
        # 100 ms flush cadence.
        def pump():
            batch: List[str] = []
            last_flush = time.monotonic()
            tail = b""  # partial line carried across read chunks
            fd = proc.stdout.fileno()

            def flush():
                nonlocal batch, last_flush
                if batch:
                    try:
                        self._gcs.send_oneway({
                            "type": "publish_logs", "node_id": self.node_id,
                            "pid": proc.pid, "lines": batch})
                    except (ConnectionError, OSError):
                        pass
                    batch = []
                last_flush = time.monotonic()

            poller = select.poll()
            poller.register(fd, select.POLLIN)
            while True:
                if batch:
                    # A blocking read must not strand a short batch on an
                    # idle pipe (an unbuffered print() lands as two writes,
                    # so a wakeup can see a partial line and the completing
                    # chunk can arrive inside the cadence window): once
                    # lines are batched, wait only until the 100 ms point.
                    wait_ms = 100 - 1000 * (time.monotonic() - last_flush)
                    if wait_ms <= 0 or not poller.poll(wait_ms):
                        flush()
                        continue
                try:
                    chunk = os.read(fd, 65536)
                except (OSError, ValueError):  # closed pipe
                    break
                if not chunk:
                    break  # EOF: worker exited
                *lines, tail = (tail + chunk).split(b"\n")
                for ln in lines:
                    batch.append(ln.decode("utf-8", "replace"))
                if len(batch) >= 20:
                    flush()
            if tail:
                batch.append(tail.decode("utf-8", "replace"))
            flush()

        threading.Thread(target=pump, daemon=True,
                         name=f"logpump-{proc.pid}").start()

    async def _heartbeat_loop(self):
        from .._private import flight_recorder, tracing
        from .._private.node_stats import NodeStatsSampler

        interval = self.config.heartbeat_interval_ms / 1000.0
        last_refresh = 0.0
        last_report = 0.0
        sampler = NodeStatsSampler()
        trace_kv_last: Any = ("\0unset",)  # sentinel != any kv value
        while True:
            await asyncio.sleep(interval)
            try:
                self._gcs.send_oneway({
                    "type": "heartbeat", "node_id": self.node_id,
                })
                if self._spilling:
                    # Watermark maintenance: keep arena headroom for the
                    # zero-copy writers that bypass the wrapper (same-host
                    # workers), so pressure lands on the spiller, not the
                    # native evictor (which drops bytes). Off-loop: spill
                    # writes fsync.
                    st = self.store.base.stats()
                    cap = st.get("capacity") or st.get("arena_bytes") or 0
                    if cap and st.get("used_bytes", 0) > \
                            cap * self.store.high_watermark:
                        await asyncio.to_thread(self.store.maybe_spill)
                now = time.monotonic()
                if now - last_refresh > 2.0 and self._ref_held_calls:
                    last_refresh = now
                    held = sorted({o for oids in self._ref_held_calls.values()
                                   for o in oids})
                    self._gcs.send_oneway({"type": "ref_refresh",
                                           "worker": self._ref_uid,
                                           "held": held})
                if now - last_report > 2.0:
                    # Per-node physical reporter (reference: dashboard/
                    # reporter.py daemon): cpu/mem/disk + per-worker usage,
                    # piggybacked on the node's GCS connection.
                    last_report = now
                    stats = sampler.sample([os.getpid(), *self.workers])
                    # OOM guard rides the stats cadence: the sampler just
                    # read every worker's RSS from /proc, so comparing it
                    # against the declared memory demand costs nothing
                    # extra and the controller beats the kernel's
                    # OOM-killer to the punch (which would take the whole
                    # node down, not one worker).
                    self._oom_guard(stats)
                    stats["store"] = self.store.stats()
                    # Data-plane counters + event drain ride the report
                    # (same no-connection-of-its-own discipline as the
                    # flight recorder): the head rolls the deltas into its
                    # time-series store and Prometheus, and records the
                    # drained sender-death/pull-failure events.
                    if self.transfer_manager is not None:
                        stats["transfer"] = self.transfer_manager.stats()
                        tev = self.transfer_manager.drain_events()
                        if tev:
                            stats["transfer_events"] = tev
                    # Consistency-audit inventory: what this node actually
                    # holds (arena + overflow + spill dir + ring health),
                    # cross-checked against the GCS object directory by
                    # the reconciliation pass / `cli doctor`.
                    stats["audit"] = self._audit_inventory()
                    # Handler stats ride along so the GCS's time-series
                    # rollups see controller-side counters too.
                    stats["handler_stats"] = {
                        k: list(v)
                        for k, v in self.server.handler_stats.items()}
                    # GCS-link IO counters (write coalescing + late-drop
                    # reaping) land in the node_stats table, so `cli
                    # doctor` bundles and dashboards see a client that is
                    # timing out and dropping stale responses.
                    stats["gcs_io"] = dict(self._gcs.io_stats)
                    rec = flight_recorder.get()
                    if rec is not None:
                        # Flight-recorder drain piggybacks on the report
                        # (the sampler needs no connection of its own).
                        stacks, stacks_cpu = rec.drain_tagged()
                        if stacks:
                            stats["stacks"] = stacks
                            stats["stacks_oncpu"] = stacks_cpu
                            stats["stack_component"] = rec.component
                            stats["stack_samples"] = sum(stacks.values())
                            flight_recorder.flush_metrics(
                                rec, stats["stack_samples"])
                    # Event-loop observatory windows ride the same report.
                    if self._loopmon is not None:
                        stats["loopmon"] = self._loopmon.drain()
                    if self._cpu_sampler is not None:
                        tc = self._cpu_sampler.drain()
                        if tc:
                            # On the head the process sampler is labeled
                            # "gcs" (first starter); attribution follows
                            # the sampler, not the sender.
                            tc["component"] = \
                                self._cpu_sampler.component or "controller"
                            stats["thread_cpu"] = tc
                    self._gcs.send_oneway({"type": "node_stats",
                                           "node_id": self.node_id,
                                           "stats": stats})
                    # Runtime-adjustable trace sampling: `cli trace
                    # --sample N` writes the GCS kv; every node polls it on
                    # the stats cadence and rebroadcasts changes to its
                    # workers (nested submissions sample there too).
                    try:
                        resp = await asyncio.to_thread(
                            self._gcs.call,
                            {"type": "kv_get",
                             "key": tracing.TRACE_SAMPLE_KV_KEY})
                        raw = resp.get("value")
                    except Exception:  # noqa: BLE001 - next poll retries
                        raw = trace_kv_last
                    if raw != trace_kv_last:
                        trace_kv_last = raw
                        tracing.apply_kv_rate(raw)
                        for w in self.workers.values():
                            if w.conn is not None:
                                try:
                                    w.conn.send_nowait(
                                        {"type": "set_trace_sample",
                                         "raw": raw})
                                except Exception:  # noqa: BLE001
                                    pass
            except ConnectionError:
                return

    def _worker_declared_memory(self, w: WorkerHandle) -> float:
        """Sum of the ``memory`` resource declared by everything in flight
        on this worker. 0 => the worker declared nothing, the guard skips
        it (no declared budget to enforce)."""
        total = 0.0
        for t in w.inflight.values():
            total += float((t.get("resources") or {}).get("memory", 0.0))
        if w.current_task is not None:
            total += float((w.current_task.get("resources") or {})
                           .get("memory", 0.0))
        return total

    def _oom_guard(self, stats: Dict) -> None:
        """Kill the single worst worker whose RSS exceeds its declared
        ``memory`` demand (x watermark) for longer than the grace window.
        One kill per pass: RSS is re-sampled next beat, so a transient
        spike on a neighbour never turns one OOM into a massacre."""
        if self._oom_watermark <= 0:
            return
        now = time.monotonic()
        worst = None  # (overage, pid, w, rss, limit)
        over_pids = set()
        for went in stats.get("workers", []):
            pid = went.get("pid")
            w = self.workers.get(pid)
            if w is None or pid in self._kill_causes:
                continue
            declared = self._worker_declared_memory(w)
            if declared <= 0:
                continue
            rss = float(went.get("rss_bytes") or 0.0)
            limit = declared * self._oom_watermark
            if rss <= limit:
                continue
            over_pids.add(pid)
            since = self._oom_over_since.setdefault(pid, now)
            if now - since < self._oom_grace_s:
                continue
            over = rss - limit
            if worst is None or over > worst[0]:
                worst = (over, pid, w, rss, limit)
        for pid in list(self._oom_over_since):
            if pid not in over_pids:
                del self._oom_over_since[pid]
        if worst is None:
            return
        _, pid, w, rss, limit = worst
        self._oom_over_since.pop(pid, None)
        detail = (f"rss {int(rss)} bytes exceeded the declared memory "
                  f"budget ({int(limit)} bytes) for {self._oom_grace_s}s")
        self._gcs_send({
            "type": "log_event", "kind": "worker_oom_kill",
            "node_id": self.node_id, "pid": pid,
            "rss_bytes": int(rss), "limit_bytes": int(limit)})
        # Straight to SIGKILL: a worker past its memory budget can grow
        # faster than a SIGTERM grace window.
        self._record_kill(pid, w, "oom", None, detail, force=True)

    def _audit_inventory(self) -> Optional[Dict[str, Any]]:
        """One inventory snapshot for the GCS consistency auditor: every
        object id this node can serve (arena, overflow dict, spill dir)
        plus completion-ring liveness. Bounded: an arena past 65536
        objects reports ``arena_complete=False`` and the auditor skips
        absence-based checks for it (presence-based ones still work).
        RAY_TPU_TORCH_AUDIT_INTERVAL_S<=0 disables the whole subsystem (the
        GCS reconciliation loop and this inventory) — the A/B arm."""
        if float(getattr(self.config, "audit_interval_s", 30.0)) <= 0:
            return None
        try:
            base = self.store.base if self._spilling else self.store
            arena = base.list_ids()
            audit: Dict[str, Any] = {
                "ts": time.time(),
                "arena": arena,
                "arena_complete": len(arena) < (1 << 16),
                "overflow": list(self._overflow),
                "inline_cached": len(self._inline),
            }
            if self._spilling:
                audit["spilled"] = self.store.spill.ids()
            if self.transfer_manager is not None:
                # Inflight/queued pull inventory: the head flags pulls
                # queued past grace (stuck_transfer) and pulls aimed at
                # dead sources (orphan_transfer).
                audit["transfers"] = self.transfer_manager.inventory()
            from .._native import completion_ring as _cring

            audit["stale_rings"] = _cring.scan_stale_rings()
            return audit
        except Exception:  # noqa: BLE001 - the audit must never cost a beat
            return None

    def _borrow_call_refs(self, msg: Dict) -> None:
        if not self.config.ref_counting_enabled:
            return  # no GC -> a lone borrow/unborrow cycle would BE the GC
        oids = list(msg.get("deps", [])) + list(msg.get("pin_refs", []))
        rids = msg.get("return_ids") or []
        if not oids or not rids:
            return
        self._ref_held_calls[rids[0]] = oids
        try:
            self._gcs.send_oneway({"type": "ref_update",
                                   "worker": self._ref_uid,
                                   "inc": oids, "dec": []})
        except ConnectionError:
            pass

    def _unborrow_call_refs(self, rid: bytes) -> None:
        oids = self._ref_held_calls.pop(rid, None)
        if oids:
            try:
                self._gcs.send_oneway({"type": "ref_update",
                                       "worker": self._ref_uid,
                                       "inc": [], "dec": oids})
            except ConnectionError:
                pass

    def _rescue_stalled_pipelines(self) -> None:
        """A pipelined execute queued behind a long-running (possibly
        BLOCKED, e.g. nested-get) task must not starve: revoke it from the
        worker's inbox and re-dispatch once the worker acks. Without this,
        depth-2 pipelining can deadlock nested task graphs."""
        now = time.monotonic()
        for w in self.workers.values():
            if w.qdepth < 2 or w.conn is None or now - w.last_done < 0.5:
                continue
            queued = [t for t in w.inflight.values()
                      if not t.get("direct") and "method" not in t]
            for t in queued[1:]:
                if not t.get("_revoke_sent"):
                    t["_revoke_sent"] = True
                    self._gcs_send({
                        "type": "log_event", "kind": "revoke_rescue",
                        "node_id": self.node_id,
                        "task_id": (t.get("task_id") or b"").hex()[:16]})
                    try:
                        w.conn.send_nowait({"type": "revoke_execute",
                                            "task_id": t.get("task_id")})
                    except Exception:  # noqa: BLE001 - reaper handles death
                        pass

    def _record_kill(self, pid: int, w: WorkerHandle, cause: str,
                     task_id: Optional[bytes], detail: str,
                     timeout_s: Optional[float] = None,
                     force: bool = False) -> None:
        """Mark a deliberate worker kill so the reaper classifies the death
        (deadline / oom / cancelled) instead of reporting a bare crash.
        SIGTERM first so the worker can exit cleanly; the reap loop
        escalates to SIGKILL after the grace window. force skips the
        grace."""
        self._kill_causes.setdefault(pid, {
            "cause": cause, "task_id": task_id, "detail": detail,
            "timeout_s": timeout_s})
        try:
            if force:
                w.proc.kill()
            else:
                w.proc.terminate()
                self._term_deadline[pid] = (
                    time.monotonic() + self._kill_grace_s)
        except OSError:
            pass

    def _enforce_deadlines(self) -> None:
        """Kill workers whose running task has outlived its timeout_s.

        The worker drains its inbox FIFO, so the oldest inflight entry is
        the running one; a deadline's clock only starts once its task
        reaches the head (pipelined queue time doesn't count). Runs on the
        reap cadence (0.2s), which bounds the start-of-clock lag."""
        now = time.monotonic()
        for pid, w in list(self.workers.items()):
            if w.proc.poll() is not None:
                continue
            esc = self._term_deadline.get(pid)
            if esc is not None:
                if now >= esc:
                    self._term_deadline.pop(pid, None)
                    try:
                        w.proc.kill()
                    except OSError:
                        pass
                continue
            if not w.deadlines:
                continue
            running = next(iter(w.inflight.values()), None)
            if running is None:
                continue
            tid = running.get("task_id")
            ent = w.deadlines.get(tid)
            if ent is None:
                continue
            if ent[1] is None:
                ent[1] = now + ent[0]  # clock starts at the inbox head
                continue
            if now < ent[1]:
                continue
            self._gcs_send({
                "type": "log_event", "kind": "task_deadline_kill",
                "node_id": self.node_id, "pid": pid,
                "task_id": (tid or b"").hex()[:16],
                "timeout_s": ent[0]})
            self._record_kill(
                pid, w, "deadline", tid,
                f"exceeded its {ent[0]}s deadline", timeout_s=ent[0])

    def _classify_death(self, pid: int, w: WorkerHandle):
        """(cause, blamed_task_id, detail) for a dead worker. Deliberate
        kills were recorded by _record_kill; anything else is a crash,
        named by signal when the exit status carries one."""
        info = self._kill_causes.pop(pid, None)
        self._term_deadline.pop(pid, None)
        self._oom_over_since.pop(pid, None)
        rc = w.proc.returncode
        if info is not None:
            blamed = info.get("task_id")
            if blamed is None:
                # OOM / chaos kill: blame the running task (inbox head).
                first = next(iter(w.inflight.values()), None)
                blamed = (first or {}).get("task_id")
            return info["cause"], blamed, info.get("detail") or info["cause"], \
                info.get("timeout_s")
        if rc is not None and rc < 0:
            try:
                detail = f"killed by {_signal.Signals(-rc).name}"
            except ValueError:
                detail = f"killed by signal {-rc}"
        else:
            detail = f"exit code {rc}"
        first = next(iter(w.inflight.values()), None)
        return "worker_crash", (first or {}).get("task_id"), detail, None

    async def _reap_loop(self):
        """Detect dead worker processes; fail their tasks; respawn."""
        while True:
            await asyncio.sleep(0.2)
            self._rescue_stalled_pipelines()
            self._enforce_deadlines()
            for pid, w in list(self.workers.items()):
                if w.proc.poll() is not None:
                    del self.workers[pid]
                    cause, blamed_tid, detail, timeout_s = \
                        self._classify_death(pid, w)
                    self._gcs_send({
                        "type": "log_event", "kind": "worker_died",
                        "node_id": self.node_id, "pid": pid,
                        "exit_code": w.proc.returncode,
                        "cause": cause, "detail": detail,
                        "was_actor": w.actor_id is not None,
                        "inflight": len(w.inflight)})
                    if w.current_task is not None:
                        await self._fail_task(
                            w.current_task,
                            f"worker died executing task ({detail})",
                            crashed=True, cause=cause,
                        )
                    for call in list(w.inflight.values()):
                        # The task at the inbox head takes the blame; the
                        # pipelined neighbours behind it are collateral and
                        # must not burn a retry or a quarantine strike.
                        is_blamed = (blamed_tid is not None
                                     and call.get("task_id") == blamed_tid)
                        kw = dict(
                            crashed=True,
                            cause=cause if is_blamed else "collateral",
                            fatal=is_blamed and cause in ("worker_crash",
                                                          "oom"),
                            no_retry_charge=not is_blamed,
                            timeout_s=timeout_s if is_blamed else None,
                        )
                        if call.get("direct"):
                            # resources={}: the share belongs to the lease;
                            # the GCS record re-drives on the normal path
                            # (max_retries) or serves the terminal error.
                            await self._fail_task(
                                dict(call, resources={}),
                                f"leased worker died ({detail})", **kw)
                        elif "method" in call:
                            await self._fail_actor_call(call)
                        else:
                            # Pipelined queued task: full failure path (the
                            # GCS decides retry; local+cluster shares are
                            # released there).
                            await self._fail_task(
                                call,
                                f"worker died executing task ({detail})",
                                **kw)
                    w.inflight.clear()
                    w.deadlines.clear()
                    if w.lease_id is not None:
                        # The lease dies with its worker: give back the
                        # local + cluster shares and tell the owner (the
                        # controller stays reachable, so only this push
                        # stops it from feeding a dead lease).
                        lease = self._leases.pop(w.lease_id, None)
                        if lease is not None:
                            self._release_local(lease["task"])
                            try:
                                self._gcs.send_oneway({
                                    "type": "release_resources",
                                    "node_id": self.node_id,
                                    "resources":
                                        lease["task"].get("resources", {}),
                                })
                            except ConnectionError:
                                pass
                            if lease.get("conn") is not None:
                                try:
                                    await lease["conn"].send(
                                        {"type": "lease_lost",
                                         "lease_id": w.lease_id})
                                except Exception:  # noqa: BLE001
                                    pass
                        w.lease_id = None
                    if w.actor_task is not None:
                        # The actor's life ends with its worker: give back
                        # the shares its creation took.
                        held, w.actor_task = w.actor_task, None
                        self._release_local(held)
                        self._gcs_send({
                            "type": "release_resources",
                            "node_id": self.node_id,
                            "resources": held.get("resources", {})})
                    if w.actor_id is not None:
                        # A crash report: the GCS transitions to RESTARTING
                        # when max_restarts allows, DEAD otherwise.
                        await asyncio.to_thread(self._gcs.call, {
                            "type": "update_actor",
                            "actor_id": w.actor_id, "state": "DEAD",
                            "no_restart": w.killed_deliberately,
                        })
                    if not self._shutting_down:
                        await self._spawn_worker_async()

    # ------------------------------------------------------------ object store
    def _gcs_send(self, msg: Dict) -> None:
        """Oneway to the GCS, coalesced per event-loop pass: frames buffer
        here and leave in ONE scatter-write (send_oneway_many). FIFO order
        is preserved, so a wave's location registrations still precede its
        task_done batch on the wire. Off-loop callers (spill threads) fall
        back to an immediate locked send."""
        try:
            on_loop = asyncio.get_running_loop() is self._loop
        except RuntimeError:
            on_loop = False
        if not on_loop:
            try:
                self._gcs.send_oneway(msg)
            except (ConnectionError, OSError):
                pass
            return
        self._gcs_out.append(msg)
        if len(self._gcs_out) == 1:
            self._spawn_bg(self._flush_gcs_out())
        elif len(self._gcs_out) >= 1024:
            buf, self._gcs_out = self._gcs_out, []
            self._gcs_send_many(buf)

    async def _flush_gcs_out(self) -> None:
        await asyncio.sleep(0)   # drain the current event-loop pass first
        buf, self._gcs_out = self._gcs_out, []
        if buf:
            self._gcs_send_many(buf)

    def _gcs_send_many(self, buf: List[Dict]) -> None:
        try:
            self._gcs.send_oneway_many(buf)
        except (ConnectionError, OSError):
            pass

    def _register_object(self, oid: bytes, size: int):
        """Wake local waiters and report the location to the GCS directory."""
        for ev in self._store_waiters.pop(oid, []):
            ev.set()
        self._gcs_send({
            "type": "add_object_location", "object_id": oid,
            "node_id": self.node_id, "size": size,
        })

    def _drop_location(self, oid: bytes):
        """Retract this node from the GCS object directory (eviction or
        deletion made our advertised copy a lie)."""
        self._gcs_send({
            "type": "remove_object_location", "object_id": oid,
            "node_id": self.node_id,
        })

    def _on_object_spilled(self, oid: bytes, size: int) -> None:
        """SpillingStore moved an object arena->disk: flip this node's
        directory entry to the SPILLED location state (the object stays
        fetchable here — the fetch path restores it transparently).
        Thread-safe: only touches the (locked) GCS client."""
        try:
            self._gcs.send_oneway({
                "type": "object_spilled", "object_id": oid,
                "node_id": self.node_id, "size": size,
            })
        except ConnectionError:
            pass

    def _on_object_restored(self, oid: bytes, size: int) -> None:
        """SpillingStore migrated a spilled object back into the arena:
        re-register the in-memory location (runs on the event loop — every
        restore-triggering get happens there)."""
        self._gcs_send({"type": "log_event", "kind": "object_restored",
                        "node_id": self.node_id,
                        "object_id": oid.hex()[:16], "size": size})
        self._register_object(oid, size)

    async def _store_put(self, oid: bytes, blob: bytes,
                         owner: Optional[str] = None):
        try:
            if self._spilling:
                # Off-loop: a put under pressure spills cold objects to
                # disk first (fsync'd writes must not stall the RPC loop).
                # The wrapper is internally locked; per-connection FIFO
                # keeps the register-before-finish invariant.
                await asyncio.to_thread(self.store.put, oid, blob, owner)
            else:
                self.store.put(oid, blob)  # immutable; double-put is a no-op
        except Exception:  # noqa: BLE001 - blob exceeds the arena: overflow
            # Plasma's external-store spill path (plasma/external_store.h):
            # objects that can't fit in shared memory still must be storable.
            self._overflow[oid] = blob
        # Register even for duplicates: the writer may have stored the blob
        # via shm earlier but failed to deliver its object_added message.
        self._register_object(oid, len(blob))

    def _local_blob(self, oid: bytes) -> Optional[bytes]:
        blob = self.store.get_bytes(oid)
        if blob is None:
            blob = self._overflow.get(oid)
        if blob is None:
            blob = self._inline.get(oid)
        return blob

    def _stash_inline(self, oid: bytes, blob: bytes) -> None:
        """Cache one inline result carried in a completion (LRU under the
        byte budget). Replaces nothing on duplicates — results are
        immutable, and double-counting the budget would leak it."""
        if oid in self._inline:
            return
        self._inline[oid] = blob
        self._inline_order.append(oid)
        self._inline_bytes += len(blob)
        while self._inline_bytes > self._inline_budget and self._inline_order:
            old = self._inline_order.popleft()
            dropped = self._inline.pop(old, None)
            if dropped is not None:
                self._inline_bytes -= len(dropped)

    def _drop_inline(self, oid: bytes) -> None:
        blob = self._inline.pop(oid, None)
        if blob is not None:
            self._inline_bytes -= len(blob)

    def _transfer_client(self):
        """Lazy native data-plane client bound to this node's arena."""
        if getattr(self, "_transfer_cli", None) is None:
            if self.transfer_server is None:
                self._transfer_cli = None
                return None
            try:
                from .._native.transfer import TransferClient

                self._transfer_cli = TransferClient(self.store_name)
            except Exception:  # noqa: BLE001
                self._transfer_cli = None
        return self._transfer_cli

    def _announce_blob(self, oid: bytes) -> None:
        """Register a blob that landed in the arena via the native plane."""
        blob = self.store.get_bytes(oid)
        if blob is not None:
            self._register_object(oid, len(blob))

    async def _store_get(self, oid: bytes, timeout: float = 60.0) -> bytes:
        """Local get; fetches from a remote node if needed (Pull path).

        Single-flight per object: concurrent stagings of the same ref (e.g.
        a large batch fanned out to several co-located consumers) share one
        transfer instead of racing N duplicate pulls (reference: the pull
        manager dedupes active pulls, object_manager.h:213).
        """
        blob = self.store.get_bytes(oid)
        if blob is None:
            blob = self._overflow.get(oid)
        if blob is None:
            blob = self._inline.get(oid)
            if blob is not None:
                # Promote an inline-carried result into the arena before
                # dispatch: the executing worker then resolves this dep
                # zero-copy from shm instead of a directory round trip.
                await self._store_put(oid, blob)
        if blob is not None:
            return blob
        task = self._inflight_fetch.get(oid)
        if task is None:
            task = asyncio.create_task(self._remote_fetch(oid, timeout))
            self._inflight_fetch[oid] = task
            task.add_done_callback(
                lambda t, o=oid: self._inflight_fetch.pop(o, None))
        return await asyncio.shield(task)

    async def _remote_fetch(self, oid: bytes, timeout: float = 60.0) -> bytes:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._owner_active():
                # Owner-tracked inline results never reach the directory:
                # ask the oid's owner first (cached job lookup + one
                # owner_fetch; a miss costs one loopback RTT per cycle).
                blob = await asyncio.to_thread(self._owner_fetch_blob, oid)
                if blob is not None:
                    await self._store_put(oid, blob)
                    return blob
            resp = await asyncio.to_thread(self._gcs.call, {
                "type": "get_object_locations", "object_id": oid,
                "wait": True, "timeout": min(5.0, timeout),
            })
            if resp.get("error_blob") is not None:
                # The producing task failed terminally: the error blob is
                # the object (consumers raise it on deserialize).
                return resp["error_blob"]
            if resp.get("inline_blob") is not None:
                # Small result carried by the directory itself: land it in
                # the arena so local consumers read zero-copy.
                blob = resp["inline_blob"]
                await self._store_put(oid, blob)
                return blob
            blob = self._local_blob(oid)
            if blob is not None:
                return blob
            transfer = resp.get("transfer_addresses", [])
            locations = resp.get("locations", [])
            # Fast path: the transfer manager pulls over the native data
            # plane — chunked straight into our arena (bytes never enter
            # Python), admission-capped per source, resuming on sender
            # death against the next holder. One call covers ALL native
            # sources; only spilled/python-store holders (port 0) are left
            # to the RPC restore path below.
            if self.transfer_manager is not None:
                sources = []
                for i, taddr in enumerate(transfer):
                    if not taddr or not taddr[1]:
                        continue
                    if (taddr[0], int(taddr[1])) == \
                            (self.address[0], self.transfer_port):
                        continue
                    nid = locations[i] if i < len(locations) else taddr[0]
                    sources.append((nid, taddr[0], int(taddr[1])))
                if sources:
                    from .transfer_manager import PullFailedError
                    try:
                        ok = await self.transfer_manager.pull(
                            oid, sources, size_hint=int(resp.get("size", 0)),
                            timeout=max(0.1, deadline - time.monotonic()))
                    except (PullFailedError, asyncio.TimeoutError):
                        ok = False
                    except Exception:  # noqa: BLE001 - RPC path still open
                        ok = False
                    if ok:
                        blob = self._local_blob(oid)
                        if blob is not None:
                            self._announce_blob(oid)
                            return blob
            for i, addr in enumerate(resp.get("addresses", [])):
                addr = tuple(addr)
                if addr == self.address:
                    continue
                taddr = transfer[i] if i < len(transfer) else None
                if taddr and taddr[1] and self.transfer_manager is not None:
                    continue  # native source: the manager already tried it
                try:
                    peer = self._peer(addr)
                    fetched = await asyncio.to_thread(
                        peer.call, {"type": "fetch_object", "object_id": oid}
                    )
                    blob = fetched["blob"]
                    await self._store_put(oid, blob)
                    return blob
                except Exception:  # noqa: BLE001 - node may have just died
                    continue
            blob = self._local_blob(oid)
            if blob is not None:
                return blob
            await asyncio.sleep(0.01)
        raise TimeoutError(f"object {oid.hex()[:16]} not available")

    def _peer(self, addr: Tuple[str, int]) -> RpcClient:
        client = self._peer_clients.get(addr)
        if client is None or client._closed:
            client = RpcClient(*addr)
            self._peer_clients[addr] = client
        return client

    # ------------------------------------------------------- ownership plane
    def _owner_active(self) -> bool:
        return self._ownership_on \
            and getattr(self._gcs, "peer_wire", 1) >= 9

    def _owner_lookup(self, job: bytes):
        """THREAD-side: resolve a job's owner-serve address via the GCS
        directory (cached). Positive hits cache 10 s, misses 2 s — a
        driver that never registered costs one probe per job per 2 s."""
        now = time.monotonic()
        ent = self._owner_dir.get(job)
        if ent is not None and ent[0] > now:
            return ent[1]
        addr = None
        try:
            resp = self._gcs.call({"type": "get_owner", "job_id": job},
                                  timeout=5.0)
            info = resp.get("owner") if resp.get("ok") else None
            if info and info.get("alive") and info.get("address"):
                addr = (str(info["address"][0]), int(info["address"][1]))
        except Exception:  # noqa: BLE001 - treated as a (short-lived) miss
            addr = None
        self._owner_dir[job] = (now + (10.0 if addr else 2.0), addr)
        if len(self._owner_dir) > 4096:
            self._owner_dir.pop(next(iter(self._owner_dir)))
        return addr

    def _owner_client(self, addr: Tuple[str, int]) -> RpcClient:
        """THREAD-side: cached client to one owner-serve loop, with the
        wire version probed once so publishes ride the binary codec."""
        cli = self._owner_clients.get(addr)
        if cli is None or cli._closed:
            cli = RpcClient(*addr)
            try:
                cli.probe_wire()
            except Exception:  # noqa: BLE001 - pickle frames still work
                pass
            self._owner_clients[addr] = cli
        return cli

    def _publish_to_owners(self, waves: Dict[Tuple[str, int], list]) -> set:
        """THREAD-side: one acked owner_publish per owner for this wave.
        Same-host owners get size+address only (the completion ring
        already carried the bytes; our fetch_batch serves a ring miss);
        cross-host owners get the blob — the bytes had to travel anyway,
        and previously travelled to the GCS instead. Returns the set of
        addresses whose publish FAILED (those entries stay on the legacy
        GCS path so the bytes always land somewhere reachable)."""
        failed = set()
        my_host = self.address[0]
        for addr, items in waves.items():
            same_host = addr[0] == my_host
            send = [[e[0], e[1], None if same_host else e[2]]
                    for e in items]
            msg = {"type": "owner_publish", "node_id": self.node_id,
                   "address": list(self.address), "items": send}
            try:
                cli = self._owner_client(addr)
                if same_host:
                    # Address-only pointers: oneway — the bytes stay in
                    # our inline stash either way, and a lost publish is
                    # caught by the GCS owner-verify probe. Skipping the
                    # ack halves the owner-side serve work per wave.
                    cli.send_oneway(msg)
                else:
                    # Blob-bearing (cross-host): acked — the owner copy
                    # is the authoritative one once our stash evicts.
                    resp = cli.call(msg, timeout=10.0)
                    if not resp.get("ok"):
                        failed.add(addr)
            except Exception:  # noqa: BLE001 - owner died / unreachable
                self._owner_clients.pop(addr, None)
                failed.add(addr)
        return failed

    def _owner_enqueue(self, ents: list) -> None:
        """Hand diverted inline entries to the publisher thread (lazily
        started). LOOP-side and O(1): the completion wave never waits on
        an owner lookup or publish round trip."""
        import queue

        if self._owner_pub_q is None:
            self._owner_pub_q = queue.Queue()
            self._owner_pub_thread = __import__("threading").Thread(
                target=self._owner_pub_loop, daemon=True,
                name="owner-publish")
            self._owner_pub_thread.start()
        self._owner_pub_q.put(ents)

    def _owner_pub_loop(self) -> None:
        """Publisher thread: resolve owners (cached get_owner), send one
        acked owner_publish per owner per drain, and fall back to the
        legacy GCS registration (blob included) for anything unowned or
        unreachable — bytes always land somewhere reachable. The finish
        message has ALREADY been sent by the time entries drain here; a
        driver woken early just re-polls until the publish lands, and a
        lost publish is caught by the GCS's owner-verify probe, which
        re-drives the task from lineage."""
        import queue

        q = self._owner_pub_q
        while not self._shutting_down:
            try:
                ents = q.get(timeout=0.5)
            except queue.Empty:
                continue
            if ents is None:
                return
            try:
                batch = list(ents)
                # Coalesce a short window: completion waves trickle
                # entries in task-sized dribbles, and every publish wakes
                # the owning DRIVER's serve loop (GIL theft from its
                # submit/get hot path — measured 60% slower submit RTTs
                # with per-wave publishes). 5 ms of batching turns ~1
                # publish per task into ~1 per wave; the ring already
                # delivered the bytes same-host, so nothing waits on it.
                time.sleep(0.005)
                try:  # drain everything the window accumulated
                    while True:
                        more = q.get_nowait()
                        if more is None:
                            return
                        batch.extend(more)
                except queue.Empty:
                    pass
                waves: Dict[Tuple[str, int], list] = {}
                orphans: list = []
                for ent in batch:
                    addr = self._owner_lookup(bytes(ent[0][12:16]))
                    if addr is None:
                        orphans.append(ent)
                    else:
                        waves.setdefault(addr, []).append(ent)
                if waves:
                    failed = self._publish_to_owners(waves)
                    for addr in failed:
                        orphans.extend(waves.get(addr, []))
                for ent in orphans:
                    self._gcs.send_oneway(
                        {"type": "add_object_location",
                         "object_id": ent[0], "node_id": self.node_id,
                         "size": ent[1], "blob": ent[2]})
            except Exception:  # noqa: BLE001 - the loop must survive
                time.sleep(0.05)

    def _owner_fetch_blob(self, oid: bytes) -> Optional[bytes]:
        """THREAD-side: fetch one owner-tracked blob straight from its
        owner (inline bytes, or a location redirect to the node whose
        ring delivered it). None = not owner-resolvable; the caller
        falls back to the directory."""
        if len(oid) < 16:
            return None
        addr = self._owner_lookup(bytes(oid[12:16]))
        if addr is None:
            return None
        try:
            cli = self._owner_client(addr)
            resp = cli.call({"type": "owner_fetch", "object_ids": [oid]},
                            timeout=5.0)
            if not resp.get("ok"):
                return None
            blob = resp.get("blobs", {}).get(oid)
            if blob is not None:
                return blob
            loc = resp.get("locations", {}).get(oid)
            if loc:
                loc = (str(loc[0]), int(loc[1]))
                if loc != tuple(self.address):
                    fetched = self._peer(loc).call(
                        {"type": "fetch_object", "object_id": oid},
                        timeout=30.0)
                    return fetched.get("blob")
        except Exception:  # noqa: BLE001 - owner died mid-fetch
            self._owner_clients.pop(addr, None)
        return None

    # ---------------------------------------------------------------- workers
    def _claim_worker(self, exclusive: bool) -> Optional[WorkerHandle]:
        """Pick a worker for one queued execute. ``exclusive`` (actors,
        leases) requires a fully-idle worker; queued tasks may pipeline
        onto a busy one up to QUEUE_PIPELINE_DEPTH (idle-first)."""
        backup = None
        for w in self.workers.values():
            if w.conn is None or w.actor_id is not None \
                    or w.lease_id is not None or w.current_task is not None:
                continue
            if w.qdepth == 0:
                w.idle = False
                if not exclusive:
                    w.qdepth = 1
                return w
            if (not exclusive and backup is None
                    and w.qdepth < QUEUE_PIPELINE_DEPTH):
                backup = w
        if backup is not None:
            backup.qdepth += 1
            return backup
        return None

    async def _pop_idle_worker(self, timeout: float = 60.0,
                               exclusive: bool = True) -> WorkerHandle:
        deadline = time.monotonic() + timeout
        while True:
            w = self._claim_worker(exclusive)
            if w is not None:
                return w
            if all(w.conn is not None for w in self.workers.values()) and \
                    len(self.workers) + self._spawning \
                    < self.num_workers + 8:
                # Grow under load (bounded; in-flight spawns count so
                # concurrent waiters can't overshoot while Popen runs
                # off-loop).
                await self._spawn_worker_async()
            if time.monotonic() > deadline:
                raise TimeoutError("no idle worker available")
            self._idle_event.clear()
            try:
                await asyncio.wait_for(self._idle_event.wait(), 0.5)
            except asyncio.TimeoutError:
                pass

    async def _fail_task(self, task: Dict, message: str, crashed: bool = False,
                         cause: Optional[str] = None, fatal: bool = False,
                         no_retry_charge: bool = False,
                         timeout_s: Optional[float] = None):
        """Report a failed task to the GCS task table; the GCS decides
        between resubmission (max_retries, reference task_manager.h:57) and
        terminal failure. Only terminal failures store error blobs here.

        cause classifies the death for forensics and policy: "deadline"
        fails typed (TaskTimeoutError) without burning a retry, "oom" and
        "worker_crash" count a quarantine strike when fatal=True, and
        no_retry_charge re-drives without decrementing retries (collateral
        victims of a deliberate kill)."""
        import pickle

        from ..exceptions import (ClusterUnavailableError, TaskTimeoutError,
                                  WorkerCrashedError)

        self._release_local(task)
        will_retry = False
        error_blob: Optional[bytes] = None
        task_id = task.get("task_id")
        self._cancelled.discard(task_id)  # terminal either way: don't leak
        reported = False
        if task_id is not None and self._gcs is not None:
            try:
                req = {
                    "type": "task_failed", "task_id": task_id,
                    "node_id": self.node_id,
                    "resources": task.get("resources", {}),
                    "error": message,
                }
                if cause is not None:
                    req["cause"] = cause
                if fatal:
                    req["fatal"] = True
                if no_retry_charge:
                    req["no_retry_charge"] = True
                if timeout_s is not None:
                    req["timeout_s"] = timeout_s
                resp = await asyncio.to_thread(self._gcs.call, req)
                reported = True
                will_retry = resp.get("will_retry", False)
                error_blob = resp.get("error_blob")
            except Exception:  # noqa: BLE001 - GCS unreachable: fail locally
                pass
        if reported:
            task["released"] = True  # task_failed released the resources
        else:
            await self._release(task)
        if will_retry:
            return
        if error_blob is None:
            if cause == "deadline":
                err: Exception = TaskTimeoutError(
                    task_id=task_id, timeout_s=timeout_s)
            elif crashed:
                err = WorkerCrashedError(message)
            else:
                err = ClusterUnavailableError(message)
            # Bounded: a bare exception with a short message, not task
            # data.  # raylint: disable=async-blocking
            error_blob = ERR_PREFIX + pickle.dumps(err)
        for oid in task["return_ids"]:
            await self._store_put(oid, error_blob)

    def _drop_lease(self, lease_id: bytes) -> None:
        """Return a lease's worker + local/cluster shares. Shared by the
        release_lease RPC and owner-disconnect reaping."""
        lease = self._leases.pop(lease_id, None)
        if lease is None:
            return
        w = lease["worker"]
        if w.lease_id == lease_id:
            w.lease_id = None
            # Only idle the worker when nothing it was pushed is still
            # running; otherwise a queued task would be dispatched onto it
            # and the direct task's task_done would prematurely finish the
            # queued one. task_done idles it on completion (lease_id is
            # None by then).
            if w.conn is not None and w.actor_id is None \
                    and not w.inflight:
                w.idle = True
                self._idle_event.set()
        self._release_local(lease["task"])
        try:
            self._gcs.send_oneway({
                "type": "release_resources", "node_id": self.node_id,
                "resources": lease["task"].get("resources", {}),
            })
        except ConnectionError:
            pass

    def _on_conn_lost(self, conn) -> None:
        """A client connection dropped: reap any worker leases it owned —
        a crashed driver must not pin workers and resource shares forever
        (reference: lease reclamation on owner death)."""
        for lease_id, lease in list(self._leases.items()):
            if lease.get("conn") is conn:
                self._drop_lease(lease_id)

    async def _requeue_direct(self, task: Dict) -> None:
        """Re-drive a never-executed direct task through its GCS lineage
        record without burning a retry. The record travels owner->GCS while
        the push travels owner->controller: it can lag us, so retry briefly
        before treating the task as failed."""
        for _ in range(5):
            try:
                resp = await asyncio.to_thread(self._gcs.call, {
                    "type": "requeue_task", "task_id": task.get("task_id"),
                    "node_id": self.node_id})
                if resp.get("requeued"):
                    return
            except Exception:  # noqa: BLE001 - GCS unreachable: fall through
                break
            await asyncio.sleep(0.05)
        await self._fail_task(dict(task, resources={}),
                              "lease lost before dispatch", crashed=True)

    async def _release(self, task: Dict, exec_s: float = 0.0,
                       reg_s: float = 0.0, added: Optional[list] = None,
                       ts_exec: Tuple[float, float] = (0.0, 0.0)):
        if task.get("released"):
            return
        task["released"] = True
        self._report_done(task.get("task_id"), task.get("resources", {}),
                          exec_s, reg_s, added, ts_exec)

    def _report_done(self, task_id, resources, exec_s: float = 0.0,
                     reg_s: float = 0.0,
                     added: Optional[list] = None,
                     ts_exec: Tuple[float, float] = (0.0, 0.0)) -> None:
        """Coalesce task_done reports into one task_done_batch oneway per
        event-loop pass (mirror of the GCS's assign_batch: at fan-out
        rates the per-task socket write dominated both ends' CPU). The
        worker-measured exec/store wall times AND the task's result
        registrations ride in the item — one GCS message per wave carries
        completion + directory updates, not one per object."""
        self._done_buf.append({"task_id": task_id, "resources": resources,
                               "exec_s": exec_s, "reg_s": reg_s,
                               "ts_exec_start": ts_exec[0],
                               "ts_exec_end": ts_exec[1],
                               "added": added or []})
        if len(self._done_buf) == 1:
            self._spawn_bg(self._flush_done())
        elif len(self._done_buf) >= 512:
            buf, self._done_buf = self._done_buf, []
            self._send_done_batch(buf)

    async def _flush_done(self) -> None:
        await asyncio.sleep(0)   # let same-pass completions pile up
        buf, self._done_buf = self._done_buf, []
        if buf:
            self._send_done_batch(buf)

    def _send_done_batch(self, buf) -> None:
        # Always the batch form (n=1 included): one shape on the wire, and
        # the batch has the binary fast-path codec. Flush the oneway
        # buffer SYNCHRONOUSLY here — this already runs one deferred pass
        # after the completion wave, and chaining a second deferral
        # (_flush_gcs_out) measurably taxed serial round-trip latency.
        if self._owner_active():
            # Ownership divert: strip inline result entries out of the
            # done items and hand them to the publisher thread — the GCS
            # object table never sees them, and this path adds only a
            # queue put to the completion wave.
            divert: list = []
            for item in buf:
                added = item.get("added")
                if not added:
                    continue
                keep = [e for e in added
                        if len(e) <= 2 or e[2] is None or len(e[0]) < 16]
                if len(keep) != len(added):
                    divert.extend(e for e in added
                                  if not (len(e) <= 2 or e[2] is None
                                          or len(e[0]) < 16))
                    item["added"] = keep
            if divert:
                self._owner_enqueue(divert)
        self._gcs_out.append({"type": "task_done_batch",
                              "node_id": self.node_id, "items": buf})
        out, self._gcs_out = self._gcs_out, []
        self._gcs_send_many(out)

    def _on_gcs_push(self, msg: Dict) -> None:
        """Runs on the GCS client's reader thread: hop to the loop."""
        if self._loop is None or self._loop.is_closed():
            return
        mtype = msg.get("type")
        if mtype == "assign_task":
            coro = self._run_task(_payload(msg))
        elif mtype in ("assign_batch", "dispatch_wave"):
            if mtype == "dispatch_wave":
                # Columnar scatter frame: explode the template runs into
                # per-task dicts HERE, off the GCS — it relayed one frame
                # for this node's whole wave instead of N spec structs.
                tasks = self._explode_wave(msg)
            else:
                tasks = msg.get("tasks", [])

            def fan_out(ts=tasks):
                for t in ts:
                    # Inline dispatch when nothing would block: no deps,
                    # headroom free, idle worker in hand. Skips the
                    # per-task coroutine + two awaits of the general path
                    # (which at fan-out rates dominated controller CPU).
                    if not self._try_run_task_fast(t):
                        self._spawn_bg(self._run_task(t))

            self._loop.call_soon_threadsafe(fan_out)
            return
        elif mtype == "create_actor":
            coro = self._create_actor(_payload(msg))
        elif mtype == "cancel_task":
            coro = self._cancel_task(msg["task_id"], msg.get("force", False))
        elif mtype == "delete_objects":
            coro = self._delete_objects(msg["object_ids"])
        elif mtype == "restore_object":
            coro = self._restore_object(msg["object_id"])
        elif mtype == "replicate_object":
            coro = self._replicate_object(msg["object_id"])
        elif mtype in ("pg_reserve", "pg_release"):
            self._loop.call_soon_threadsafe(self._apply_pg_update, msg)
            return
        elif mtype == "pubsub":
            return
        else:
            return
        self._loop.call_soon_threadsafe(lambda: self._spawn_bg(coro))

    @staticmethod
    def _explode_wave(msg: Dict) -> list:  # raylint: hotpath
        """Expand a DISPATCH_WAVE scatter frame into the per-task dicts the
        assign_batch path runs. Template fields (fn_id/name/retries/deps/
        pins/resources) are parsed once per run by the wire decoder and
        SHARED across the run's task dicts (read-only downstream); each
        task's executable spec bytes are rebuilt from the template +
        its own id/return-ids/arg tail."""
        from . import wire

        tasks = list(msg.get("singles") or ())
        for run in msg.get("runs") or ():
            fn_id = run.get("fn_id")
            name = run.get("name")
            max_retries = run.get("max_retries", 0)
            deps = run.get("deps") or []
            pin_refs = run.get("pin_refs") or []
            resources = run.get("resources") or {}
            return_oids = run["return_oids"]
            for i, tid in enumerate(run["task_ids"]):
                tasks.append({
                    "task_id": tid, "name": name, "fn_id": fn_id,
                    "deps": deps, "pin_refs": pin_refs,
                    "return_ids": return_oids[i], "resources": resources,
                    "max_retries": max_retries,
                    "_spec": wire.build_spec_from_run(run, i),
                })
        return tasks

    def _fits_local(self, res: Dict[str, float]) -> bool:
        return all(self.local_avail.get(k, 0.0) + 1e-9 >= v
                   for k, v in res.items())

    def _acquire_now(self, task: Dict) -> None:
        for k, v in task.get("resources", {}).items():
            self.local_avail[k] = self.local_avail.get(k, 0.0) - v
        task["local_acquired"] = True

    async def _acquire_local(self, task: Dict) -> None:
        """FIFO admission within the task's resource class; returns once
        the local share is held."""
        res = task.get("resources", {})
        klass = tuple(sorted(res.items()))
        granted = asyncio.Event()
        from collections import deque as _deque

        dq = self._admit_queues.get(klass)
        if dq is None:
            dq = self._admit_queues[klass] = _deque()
        dq.append((task, granted))
        self._admit_event.set()
        if not self._admit_pump_running:
            self._admit_pump_running = True
            self._spawn_bg(self._admit_pump())
        await granted.wait()

    async def _admit_pump(self):
        """Single drainer: admits queue heads as resources free up."""
        try:
            while True:
                progressed = False
                for klass in list(self._admit_queues):
                    dq = self._admit_queues.get(klass)
                    while dq and self._fits_local(dq[0][0].get("resources", {})):
                        task, granted = dq.popleft()
                        self._acquire_now(task)
                        granted.set()
                        progressed = True
                    if dq is not None and not dq:
                        del self._admit_queues[klass]
                if not self._admit_queues:
                    return
                if not progressed:
                    self._admit_event.clear()
                    try:
                        await asyncio.wait_for(self._admit_event.wait(), 0.5)
                    except asyncio.TimeoutError:
                        pass
        finally:
            self._admit_pump_running = False

    def _release_local(self, task: Dict) -> None:
        if not task.pop("local_acquired", False):
            return
        for k, v in task.get("resources", {}).items():
            if k not in self.resources:
                # A removed placement group's bundle share (pg_release
                # stripped the name): don't resurrect it locally.
                self.local_avail.pop(k, None)
                continue
            self.local_avail[k] = min(
                self.local_avail.get(k, 0.0) + v, self.resources[k])
        self._admit_event.set()

    def _apply_pg_update(self, msg: Dict) -> None:
        """Placement-group bundle reservation pushed by the GCS: the base
        resources move out of the node's free pool and come back as
        group-scoped custom names (pg_reserve), or the reverse on group
        removal/rescheduling (pg_release). Local admission then treats
        member tasks exactly like any other custom-resource demand."""
        if msg.get("type") == "pg_reserve":
            for k, v in (msg.get("deduct") or {}).items():
                self.local_avail[k] = self.local_avail.get(k, 0.0) - v
            for k, v in (msg.get("add") or {}).items():
                self.resources[k] = self.resources.get(k, 0.0) + v
                self.local_avail[k] = self.local_avail.get(k, 0.0) + v
        else:  # pg_release
            for k in (msg.get("remove") or ()):
                self.resources.pop(k, None)
                self.local_avail.pop(k, None)
            for k, v in (msg.get("restore") or {}).items():
                self.local_avail[k] = min(
                    self.local_avail.get(k, 0.0) + v,
                    self.resources.get(k, 0.0))
        self._admit_event.set()

    async def _restore_object(self, oid: bytes) -> None:
        """Restore a spilled object into the arena and re-register it
        (reference: ObjectRecovery's restore-from-external-store path). A
        no-op when the object is gone — recovery then falls back to
        lineage on the GCS side."""
        # Inline on the loop: the restore path touches asyncio waiter
        # events via the on_restore callback, which must not fire from a
        # foreign thread. Restores are rare and read-mostly.
        blob = self._local_blob(oid)
        if blob is not None:
            self._register_object(oid, len(blob))

    async def _replicate_object(self, oid: bytes) -> None:
        """Pull a copy of an object onto THIS node (GCS drain evacuation:
        the only live copy sits on a node being retired). _store_get
        fetches from the current holder, lands the bytes in the local
        arena, and registers the new location with the directory."""
        try:
            await self._store_get(oid)
        except Exception:  # noqa: BLE001 - straggler: lineage recovers it
            pass

    async def _delete_objects(self, oids) -> None:
        for oid in oids:
            self.store.delete(oid)
            self._overflow.pop(oid, None)
            self._drop_inline(oid)

    async def _cancel_task(self, task_id: bytes, force: bool) -> None:
        """Cancel a GCS-dispatched task on this node: pre-dispatch tasks are
        flagged (the dep-staging path checks), running ones lose their worker
        (reference: CoreWorker::KillActor/CancelTask semantics — the interrupt
        is process-level; the worker pool respawns)."""
        self._cancelled.add(task_id)
        for pid, w in list(self.workers.items()):
            if w.proc.poll() is not None:
                continue
            task = w.current_task
            hit = task is not None and task.get("task_id") == task_id
            if not hit:
                # Direct-pushed or pipelined queued task on this worker:
                # same process-level interrupt; the reaper fails/retries
                # its inflight set.
                hit = any(t.get("task_id") == task_id
                          for t in w.inflight.values())
            if hit:
                # force=True goes straight to SIGKILL; otherwise SIGTERM
                # with the reap loop escalating after the grace window.
                self._record_kill(pid, w, "cancelled", task_id,
                                  "cancelled by owner", force=force)

    # -------------------------------------------------------------- handlers
    def _register_handlers(self):
        from . import wire

        s = self.server
        s.on_disconnect(self._on_conn_lost)

        @s.handler("register_worker")
        async def register_worker(msg, conn):
            handle = self.workers.get(msg["pid"])
            if handle is None:
                return {"ok": False, "error": "unknown worker pid"}
            handle.conn = conn
            conn.meta["worker_pid"] = msg["pid"]
            # Wire-capable workers get binary execute_task frames (the
            # relay's terminal hop forwards the raw spec blob).
            if msg.get("wire"):
                conn.meta["wire"] = int(msg["wire"])
            handle.ready.set()
            self._idle_event.set()
            # Our own wire version rides back so the worker knows it may
            # send v2 inline-result frames on the task_done path.
            return {"ok": True, "node_id": self.node_id,
                    "wire": wire.WIRE_VERSION}

        @s.handler("assign_task")
        async def assign_task(msg, conn):
            self._spawn_bg(self._run_task(_payload(msg)))
            return {"ok": True}

        @s.handler("assign_batch")
        async def assign_batch(msg, conn):
            for t in msg.get("tasks", []):
                self._spawn_bg(self._run_task(dict(t)))
            return {"ok": True}

        @s.handler("revoke_ack")
        async def revoke_ack(msg, conn):
            """Worker confirmed a queued execute never started: reclaim it
            and re-drive through the normal dispatch path (the ack is the
            at-most-once guarantee — a started task acks revoked=False and
            completes normally)."""
            if not msg.get("revoked"):
                return None
            pid = msg.get("pid") or conn.meta.get("worker_pid")
            w = self.workers.get(pid)
            if w is None:
                return None
            tid = msg.get("task_id")
            for rid, t in list(w.inflight.items()):
                if t.get("task_id") == tid and not t.get("direct") \
                        and "method" not in t:
                    del w.inflight[rid]
                    w.deadlines.pop(tid, None)
                    self._unclaim_queued(w)
                    self._release_local(t)
                    t.pop("_revoke_sent", None)
                    # Once revoked, never pipeline this task again: it must
                    # claim a FULLY idle worker (growing the pool if none),
                    # or it would re-queue behind the same blocked worker
                    # in a revoke loop that never makes progress.
                    t["_no_pipeline"] = True
                    self._spawn_bg(self._run_task(t))
                    break
            return None

        @s.handler("task_done")
        async def task_done(msg, conn):
            """Worker finished: blobs already stored via store_object."""
            # Result blobs the worker wrote straight into the arena,
            # carried IN the finish message. Local waiters wake here; the
            # GCS directory registration rides inside this completion's
            # task_done_batch item (one wave message carries both), so
            # registration still strictly precedes the finish processing.
            added = msg.get("added", [])
            for ent in added:
                if len(ent) > 2 and ent[2] is not None:
                    # Inline small result riding the completion: cache the
                    # bytes so local dep staging and fetch_batch serve
                    # them without an arena slot ever existing.
                    self._stash_inline(ent[0], ent[2])
                for ev in self._store_waiters.pop(ent[0], []):
                    ev.set()
            pid = msg.get("pid") or conn.meta.get("worker_pid")
            w = self.workers.get(pid)
            exec_s = float(msg.get("exec_s") or 0.0)
            reg_s = float(msg.get("reg_s") or 0.0)
            # Wall-clock execution window, stamped by the worker on every
            # completion (wire v7): rides the done item to the GCS task
            # table for the job profiler's timeline.
            ts_exec = (float(msg.get("ts_exec_start") or 0.0),
                       float(msg.get("ts_exec_end") or 0.0))
            reported = False
            for rid in msg.get("return_ids", []):
                self._unborrow_call_refs(rid)
            if w is not None:
                w.last_done = time.monotonic()
                for rid in msg.get("return_ids", []):
                    done = w.inflight.pop(rid, None)
                    if done is None:
                        continue
                    w.deadlines.pop(done.get("task_id"), None)
                    if done.get("direct"):
                        # Finish the direct task's lineage record; resources
                        # are empty — the lease keeps holding the share.
                        # Coalesced with queued-task completions.
                        self._report_done(done.get("task_id"), {},
                                          exec_s, reg_s,
                                          None if reported else added,
                                          ts_exec)
                        reported = True
                    elif "method" not in done:
                        # Queued task: return the pipeline claim + local
                        # share, report done (registrations ride along).
                        self._unclaim_queued(w)
                        self._release_local(done)
                        if not done.get("released"):
                            await self._release(done, exec_s, reg_s,
                                                None if reported else added,
                                                ts_exec)
                            reported = True
                task = w.current_task
                w.current_task = None
                # not w.inflight: a lease released mid-run leaves later
                # direct pushes still executing — idling then would let a
                # queued task be dispatched behind them and prematurely
                # "finished" by their task_done.
                if w.actor_id is None and w.lease_id is None \
                        and not w.inflight and w.qdepth == 0:
                    w.idle = True
                    self._idle_event.set()
                if task is not None and not task.get("released"):
                    # Actor creation finish (the only current_task user).
                    # The actor keeps its local and cluster shares for its
                    # life (as the local runtime's actors do); the reap
                    # loop gives them back when its worker exits. The
                    # reference released them here (ROADMAP C10).
                    task["released"] = True
                    w.actor_task = task
                    self._report_done(task.get("task_id"), {}, exec_s,
                                      reg_s, None if reported else added,
                                      ts_exec)
                    reported = True
            if not reported:
                # Actor-method completion (or an unknown worker): no done
                # item will carry these registrations — report directly
                # (inline bytes ride the pickled dict, no binary codec).
                # Inline entries divert to their owner like done items do.
                owned = []
                for ent in added:
                    if self._owner_active() and len(ent) > 2 \
                            and ent[2] is not None and len(ent[0]) >= 16:
                        owned.append(ent)
                        continue
                    reg = {"type": "add_object_location",
                           "object_id": ent[0],
                           "node_id": self.node_id, "size": ent[1]}
                    if len(ent) > 2 and ent[2] is not None:
                        reg["blob"] = ent[2]
                    self._gcs_send(reg)
                if owned:
                    self._owner_enqueue(owned)
            return None

        @s.handler("lease_worker")
        async def lease_worker(msg, conn):
            """Pin an idle worker to an owner's lease (reference: raylet
            HandleRequestWorkerLease, node_manager.cc:1777). The owner then
            pushes tasks straight at it via push_task — no GCS queue hop.
            The cluster-side share was reserved by the owner's
            request_placement; this acquires the matching LOCAL share."""
            admit = {"resources": msg.get("resources", {})}
            # Non-blocking: a lease is an optimization — when the node is
            # saturated the owner just keeps using the queued path rather
            # than holding an RPC open against the admission queue.
            if not self._fits_local(admit["resources"]):
                return {"ok": False, "error": "node busy"}
            try:
                worker = await self._pop_idle_worker(timeout=5.0)
            except Exception as e:  # noqa: BLE001 - no worker: lease denied
                return {"ok": False, "error": f"no idle worker: {e}"}
            # Acquire only now that a worker is in hand, and re-check: the
            # share must not be held across the idle-wait above, where it
            # would starve queued tasks of that capacity for up to 5 s.
            if not self._fits_local(admit["resources"]):
                worker.idle = True
                self._idle_event.set()
                return {"ok": False, "error": "node busy"}
            self._acquire_now(admit)
            worker.lease_id = msg["lease_id"]
            # conn kept so worker death can notify the owner (lease_lost):
            # the controller stays reachable, so no connection error would.
            self._leases[msg["lease_id"]] = {
                "worker": worker, "task": admit, "conn": conn}
            return {"ok": True, "node_id": self.node_id}

        @s.handler("push_task")
        async def push_task(msg, conn):
            """Owner-pushed task for a leased worker (reference: the owner's
            PushTask straight to the leased worker,
            direct_task_transport.cc OnWorkerIdle). One-way: the result
            surfaces through the object store/directory as usual; failures
            route through the GCS record the owner wrote first."""
            lease = self._leases.get(msg["lease_id"])
            w = None if lease is None else lease["worker"]
            task = _payload(msg)
            task["direct"] = True
            if w is None or w.conn is None:
                # Lease vanished (worker death raced the push). The task
                # never ran, so requeue it through its GCS record WITHOUT
                # burning a retry; tell the owner so it stops pushing here.
                try:
                    await conn.send({"type": "lease_lost",
                                     "lease_id": msg["lease_id"]})
                except Exception:  # noqa: BLE001
                    pass
                await self._requeue_direct(task)
                return None
            if msg.get("return_ids"):
                w.inflight[msg["return_ids"][0]] = task
                if task.get("timeout_s"):
                    w.deadlines[task.get("task_id")] = [
                        float(task["timeout_s"]), None]
            try:
                await w.conn.send(dict(task, type="execute_task"))
            except Exception:  # noqa: BLE001 - worker died under the send
                # Same recovery as the lease-vanished branch: the task
                # never ran, so requeue without burning a retry and tell
                # the owner — don't leave it to the death reaper alone.
                if msg.get("return_ids"):
                    w.inflight.pop(msg["return_ids"][0], None)
                    w.deadlines.pop(task.get("task_id"), None)
                try:
                    await conn.send({"type": "lease_lost",
                                     "lease_id": msg["lease_id"]})
                except Exception:  # noqa: BLE001
                    pass
                await self._requeue_direct(task)
            return None

        @s.handler("release_lease")
        async def release_lease(msg, conn):
            """Owner returns its leased worker (idle timeout or shutdown)."""
            self._drop_lease(msg["lease_id"])
            return {"ok": True}

        @s.handler("store_object")
        async def store_object(msg, conn):
            await self._store_put(msg["object_id"], msg["blob"],
                                  owner=msg.get("owner"))
            return {"ok": True}

        @s.handler("restore_object")
        async def restore_object(msg, conn):
            """Explicit restore request (GCS recovery preferring a spilled
            copy over lineage re-execution). The get is the restore; the
            registration re-adds the in-arena location."""
            await self._restore_object(msg["object_id"])
            return {"ok": True}

        @s.handler("object_added")
        async def object_added(msg, conn):
            """A local worker wrote the object straight into the shared
            arena (zero-copy); register it (plasma notification path)."""
            self._register_object(msg["object_id"], msg.get("size", 0))
            return {"ok": True}

        @s.handler("fetch_batch")
        async def fetch_batch(msg, conn):
            """Many small result blobs in one reply (the fan-out driver's
            per-oid fetch_object RPCs dominated socket I/O). Response is
            size-capped; absent oids fall back to the per-oid path (which
            also serves the native zero-copy plane for big blobs)."""
            out = {}
            total = 0
            for oid in msg["object_ids"]:
                blob = self._local_blob(oid)
                if blob is None:
                    self._drop_location(oid)
                    continue
                if len(blob) > 256 << 10 or total + len(blob) > 8 << 20:
                    # Big blobs belong on the native zero-copy plane (the
                    # caller's per-oid fallback), not a pickled RPC reply;
                    # the total cap is checked BEFORE adding so the reply
                    # never exceeds it.
                    continue
                out[oid] = blob
                total += len(blob)
            return {"ok": True, "blobs": out}

        @s.handler("fetch_object")
        async def fetch_object(msg, conn):
            oid = msg["object_id"]
            if msg.get("remote_ok", False):
                blob = await self._store_get(oid, msg.get("timeout", 60.0))
            else:
                blob = self._local_blob(oid)
                if blob is None:
                    # Likely LRU-evicted: retract our stale directory entry
                    # so consumers move on to a surviving replica.
                    self._drop_location(oid)
                    return {"ok": False, "error": "object not local"}
            return {"ok": True, "blob": blob}

        @s.handler("has_object")
        async def has_object(msg, conn):
            oid = msg["object_id"]
            has = self.store.contains(oid) or oid in self._overflow \
                or oid in self._inline
            if not has:
                self._drop_location(oid)
            return {"ok": True, "has": has}

        @s.handler("delete_objects")
        async def delete_objects(msg, conn):
            for oid in msg["object_ids"]:
                self.store.delete(oid)
                self._overflow.pop(oid, None)
                self._drop_inline(oid)
                self._drop_location(oid)
            return None

        @s.handler("create_actor")
        async def create_actor(msg, conn):
            self._spawn_bg(self._create_actor(_payload(msg)))
            return {"ok": True}

        @s.handler("actor_call")
        async def actor_call(msg, conn):
            """Enqueue on the actor's ordered dispatch queue.

            Dep staging must not run inline (it would block this connection's
            read loop), and per-actor FIFO order must survive the detach —
            hence one queue + dispatcher task per actor.
            """
            actor_id = msg["actor_id"]
            self._borrow_call_refs(msg)
            q = self._actor_queues.get(actor_id)
            if q is None:
                q = asyncio.Queue()
                self._actor_queues[actor_id] = q
                self._spawn_bg(self._actor_dispatch_loop(actor_id, q))
            await q.put(_payload(msg))
            return {"ok": True}

        @s.handler("kill_actor")
        async def kill_actor(msg, conn):
            worker = self._actor_worker(msg["actor_id"])
            if worker is not None:
                worker.killed_deliberately = msg.get("no_restart", True)
                worker.proc.terminate()
                task = {"return_ids": [], "resources": msg.get("resources", {})}
                await self._release(task)
            return {"ok": True}

        @s.handler("kill_worker")
        async def kill_worker(msg, conn):
            """Chaos / drill hook (`cli kill_random_node --worker`): SIGKILL
            one worker process — a specific pid, or a random live one —
            and let the containment machinery classify and recover."""
            import random as _random

            pid = msg.get("pid")
            if pid is None:
                live = [p for p, w in self.workers.items()
                        if w.proc.poll() is None]
                if not live:
                    return {"ok": False, "error": "no live workers"}
                pid = _random.choice(live)
            w = self.workers.get(pid)
            if w is None or w.proc.poll() is not None:
                return {"ok": False, "error": f"no live worker pid {pid}"}
            self._gcs_send({
                "type": "log_event", "kind": "chaos_kill_worker",
                "node_id": self.node_id, "pid": pid})
            self._record_kill(pid, w, "chaos", None,
                              "chaos kill (drill)", force=True)
            return {"ok": True, "pid": pid}

        @s.handler("stats")
        async def stats(msg, conn):
            st = self.store.stats()
            return {"ok": True, "node_id": self.node_id,
                    "store": st,
                    "num_objects": st["num_objects"],
                    # Per-RPC-type counts + cumulative seconds: the
                    # cProfile-free view of where this controller's event
                    # loop goes (GCS exposes the same via debug_stats).
                    "handler_stats": dict(self.server.handler_stats),
                    # Oneway coalescing evidence: frames vs actual socket
                    # writes on the GCS link (regression guard reads this;
                    # late_drops counts timed-out responses reaped by the
                    # reader instead of leaking to the push handler).
                    "gcs_io": dict(self._gcs.io_stats),
                    # Inbound frame batching on this controller's server
                    # (frames/reads >> 1 = the native pump's recv win).
                    "recv_stats": dict(self.server.recv_stats),
                    "num_workers": len(self.workers),
                    "workers": [
                        {"pid": pid, "registered": w.conn is not None,
                         "idle": w.idle, "actor": bool(w.actor_id),
                         "task": (w.current_task or {}).get("name")}
                        for pid, w in self.workers.items()
                    ]}

    async def _actor_dispatch_loop(self, actor_id: bytes, q: "asyncio.Queue"):
        """Stage deps and forward actor calls strictly in arrival order.

        When the local worker is gone the GCS actor table decides: a
        RESTARTING actor is awaited, one that came back ALIVE on another
        node has its queued calls forwarded there (restart spillover), and a
        DEAD one fails the call."""
        while True:
            msg = await q.get()
            worker = self._actor_worker(actor_id)
            if worker is None:
                routed = await self._route_actor_call(actor_id, msg)
                if not routed:
                    await self._fail_actor_call(msg)
                continue
            try:
                for oid in msg.get("deps", []):
                    await self._store_get(oid)
            except Exception:  # noqa: BLE001 - dep fetch failed: fail the call
                await self._fail_actor_call(msg)
                continue
            if msg.get("return_ids"):
                worker.inflight[msg["return_ids"][0]] = msg
            await worker.conn.send(dict(msg, type="execute_actor_task"))

    async def _route_actor_call(self, actor_id: bytes, msg: Dict) -> bool:
        """No local worker for the actor: wait out a restart, then execute
        locally or forward to its new home. Returns False when the actor is
        truly dead."""
        try:
            info = await asyncio.to_thread(self._gcs.call, {
                "type": "get_actor", "actor_id": actor_id, "timeout": 30.0,
            }, 45.0)
        except Exception:  # noqa: BLE001
            return False
        if info.get("state") != "ALIVE" or not info.get("address"):
            return False
        addr = tuple(info["address"])
        if addr == self.address:
            # Restarted here: the fresh worker registers momentarily.
            for _ in range(100):
                worker = self._actor_worker(actor_id)
                if worker is not None:
                    try:
                        for oid in msg.get("deps", []):
                            await self._store_get(oid)
                    except Exception:  # noqa: BLE001
                        return False
                    if msg.get("return_ids"):
                        worker.inflight[msg["return_ids"][0]] = msg
                    await worker.conn.send(
                        dict(msg, type="execute_actor_task"))
                    return True
                await asyncio.sleep(0.05)
            return False
        try:
            await asyncio.to_thread(
                self._peer(addr).call, dict(msg, type="actor_call"))
            # The new home registered its own borrow in its actor_call
            # handler before acking; ours can go.
            if msg.get("return_ids"):
                self._unborrow_call_refs(msg["return_ids"][0])
            return True
        except Exception:  # noqa: BLE001
            return False

    def _actor_worker(self, actor_id: bytes) -> Optional[WorkerHandle]:
        for w in self.workers.values():
            if w.actor_id == actor_id and w.conn is not None:
                return w
        return None

    async def _fail_actor_call(self, msg: Dict):
        import pickle

        from ..exceptions import ActorDiedError

        # Bounded: a bare exception carrying a 12-char actor id.
        # raylint: disable=async-blocking
        blob = ERR_PREFIX + pickle.dumps(
            ActorDiedError(msg["actor_id"].hex()[:12]))
        for oid in msg["return_ids"]:
            await self._store_put(oid, blob)
        if msg.get("return_ids"):
            self._unborrow_call_refs(msg["return_ids"][0])

    # -------------------------------------------------------------- task run
    def _start_queued_exec(self, worker: WorkerHandle, task: Dict) -> None:
        """Register a CLAIMED worker's queued execute and push it (sync,
        no drain: the worker demonstrably consumes its inbox)."""
        rids = task.get("return_ids") or []
        if rids:
            worker.inflight[rids[0]] = task
            if task.get("timeout_s"):
                # The deadline clock arms once the task reaches the inbox
                # head (see _enforce_deadlines) — not here, where pipelined
                # queue time would count against it.
                worker.deadlines[task.get("task_id")] = [
                    float(task["timeout_s"]), None]
        try:
            worker.conn.send_nowait(dict(task, type="execute_task"))
        except Exception:  # noqa: BLE001 - worker died under the send:
            pass  # the reaper fails/retries its inflight set exactly as
            #       if the send had been delivered to a dying worker.

    def _try_run_task_fast(self, task: Dict) -> bool:
        """Inline dispatch on the event loop: only when no staging, no
        admission wait, and no worker wait could occur — anything else
        returns False and the coroutine path handles it. FIFO fairness is
        preserved by refusing the fast path while the admission queue is
        non-empty (fast-pathing past queued tasks would starve them)."""
        if task.get("deps") or self._admit_queues:
            return False
        res = task.get("resources", {})
        if not self._fits_local(res):
            return False
        if task.get("task_id") in self._cancelled:
            return False
        worker = self._claim_worker(exclusive=False)
        if worker is None:
            return False
        self._acquire_now(task)
        self._start_queued_exec(worker, task)
        return True

    def _unclaim_queued(self, worker: WorkerHandle) -> None:
        """Return one queued-execute claim on a worker."""
        if worker.qdepth > 0:
            worker.qdepth -= 1
        if worker.qdepth == 0 and worker.conn is not None \
                and worker.actor_id is None and worker.lease_id is None \
                and worker.current_task is None and not worker.inflight:
            worker.idle = True
            self._idle_event.set()

    async def _run_task(self, task: Dict):
        try:
            for oid in task.get("deps", []):
                await self._store_get(oid)
            await self._acquire_local(task)
            worker = await self._pop_idle_worker(
                exclusive=task.get("_no_pipeline", False))
        except Exception as e:  # noqa: BLE001
            await self._fail_task(task, f"dispatch failed: {e}")
            return
        if task.get("task_id") in self._cancelled:
            self._cancelled.discard(task["task_id"])
            await self._fail_task(task, "task cancelled before dispatch")
            self._unclaim_queued(worker)
            return
        self._start_queued_exec(worker, task)

    async def _create_actor(self, msg: Dict):
        try:
            for oid in msg.get("deps", []):
                await self._store_get(oid)
            await self._acquire_local(msg)
            worker = await self._pop_idle_worker()
        except Exception as e:  # noqa: BLE001
            await self._fail_task(msg, f"actor creation dispatch failed: {e}")
            self._gcs.call({"type": "update_actor", "actor_id": msg["actor_id"],
                            "state": "DEAD"})
            return
        worker.actor_id = msg["actor_id"]
        worker.current_task = msg
        await worker.conn.send(dict(msg, type="create_actor_instance"))
        self._gcs.call({
            "type": "update_actor", "actor_id": msg["actor_id"],
            "state": "ALIVE", "node_id": self.node_id,
            "address": list(self.address),
        })

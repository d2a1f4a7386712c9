"""Worker process entry point.

Reference counterpart: ``python/ray/workers/default_worker.py`` + the
core-worker task execution loop (``core_worker.cc:1421 RunTaskExecutionLoop``).
Connects to its NodeController, registers, then executes pushed tasks:
fetch function blob (cached), resolve args from the local store, run, store
returns, report done. Actor workers keep the instance alive and execute
method calls in arrival order.
"""

from __future__ import annotations

import argparse
import os
import pickle
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

ERR_PREFIX = b"E"
VAL_PREFIX = b"V"


class _Inbox:
    """Task inbox fed by the reader thread's frame batches: ``put_many``
    enqueues a whole batch under ONE lock acquisition + ONE wakeup where
    ``queue.Queue`` pays a mutex round-trip per item. Single consumer
    (serve_loop), single producer (the RpcClient reader thread)."""

    def __init__(self):
        self._d: deque = deque()
        self._cv = threading.Condition()

    def put(self, item: Dict) -> None:
        with self._cv:
            self._d.append(item)
            self._cv.notify()

    def put_many(self, items: List[Dict]) -> None:
        with self._cv:
            self._d.extend(items)
            self._cv.notify()

    # raylint: hotpath — serve_loop blocks here between tasks
    def get(self) -> Dict:
        with self._cv:
            while not self._d:
                self._cv.wait()
            return self._d.popleft()


def main():
    from ray_tpu_torch._private.stack_dump import register_stack_dump

    register_stack_dump()
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller", required=True)
    parser.add_argument("--gcs", required=True)
    args = parser.parse_args()

    chost, cport = args.controller.rsplit(":", 1)
    ghost, gport = args.gcs.rsplit(":", 1)

    from ray_tpu_torch._native import completion_ring as cring
    from ray_tpu_torch._native import open_store
    from ray_tpu_torch._private.serialization import get_context
    from ray_tpu_torch.cluster import wire
    from ray_tpu_torch.cluster.core_worker import ClusterCoreWorker
    from ray_tpu_torch.cluster.protocol import RpcClient
    from ray_tpu_torch.exceptions import TaskError

    inbox = _Inbox()
    # Revocation bookkeeping for pipelined executes (the controller may
    # pre-push a second task into this inbox; if the current task blocks,
    # the controller revokes the queued one and re-dispatches it
    # elsewhere). The reader thread answers revokes OUT OF BAND: it knows
    # exactly which executes are still queued (``inbox_ids``) vs already
    # started, so the ack is authoritative and a revoked task can never
    # also run here (at-most-once preserved).
    revoke_lock = threading.Lock()
    inbox_ids: set = set()
    revoked: set = set()

    def on_push(msg: Dict) -> None:
        mtype = msg.get("type")
        if mtype == "set_trace_sample":
            # Runtime-adjustable sampling (cli trace --sample): the
            # controller rebroadcasts the GCS kv cell; nested submissions
            # from task code sample at the new rate.
            from ray_tpu_torch._private import tracing

            tracing.apply_kv_rate(msg.get("raw"))
            return
        if mtype == "revoke_execute":
            tid = msg.get("task_id")
            with revoke_lock:
                ok = tid in inbox_ids
                if ok:
                    inbox_ids.discard(tid)
                    revoked.add(tid)
            try:
                controller.send_oneway({"type": "revoke_ack",
                                        "pid": os.getpid(),
                                        "task_id": tid, "revoked": ok})
            except (ConnectionError, OSError):
                pass
            return
        if mtype == "execute_task" and msg.get("task_id") is not None:
            with revoke_lock:
                inbox_ids.add(msg["task_id"])
        inbox.put(msg)

    # raylint: hotpath — every pushed task enters the worker through here
    def on_push_batch(msgs: List[Dict]) -> None:
        """Batched inbox feed (native frame pump): one recv wakeup's worth
        of pushes lands in the inbox via ONE put_many. Control messages
        (trace sampling, revokes) keep their per-message handling and
        their order relative to surrounding executes — earlier executes
        are flushed first, so a revoke still sees its target queued."""
        pend: List[Dict] = []
        for msg in msgs:
            mtype = msg.get("type")
            if mtype == "set_trace_sample" or mtype == "revoke_execute":
                if pend:
                    inbox.put_many(pend)
                    pend = []
                on_push(msg)
                continue
            if mtype == "execute_task" and msg.get("task_id") is not None:
                with revoke_lock:
                    inbox_ids.add(msg["task_id"])
            pend.append(msg)
        if pend:
            inbox.put_many(pend)

    # A dead controller connection must terminate the worker (otherwise a
    # SIGKILL'd controller leaves its workers orphaned on inbox.get forever).
    controller = RpcClient(
        chost, int(cport), push_handler=on_push,
        push_batch_handler=on_push_batch,
        on_close=lambda: inbox.put({"type": "shutdown"}),
    )

    # Attach to the node's shared-memory arena: results are written straight
    # into shm and dependencies read from it, no blob bytes on the socket.
    store_name = os.environ.get("RAY_TPU_TORCH_STORE_NAME", "")
    local_store = open_store(store_name) if store_name else None

    # The worker's own core runtime: nested ray_tpu_torch API calls from task code
    # route through the same cluster machinery.
    core = ClusterCoreWorker(
        (ghost, int(gport)), controller_addr=(chost, int(cport)),
        role="worker",
    )
    core.local_store = local_store
    from ray_tpu_torch._private.worker import global_worker

    worker = global_worker()
    worker.core = core
    worker.mode = "worker"
    worker.connected = True

    reg = controller.call(
        {"type": "register_worker", "pid": os.getpid(),
         "wire": wire.WIRE_VERSION})
    # The controller's advertised wire version gates the v2 inline-result
    # frames on the task_done path (a v1 controller gets pickle instead).
    peer_wire = int(reg.get("wire") or 1)
    controller.peer_wire = peer_wire
    core._controller((chost, int(cport))).peer_wire = peer_wire

    # Continuous stack sampler: this worker's wall-clock profile, drained
    # to the GCS profile-stacks table on the flush cadence below.
    from ray_tpu_torch._private import flight_recorder, loopmon

    flight_recorder.start("worker")
    cpu_sampler = loopmon.cpu_sampler("worker")

    # Periodic profile-span flush to the GCS (reference: profiling.cc's
    # batched AddProfileData timer).
    def flush_loop():
        import time as _time

        while True:
            _time.sleep(2.0)
            try:
                core.flush_events()
                rec = flight_recorder.get()
                msg = None
                if rec is not None:
                    stacks, stacks_cpu = rec.drain_tagged()
                    if stacks:
                        n = sum(stacks.values())
                        msg = {"type": "add_profile_stacks",
                               "component": rec.component,
                               "samples": n, "stacks": stacks,
                               "stacks_oncpu": stacks_cpu}
                        flight_recorder.flush_metrics(rec, n)
                # Off-CPU truth rides the same flush: per-thread CPU and
                # ctx-switch deltas for the worker process (workers have
                # no asyncio loop — thread coverage IS their observatory).
                if cpu_sampler is not None:
                    tc = cpu_sampler.drain()
                    if tc:
                        tc["component"] = "worker"
                        if msg is None:
                            msg = {"type": "add_profile_stacks",
                                   "component": "worker", "samples": 0,
                                   "stacks": {}}
                        msg["thread_cpu"] = tc
                if msg is not None:
                    core.gcs.send_oneway(msg)
            except Exception:  # noqa: BLE001 - shutdown race
                return

    threading.Thread(target=flush_loop, daemon=True,
                     name="profile-flush").start()

    ser = get_context()
    fn_cache: Dict[bytes, Any] = {}
    actor_instance: Optional[Any] = None
    actor_id: Optional[bytes] = None

    def checkpoint_key(aid: bytes) -> str:
        return "__actor_ckpt:" + aid.hex()

    def maybe_save_checkpoint() -> None:
        """After each method: Checkpointable actors persist state to the GCS
        kv so a restart (possibly on another node) can restore it
        (reference: actor.py:972 + GCS checkpoint RPCs)."""
        inst = actor_instance
        if (inst is None or actor_id is None
                or not hasattr(inst, "should_checkpoint")
                or not hasattr(inst, "save_checkpoint")):
            return
        try:
            if inst.should_checkpoint(None):
                core.gcs.call({
                    "type": "kv_put", "key": checkpoint_key(actor_id),
                    "value": pickle.dumps(inst.save_checkpoint()),
                })
        except Exception:  # noqa: BLE001 - checkpointing is best-effort
            pass

    def maybe_restore_checkpoint(msg) -> None:
        inst = actor_instance
        if (inst is None or not msg.get("restart_count")
                or not hasattr(inst, "load_checkpoint")):
            return
        resp = core.gcs.call({"type": "kv_get",
                              "key": checkpoint_key(msg["actor_id"])})
        if resp.get("value") is not None:
            inst.load_checkpoint(pickle.loads(resp["value"]))

    def load_function(fn_id: bytes):
        fn = fn_cache.get(fn_id)
        if fn is None:
            resp = core.gcs.call({"type": "get_function", "fn_id": fn_id})
            fn = pickle.loads(resp["blob"])
            fn_cache[fn_id] = fn
        return fn

    def resolve_args(msg) -> tuple:
        pos = []
        for kind, payload in msg["args"]:
            if kind == "ref":
                pos.append(core.get_blob_value(payload))
            else:
                pos.append(ser.deserialize(
                    type(ser.serialize(None)).from_bytes(payload)))
        kwargs = {}
        for key, (kind, payload) in msg.get("kwargs", {}).items():
            if kind == "ref":
                kwargs[key] = core.get_blob_value(payload)
            else:
                kwargs[key] = ser.deserialize(
                    type(ser.serialize(None)).from_bytes(payload))
        return pos, kwargs

    # Result blobs written by the CURRENT task, registered with the
    # controller inside the task_done message instead of one object_added
    # oneway each — at fan-out rates the per-result socket write was half
    # the worker->controller traffic. Same connection + same FIFO slot, so
    # the registration-before-finish invariant is unchanged. Keyed per
    # thread: concurrent actor methods (max_concurrency/asyncio) each
    # accumulate their own adds.
    _pending_adds: Dict[int, list] = {}
    # Per-thread [exec_s, reg_s, ts_exec_start, ts_exec_end] for the task
    # being finished: monotonic phase durations (the phase profiler's
    # worker-side samples) plus the wall-clock execution window that the
    # job profiler joins against the GCS submit/dispatch/finish stamps —
    # carried inside task_done on EVERY completion, not just traced ones.
    _phase_times: Dict[int, list] = {}

    def _store_blob(oid: bytes, blob: bytes, adds: list) -> None:
        """Result store on the new data plane (see ARCHITECTURE.md
        "Result data plane"):

        * **inline** — results at or under cring.INLINE_RESULT_MAX ride
          inside the owner's completion-ring record AND inside this task's
          task_done "added" item, so they never touch an arena slot or a
          fetch RPC: the same-host owner pops them from its ring; everyone
          else gets the bytes carried through the GCS directory;
        * **arena** — bigger results keep the zero-copy arena write with
          DEFERRED registration, plus a slot record into the owner's ring
          (same-host owners then read the arena without scanning it);
        * **RPC** — arena unavailable/full (or over the spill high
          watermark, where the controller route spills cold objects to
          disk instead of the native evictor dropping them).
        """
        if 0 < len(blob) <= cring.INLINE_RESULT_MAX:
            core.publish_completion(oid, len(blob), inline=blob)
            adds.append([oid, len(blob), blob])
            return
        if core.local_store is not None and core.arena_admits(len(blob)):
            try:
                core.local_store.put(oid, blob)
                core.publish_completion(oid, len(blob))
                adds.append([oid, len(blob)])
                return
            except Exception:  # noqa: BLE001 - arena full: RPC path
                pass
        core.put_blob(oid, blob)

    def _adds_list() -> list:
        """This executor thread's pending "added" registrations, resolved
        ONCE per task (the batched-bookkeeping mirror of the GCS
        completion apply): every return object of a task appends to the
        same list without re-paying the ident lookup + setdefault."""
        return _pending_adds.setdefault(threading.get_ident(), [])

    def store_result(oid: bytes, value: Any, adds: list):
        sobj = ser.serialize(value)
        # Refs returned inside the result stay pinned while it lives.
        core._report_contained(oid, sobj.contained_refs)
        _store_blob(oid, VAL_PREFIX + sobj.to_bytes(), adds)

    def store_error(msg, exc: BaseException):
        if not isinstance(exc, TaskError):
            exc = TaskError(msg.get("name", "task"), exc)
        blob = ERR_PREFIX + pickle.dumps(exc)
        adds = _adds_list()
        for oid in msg["return_ids"]:
            _store_blob(oid, blob, adds)

    def run_returns(msg, result):
        oids = msg["return_ids"]
        adds = _adds_list()
        if len(oids) == 1:
            store_result(oids[0], result, adds)
        else:
            if not isinstance(result, tuple) or len(result) != len(oids):
                raise ValueError(
                    f"expected {len(oids)} returns, got {type(result).__name__}"
                )
            for oid, val in zip(oids, result):
                store_result(oid, val, adds)

    # ---- actor method concurrency -----------------------------------------
    # Cluster/local parity (reference: BoundedExecutor for max_concurrency,
    # direct_actor_transport.h:264, and fibers for asyncio actors,
    # core_worker/fiber.h — mirrored locally by _private/runtime.LocalActor):
    #  * plain actors run inline in this thread — per-caller order is the
    #    controller's FIFO dispatch order;
    #  * max_concurrency > 1 runs methods on a bounded thread pool;
    #  * async actors schedule coroutines on ONE persistent event loop
    #    thread, so concurrent awaits genuinely interleave instead of each
    #    call paying a fresh asyncio.run().
    import asyncio

    actor_pool = None   # ThreadPoolExecutor when max_concurrency > 1
    actor_loop: Optional[asyncio.AbstractEventLoop] = None

    def finish(msg) -> bool:
        """Report task completion; returns False when the controller is gone.

        Sends on the SAME connection the result notifications used (core's
        controller client): TCP FIFO guarantees the controller registers the
        objects before it sees task_done, so the GCS can never mark the task
        FINISHED while its outputs are still unindexed (a lost-object false
        positive that would trigger spurious lineage re-execution). Each
        concurrent executor thread stores then finishes on that one locked
        client, so the invariant holds per task regardless of interleaving.
        """
        try:
            phases = _phase_times.pop(threading.get_ident(), None) \
                or (0.0, 0.0)
            core._controller((chost, int(cport))).send_oneway({
                "type": "task_done",
                "pid": os.getpid(),
                "return_ids": msg.get("return_ids", []),
                # This task's result blobs: registered by the controller
                # BEFORE it processes the finish (same message).
                "added": _pending_adds.pop(threading.get_ident(), []),
                # Phase profiler samples (execution / result-store wall).
                "exec_s": phases[0], "reg_s": phases[1],
                # Wall-clock execution window (job profiler timeline).
                "ts_exec_start": phases[2] if len(phases) > 2 else 0.0,
                "ts_exec_end": phases[3] if len(phases) > 3 else 0.0,
            })
            return True
        except (ConnectionError, OSError):
            inbox.put({"type": "shutdown"})  # main loop exits
            return False

    def complete_actor_method(msg, result=None, error=None,
                              exec_s: float = 0.0,
                              exec_win=(0.0, 0.0)) -> None:
        """Store returns (or the error), checkpoint, report task_done.

        The store->finish pair runs in ONE thread so the TCP FIFO invariant
        documented on finish() holds per task. Shared by the inline, pooled,
        and async execution paths — a fix to error storage or the ordering
        applies to all three at once."""
        t1 = time.monotonic()
        try:
            if error is None:
                run_returns(msg, result)
                maybe_save_checkpoint()
            else:
                store_error(msg, error)
        except BaseException as e:  # noqa: BLE001 - completion errors are data
            try:
                store_error(msg, e)
            except Exception:  # noqa: BLE001
                traceback.print_exc()
        finally:
            _phase_times[threading.get_ident()] = \
                [exec_s, time.monotonic() - t1, exec_win[0], exec_win[1]]
            finish(msg)

    def record_span(kind: str, name: str, t0: float,
                    id_key: str, id_val) -> None:
        """Execution span for the timeline lanes (reference: profiling.cc
        task spans). Called from success AND failure paths — a failed
        task's span is exactly what a user debugging a job needs to see."""
        ident = id_val or b""
        core.events.record(
            kind, name, t0, time.monotonic(),
            **{id_key: ident.hex() if isinstance(ident, bytes)
               else str(ident),
               "worker_pid": os.getpid(),
               # Cluster-unique lane key: bare OS pids collide across
               # nodes (containers reuse low pids), which would merge two
               # machines' spans into one timeline lane.
               "lane": f"{core.worker_uid[:8]}:{os.getpid()}"})

    def run_actor_method(msg) -> None:
        """One actor method: resolve, run, complete. Used inline (plain
        actors) and from pool threads (max_concurrency)."""
        t0 = time.monotonic()
        w0 = time.time()
        try:
            method = getattr(actor_instance, msg["method"])
            pos, kwargs = resolve_args(msg)
            result = method(*pos, **kwargs)
            if asyncio.iscoroutine(result):
                result = asyncio.run(result)
        except BaseException as e:  # noqa: BLE001 - task errors are data
            complete_actor_method(msg, error=e,
                                  exec_s=time.monotonic() - t0,
                                  exec_win=(w0, time.time()))
            return
        finally:
            record_span("actor_task", msg.get("method", "method"), t0,
                        "actor_id", msg.get("actor_id"))
        complete_actor_method(msg, result, exec_s=time.monotonic() - t0,
                              exec_win=(w0, time.time()))

    async def run_actor_method_async(msg) -> None:
        """Coroutine twin for the persistent loop: the method's coroutine is
        awaited IN PLACE so batch-mates interleave, while the potentially
        BLOCKING pieces (ref-arg resolution, result store / checkpoint /
        task_done RPCs) run via asyncio.to_thread so they never stall the
        loop and re-serialize the in-flight coroutines."""
        t0 = time.monotonic()
        w0 = time.time()
        try:
            pos, kwargs = await asyncio.to_thread(resolve_args, msg)
            method = getattr(actor_instance, msg["method"])
            result = method(*pos, **kwargs)
            if asyncio.iscoroutine(result):
                result = await result
        except BaseException as e:  # noqa: BLE001 - task errors are data
            await asyncio.to_thread(
                complete_actor_method, msg, None, e,
                time.monotonic() - t0, (w0, time.time()))
            return
        finally:
            record_span("actor_task", msg.get("method", "method"), t0,
                        "actor_id", msg.get("actor_id"))
        await asyncio.to_thread(
            complete_actor_method, msg, result, None,
            time.monotonic() - t0, (w0, time.time()))

    # The worker inner loop — one of the flight recorder's top burners, so
    # it is a named, hot-path-linted function: no pickle/json or loud
    # logging may creep into the per-task path (raylint hot-path).
    # raylint: hotpath
    def serve_loop() -> None:
        nonlocal actor_instance, actor_id, actor_loop, actor_pool
        while True:
            msg = inbox.get()
            mtype = msg.get("type")
            if mtype == "shutdown":
                break
            if mtype == "execute_task" and msg.get("task_id") is not None:
                with revoke_lock:
                    inbox_ids.discard(msg["task_id"])
                    if msg["task_id"] in revoked:
                        # Revoked while queued: the controller re-dispatched
                        # it elsewhere; executing here too would double-run
                        # it.
                        revoked.discard(msg["task_id"])
                        continue
            if "_spec" in msg and "args" not in msg:
                # Pickle-relayed opaque spec (mixed-wire path): the header
                # dict carries the encoded blob but not the args — the full
                # decode happens here, at the executing worker, exactly
                # like the binary execute_task frame.
                msg = dict(wire.decode_task_spec(msg["_spec"]), type=mtype)
            if mtype == "execute_actor_task" and actor_instance is not None:
                # Dispatch order == controller FIFO order for all three
                # modes; completion may interleave for async/pooled actors
                # (that is their contract). The concurrent paths own their
                # error handling + task_done, so they bypass the serial
                # finally.
                if actor_loop is not None:
                    asyncio.run_coroutine_threadsafe(
                        run_actor_method_async(msg), actor_loop)
                    continue
                if actor_pool is not None:
                    actor_pool.submit(run_actor_method, msg)
                    continue
                run_actor_method(msg)
                continue
            try:
                if mtype == "execute_task":
                    fn = load_function(msg["fn_id"])
                    pos, kwargs = resolve_args(msg)
                    trace = msg.get("trace")  # sampled task: phase spans
                    t0 = time.monotonic()
                    w0 = time.time()
                    try:
                        result = fn(*pos, **kwargs)
                    finally:
                        _phase_times[threading.get_ident()] = \
                            [time.monotonic() - t0, 0.0, w0, time.time()]
                        record_span("task", getattr(fn, "__name__", "task"),
                                    t0, "task_id", msg.get("task_id"))
                        if trace is not None:
                            core.record_trace_span(
                                trace, msg.get("task_id"), "worker_exec",
                                t0, time.monotonic())
                    t1 = time.monotonic()
                    run_returns(msg, result)
                    _phase_times[threading.get_ident()][1] = \
                        time.monotonic() - t1
                    if trace is not None:
                        core.record_trace_span(
                            trace, msg.get("task_id"), "result_register",
                            t1, time.monotonic())
                elif mtype == "create_actor_instance":
                    cls = load_function(msg["fn_id"])
                    pos, kwargs = resolve_args(msg)
                    t0 = time.monotonic()
                    w0 = time.time()
                    try:
                        actor_instance = cls(*pos, **kwargs)
                        actor_id = msg["actor_id"]
                        maybe_restore_checkpoint(msg)
                    finally:
                        # Constructor window: actor-creation completions
                        # carry exec stamps like plain tasks do.
                        _phase_times[threading.get_ident()] = \
                            [time.monotonic() - t0, 0.0, w0, time.time()]
                    if msg.get("is_asyncio"):
                        actor_loop = asyncio.new_event_loop()
                        threading.Thread(
                            target=actor_loop.run_forever, daemon=True,
                            name="actor-asyncio-loop").start()
                    elif int(msg.get("max_concurrency", 1) or 1) > 1:
                        from concurrent.futures import ThreadPoolExecutor

                        actor_pool = ThreadPoolExecutor(
                            max_workers=int(msg["max_concurrency"]),
                            thread_name_prefix="actor-exec")
                    store_result(msg["return_ids"][0], True, _adds_list())
                elif mtype == "execute_actor_task":
                    raise RuntimeError("actor not initialized")
                else:
                    continue
            except BaseException as e:  # noqa: BLE001 - task errors are data
                try:
                    store_error(msg, e)
                except Exception:  # noqa: BLE001
                    traceback.print_exc()
            finally:
                if not finish(msg):
                    break

    serve_loop()

    if actor_loop is not None:
        actor_loop.call_soon_threadsafe(actor_loop.stop)
    if actor_pool is not None:
        actor_pool.shutdown(wait=False)


if __name__ == "__main__":
    main()

"""Local (single-process) runtime: core worker + node scheduler in one.

This is the stage-2 runtime from the build plan: the semantics of the
reference's core_worker (task submission, dependency resolution, object
put/get/wait — reference: ``src/ray/core_worker/core_worker.h:262``) fused with
a single node's scheduler (resource admission + dispatch — reference:
``src/ray/raylet/node_manager.cc:993`` DispatchTasks) into one in-process
engine. The port's copy of ``ray_tpu/_private/runtime.py``; the cluster
backend (``ray_tpu_torch/cluster``) reuses the same submission/actor
machinery but routes placement through the GCS's batch placement passes
and objects through the shared-memory arena.

Execution model:
  - normal tasks run on a growable thread pool; admission is controlled by the
    node's ResourceSet accounting, not pool size (torch releases the GIL in
    its operators and while it launches CUDA work, so threads overlap);
  - a task that blocks in ``get()`` releases its resources and re-acquires
    (oversubscribing if needed) on unblock — the reference's
    HandleDirectCallTaskBlocked/Unblocked protocol (node_manager.h:385-392),
    without which nested task graphs deadlock;
  - actors are dispatch threads with ordered inbound queues (the reference's
    direct actor transport, direct_actor_transport.h:298), optional
    max_concurrency via an inner pool, optional asyncio event loop.

The card: every task and actor thread enqueues its CUDA work on torch's
legacy default stream, the stream the driver uses too. So a CUDA tensor that
a task returns is ordered before anything a later task or the driver
enqueues, and the runtime adds no ``synchronize()`` of its own (the
reference's jax arrays are asynchronous in the same way). A task's exec
window (``ts_exec_start``..``ts_exec_end``, the ``task`` timeline span) is
therefore the time its thread took to enqueue the work, not the card's time.
Objects are stored as they are: ``put`` and ``get`` never copy a tensor, and
a CUDA tensor counts its ``nbytes`` against ``object_store_memory`` (see
``_sizeof``).
"""

from __future__ import annotations

import asyncio
import itertools
import threading
import time
from collections import deque
import logging
from concurrent.futures import Future, ThreadPoolExecutor

logger = logging.getLogger(__name__)
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..exceptions import (
    ActorDiedError,
    ReplicaUnavailableError,
    TaskCancelledError,
    TaskError,
)
from ..object_ref import ObjectRef
from .config import Config
from .ids import ActorID, JobID, NodeID, ObjectID, TaskID
from .memory_store import MemoryStore, StoredObject
from .resources import KILO, NodeResources, ResourceSet
from .serialization import get_context as get_serialization_context
from .task_spec import TaskSpec

_LOCAL = threading.local()
_ADMITTED = object()  # PendingTask.future sentinel: handed to the pool


class WorkerContext:
    """Per-thread execution context (reference: core_worker/context.h)."""

    def __init__(self, job_id: JobID, task_id: TaskID):
        self.job_id = job_id
        self.current_task_id = task_id
        self.task_counter = itertools.count(1)
        self.put_counter = itertools.count(1)
        self.acquired: Optional[ResourceSet] = None  # held by the running task


def current_context() -> Optional[WorkerContext]:
    return getattr(_LOCAL, "ctx", None)


def ensure_context(runtime) -> WorkerContext:
    """Context for this thread, creating a driver-scoped one if absent.

    User-spawned threads (e.g. a ThreadPoolExecutor in driver code) have no
    inherited context; they submit as children of the driver task.

    A context auto-created here is tagged with its runtime and replaced
    when that runtime changes: after shutdown()+init() in one process the
    thread-local would otherwise keep deriving task/object IDs from the
    DEAD job (their embedded job bytes then name a completion ring that
    no longer exists, and cross-driver result serving breaks the same
    way). Contexts set by task execution are never replaced — they carry
    the SUBMITTING driver's job on purpose.
    """
    ctx = getattr(_LOCAL, "ctx", None)
    if ctx is None or getattr(ctx, "scoped_runtime", None) \
            not in (None, runtime):
        # Scope the thread under a unique pseudo-task so two threads never
        # derive colliding task/object IDs (counters alone are per-context).
        scope = TaskID.for_normal_task(
            runtime.job_id, runtime.driver_task_id, next(runtime._thread_scope_counter)
        )
        ctx = WorkerContext(runtime.job_id, scope)
        ctx.scoped_runtime = runtime
        _LOCAL.ctx = ctx
    return ctx


class _EventLog:
    """Cheap append-only profile log; feeds timeline() chrome-trace export."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.events: deque = deque(maxlen=1_000_000)

    def record(self, kind: str, name: str, start: float, end: float, **extra):
        if self.enabled:
            self.events.append((kind, name, start, end, extra))


class PendingTask:
    __slots__ = ("spec", "fn", "remaining_deps", "retries_left", "cancelled", "future")

    def __init__(self, spec: TaskSpec, fn: Callable, retries_left: int):
        self.spec = spec
        self.fn = fn
        self.remaining_deps = 0
        self.retries_left = retries_left
        self.cancelled = False
        self.future: Optional[Future] = None


class LocalActor:
    """One live actor: instance + ordered dispatch thread.

    Reference semantics: per-caller sequence ordering and bounded concurrency
    (``direct_actor_transport.h:264,298``); asyncio actors run methods on an
    event loop instead of blocking the dispatch thread (core_worker/fiber.h).
    """

    def __init__(self, actor_id: ActorID, name: Optional[str], runtime: "LocalRuntime",
                 max_concurrency: int, is_asyncio: bool,
                 lifetime_resources: ResourceSet):
        self.actor_id = actor_id
        self.name = name
        self.runtime = runtime
        self.instance: Any = None
        self.dead = False
        self.resources_released = False
        self.class_info: Optional[Tuple[str, str, tuple]] = None  # name, module, methods
        self.creation_error: Optional[BaseException] = None
        self.created = threading.Event()
        self.lifetime_resources = lifetime_resources
        self.max_concurrency = max_concurrency
        self.is_asyncio = is_asyncio
        self.queue: "deque[Tuple[int, TaskSpec]]" = deque()
        self.next_seq = 0
        self.restarts_left = 0  # set from creation spec in start()
        self.checkpoints: deque = deque(maxlen=20)  # Checkpointable blobs
        self._exit_requested = False
        self.pending_out_of_order: Dict[int, TaskSpec] = {}
        self.cv = threading.Condition()
        self.num_executing = 0
        self.inner_pool: Optional[ThreadPoolExecutor] = None
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self.thread = threading.Thread(
            target=self._run, name=f"actor-{actor_id.hex()[:8]}", daemon=True
        )

    def _died_error(self) -> "ActorDiedError":
        """Death error that names the CAUSE when the constructor failed —
        a bare "died unexpectedly" sent callers hunting through logs."""
        if self.creation_error is not None:
            return ActorDiedError(
                self.actor_id,
                f"actor constructor failed: "
                f"{type(self.creation_error).__name__}: "
                f"{self.creation_error}")
        return ActorDiedError(self.actor_id)

    def start(self, creation_spec: TaskSpec, cls: type, args, kwargs):
        self._creation = (creation_spec, cls, args, kwargs)
        self.restarts_left = creation_spec.max_restarts
        self.thread.start()

    def submit(self, seq_no: int, spec: TaskSpec):
        with self.cv:
            if self.dead:
                self._fail_spec(spec, self._died_error())
                return
            if seq_no == self.next_seq:
                self.queue.append((seq_no, spec))
                self.next_seq += 1
                # drain any buffered out-of-order successors
                while self.next_seq in self.pending_out_of_order:
                    self.queue.append(
                        (self.next_seq, self.pending_out_of_order.pop(self.next_seq))
                    )
                    self.next_seq += 1
            else:
                self.pending_out_of_order[seq_no] = spec
            self.cv.notify_all()
        self._wake_loop()

    def kill(self, no_restart: bool = True) -> bool:
        """Kill the actor; returns True if it is restarting instead of dying.

        Restart semantics follow the reference (max_restarts,
        core_worker.cc:1156 + gcs_actor_manager): queued calls fail during the
        restart, later calls hit the fresh instance; -1 = infinite restarts.

        Unlike the reference, which keeps the dead instance, the instance's
        ``__ray_shutdown__()`` runs here, once, on the killing thread (a
        method still running may overlap it), and a dead actor's instance
        is dropped. A GPU actor frees its caches there before its
        resources go back to the pool: in one process nothing else ends
        what the instance holds.
        """
        with self.cv:
            already_dead = self.dead
            self.dead = True
            pending = [spec for _, spec in self.queue]
            pending.extend(self.pending_out_of_order.values())
            self.queue.clear()
            self.pending_out_of_order.clear()
            self.cv.notify_all()
        for spec in pending:
            self._fail_spec(spec, self._died_error())
        self._wake_loop()
        if not already_dead:
            self._shutdown_instance()
        if (no_restart or already_dead or self.creation_error is not None
                or self.restarts_left == 0):
            with self.cv:
                self.instance = None
            return False
        if self.restarts_left > 0:
            self.restarts_left -= 1
        self._restart()
        return True

    def _shutdown_instance(self) -> None:
        hook = getattr(self.instance, "__ray_shutdown__", None)
        if hook is None:
            return
        try:
            hook()
        except Exception:  # noqa: BLE001 - a failed teardown must not block kill
            logger.exception("__ray_shutdown__ of actor %s failed",
                             self.actor_id.hex())

    def _restart(self) -> None:
        old_thread = self.thread
        old_loop = self.loop
        same_thread = old_thread is threading.current_thread()
        if old_thread.is_alive() and not same_thread:
            old_thread.join(timeout=5.0)
        if (old_loop is not None and not old_loop.is_closed()
                and not old_loop.is_running()):
            old_loop.close()
        with self.cv:
            self.instance = None
            self.loop = None
            self.inner_pool = None
            self.created.clear()
            self._exit_requested = False
            self.dead = False
        self.thread = threading.Thread(
            target=self._run, name=f"actor-{self.actor_id.hex()[:8]}",
            daemon=True)
        with self.cv:
            self.cv.notify_all()  # wake a same-thread-restart's old loop
        self.thread.start()

    def _fail_spec(self, spec: TaskSpec, error: BaseException):
        self.runtime._stamp_terminal(spec, "FAILED")
        for oid in spec.return_ids():
            self.runtime.store.put(oid, StoredObject(error=error))
        self.runtime._unpin_args(spec.dependencies())

    # -- dispatch loop --------------------------------------------------------
    def _run(self):
        creation_spec, cls, args, kwargs = self._creation
        _LOCAL.ctx = WorkerContext(creation_spec.job_id, creation_spec.task_id)
        t0 = time.monotonic()
        w0 = time.time()
        self.runtime._stamp_dispatch(creation_spec)
        try:
            resolved_args, resolved_kwargs = self.runtime._resolve_args(args, kwargs)
            self.instance = cls(*resolved_args, **resolved_kwargs)
            if self.checkpoints and hasattr(self.instance, "load_checkpoint"):
                # Restart of a Checkpointable actor: resume from the newest
                # checkpoint (reference actor.py:972 + node_manager.h:525).
                self.instance.load_checkpoint(self.checkpoints[-1])
            self.runtime.store.put(
                creation_spec.return_ids()[0], StoredObject(value=self.actor_id)
            )
        except BaseException as e:  # noqa: BLE001 - creation failure is data
            self.creation_error = e
            self.runtime._stamp_terminal(
                creation_spec, "FAILED", (w0, time.time()),
                time.monotonic() - t0)
            err = TaskError(f"{cls.__name__}.__init__", e)
            self.runtime.store.put(creation_spec.return_ids()[0], StoredObject(error=err))
            with self.cv:
                self.dead = True
                # Calls submitted between thread start and this failure sit
                # in the queue; abandoning them would hang their callers
                # forever (observed: serve master blocked on ready()).
                pending = [spec for _, spec in self.queue]
                pending.extend(self.pending_out_of_order.values())
                self.queue.clear()
                self.pending_out_of_order.clear()
            for spec in pending:
                self._fail_spec(spec, self._died_error())
            self.created.set()
            # Release lifetime resources reserved in create_actor, else a
            # failed constructor permanently leaks them.
            self.runtime._release_actor_resources(self)
            return
        finally:
            self.runtime.events.record(
                "actor_creation", cls.__name__, t0, time.monotonic(),
                actor_id=self.actor_id.hex(),
            )
        self.runtime._stamp_terminal(
            creation_spec, "FINISHED", (w0, time.time()),
            time.monotonic() - t0)
        self.created.set()

        if self.is_asyncio:
            self.loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self.loop)
            self.loop.create_task(self._async_dispatch())
            self.loop.run_forever()
            return
        if self.max_concurrency > 1:
            self.inner_pool = ThreadPoolExecutor(
                max_workers=self.max_concurrency,
                thread_name_prefix=f"actor-{self.actor_id.hex()[:8]}-c",
            )
        me = threading.current_thread()
        while True:
            with self.cv:
                # `self.thread is not me` => a restart replaced this loop
                # (possible when the restart was triggered from this very
                # thread, e.g. a method calling kill on its own actor):
                # retire so two dispatchers never run concurrently.
                while not self.queue and not self.dead and self.thread is me:
                    self.cv.wait()
                if self.thread is not me:
                    break
                if self.dead and not self.queue:
                    break
                _, spec = self.queue.popleft()
            if self.inner_pool is not None:
                self.inner_pool.submit(self._execute_method, spec)
            else:
                self._execute_method(spec)
        if self.inner_pool is not None:
            self.inner_pool.shutdown(wait=False)

    async def _async_dispatch(self):
        # Woken by submit()/kill() via call_soon_threadsafe on this event —
        # no idle polling.
        self._wake = asyncio.Event()
        me = threading.current_thread()
        while True:
            spec = None
            with self.cv:
                if self.thread is not me:
                    break  # a restart replaced this loop; retire
                if self.queue:
                    _, spec = self.queue.popleft()
                elif self.dead:
                    break
            if spec is None:
                self._wake.clear()
                await self._wake.wait()
                continue
            asyncio.get_event_loop().create_task(self._execute_method_async(spec))
        # Cancel stragglers (e.g. long-lived background loops the actor
        # spawned) so loop teardown doesn't warn about pending tasks; yield
        # once so the cancellations actually propagate before stop().
        stragglers = [t for t in asyncio.all_tasks(self.loop)
                      if t is not asyncio.current_task()]
        for task in stragglers:
            task.cancel()
        if stragglers:
            await asyncio.gather(*stragglers, return_exceptions=True)
        self.loop.stop()

    def _wake_loop(self):
        if self.loop is not None and hasattr(self, "_wake"):
            self.loop.call_soon_threadsafe(self._wake.set)

    def _execute_method(self, spec: TaskSpec):
        from ..exceptions import ActorExitError

        _LOCAL.ctx = WorkerContext(spec.job_id, spec.task_id)

        def call(a, k):
            try:
                return getattr(self.instance, spec.function.qualname)(*a, **k)
            except ActorExitError:
                self._exit_requested = True
                return None

        self.runtime._execute_callable(spec, call)
        self._post_method_hooks()

    def _post_method_hooks(self):
        if self._exit_requested:
            self.runtime.kill_actor(self.actor_id, no_restart=True)
            return
        inst = self.instance
        if (inst is not None and hasattr(inst, "should_checkpoint")
                and hasattr(inst, "save_checkpoint")):
            try:
                if inst.should_checkpoint(None):
                    self.checkpoints.append(inst.save_checkpoint())
            except Exception:  # noqa: BLE001 - checkpointing is best-effort
                pass

    async def _execute_method_async(self, spec: TaskSpec):
        from ..exceptions import ActorExitError

        method = getattr(self.instance, spec.function.qualname)
        t0 = time.monotonic()
        w0 = time.time()
        self.runtime._stamp_dispatch(spec)
        try:
            args, kwargs = self.runtime._resolve_args_from_spec(spec)
            result = method(*args, **kwargs)
            if asyncio.iscoroutine(result):
                result = await result
            self.runtime._store_returns(spec, result)
            self._post_method_hooks()
        except ActorExitError:
            self.runtime._store_returns(spec, None)
            self._exit_requested = True
            self._post_method_hooks()
        except BaseException as e:  # noqa: BLE001
            if isinstance(e, (TaskError, ActorDiedError,
                              ReplicaUnavailableError)):
                err = e  # propagate the original failure through chains
            else:
                err = TaskError(spec.function.repr_name, e)
            self.runtime._store_error(spec, err)
        finally:
            self.runtime._stamp_terminal(
                spec, "FINISHED", (w0, time.time()), time.monotonic() - t0)
            self.runtime._unpin_args(spec.dependencies())
            self.runtime.events.record(
                "actor_task", spec.function.repr_name, t0, time.monotonic(),
                actor_id=self.actor_id.hex(),
            )


class _TaskPool:
    """Growable thread pool with exact idle accounting.

    stdlib ThreadPoolExecutor spawns a new thread on nearly every submit
    (its idle check races with completions), which at 10k+ task rates melts
    into thread-creation overhead. This pool spawns only when no worker is
    actually idle — the same grow-on-demand policy as the reference's
    WorkerPool (worker_pool.h:45) — and retires workers after an idle
    timeout. max_threads stays high only as a deadlock backstop for tasks
    that block on ray.get of sub-task results.
    """

    def __init__(self, max_threads: int = 4096, idle_timeout_s: float = 30.0,
                 name: str = "task"):
        self._max = max_threads
        self._idle_timeout = idle_timeout_s
        self._name = name
        self._cv = threading.Condition()
        self._q: deque = deque()
        self._idle = 0
        self._threads = 0
        self._spawned_total = 0
        self._shutdown = False

    def submit(self, fn: Callable, *args) -> None:
        with self._cv:
            if self._shutdown:
                return
            self._q.append((fn, args))
            # Spawn when idle workers can't cover the backlog. `_idle` still
            # counts workers that were notified but haven't woken, so compare
            # against queue depth rather than testing idle > 0 — otherwise
            # two quick submits can both be assigned to one worker and the
            # second item waits behind the first (deadlock if item 1 blocks
            # on item 2's result).
            if self._idle < len(self._q) and self._threads < self._max:
                self._threads += 1
                self._spawned_total += 1
                threading.Thread(
                    target=self._worker, daemon=True,
                    name=f"{self._name}-{self._spawned_total}").start()
            self._cv.notify()

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._shutdown:
                    self._idle += 1
                    signaled = self._cv.wait(timeout=self._idle_timeout)
                    self._idle -= 1
                    if not signaled and not self._q:
                        self._threads -= 1  # idle timeout: retire
                        return
                if self._shutdown and not self._q:
                    self._threads -= 1
                    return
                fn, args = self._q.popleft()
            try:
                fn(*args)
            except BaseException:  # noqa: BLE001 - never kill the worker
                logger.exception("task pool fn raised")

    def shutdown(self, wait: bool = False, cancel_futures: bool = True) -> None:
        with self._cv:
            self._shutdown = True
            if cancel_futures:
                self._q.clear()
            self._cv.notify_all()


class LocalRuntime:
    """The single-node engine behind ``ray_tpu_torch.init()`` (default mode)."""

    def __init__(self, resources: ResourceSet, config: Config,
                 job_id: Optional[JobID] = None):
        self.config = config
        self.node_id = NodeID.from_random()
        self.job_id = job_id or JobID.from_int(1)
        self.driver_task_id = TaskID.for_driver_task(self.job_id)
        # Same graceful-degradation contract as the cluster arena: a
        # spiller turns budget overruns into disk spill instead of
        # ObjectStoreFullError (reference: plasma external store).
        self._spiller = None
        if getattr(config, "object_spill_enabled", False):
            from .spill import SpillManager, resolve_spill_dir

            spill_dir = resolve_spill_dir(
                config, f"local-{self.node_id.hex()[:12]}")
            try:
                self._spiller = SpillManager(spill_dir)
            except OSError:
                self._spiller = None
        self.store = MemoryStore(max_bytes=config.object_store_memory,
                                 spiller=self._spiller)
        self.node = NodeResources(resources)
        self.events = _EventLog(config.event_log_enabled)
        self.serialization = get_serialization_context()

        self._lock = threading.Lock()
        self._resource_cv = threading.Condition(self._lock)
        # Ready tasks indexed by SchedulingClass (= ResourceSet.key()), the
        # reference's ReadyQueue structure (scheduling_queue.h:123,148): one
        # feasibility check admits/skips a whole class, and dispatch
        # round-robins classes for fairness.
        self._ready: Dict[Tuple, deque] = {}
        self._pending: Dict[TaskID, PendingTask] = {}
        self._actors: Dict[ActorID, LocalActor] = {}
        self._named_actors: Dict[str, ActorID] = {}
        self._actor_seq: Dict[ActorID, itertools.count] = {}
        self._pool = _TaskPool(max_threads=4096, name="task")
        # Placement groups (single-node gang admission): pg_id -> record.
        self._placement_groups: Dict[bytes, Dict[str, Any]] = {}
        # Counter namespace for user-thread contexts; starts high so it never
        # collides with the driver thread's own task counters.
        self._thread_scope_counter = itertools.count(1 << 31)
        self._shutdown = False
        self.stats = {"tasks_submitted": 0, "tasks_finished": 0, "tasks_failed": 0}
        # Local-mode task records: the same lifecycle/exec stamps the GCS
        # task table keeps (ts_submit/ts_dispatch/ts_exec_start/
        # ts_exec_end/ts_finish + the pending-reason ledger), so
        # state.tasks() and the job profiler work identically in local
        # runs instead of silently reading zeros. Bounded like GCS
        # lineage: oldest terminal records evicted past the cap.
        self._task_records: Dict[str, Dict[str, Any]] = {}
        self._task_order: deque = deque()
        self._task_records_max = 20_000

        # Reference counting (reference: core_worker/reference_count.h:33).
        # Local python refs = live ObjectRef instances; pins = in-flight task
        # arguments ("submitted task references"). An object is deleted when
        # both hit zero. Owner-only model: everything is in-process, so the
        # borrowed-ref WaitForRefRemoved protocol collapses away.
        self._ref_lock = threading.Lock()
        self._local_refs: Dict[ObjectID, int] = {}
        self._arg_pins: Dict[ObjectID, int] = {}

        _LOCAL.ctx = WorkerContext(self.job_id, self.driver_task_id)
        # Tag so ensure_context replaces it if a DIFFERENT runtime (e.g. a
        # later cluster init in this process) takes over this thread.
        _LOCAL.ctx.scoped_runtime = self

        if getattr(config, "flight_recorder", True):
            from . import flight_recorder

            # Local mode samples as "driver" (the only component here);
            # shutdown() stops the thread so init()/shutdown() cycles
            # never accumulate samplers.
            flight_recorder.start("driver")

    # -------------------------------------------------------------- refcount
    def add_local_ref(self, oid: ObjectID) -> None:
        with self._ref_lock:
            self._local_refs[oid] = self._local_refs.get(oid, 0) + 1

    def remove_local_ref(self, oid: ObjectID) -> None:
        with self._ref_lock:
            n = self._local_refs.get(oid, 0) - 1
            if n > 0:
                self._local_refs[oid] = n
                return
            self._local_refs.pop(oid, None)
            if self._arg_pins.get(oid, 0) > 0:
                return
        if self.config.ref_counting_enabled:
            self.store.delete([oid])

    def _pin_args(self, oids) -> None:
        with self._ref_lock:
            for oid in oids:
                self._arg_pins[oid] = self._arg_pins.get(oid, 0) + 1

    def _unpin_args(self, oids) -> None:
        to_delete = []
        with self._ref_lock:
            for oid in oids:
                n = self._arg_pins.get(oid, 0) - 1
                if n > 0:
                    self._arg_pins[oid] = n
                    continue
                self._arg_pins.pop(oid, None)
                if self._local_refs.get(oid, 0) == 0:
                    to_delete.append(oid)
        if to_delete and self.config.ref_counting_enabled:
            self.store.delete(to_delete)

    def free(self, refs) -> None:
        """Eager delete (reference: ray.internal.free)."""
        self.store.delete([r.id for r in refs])

    def reference_counts(self) -> Dict[str, Dict[str, int]]:
        """Debug view (feeds the reference's `ray memory`-style accounting)."""
        with self._ref_lock:
            out: Dict[str, Dict[str, int]] = {}
            for oid, n in self._local_refs.items():
                out.setdefault(oid.hex(), {})["local_refs"] = n
            for oid, n in self._arg_pins.items():
                out.setdefault(oid.hex(), {})["task_arg_pins"] = n
            return out

    # ---------------------------------------------------------- task records
    def _task_record(self, spec: TaskSpec) -> Dict[str, Any]:
        """Get-or-create the lifecycle record for a spec (cluster task-
        table row shape). Actor methods arrive here lazily from the
        dispatch thread; plain tasks are created at submit."""
        tid = spec.task_id.hex()
        rec = self._task_records.get(tid)
        if rec is not None:
            return rec
        if spec.is_actor_creation:
            kind = "actor_creation"
        elif spec.is_actor_task:
            kind = "actor_method"
        else:
            kind = "task"
        rec = {
            "task_id": tid,
            "name": spec.function.repr_name,
            "kind": kind,
            "state": "PENDING",
            "node_id": self.node_id.hex(),
            "pending_reason": "",
            "ts_submit": time.time(),
            "ts_dispatch": 0.0, "ts_exec_start": 0.0,
            "ts_exec_end": 0.0, "ts_finish": 0.0,
            "exec_s": 0.0,
            "reason_s": {},
            "deps": [oid.binary()[:16].hex()
                     for oid in spec.dependencies()],
        }
        with self._lock:
            self._task_records[tid] = rec
            self._task_order.append(tid)
            while len(self._task_order) > self._task_records_max:
                self._task_records.pop(self._task_order.popleft(), None)
        return rec

    def _stamp_ready(self, spec: TaskSpec) -> None:
        """Deps satisfied → the record's waiting-for-deps stretch closes
        and the capacity wait opens (the pending-reason taxonomy)."""
        rec = self._task_records.get(spec.task_id.hex())
        if rec is None or rec["state"] != "PENDING":
            return
        now = time.time()
        if rec["pending_reason"] == "waiting-for-deps":
            ledger = rec["reason_s"]
            ledger["waiting-for-deps"] = ledger.get(
                "waiting-for-deps", 0.0) + max(0.0, now - rec["ts_submit"])
        rec["pending_reason"] = "waiting-for-capacity"
        rec["_ready_ts"] = now

    def _stamp_dispatch(self, spec: TaskSpec) -> None:
        rec = self._task_record(spec)
        if rec["state"] != "PENDING":
            return
        now = time.time()
        t0 = rec.pop("_ready_ts", 0.0)
        if rec["pending_reason"] == "waiting-for-capacity" and t0:
            ledger = rec["reason_s"]
            ledger["waiting-for-capacity"] = ledger.get(
                "waiting-for-capacity", 0.0) + max(0.0, now - t0)
        rec["pending_reason"] = ""
        rec["state"] = "DISPATCHED"
        rec["ts_dispatch"] = now

    def _stamp_terminal(self, spec: TaskSpec, state: str,
                        exec_win: Tuple[float, float] = (0.0, 0.0),
                        exec_s: float = 0.0) -> None:
        """Terminal stamp — used by EVERY end-of-life path (finish, task
        error, cancel, deadline expiry, dead-actor fast-fail) so
        durations never silently read 0. First terminal wins the state
        and ts_finish; a later exec window (deadline zombie finishing
        after the watchdog already failed the task) still lands."""
        rec = self._task_record(spec)
        if exec_win[1] > 0.0:
            rec["ts_exec_start"], rec["ts_exec_end"] = exec_win
            rec["exec_s"] = exec_s
        if rec["state"] in ("FINISHED", "FAILED"):
            return
        rec["state"] = state
        rec["pending_reason"] = ""
        rec["ts_finish"] = time.time()

    def task_rows(self) -> List[Dict[str, Any]]:
        """Snapshot every record (state.tasks()' local-mode source)."""
        with self._lock:
            return [dict(rec) for rec in self._task_records.values()]

    # ------------------------------------------------------------------ tasks
    def submit_task(self, fn: Callable, spec: TaskSpec) -> List[ObjectRef]:
        from . import tracing

        trace = tracing.maybe_sample()
        if trace is not None:
            # Local-mode parity with the cluster tracer: sampled tasks get
            # a phase lane in timeline() (single process => the only
            # control-plane phase with real wall time is worker_exec).
            spec.metadata["trace"] = trace.hex()
        refs = [ObjectRef(oid) for oid in spec.return_ids()]
        pending = PendingTask(spec, fn, retries_left=spec.max_retries)
        deps = spec.dependencies()
        self._pin_args(deps)
        rec = self._task_record(spec)
        if deps:
            rec["pending_reason"] = "waiting-for-deps"
        with self._lock:
            if self._shutdown:
                raise RuntimeError("runtime is shut down")
            self.stats["tasks_submitted"] += 1
            self._pending[spec.task_id] = pending
            pending.remaining_deps = len(deps)
        if deps:
            for oid in deps:
                self.store.on_available(oid, lambda _oid, p=pending: self._dep_ready(p))
        else:
            self._enqueue_ready(pending)
        return refs

    def _dep_ready(self, pending: PendingTask):
        with self._lock:
            pending.remaining_deps -= 1
            if pending.remaining_deps > 0 or pending.cancelled:
                return
        self._enqueue_ready(pending)

    def _enqueue_ready(self, pending: PendingTask):
        self._stamp_ready(pending.spec)
        with self._lock:
            klass = pending.spec.resources.key()
            dq = self._ready.get(klass)
            if dq is None:
                dq = self._ready[klass] = deque()
            dq.append(pending)
        self._dispatch()

    def _dispatch(self):
        """Admit as many ready tasks as resources allow (ref DispatchTasks)."""
        to_run: List[PendingTask] = []
        with self._lock:
            for klass in list(self._ready.keys()):
                dq = self._ready.get(klass)
                while dq:
                    p = dq[0]
                    if p.cancelled:
                        dq.popleft()
                        continue
                    if not self.node.acquire(p.spec.resources):
                        break  # class infeasible right now; try next class
                    dq.popleft()
                    to_run.append(p)
                if not dq:
                    del self._ready[klass]
            # Mark admission under the lock: cancel() checks future under
            # the same lock, so store-error/unpin can never run twice.
            for p in to_run:
                p.future = _ADMITTED
        for p in to_run:
            self._pool.submit(self._run_task, p)

    def _run_task(self, pending: PendingTask):
        spec = pending.spec
        ctx = WorkerContext(spec.job_id, spec.task_id)
        ctx.acquired = spec.resources
        _LOCAL.ctx = ctx
        try:
            if pending.cancelled:
                self._store_error(spec, TaskCancelledError(spec.task_id))
                self._unpin_args(spec.dependencies())
                return
            self._execute_callable(
                spec, lambda a, k: pending.fn(*a, **k), pending=pending
            )
        finally:
            acquired = ctx.acquired
            ctx.acquired = None
            with self._lock:
                if acquired is not None:
                    self.node.release(acquired)
                self._pending.pop(spec.task_id, None)
                self._resource_cv.notify_all()
            self._dispatch()

    def _execute_callable(self, spec: TaskSpec, call: Callable,
                          pending: Optional[PendingTask] = None):
        """Run one task or actor method and store its result. The exec
        window it stamps is host time: CUDA work the call enqueued may
        still be running on the card when it closes."""
        t0 = time.monotonic()
        w0 = time.time()
        self._stamp_dispatch(spec)
        final_state = "FINISHED"
        timer = None
        if getattr(spec, "timeout_s", None):
            # Local-mode deadline parity: threads can't be killed, so the
            # watchdog resolves the refs to TaskTimeoutError at expiry and
            # the store's first-write-wins makes the late result a no-op.
            # (The cluster backend actually kills the worker process.)
            from ..exceptions import TaskTimeoutError

            def _expire():
                self._store_error(spec, TaskTimeoutError(
                    task_id=spec.task_id.hex()[:16],
                    timeout_s=spec.timeout_s))
                self.events.record(
                    "task_deadline", spec.function.repr_name,
                    time.monotonic(), time.monotonic(),
                    task_id=spec.task_id.hex())

            timer = threading.Timer(float(spec.timeout_s), _expire)
            timer.daemon = True
            timer.start()
        try:
            args, kwargs = self._resolve_args_from_spec(spec)
            result = call(args, kwargs)
            self._store_returns(spec, result)
            self.stats["tasks_finished"] += 1
            self._unpin_args(spec.dependencies())
        except BaseException as e:  # noqa: BLE001 - task errors are data
            # Retry semantics match the reference (task_manager.cc): only
            # *system* failures (worker crash / node death) consume
            # max_retries; application exceptions are stored immediately.
            # In this in-process runtime tasks cannot crash a worker, so the
            # retry path is exercised by the cluster backend.
            from ..exceptions import WorkerCrashedError

            if (isinstance(e, WorkerCrashedError) and pending is not None
                    and pending.retries_left > 0):
                pending.retries_left -= 1
                rec = self._task_records.get(spec.task_id.hex())
                if rec is not None:  # retried: back to the pending state
                    rec["state"] = "PENDING"
                self._enqueue_ready(pending)
                return
            final_state = "FAILED"
            self.stats["tasks_failed"] += 1
            if isinstance(e, (TaskError, ActorDiedError,
                              ReplicaUnavailableError)):
                err = e  # propagate the original failure through chains
            else:
                err = TaskError(spec.function.repr_name, e)
            self._store_error(spec, err)
            self._unpin_args(spec.dependencies())
        finally:
            if timer is not None:
                timer.cancel()
            now = time.monotonic()
            # Exec window + terminal stamps (ts_finish already set if
            # the deadline watchdog or a cancel got there first).
            self._stamp_terminal(spec, final_state,
                                 (w0, time.time()), now - t0)
            self.events.record(
                "task", spec.function.repr_name, t0, now,
                task_id=spec.task_id.hex(),
            )
            trace = spec.metadata.get("trace")
            if trace:
                self.events.record(
                    "phase", "worker_exec", t0, now,
                    trace=trace, task_id=spec.task_id.hex())

    # -------------------------------------------------------------- arguments
    def _resolve_args_from_spec(self, spec: TaskSpec) -> Tuple[list, dict]:
        args = []
        for kind, val in spec.args:
            if kind == "ref":
                obj = self.store.get([val])[0]
                if obj.error is not None:
                    raise obj.error
                args.append(obj.value)
            else:
                args.append(val)
        kwargs = spec.metadata.get("kwargs", {})
        resolved_kwargs = {}
        for k, v in kwargs.items():
            if isinstance(v, ObjectRef):
                obj = self.store.get([v.id])[0]
                if obj.error is not None:
                    raise obj.error
                resolved_kwargs[k] = obj.value
            else:
                resolved_kwargs[k] = v
        return args, resolved_kwargs

    def _resolve_args(self, args, kwargs) -> Tuple[list, dict]:
        out = []
        for a in args:
            if isinstance(a, ObjectRef):
                obj = self.store.get([a.id])[0]
                if obj.error is not None:
                    raise obj.error
                out.append(obj.value)
            else:
                out.append(a)
        out_k = {}
        for k, v in (kwargs or {}).items():
            if isinstance(v, ObjectRef):
                obj = self.store.get([v.id])[0]
                if obj.error is not None:
                    raise obj.error
                out_k[k] = obj.value
            else:
                out_k[k] = v
        return out, out_k

    # ---------------------------------------------------------------- returns
    def _store_returns(self, spec: TaskSpec, result: Any):
        oids = spec.return_ids()
        if len(oids) == 1:
            self.store.put(oids[0], StoredObject(value=result, nbytes=_sizeof(result)))
            self._gc_if_unreferenced(spec, oids)
            return
        if not isinstance(result, tuple) or len(result) != len(oids):
            raise ValueError(
                f"task {spec.function.repr_name} declared num_returns="
                f"{len(oids)} but returned {type(result).__name__}"
            )
        for oid, value in zip(oids, result):
            self.store.put(oid, StoredObject(value=value, nbytes=_sizeof(value)))
        self._gc_if_unreferenced(spec, oids)

    def _store_error(self, spec: TaskSpec, error: BaseException):
        # Every error path is a terminal lifecycle transition — cancel,
        # deadline expiry, task exception, dead-actor fail — so the
        # record is stamped here, at the single sink they all share.
        self._stamp_terminal(spec, "FAILED")
        oids = spec.return_ids()
        for oid in oids:
            self.store.put(oid, StoredObject(error=error))
        self._gc_if_unreferenced(spec, oids)

    def _gc_if_unreferenced(self, spec: TaskSpec, oids) -> None:
        """Free return objects whose refs all died before the task finished
        (the reference's owner deletes such returns on completion too)."""
        if not self.config.ref_counting_enabled or spec.is_actor_creation:
            return  # creation markers have no user-visible ObjectRef
        dead = []
        with self._ref_lock:
            for oid in oids:
                if (self._local_refs.get(oid, 0) == 0
                        and self._arg_pins.get(oid, 0) == 0):
                    dead.append(oid)
        if dead:
            self.store.delete(dead)

    # ----------------------------------------------------------------- actors
    def _release_actor_resources(self, actor: "LocalActor"):
        """Release an actor's lifetime resources exactly once."""
        with self._lock:
            if actor.resources_released or actor.lifetime_resources.is_empty():
                actor.resources_released = True
                return
            actor.resources_released = True
            self.node.release(actor.lifetime_resources)
            self._resource_cv.notify_all()
        self._dispatch()

    def create_actor(self, cls: type, spec: TaskSpec, args, kwargs) -> ActorID:
        actor = LocalActor(
            spec.actor_id, spec.name, self,
            max_concurrency=spec.max_concurrency,
            is_asyncio=spec.is_asyncio,
            lifetime_resources=spec.resources,
        )
        actor.class_info = (
            cls.__name__,
            cls.__module__,
            tuple(n for n in dir(cls) if not n.startswith("_")),
        )
        with self._lock:
            if spec.name:
                if spec.name in self._named_actors:
                    raise ValueError(f"actor name {spec.name!r} already taken")
                self._named_actors[spec.name] = spec.actor_id
            self._actors[spec.actor_id] = actor
            self._actor_seq[spec.actor_id] = itertools.count()
        # Reserve lifetime resources (may block-free fail: queue until free).
        if not spec.resources.is_empty():
            with self._resource_cv:
                while not self.node.acquire(spec.resources):
                    self._resource_cv.wait(timeout=1.0)
        actor.start(spec, cls, args, kwargs)
        return spec.actor_id

    def submit_actor_task(self, spec: TaskSpec) -> List[ObjectRef]:
        refs = [ObjectRef(oid) for oid in spec.return_ids()]
        self._pin_args(spec.dependencies())
        with self._lock:
            actor = self._actors.get(spec.actor_id)
            seq = self._actor_seq.get(spec.actor_id)
        if actor is None:
            self._stamp_terminal(spec, "FAILED")
            for oid in spec.return_ids():
                self.store.put(oid, StoredObject(error=ActorDiedError(spec.actor_id)))
            self._unpin_args(spec.dependencies())
            return refs
        self._task_record(spec)  # ts_submit at enqueue, not dispatch
        actor.submit(next(seq), spec)
        return refs

    def get_actor(self, name: str) -> ActorID:
        with self._lock:
            actor_id = self._named_actors.get(name)
        if actor_id is None:
            raise ValueError(f"no actor named {name!r}")
        return actor_id

    def actor_handle_alive(self, actor_id: ActorID) -> bool:
        with self._lock:
            actor = self._actors.get(actor_id)
        return actor is not None and not actor.dead

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        with self._lock:
            actor = self._actors.get(actor_id)
        if actor is None:
            return
        restarting = actor.kill(no_restart)
        if restarting:
            return  # actor keeps its resources, name, and handle validity
        self._release_actor_resources(actor)  # idempotent on repeated kill()
        with self._lock:
            if actor.name:
                self._named_actors.pop(actor.name, None)

    def actor_class_info(self, actor_id: ActorID):
        with self._lock:
            actor = self._actors.get(actor_id)
        if actor is None:
            raise ValueError(f"unknown actor {actor_id}")
        return actor.class_info

    # ---------------------------------------------------------------- objects
    def put(self, value: Any) -> ObjectRef:
        ctx = ensure_context(self)
        oid = ObjectID.for_put(ctx.current_task_id, next(ctx.put_counter))
        self.store.put(oid, StoredObject(value=value, nbytes=_sizeof(value)))
        return ObjectRef(oid)

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        oids = [r.id for r in refs]
        objs = self._blocking_get(oids, timeout)
        out = []
        for obj in objs:
            if obj.error is not None:
                raise obj.error
            out.append(obj.value)
        return out

    def _blocking_get(self, oids: Sequence[ObjectID], timeout: Optional[float]):
        """Get that releases the calling task's resources while blocked.

        Reference protocol: HandleDirectCallTaskBlocked/Unblocked
        (node_manager.h:385-392). On unblock we oversubscribe rather than wait,
        exactly as the reference re-acquires CPU for unblocked workers.
        """
        if all(self.store.contains(oid) for oid in oids):
            return self.store.get(oids, timeout=0.01)
        ctx = current_context()
        released = None
        if ctx is not None and ctx.acquired is not None and not ctx.acquired.is_empty():
            released = ctx.acquired
            with self._lock:
                self.node.release(released)
                self._resource_cv.notify_all()
            self._dispatch()
        try:
            return self.store.get(oids, timeout=timeout)
        finally:
            if released is not None:
                with self._lock:
                    # Oversubscribe: force re-acquire without waiting.
                    self.node.available = self.node.available.subtract(released)

    def wait(self, refs: Sequence[ObjectRef], num_returns: int,
             timeout: Optional[float]) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        oids = [r.id for r in refs]
        by_id = {r.id: r for r in refs}
        ready, rest = self.store.wait(oids, num_returns, timeout)
        return [by_id[o] for o in ready], [by_id[o] for o in rest]

    def as_future(self, ref: ObjectRef) -> Future:
        fut: Future = Future()

        def on_ready(_oid):
            obj = self.store.get_if_exists(ref.id)
            if obj.error is not None:
                fut.set_exception(obj.error)
            else:
                fut.set_result(obj.value)

        self.store.on_available(ref.id, on_ready)
        return fut

    def cancel(self, ref: ObjectRef, force: bool = False):
        task_id = ref.id.task_id()
        with self._lock:
            pending = self._pending.get(task_id)
            if pending is None or pending.cancelled:
                return  # unknown, finished, or already cancelled
            pending.cancelled = True
            # Admission (future = _ADMITTED) happens under this lock in
            # _dispatch; once admitted, _run_task owns the error/unpin.
            not_admitted = pending.future is None
        if not_admitted:
            self._store_error(pending.spec, TaskCancelledError(task_id))
            self._unpin_args(pending.spec.dependencies())

    # ------------------------------------------------------------------ state
    def cluster_resources(self) -> Dict[str, float]:
        return self.node.total.to_dict()

    def available_resources(self) -> Dict[str, float]:
        with self._lock:
            return self.node.available.to_dict()

    def nodes(self) -> List[Dict[str, Any]]:
        return [{
            "NodeID": self.node_id.hex(),
            "Alive": True,
            "Resources": self.node.total.to_dict(),
        }]

    def actors(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {
                aid.hex(): {
                    "ActorID": aid.hex(),
                    "State": "DEAD" if a.dead else "ALIVE",
                    "Name": a.name,
                }
                for aid, a in self._actors.items()
            }

    def set_resource(self, name: str, capacity: float) -> None:
        """Create/update/delete a custom resource at runtime (reference:
        python/ray/experimental/dynamic_resources.py via raylet).
        Re-runs dispatch: a queued task demanding the new resource must be
        admitted now, not at the next unrelated completion."""
        fixed = int(round(capacity * 1000))
        with self._resource_cv:
            old_total = self.node.total.custom.get(name, 0)
            delta = fixed - old_total
            new_total = dict(self.node.total.custom)
            new_avail = dict(self.node.available.custom)
            if fixed == 0:
                new_total.pop(name, None)
                new_avail.pop(name, None)
            else:
                new_total[name] = fixed
                new_avail[name] = new_avail.get(name, 0) + delta
            self.node.total = ResourceSet(self.node.total.predefined,
                                          new_total)
            self.node.available = ResourceSet(self.node.available.predefined,
                                              new_avail)
            self._resource_cv.notify_all()
        self._dispatch()

    def next_task_id(self) -> TaskID:
        ctx = ensure_context(self)
        return TaskID.for_normal_task(
            ctx.job_id, ctx.current_task_id, next(ctx.task_counter)
        )

    # -------------------------------------------------------- placement groups
    def _pg_apply_custom(self, grants: Dict[str, float], sign: int) -> None:
        """Add (+1) / remove (-1) group-scoped custom resources on this
        node. Caller holds _resource_cv."""
        new_total = dict(self.node.total.custom)
        new_avail = dict(self.node.available.custom)
        for name, qty in grants.items():
            fixed = sign * int(round(qty * KILO))
            if sign > 0:
                new_total[name] = new_total.get(name, 0) + fixed
                new_avail[name] = new_avail.get(name, 0) + fixed
            else:
                new_total.pop(name, None)
                new_avail.pop(name, None)
        self.node.total = ResourceSet(self.node.total.predefined, new_total)
        self.node.available = ResourceSet(
            self.node.available.predefined, new_avail)

    def create_placement_group(self, pg_id: bytes, bundles, strategy: str,
                               name: str = "") -> None:
        """Single-node gang admission: all bundles must co-reside here, so
        the gang fits iff the bundle SUM fits (all-or-nothing by
        construction) — except STRICT_SPREAD with more than one bundle,
        which can never be satisfied by one node and is INFEASIBLE."""
        total = {}
        for b in bundles:
            for k, v in b.items():
                total[k] = total.get(k, 0.0) + v
        total_set = ResourceSet.from_dict(total)
        rec = {
            "pg_id": pg_id, "bundles": [dict(b) for b in bundles],
            "strategy": strategy, "name": name, "state": "PENDING",
            "reason": "", "nodes": [], "created": threading.Event(),
            "base": total_set,
        }
        with self._lock:
            self._placement_groups[pg_id] = rec
        if (strategy == "STRICT_SPREAD" and len(bundles) > 1) or \
                not total_set.is_subset_of(self.node.total):
            rec["reason"] = "infeasible"
            return
        threading.Thread(target=self._pg_admit_local, args=(rec,),
                         daemon=True,
                         name=f"pg-{pg_id.hex()[:8]}").start()

    def _pg_admit_local(self, rec: Dict[str, Any]) -> None:
        from .resources import pg_bundle_grants

        with self._resource_cv:
            while rec["state"] == "PENDING" and \
                    not self.node.acquire(rec["base"]):
                rec["reason"] = "waiting-for-capacity"
                self._resource_cv.wait(timeout=0.5)
            if rec["state"] != "PENDING":
                if rec.get("base_acquired"):
                    self.node.release(rec["base"])
                return
            rec["base_acquired"] = True
            grants: Dict[str, float] = {}
            for g in pg_bundle_grants(rec["bundles"], rec["pg_id"].hex()):
                for k, v in g.items():
                    grants[k] = grants.get(k, 0.0) + v
            rec["grants"] = grants
            self._pg_apply_custom(grants, +1)
            rec["state"] = "CREATED"
            rec["reason"] = ""
            rec["nodes"] = [self.node_id.hex()] * len(rec["bundles"])
            self._resource_cv.notify_all()
        rec["created"].set()
        self._dispatch()

    def remove_placement_group(self, pg_id: bytes) -> None:
        from ..exceptions import PlacementGroupError

        with self._lock:
            rec = self._placement_groups.get(pg_id)
        if rec is None:
            return
        with self._resource_cv:
            was_created = rec["state"] == "CREATED"
            rec["state"] = "REMOVED"
            if was_created:
                self._pg_apply_custom(rec.get("grants", {}), -1)
                self.node.release(rec["base"])
                rec["base_acquired"] = False
            self._resource_cv.notify_all()
        # Fail queued tasks pinned to the removed group: their demands can
        # never be admitted again (the group names are gone from totals).
        marker = "_group_"
        hexid = pg_id.hex()
        victims: List[PendingTask] = []
        with self._lock:
            for klass in list(self._ready.keys()):
                _, custom = klass
                if any(marker in k and k.endswith(hexid)
                       for k, _v in custom):
                    dq = self._ready.pop(klass)
                    victims.extend(dq)
        for p in victims:
            p.cancelled = True
            self._store_error(p.spec, PlacementGroupError(
                f"placement group {hexid[:12]} was removed"))
            self._unpin_args(p.spec.dependencies())
        self._dispatch()

    def placement_group_wait(self, pg_id: bytes,
                             timeout: Optional[float] = None) -> bool:
        with self._lock:
            rec = self._placement_groups.get(pg_id)
        if rec is None:
            return False
        rec["created"].wait(timeout)
        return rec["state"] == "CREATED"

    def placement_group_table(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            recs = list(self._placement_groups.values())
        return {
            rec["pg_id"].hex(): {
                "state": rec["state"], "strategy": rec["strategy"],
                "name": rec["name"], "bundles": rec["bundles"],
                "nodes": list(rec["nodes"]), "reason": rec["reason"],
            }
            for rec in recs
        }

    def shutdown(self):
        with self._lock:
            self._shutdown = True
            actors = list(self._actors.values())
        for actor in actors:
            actor.kill()
        self._pool.shutdown(wait=False, cancel_futures=True)
        if self._spiller is not None:
            self._spiller.close(remove=True)
        from . import flight_recorder

        rec = flight_recorder.get()
        if rec is not None and rec.component == "driver":
            flight_recorder.stop()


def _sizeof(value: Any) -> int:
    """Bytes a value holds against ``object_store_memory``: a tensor's or
    array's ``nbytes`` (a CUDA tensor's too, as the reference counts device
    arrays), else 64."""
    try:
        import numpy as np

        if isinstance(value, np.ndarray):
            return value.nbytes
        if hasattr(value, "nbytes"):
            return int(value.nbytes)
        if isinstance(value, (bytes, bytearray)):
            return len(value)
    except Exception:  # pragma: no cover
        pass
    return 64  # nominal accounting for small python objects

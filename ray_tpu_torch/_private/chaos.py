"""Fault-injection harness for cluster chaos testing.

Reference counterpart: Ray's ``ray._private.test_utils`` failure helpers +
the chaos-testing ``NodeKillerActor`` — collapsed into one env-driven
module so any process in the cluster can be told to misbehave without code
changes. The head-failover soak scenario and the chaos-matrix tests drive
these knobs; ``docs/devtools.md`` documents them.

Env knobs (all off by default; read once at :func:`install_from_env`):

``RAY_TPU_TORCH_CHAOS_DROP_FRAME_P``
    Probability in [0, 1] that an inbound RPC frame is dropped on the
    floor by the server (the sender sees a timeout, not an error — the
    lost-oneway / lost-request case).
``RAY_TPU_TORCH_CHAOS_DELAY_FRAME_P`` / ``RAY_TPU_TORCH_CHAOS_DELAY_FRAME_MS``
    Probability that an inbound frame is delayed, and the maximum delay in
    milliseconds (uniform in [0, max]).
``RAY_TPU_TORCH_CHAOS_PARTITION_NODE``
    Node-id prefix to partition: every frame arriving on a connection that
    registered that node is dropped (a one-way network partition as seen
    from this server).
``RAY_TPU_TORCH_CHAOS_KILL_HEAD_AFTER_S``
    In a head process: SIGKILL the whole process after N seconds (the hard
    leader-death drill).
``RAY_TPU_TORCH_CHAOS_PAUSE_HEAD_AFTER_S`` / ``RAY_TPU_TORCH_CHAOS_PAUSE_HEAD_S``
    In a head process: SIGSTOP after N seconds, SIGCONT after a further M
    seconds (default 10) — the deposed-leader/split-brain drill: the head
    wakes up believing it still leads and must find its lease stolen.
``RAY_TPU_TORCH_CHAOS_KILL_WORKER_EVERY_S``
    In a controller process: SIGKILL one random live worker process every
    N seconds (armed controller-side in ``Controller.start``) — the
    blast-radius drill: blame attribution, collateral re-drive, and the
    poison-quarantine counters all run under it.
``RAY_TPU_TORCH_CHAOS_KILL_REPLICA_EVERY_S``
    In a serve driver: kill one random replica of a backend every N
    seconds (armed by :func:`arm_replica_killer`, driven by
    ``scripts/serve_soak.py``) — the self-healing fleet drill: failover
    routing, stream fast-fail, and replica auto-replacement all run
    under it.
``RAY_TPU_TORCH_CHAOS_SEED``
    Deterministic RNG seed for the drop/delay draws.

Hostile-task helpers (:func:`hostile_hang`, :func:`hostile_segfault`,
:func:`hostile_oom`) are plain functions meant to be submitted as remote
tasks by chaos workloads (``scripts/soak.py hostile_workload``, the
containment test suite): a hanger for the deadline killer, a
crash-looper for quarantine, an allocator bomb for the OOM guard.
"""

from __future__ import annotations

import os
import random
import signal
import threading
from typing import Optional


def _env_f(name: str, default: float = 0.0) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class Chaos:
    """One process's installed fault plan. Decision methods are cheap and
    called from the server's event loop; timers run on daemon threads."""

    def __init__(self, drop_p: float = 0.0, delay_p: float = 0.0,
                 delay_max_ms: float = 0.0, partition_node: str = "",
                 seed: Optional[int] = None):
        self.drop_p = max(0.0, min(1.0, drop_p))
        self.delay_p = max(0.0, min(1.0, delay_p))
        self.delay_max_s = max(0.0, delay_max_ms) / 1000.0
        self.partition_node = partition_node
        self._rng = random.Random(seed)
        # Counters for tests/postmortems (single-threaded loop updates).
        self.dropped = 0
        self.delayed = 0

    def should_drop_frame(self, conn_meta: Optional[dict] = None) -> bool:
        """Drop decision for one inbound frame (server side)."""
        if self.partition_node and conn_meta is not None:
            nid = str(conn_meta.get("node_id") or "")
            if nid and nid.startswith(self.partition_node):
                self.dropped += 1
                return True
        if self.drop_p > 0.0 and self._rng.random() < self.drop_p:
            self.dropped += 1
            return True
        return False

    def frame_delay_s(self) -> float:
        """Extra latency to inject before handling one frame (0 = none)."""
        if self.delay_p > 0.0 and self._rng.random() < self.delay_p:
            self.delayed += 1
            return self._rng.uniform(0.0, self.delay_max_s)
        return 0.0

    @property
    def active(self) -> bool:
        return bool(self.drop_p or self.delay_p or self.partition_node)


# The process-wide plan. Written once by install_from_env() before the
# server starts serving, read by the protocol layer per frame.
_active: Optional[Chaos] = None


def get() -> Optional[Chaos]:
    return _active


def install_from_env() -> Optional[Chaos]:
    """Read the env knobs; install and return a plan when any is set."""
    global _active
    plan = Chaos(
        drop_p=_env_f("RAY_TPU_TORCH_CHAOS_DROP_FRAME_P"),
        delay_p=_env_f("RAY_TPU_TORCH_CHAOS_DELAY_FRAME_P"),
        delay_max_ms=_env_f("RAY_TPU_TORCH_CHAOS_DELAY_FRAME_MS"),
        partition_node=os.environ.get("RAY_TPU_TORCH_CHAOS_PARTITION_NODE", ""),
        seed=int(_env_f("RAY_TPU_TORCH_CHAOS_SEED")) or None,
    )
    if plan.active:
        _active = plan
        return plan
    return None


def uninstall() -> None:
    global _active
    _active = None


# ------------------------------------------------------------ hostile tasks
# Helpers submitted AS tasks by chaos workloads. Top-level functions so
# they pickle by reference; each models one blast-radius failure mode.

def hostile_hang(seconds: float = 3600.0) -> str:
    """Run (far) past any sane deadline — the deadline killer's prey.
    Returns only if nothing killed it (a containment failure)."""
    import time as _time

    _time.sleep(seconds)
    return "hung task survived"


def hostile_segfault() -> None:
    """Die with SIGSEGV, taking the worker process with it — the
    poison-quarantine counter's prey (3 strikes by default)."""
    os.kill(os.getpid(), signal.SIGSEGV)


def hostile_exit(code: int = 13) -> None:
    """Hard-exit the worker without a signal (os._exit skips every
    finally/atexit) — the exit-code blame-classification case."""
    os._exit(code)


def hostile_oom(target_bytes: int = 1 << 30,
                step_bytes: int = 32 << 20,
                hold_s: float = 60.0) -> str:
    """Allocate RSS in steps up to ``target_bytes`` and sit on it — the
    OOM guard's prey: declare a small ``memory`` resource and grow well
    past it. Real pages (bytearrays are touched), so the RSS sampler
    sees the growth."""
    import time as _time

    hoard = []
    held = 0
    while held < target_bytes:
        block = bytearray(min(step_bytes, target_bytes - held))
        for i in range(0, len(block), 4096):
            block[i] = 1  # touch every page: reserved != resident
        hoard.append(block)
        held += len(block)
        _time.sleep(0.01)
    _time.sleep(hold_s)
    return f"oom bomb survived holding {held} bytes"


# ---------------------------------------------------------------- process
# helpers: kill / pause / resume by pid (the head-failover drill and
# `cli kill_random_node --head` use these; SIGSTOP/SIGCONT model a hung —
# not dead — leader, the split-brain case fencing must win).

def kill_process(pid: int) -> bool:
    try:
        os.kill(pid, signal.SIGKILL)
        return True
    except (OSError, ProcessLookupError):
        return False


def pause_process(pid: int) -> bool:
    try:
        os.kill(pid, signal.SIGSTOP)
        return True
    except (OSError, ProcessLookupError):
        return False


def resume_process(pid: int) -> bool:
    try:
        os.kill(pid, signal.SIGCONT)
        return True
    except (OSError, ProcessLookupError):
        return False


def arm_replica_killer(master: object, backend_tag: str,
                       every_s: float = 0.0,
                       stop: Optional[threading.Event] = None,
                       on_kill=None) -> threading.Event:
    """In a serve driver: kill one RANDOM live replica of ``backend_tag``
    every ``every_s`` seconds (env ``RAY_TPU_TORCH_CHAOS_KILL_REPLICA_EVERY_S``
    when 0) until the returned Event is set. The self-healing drill:
    each kill must produce a router failover + a master replacement, not
    a client-visible failure. ``on_kill(handle)`` is called after each
    kill (soaks count kills survived)."""
    import ray_tpu_torch

    stop = stop or threading.Event()
    every_s = every_s or _env_f("RAY_TPU_TORCH_CHAOS_KILL_REPLICA_EVERY_S")
    if every_s <= 0:
        stop.set()
        return stop
    rng = random.Random(int(_env_f("RAY_TPU_TORCH_CHAOS_SEED")) or None)

    def _loop():
        while not stop.wait(every_s):
            try:
                replicas = ray_tpu_torch.get(
                    master.get_replicas.remote(backend_tag))
                if not replicas:
                    continue
                victim = rng.choice(replicas)
                ray_tpu_torch.kill(victim)
                if on_kill is not None:
                    on_kill(victim)
            except Exception:  # noqa: BLE001 - chaos must not crash the soak
                if not ray_tpu_torch.is_initialized():
                    return

    t = threading.Thread(target=_loop, name="chaos-replica-killer",
                         daemon=True)
    t.start()
    return stop


def arm_head_timers() -> None:
    """In a head process: arm the self-kill / self-pause timers from the
    env knobs. Daemon threads so they never block shutdown."""
    kill_after = _env_f("RAY_TPU_TORCH_CHAOS_KILL_HEAD_AFTER_S")
    if kill_after > 0:
        t = threading.Timer(kill_after, kill_process, args=(os.getpid(),))
        t.daemon = True
        t.start()
    pause_after = _env_f("RAY_TPU_TORCH_CHAOS_PAUSE_HEAD_AFTER_S")
    if pause_after > 0:
        pause_s = _env_f("RAY_TPU_TORCH_CHAOS_PAUSE_HEAD_S", 10.0)

        def _pause_then_resume():
            pid = os.getpid()
            resume = threading.Timer(pause_s, resume_process, args=(pid,))
            resume.daemon = True
            resume.start()  # armed BEFORE the stop: we can't run while stopped
            pause_process(pid)

        t = threading.Timer(pause_after, _pause_then_resume)
        t.daemon = True
        t.start()

"""Event-loop observatory: per-loop lag/dwell/callback attribution plus
per-thread off-CPU truth from ``/proc/self/task/*`` (reference: the role
``aiodebug``/``aiomonitor`` play for asyncio loops and the off-CPU
discipline of BPF wall-clock profilers, shrunk to stdlib + procfs — the
measure-then-act lineage of arXiv:1712.05889 applied to our own control
plane).

Why: in the reference's measurements the GCS *handlers* cost 2–8 µs/task
while the phase table still charged ~150 µs/task to ``submit_rpc`` — the
wall cost lives in select dwell, callback scheduling, loop lag and
GIL/ctx-switch waits that no handler timer can see. Two instruments close
that gap:

* :class:`LoopMonitor` — installed on a *running* asyncio loop. A
  high-frequency heartbeat (``HB_MS``, 50 ms) measures **loop lag** (scheduled-vs-actual wakeup delta, the queueing
  delay every callback on that loop inherits); the selector's ``select``
  is wrapped to split wall time into **poll dwell** (waiting for IO/
  timers) vs **callback run** — the run side is the exact gap between
  one poll's exit and the next poll's entry, so the aggregate split
  costs nothing per callback. Individual callbacks are wrapped at a
  1-in-N sample (``SAMPLE``, 32; asyncio emits a
  ``call_soon`` per task step, so wrapping every one is the difference
  between <1% and ~3% warm-throughput cost) purely to *name* entries in
  the top-N slow-callback ledger (threshold ``SLOW_MS``, 20 ms); timers stay always-wrapped (rare, often interesting).
* :class:`ThreadCpuSampler` — per-thread utime+stime and voluntary/
  involuntary context-switch deltas from ``/proc/self/task/*``, the
  off-CPU ground truth the flight recorder's on-CPU stack tagging and
  the ``cli top`` on/off-CPU split rows are built on.

Both drain on the existing 2 s stats cadence (no timers of their own);
``RAY_TPU_TORCH_LOOPMON=0`` is the kill switch — ``install()`` becomes a no-op
and the loops run exactly the untouched stock code paths.

The port's copy of ``ray_tpu/_private/loopmon.py``, with the kill switch
under the ``RAY_TPU_TORCH_`` prefix and the reference's heartbeat,
threshold and sample knobs as the constants below. The local runtime reaches only
``enabled()`` and ``thread_cpu_ns()`` (the flight recorder's on-CPU
tagging); the cluster's GCS, controllers and workers install the loop
monitors and the thread CPU sampler. The reference's ``get()`` and
``LoopMonitor.snapshot()``, which nothing of the port calls, are left
out.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from typing import Any, Dict, List, Optional

HB_MS = 50.0                # heartbeat cadence (loop-lag probe)
SLOW_MS = 20.0              # slow-callback ledger threshold
SAMPLE = 32                 # time 1-in-N callbacks (naming only)
MAX_SLOW_NAMES = 64         # slow-callback ledger entries
OVERFLOW_KEY = "<overflow>"

# Histogram boundaries for loop-lag samples (ms). str keys match the
# timeseries hist-cell convention (quantile_from_hist float()s them).
LAG_BOUNDS_MS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 1000.0)

_lock = threading.Lock()
_monitors: Dict[str, "LoopMonitor"] = {}
_cpu_sampler: Optional["ThreadCpuSampler"] = None


def enabled() -> bool:
    """Process-wide kill switch (``RAY_TPU_TORCH_LOOPMON=0``)."""
    return os.environ.get("RAY_TPU_TORCH_LOOPMON", "1") not in ("", "0")


def thread_cpu_ns(tid: int) -> Optional[int]:  # raylint: hotpath
    """Nanoseconds this native thread has spent on-CPU (schedstat field
    0 — updated at context-switch granularity, so even sub-tick runs
    register, unlike the 10 ms utime/stime ticks). None off-Linux or for
    an exited thread."""
    try:
        with open(f"/proc/self/task/{tid}/schedstat", "rb") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None


# Name cache keyed by the underlying code object (Task steps and bound
# methods recur with fresh wrappers but one stable code identity — same
# per-code-object caching discipline as the flight recorder's folder).
_name_cache: Dict[Any, str] = {}
_NAME_CACHE_MAX = 4096


def _cb_name(cb: Any) -> str:
    """Stable attribution key for a loop callback: partials unwrap to
    their target, ``Task.__step`` resolves to the coroutine's code name
    (the thing a human can grep for), everything else its qualname."""
    while isinstance(cb, functools.partial):
        cb = cb.func
    owner = getattr(cb, "__self__", None)
    if owner is not None and hasattr(owner, "get_coro"):
        try:
            coro = owner.get_coro()
            code = getattr(coro, "cr_code", None) or \
                getattr(coro, "gi_code", None)
            if code is not None:
                name = _name_cache.get(code)
                if name is None:
                    if len(_name_cache) >= _NAME_CACHE_MAX:
                        _name_cache.clear()
                    name = _name_cache[code] = f"task:{code.co_name}"
                return name
        except Exception:  # noqa: BLE001 - naming must never raise
            pass
    key = getattr(cb, "__func__", cb)
    try:
        name = _name_cache.get(key)
    except TypeError:
        key = None
        name = None
    if name is None:
        name = (getattr(cb, "__qualname__", "")
                or getattr(cb, "__name__", "") or type(cb).__name__)
        if key is not None:
            if len(_name_cache) >= _NAME_CACHE_MAX:
                _name_cache.clear()
            _name_cache[key] = name
    return name


class LoopMonitor:
    """Instrumented asyncio loop: lag heartbeat + exact dwell/run split
    (from poll boundaries) + a sampled slow-callback ledger.

    All counters are written from the loop's own thread (the wrappers run
    there) and drained from a coroutine on the same loop, so the hot
    increments need no lock; a racy external ``snapshot()`` at worst
    reads a torn window, never corrupts one.
    """

    def __init__(self, component: str, loop):
        self.component = component
        self.loop = loop
        self.hb_s = HB_MS / 1000.0
        self.slow_s = SLOW_MS / 1000.0
        self.sample = SAMPLE
        self.installed = False
        self._orig: Dict[str, Any] = {}
        self._hb_handle = None
        self._hb_expected = 0.0
        self._t_window0 = time.perf_counter()
        # Sampling tick, shared by every wrap site. call_soon_threadsafe
        # mutates it off-loop: a torn increment only skews WHICH callback
        # gets sampled, never the exact aggregates.
        self._tick = 0
        self._sel_exit = 0.0        # perf_counter at last select() exit
        # -- window accumulators (reset by drain) --
        self._dwell_s = 0.0
        self._polls = 0
        self._run_s = 0.0           # exact: inter-poll (non-dwell) wall
        self._cb_count = 0          # estimate: sample-weighted
        self._slow: Dict[str, List[float]] = {}       # name -> [n, sec, max]
        self._lag_buckets: Dict[str, int] = {}
        self._lag_sum_ms = 0.0
        self._lag_count = 0
        self._lag_max_ms = 0.0
        self._queue_max = 0

    # ------------------------------------------------------------ install
    def install(self) -> bool:
        """Wrap the loop's scheduling surface and start the heartbeat.
        Must run on (or before) the loop's own thread; idempotent."""
        if self.installed:
            return False
        loop = self.loop
        self._wrap_selector(loop)
        for meth in ("call_soon", "call_soon_threadsafe",
                     "call_later", "call_at"):
            self._wrap_sched(loop, meth, cb_pos=1)
        for meth in ("_add_reader", "_add_writer"):
            self._wrap_sched(loop, meth, cb_pos=1)
        self._hb_expected = loop.time() + self.hb_s
        self._hb_handle = loop.call_at(self._hb_expected, self._beat)
        self.installed = True
        return True

    def uninstall(self) -> None:
        """Restore every wrapped attribute; the loop reverts to stock
        scheduling (kill-switch semantics, pinned by tests)."""
        if self._hb_handle is not None:
            try:
                self._hb_handle.cancel()
            except Exception:  # noqa: BLE001
                pass
            self._hb_handle = None
        loop = self.loop
        sel = getattr(loop, "_selector", None)
        if sel is not None and "select" in self._orig:
            try:
                sel.select = self._orig.pop("select")
            except (AttributeError, TypeError):
                self._orig.pop("select", None)
        for meth, orig in list(self._orig.items()):
            try:
                delattr(loop, meth)
            except AttributeError:
                pass
        self._orig.clear()
        self.installed = False

    def _wrap_selector(self, loop) -> None:
        sel = getattr(loop, "_selector", None)
        if sel is None:
            return
        orig_select = sel.select

        def timed_select(timeout=None):  # raylint: hotpath
            t0 = time.perf_counter()
            # The stretch since the previous poll's exit is exactly the
            # wall the loop spent OUT of select: callbacks + loop
            # bookkeeping. This is the aggregate run/dwell split, at
            # zero per-callback cost.
            prev = self._sel_exit
            if prev:
                self._run_s += t0 - prev
            try:
                return orig_select(timeout)
            finally:
                t1 = time.perf_counter()
                self._sel_exit = t1
                self._dwell_s += t1 - t0
                self._polls += 1

        try:
            sel.select = timed_select
            self._orig["select"] = orig_select
        except (AttributeError, TypeError):
            pass  # exotic selector: dwell stays unmeasured, rest works

    def _wrap_sched(self, loop, meth: str, cb_pos: int) -> None:
        orig = getattr(loop, meth, None)
        if orig is None:
            return

        if meth in ("call_soon", "call_soon_threadsafe"):
            # One-shot callbacks at task-step frequency: the wrapper
            # closure allocation IS the cost, so only every Nth
            # scheduled callback gets one (weighted back up on drain).
            def sched(callback, *args, _orig=orig, **kw):  # raylint: hotpath
                t = self._tick + 1
                if t >= self.sample:
                    self._tick = 0
                    callback = self._timed(callback, self.sample)
                else:
                    self._tick = t
                return _orig(callback, *args, **kw)
        elif meth in ("call_later", "call_at"):
            # Timers are rare and often interesting (stats loops, GC
            # nudges, retry backoffs): always timed, weight 1.
            def sched(when, callback, *args, _orig=orig, **kw):
                return _orig(when, self._timed(callback), *args, **kw)
        else:
            # _add_reader/_add_writer: ONE registration serves every IO
            # event on the fd for the connection's lifetime, so the
            # (single) persistent wrapper samples per *invocation*.
            def sched(fd, callback, *args, _orig=orig, **kw):
                return _orig(fd, self._timed_events(callback),
                             *args, **kw)

        setattr(loop, meth, sched)
        self._orig[meth] = orig

    def _record(self, name: str, dt: float, weight: int) -> None:
        # raylint: hotpath — runs only for sampled/slow callbacks.
        self._cb_count += weight
        if dt >= self.slow_s:
            slow = self._slow
            srow = slow.get(name)
            if srow is None:
                if len(slow) >= MAX_SLOW_NAMES:
                    srow = slow.setdefault(OVERFLOW_KEY, [0, 0.0, 0.0])
                else:
                    srow = slow[name] = [0, 0.0, 0.0]
            srow[0] += 1
            srow[1] += dt
            srow[2] = max(srow[2], dt)

    def _timed(self, cb, weight: int = 1):
        """Wrap one callback with run-time + slow-ledger attribution;
        ``weight`` is how many unwrapped callbacks this sample stands
        for in the ``cb_count`` estimate."""
        if getattr(cb, "_loopmon", False):
            return cb
        name = _cb_name(cb)

        def run(*args):  # raylint: hotpath
            t0 = time.perf_counter()
            try:
                return cb(*args)
            finally:
                self._record(name, time.perf_counter() - t0, weight)

        run._loopmon = True
        return run

    def _timed_events(self, cb):
        """Persistent wrapper for reader/writer callbacks: fast path is
        one counter check per IO event; every Nth event is timed."""
        if getattr(cb, "_loopmon", False):
            return cb
        name = _cb_name(cb)

        def run(*args):  # raylint: hotpath
            t = self._tick + 1
            if t < self.sample:
                self._tick = t
                return cb(*args)
            self._tick = 0
            t0 = time.perf_counter()
            try:
                return cb(*args)
            finally:
                self._record(name, time.perf_counter() - t0, self.sample)

        run._loopmon = True
        return run

    # ---------------------------------------------------------- heartbeat
    def _beat(self) -> None:  # raylint: hotpath
        """Loop-lag probe: the delta between when this timer was due and
        when the loop actually ran it IS the queueing delay every other
        callback suffered; also samples the ready-queue depth."""
        now = self.loop.time()
        lag_ms = max(0.0, (now - self._hb_expected) * 1000.0)
        self._lag_sum_ms += lag_ms
        self._lag_count += 1
        if lag_ms > self._lag_max_ms:
            self._lag_max_ms = lag_ms
        for bound in LAG_BOUNDS_MS:
            if lag_ms <= bound:
                key = str(bound)
                break
        else:
            key = "+inf"
        self._lag_buckets[key] = self._lag_buckets.get(key, 0) + 1
        depth = len(getattr(self.loop, "_ready", ()))
        if depth > self._queue_max:
            self._queue_max = depth
        # Re-anchor from *now*: after a stall we measure fresh lag, not
        # an ever-growing backlog of missed beats.
        self._hb_expected = now + self.hb_s
        self._hb_handle = self.loop.call_at(self._hb_expected, self._beat)

    # -------------------------------------------------------------- sinks
    def drain(self) -> Dict[str, Any]:
        """Swap the window out (runs on the loop's thread via the 2 s
        stats coroutine). Returns the observatory window payload the GCS
        rolls into the time-series store."""
        now = time.perf_counter()
        out = {
            "component": self.component,
            "wall_s": max(now - self._t_window0, 1e-9),
            "dwell_s": self._dwell_s, "polls": self._polls,
            "cb_s": self._run_s, "cb_count": self._cb_count,
            "lag": {"buckets": self._lag_buckets,
                    "sum_ms": self._lag_sum_ms,
                    "count": self._lag_count,
                    "max_ms": self._lag_max_ms},
            "queue_max": self._queue_max,
            "slow": sorted(
                ([n, int(r[0]), r[1], r[2]]
                 for n, r in self._slow.items()),
                key=lambda r: -r[2])[:16],
        }
        self._t_window0 = now
        self._dwell_s = 0.0
        self._polls = 0
        self._run_s = 0.0
        self._cb_count = 0
        self._slow = {}
        self._lag_buckets = {}
        self._lag_sum_ms = 0.0
        self._lag_count = 0
        self._lag_max_ms = 0.0
        self._queue_max = 0
        return out


# --------------------------------------------------------------------------
# off-CPU truth: per-thread CPU + context-switch deltas from procfs
# --------------------------------------------------------------------------

class ThreadCpuSampler:
    """Per-window /proc/self/task/* deltas: utime+stime (CLOCK ticks) and
    voluntary/involuntary context switches per thread. One instance per
    process (``cpu_sampler()``); drained on the 2 s stats cadence, so the
    procfs walk costs ~a dozen file reads every 2 s."""

    _CLK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100

    def __init__(self, component: str = ""):
        self.component = component
        self.available = os.path.isdir("/proc/self/task")
        self._prev: Dict[int, tuple] = {}   # tid -> (cpu_s, vol, invol)
        self._t0 = time.perf_counter()

    @classmethod
    def _read_task(cls, tid: int) -> Optional[tuple]:
        """(comm, cpu_s, vol, invol) for one native thread."""
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                raw = f.read()
            comm = raw[raw.index("(") + 1:raw.rindex(")")]
            fields = raw.rsplit(")", 1)[1].split()
            cpu_s = (int(fields[11]) + int(fields[12])) / cls._CLK
            vol = invol = 0
            with open(f"/proc/self/task/{tid}/status") as f:
                for line in f:
                    if line.startswith("voluntary_ctxt"):
                        vol = int(line.split()[1])
                    elif line.startswith("nonvoluntary_ctxt"):
                        invol = int(line.split()[1])
            return comm, cpu_s, vol, invol
        except (OSError, ValueError, IndexError):
            return None

    def drain(self) -> Optional[Dict[str, Any]]:
        """One delta window over every live thread; None off-Linux."""
        if not self.available:
            return None
        now = time.perf_counter()
        wall_s = max(now - self._t0, 1e-9)
        self._t0 = now
        try:
            tids = [int(d) for d in os.listdir("/proc/self/task")]
        except (OSError, ValueError):
            return None
        total_cpu = 0.0
        total_vol = 0
        total_invol = 0
        threads: Dict[str, Dict[str, float]] = {}
        seen = set()
        for tid in tids:
            row = self._read_task(tid)
            if row is None:
                continue
            comm, cpu_s, vol, invol = row
            seen.add(tid)
            prev = self._prev.get(tid)
            self._prev[tid] = (cpu_s, vol, invol)
            if prev is None:
                # First sight: whole-life totals would mislabel the
                # window; contribute nothing until the next drain.
                continue
            d_cpu = max(0.0, cpu_s - prev[0])
            d_vol = max(0, vol - prev[1])
            d_invol = max(0, invol - prev[2])
            total_cpu += d_cpu
            total_vol += d_vol
            total_invol += d_invol
            t = threads.setdefault(
                comm, {"cpu_s": 0.0, "vol": 0, "invol": 0})
            t["cpu_s"] += d_cpu
            t["vol"] += d_vol
            t["invol"] += d_invol
        for tid in list(self._prev):
            if tid not in seen:
                del self._prev[tid]
        top = dict(sorted(threads.items(),
                          key=lambda kv: -kv[1]["cpu_s"])[:12])
        return {"wall_s": wall_s, "cpu_s": total_cpu,
                "vol": total_vol, "invol": total_invol,
                "nthreads": len(seen), "threads": top}


# --------------------------------------------------------------------------
# per-process registry (mirrors flight_recorder's singleton discipline:
# the head process hosts the GCS loop AND a colocated controller loop —
# one monitor per loop, one cpu sampler per process)
# --------------------------------------------------------------------------

def install(component: str, loop=None) -> Optional[LoopMonitor]:
    """Install (or return) the monitor for ``component``'s running loop.
    None when the kill switch is set or no loop is running."""
    if not enabled():
        return None
    if loop is None:
        import asyncio
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return None
    with _lock:
        mon = _monitors.get(component)
        if mon is not None and mon.loop is loop and mon.installed:
            return mon
        mon = LoopMonitor(component, loop)
        _monitors[component] = mon
    mon.install()
    return mon


def uninstall(component: str) -> None:
    with _lock:
        mon = _monitors.pop(component, None)
    if mon is not None:
        mon.uninstall()


def cpu_sampler(component: str = "") -> Optional[ThreadCpuSampler]:
    """This process's one ThreadCpuSampler (first caller's component
    labels it — same discipline as the flight-recorder singleton). None
    when the observatory is disabled."""
    global _cpu_sampler
    if not enabled():
        return None
    with _lock:
        if _cpu_sampler is None:
            _cpu_sampler = ThreadCpuSampler(component)
        return _cpu_sampler

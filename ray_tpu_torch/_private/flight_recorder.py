"""Flight recorder: always-on wall-clock stack sampling (reference: the
role ``py-spy``/``ray stack`` play for Ray, turned continuous — the GCS
profiling tables of arXiv:1712.05889 §4.1 are the template for shipping the
samples centrally; py-spy isn't in this image, so the sampler walks
``sys._current_frames()`` in-process).

One :class:`FlightRecorder` daemon thread per process samples every live
thread at a configurable rate (default 20 Hz, ``RAY_TPU_TORCH_FLIGHT_RECORDER_HZ``;
kill switch ``RAY_TPU_TORCH_FLIGHT_RECORDER=0``), folds each stack into the
collapsed ``outer;...;leaf`` form flamegraph tools consume directly, and
accumulates per-stack sample counts, with an on-CPU weight per stack.

Overhead model: a 20 Hz walk of a handful of threads is ~100 µs/s of work;
the reference's interleaved A/B smoke (tests/test_control_plane.py) pins
its own sampler under 3% of warm batched throughput.

The port's copy of ``ray_tpu/_private/flight_recorder.py``, reading its
variables under the ``RAY_TPU_TORCH_`` prefix. The local runtime starts it as
the "driver" component and ``shutdown()`` stops it; ``snapshot()`` and
``drain()`` read its counts in this process. In the cluster runtime the
GCS, controllers, workers and drivers ship ``drain_tagged()`` to the GCS
profile-stacks table on their stats cadence and account each flush with
``flush_metrics``. The ``cli profile`` report on that table
(``self_time_table``, ``attribution_table``) comes with the CLI (A6b of
ROADMAP.md).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, Optional

from .loopmon import enabled as _loopmon_enabled
from .loopmon import thread_cpu_ns as _thread_cpu_ns

COMPONENTS = ("gcs", "controller", "worker", "driver")

DEFAULT_HZ = 20.0
MAX_DEPTH = 64          # frames kept per stack (outermost truncated)
MAX_STACKS = 8192       # distinct folded stacks per drain window
OVERFLOW_KEY = "<overflow>"

_lock = threading.Lock()
_recorder: Optional["FlightRecorder"] = None


def enabled() -> bool:
    """Process-wide kill switch (``RAY_TPU_TORCH_FLIGHT_RECORDER=0``)."""
    return os.environ.get("RAY_TPU_TORCH_FLIGHT_RECORDER", "1") not in ("", "0")


def sample_hz() -> float:
    try:
        hz = float(os.environ.get("RAY_TPU_TORCH_FLIGHT_RECORDER_HZ", "") or
                   DEFAULT_HZ)
    except ValueError:
        hz = DEFAULT_HZ
    return min(max(hz, 0.1), 250.0)


def fold_frame(frame) -> str:
    """One collapsed-stack element: ``file.py:function`` (basenames only —
    line numbers would explode cardinality without aiding attribution)."""
    code = frame.f_code
    return f"{os.path.basename(code.co_filename)}:{code.co_name}"


class FlightRecorder:
    """Wall-clock stack sampler for THIS process.

    ``start()``/``stop()`` are idempotent; ``drain()`` atomically swaps the
    accumulated {folded_stack: samples} map out (the piggyback flush),
    ``snapshot()`` copies it non-destructively (local introspection).
    """

    def __init__(self, component: str, hz: Optional[float] = None):
        self.component = component
        self.hz = float(hz) if hz else sample_hz()
        self._counts: Dict[str, int] = {}
        # Parallel on-CPU weight per folded stack: each sample adds the
        # fraction of the inter-sample window its thread spent on-CPU
        # (schedstat delta / wall delta), so a thread blocked in recv
        # accumulates wall samples but ~0 on-CPU weight instead of being
        # charged as self time.
        self._oncpu: Dict[str, float] = {}
        self._cpu_prev: Dict[int, int] = {}     # python ident -> cpu ns
        self._cpu_prev_t: float = 0.0           # perf_counter of last pass
        self.cpu_tagging = False                # procfs delivered at least once
        # RAY_TPU_TORCH_LOOPMON=0 also drops the tagging reads, so the
        # observatory kill switch yields a byte-stock sampler hot path.
        self._tag_cpu = _loopmon_enabled()
        self._counts_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Steady state resamples the SAME stacks over and over: cache the
        # string folding per code object and per whole stack (keys keep
        # their code objects alive, bounding both to the program's code).
        # Without these the per-sample formatting cost was measurable
        # against the 3% overhead budget on a saturated 1-vCPU box.
        self._code_cache: Dict[Any, str] = {}
        self._stack_cache: Dict[tuple, str] = {}
        self.samples = 0          # thread-walk passes taken
        self.stacks_folded = 0    # individual thread stacks folded
        self.sample_seconds = 0.0  # wall time inside the sampler itself

    # --------------------------------------------------------------- control
    def start(self) -> bool:
        """Idempotent: one sampler thread per recorder, ever."""
        if self._thread is not None and self._thread.is_alive():
            return False
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="flight-recorder", daemon=True)
        self._thread.start()
        return True

    def stop(self, timeout: float = 2.0) -> None:
        """Idempotent; joins the sampler thread so shutdown() leaves no
        stray thread behind (pinned by tests)."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=timeout)
        self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -------------------------------------------------------------- sampling
    def _run(self) -> None:
        interval = 1.0 / self.hz
        own = threading.get_ident()
        while not self._stop.wait(interval):
            t0 = time.perf_counter()
            try:
                self._sample_once(own)
            except Exception:  # noqa: BLE001 - sampling must never crash
                pass
            self.sample_seconds += time.perf_counter() - t0

    def _sample_once(self, own_ident: int) -> None:
        frames = sys._current_frames()
        self.samples += 1
        code_cache = self._code_cache
        stack_cache = self._stack_cache
        # Python ident -> native tid map for the on-CPU clock reads
        # (sys._current_frames keys are Python idents; /proc/self/task
        # wants kernel tids). enumerate() is a lock + list copy — cheap
        # against the procfs reads that follow.
        native = {}
        if self._tag_cpu:
            for t in threading.enumerate():
                nid = getattr(t, "native_id", None)
                if t.ident is not None and nid is not None:
                    native[t.ident] = nid
        now = time.perf_counter()
        wall_ns = (now - self._cpu_prev_t) * 1e9 \
            if self._cpu_prev_t else 0.0
        folded = []
        cpu_seen: Dict[int, int] = {}
        for ident, frame in frames.items():
            if ident == own_ident:
                continue
            codes = []
            depth = 0
            while frame is not None and depth < MAX_DEPTH:
                codes.append(frame.f_code)
                frame = frame.f_back
                depth += 1
            codes_t = tuple(codes)
            key = stack_cache.get(codes_t)
            if key is None:
                parts = []
                for code in reversed(codes):
                    s = code_cache.get(code)
                    if s is None:
                        s = code_cache[code] = (
                            f"{os.path.basename(code.co_filename)}"
                            f":{code.co_name}")
                    parts.append(s)
                key = ";".join(parts)
                if len(stack_cache) < 4 * MAX_STACKS:
                    stack_cache[codes_t] = key
            # on-CPU fraction of the inter-sample window for this thread:
            # schedstat cpu-ns delta / wall-ns. 1.0 when procfs is
            # unavailable (wall==on-CPU, the old degraded semantics).
            frac = 1.0
            tid = native.get(ident)
            if tid is not None:
                ns = _thread_cpu_ns(tid)
                if ns is not None:
                    self.cpu_tagging = True
                    cpu_seen[ident] = ns
                    prev = self._cpu_prev.get(ident)
                    if prev is None or wall_ns <= 0:
                        frac = 0.0  # first sight: no window to judge
                    else:
                        frac = min(max((ns - prev) / wall_ns, 0.0), 1.0)
            folded.append((key, frac))
        del frames
        self._cpu_prev = cpu_seen
        self._cpu_prev_t = now
        with self._counts_lock:
            for key, frac in folded:
                if key not in self._counts and \
                        len(self._counts) >= MAX_STACKS:
                    key = OVERFLOW_KEY
                self._counts[key] = self._counts.get(key, 0) + 1
                if frac:
                    self._oncpu[key] = self._oncpu.get(key, 0.0) + frac
                self.stacks_folded += 1

    # ----------------------------------------------------------------- sinks
    def drain(self) -> Dict[str, int]:
        """Swap out the accumulated folded-stack counts (the flush path:
        whoever drains first owns the window's samples)."""
        with self._counts_lock:
            counts, self._counts = self._counts, {}
            self._oncpu = {}
        return counts

    def drain_tagged(self) -> tuple:
        """(wall_counts, oncpu_weights) — the tagged flush the producers
        ship so `cli profile` can print wall and on-CPU columns instead
        of one conflated self-time figure."""
        with self._counts_lock:
            counts, self._counts = self._counts, {}
            oncpu, self._oncpu = self._oncpu, {}
        return counts, {k: round(v, 2) for k, v in oncpu.items() if v}

    def snapshot(self) -> Dict[str, int]:
        with self._counts_lock:
            return dict(self._counts)

    def snapshot_oncpu(self) -> Dict[str, float]:
        with self._counts_lock:
            return dict(self._oncpu)


# --------------------------------------------------------------------------
# per-process singleton: every component's flush path talks to ONE sampler
# (the head process hosts the GCS *and* a colocated controller thread — two
# samplers there would double-count every stack).
# --------------------------------------------------------------------------

def start(component: str) -> Optional[FlightRecorder]:
    """Start (or return) this process's recorder. The FIRST caller's
    component labels all of the process's samples; later callers (e.g. the
    head's colocated controller) share the instance. None when disabled."""
    global _recorder
    if not enabled():
        return None
    with _lock:
        if _recorder is None:
            _recorder = FlightRecorder(component)
        _recorder.start()
        rec = _recorder
    _recorder_metrics(rec.component)
    return rec


def get() -> Optional[FlightRecorder]:
    return _recorder


def stop() -> None:
    """Stop and discard this process's recorder (shutdown path)."""
    global _recorder
    with _lock:
        rec, _recorder = _recorder, None
    if rec is not None:
        rec.stop()


def _recorder_metrics(component: str) -> None:
    """Register the flight_recorder_* series (Prometheus-visible through
    metrics.render_prometheus); records one start marker."""
    try:
        from ..metrics import flight_recorder_metrics

        flight_recorder_metrics()["starts"].record(
            1.0, tags={"component": component})
    except Exception:  # noqa: BLE001 - metrics must never block startup
        pass


def flush_metrics(rec: FlightRecorder, n_stacks: int) -> None:
    """Account one drain flush into the flight_recorder_* series."""
    try:
        from ..metrics import flight_recorder_metrics

        m = flight_recorder_metrics()
        m["samples"].record(float(n_stacks),
                            tags={"component": rec.component})
        m["overhead_s"].record(rec.sample_seconds,
                               tags={"component": rec.component})
    except Exception:  # noqa: BLE001
        pass

"""Per-task distributed tracing (reference: Ray's per-task state tracking +
timeline primitives, arXiv:1712.05889 §4; the critical-path observation that
stragglers are located by per-task span data, not aggregates,
arXiv:1711.01912).

A *trace* is one sampled task followed across every control-plane hop. The
trace context is 8 random bytes carried inside the task spec (binary wire
frames encode it as a versioned spec-header extension — see
``cluster/wire.py`` SPEC_VERSION 2; pickle frames just carry the dict key).
Each hop records wall-clock *spans* for the phases it owns:

    driver_serialize -> submit_rpc -> gcs_place -> dispatch_relay
    -> worker_exec -> result_register -> driver_fetch

Spans flush in batches to the GCS trace table, which
``ray_tpu_torch.timeline()`` reads as chrome-trace lanes, one lane per
trace. In the local runtime a sampled task gets a ``worker_exec`` lane.

Sampling (default 1/64, ``RAY_TPU_TORCH_TRACE_SAMPLE``; 0 disables, 1 traces
everything) keeps the submit hot path at one counter increment per task.

The port's copy of ``ray_tpu/_private/tracing.py`` up to ``make_span``.
The phase tuple ``PHASES``, ``rate_override()`` and the reports over the
trace table (``group_traces``, ``straggler_report``,
``conservation_ledger``, ``ledger_table``) serve the CLI and the dashboard
and come with them (A6b of ROADMAP.md).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any, Dict, Optional

_DEFAULT_RATE = 64

_counter = itertools.count()
_lock = threading.Lock()
_metrics_box: Dict[str, Any] = {}


_rate_cache = ("\0unset", _DEFAULT_RATE)

# Runtime override (``cli trace --sample N`` broadcast through the GCS kv,
# applied by each process's stats/heartbeat poll): takes precedence over
# the env var so the rate is adjustable on a LIVE cluster without
# restarting every process. None = no override (env/default applies).
TRACE_SAMPLE_KV_KEY = "__ray_tpu_trace_sample__"
_rate_override: Optional[int] = None


def set_rate_override(rate: Optional[int]) -> None:
    """Install (or clear, with None) the cluster-broadcast sampling rate."""
    global _rate_override
    _rate_override = max(0, int(rate)) if rate is not None else None


def apply_kv_rate(raw: Optional[bytes]) -> None:
    """Fold the GCS kv cell for TRACE_SAMPLE_KV_KEY into the override
    (shared by the controller heartbeat and driver stats polls). A missing
    or unparsable cell clears the override back to env/default."""
    if raw is None:
        set_rate_override(None)
        return
    try:
        set_rate_override(int(bytes(raw).decode()))
    except (ValueError, UnicodeDecodeError):
        set_rate_override(None)


def sample_rate() -> int:
    """1-in-N sampling rate (0 = off): the kv-broadcast runtime override
    when one is installed, else ``RAY_TPU_TORCH_TRACE_SAMPLE``. The env var is
    re-read per call (tests monkeypatch it) but parsed once per distinct
    value — this runs on the per-task submit hot path."""
    global _rate_cache
    if _rate_override is not None:
        return _rate_override
    raw = os.environ.get("RAY_TPU_TORCH_TRACE_SAMPLE", "")
    cached = _rate_cache
    if cached[0] == raw:
        return cached[1]
    if not raw:
        rate = _DEFAULT_RATE
    else:
        try:
            rate = max(0, int(raw))
        except ValueError:
            rate = _DEFAULT_RATE
    _rate_cache = (raw, rate)
    return rate


def maybe_sample() -> Optional[bytes]:
    """Per-task sampling decision: every Nth submission gets a fresh 8-byte
    trace id; everything else pays one counter increment."""
    rate = sample_rate()
    if rate <= 0:
        return None
    if next(_counter) % rate:
        return None
    _trace_metrics()["sampled"].record(1.0)
    return os.urandom(8)


def _trace_metrics() -> Dict[str, Any]:
    """Lazily-registered tracing counters (driver/worker side; rides the
    same registry the Prometheus endpoint renders)."""
    with _lock:
        if not _metrics_box:
            from ..metrics import Count, Histogram, get_or_create

            _metrics_box["sampled"] = get_or_create(
                Count, "trace_tasks_sampled",
                description="tasks selected for per-task tracing")
            _metrics_box["spans"] = get_or_create(
                Count, "trace_spans_recorded", tag_keys=("phase",),
                description="trace spans recorded in this process")
            _metrics_box["phase_ms"] = get_or_create(
                Histogram, "trace_phase_ms", tag_keys=("phase",),
                description="per-phase wall time of sampled tasks",
                boundaries=[0.05, 0.1, 0.5, 1, 5, 10, 50, 100, 500, 1000])
        return _metrics_box


def make_span(trace: bytes, task_id: Optional[bytes], phase: str,
              start_mono: float, end_mono: float,
              src: str = "", via: str = "") -> Dict[str, Any]:
    """One phase span. Takes time.monotonic() endpoints (exact durations)
    and anchors them to wall clock here — the offset is constant per
    process, so durations stay exact while epochs become comparable
    across machines (same convention as profile-event flush).

    ``via`` attributes a span to its delivery mechanism — for
    driver_fetch, whether the result arrived through the shm completion
    ring ("ring"), rode inline in the completion record ("inline"), was
    pushed with the directory answer ("inline_push"), or took a fetch
    RPC ("rpc") — so a straggler report can separate data-plane tails
    from control-plane ones."""
    off = time.time() - time.monotonic()
    m = _trace_metrics()
    tags = {"phase": phase}
    m["spans"].record(1.0, tags=tags)
    m["phase_ms"].record((end_mono - start_mono) * 1e3, tags=tags)
    out = {
        "trace": trace.hex() if isinstance(trace, bytes) else str(trace),
        "task_id": (task_id.hex() if isinstance(task_id, bytes)
                    else str(task_id or "")),
        "phase": phase,
        "start": start_mono + off,
        "end": end_mono + off,
        "src": src,
    }
    if via:
        out["via"] = via
    return out

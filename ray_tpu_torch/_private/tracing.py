"""Per-task trace sampling (reference: Ray's per-task state tracking +
timeline primitives, arXiv:1712.05889 §4; the critical-path observation that
stragglers are located by per-task span data, not aggregates,
arXiv:1711.01912).

A *trace* is one sampled task: 8 random bytes carried in the task spec's
metadata. Sampling (default 1/64, ``RAY_TPU_TORCH_TRACE_SAMPLE``; 0
disables, 1 traces everything) keeps the submit hot path at one counter
increment per task.

The port's copy of the sampling half of ``ray_tpu/_private/tracing.py``.
In the local runtime a sampled task gets a ``worker_exec`` phase lane in
``timeline()``. The spans of the cluster's other phases, their report and
the rate broadcast come with the cluster runtime (A6 of ROADMAP.md).
"""

from __future__ import annotations

import itertools
import os
import threading
from typing import Any, Dict, Optional

_DEFAULT_RATE = 64

_counter = itertools.count()
_lock = threading.Lock()
_metrics_box: Dict[str, Any] = {}

_rate_cache = ("\0unset", _DEFAULT_RATE)


def sample_rate() -> int:
    """1-in-N sampling rate (0 = off) from ``RAY_TPU_TORCH_TRACE_SAMPLE``.
    The env var is re-read per call (tests monkeypatch it) but parsed once
    per distinct value — this runs on the per-task submit hot path."""
    global _rate_cache
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
    """Lazily-registered tracing counter (rides the same registry the
    Prometheus renderer reads)."""
    with _lock:
        if not _metrics_box:
            from ..metrics import Count, get_or_create

            _metrics_box["sampled"] = get_or_create(
                Count, "trace_tasks_sampled",
                description="tasks selected for per-task tracing")
        return _metrics_box

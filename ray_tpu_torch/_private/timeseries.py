"""Fixed-resolution metrics time-series rollups (reference: the GCS-backed
stats tables Ray's dashboard trends from, arXiv:1712.05889 §4.1; the
retention discipline mirrors Prometheus' fixed-step TSDB blocks, shrunk to
an in-memory ring per series).

One :class:`TimeSeriesStore` lives in the GCS beside the event/trace ring
buffers (``cluster/gcs.py``): every rollup tick folds counter deltas, gauge
samples, and histogram-delta snapshots into aligned fixed-width buckets
(default 10 s), each series bounded by a retention ring — the storage model
the dashboard's ``/api/timeseries`` sparklines, ``cli top``, and the SLO
burn-rate rules (``monitor.py``) all read.

Three cell kinds, chosen so every consumer question is one bucket scan:

* ``delta``  — increments observed during the bucket (counter deltas;
  tasks/s is ``sum / bucket_s``);
* ``gauge``  — last/min/max/avg of samples within the bucket;
* ``hist``   — a bucketed distribution of the events that happened during
  the bucket (sources ship per-flush deltas, merged additively), from
  which :func:`quantile_from_hist` estimates p50/p99.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence

SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


class TimeSeriesStore:
    """Per-name ring of aligned fixed-width buckets.

    Thread-safe: producers (the GCS rollup loop, node/driver stat handlers)
    and consumers (RPC snapshot) may interleave. Buckets are aligned to
    ``bucket_s`` boundaries of the wall clock so two stores (or a restart)
    produce comparable timestamps; late samples (clock skew, delayed
    flushes) fold into the newest bucket rather than minting out-of-order
    entries.
    """

    def __init__(self, bucket_s: float = 10.0, retention_buckets: int = 360):
        if bucket_s <= 0:
            raise ValueError("bucket_s must be positive")
        if retention_buckets <= 0:
            raise ValueError("retention_buckets must be positive")
        self.bucket_s = float(bucket_s)
        self.retention_buckets = int(retention_buckets)
        self._lock = threading.Lock()
        # name -> (kind, deque[[bucket_start, cell]]) — the deque maxlen IS
        # the retention policy (same discipline as the GCS event rings).
        self._series: Dict[str, tuple] = {}

    # ------------------------------------------------------------- recording
    def _bucket_start(self, ts: Optional[float]) -> float:
        if ts is None:
            ts = time.time()
        return (int(ts) // int(self.bucket_s)) * int(self.bucket_s) \
            if self.bucket_s >= 1 else ts - (ts % self.bucket_s)

    def _cell(self, name: str, kind: str, ts: Optional[float]) -> Dict:
        """Current bucket's cell for ``name`` (created/rotated as needed).
        Caller holds the lock."""
        entry = self._series.get(name)
        if entry is None:
            entry = (kind, deque(maxlen=self.retention_buckets))
            self._series[name] = entry
        stored_kind, ring = entry
        if stored_kind != kind:
            raise ValueError(
                f"series {name!r} is {stored_kind}, not {kind}")
        start = self._bucket_start(ts)
        if ring and ring[-1][0] >= start:
            # Same bucket — or a late/straggling sample: fold into newest.
            return ring[-1][1]
        cell: Dict[str, Any]
        if kind == "delta":
            cell = {"sum": 0.0}
        elif kind == "gauge":
            cell = {"last": 0.0, "min": None, "max": None,
                    "sum": 0.0, "n": 0}
        else:  # hist
            cell = {"buckets": {}, "sum": 0.0, "count": 0}
        ring.append([start, cell])
        return cell

    def add_delta(self, name: str, value: float,
                  ts: Optional[float] = None) -> None:
        """Fold counter *increments* (not cumulative totals) into the
        current bucket. Rate over a bucket = sum / bucket_s."""
        with self._lock:
            cell = self._cell(name, "delta", ts)
            cell["sum"] += float(value)

    def add_gauge(self, name: str, value: float,
                  ts: Optional[float] = None) -> None:
        value = float(value)
        with self._lock:
            cell = self._cell(name, "gauge", ts)
            cell["last"] = value
            cell["min"] = value if cell["min"] is None \
                else min(cell["min"], value)
            cell["max"] = value if cell["max"] is None \
                else max(cell["max"], value)
            cell["sum"] += value
            cell["n"] += 1

    def add_hist(self, name: str, buckets: Dict[str, int],
                 total: float = 0.0, count: int = 0,
                 ts: Optional[float] = None) -> None:
        """Merge one histogram *delta* snapshot (bucket-boundary -> count of
        events since the source's last flush) into the current bucket.
        Additive across sources — two drivers flushing into the same bucket
        produce their combined distribution."""
        with self._lock:
            cell = self._cell(name, "hist", ts)
            dst = cell["buckets"]
            for bound, n in buckets.items():
                if n:
                    dst[bound] = dst.get(bound, 0) + int(n)
            cell["sum"] += float(total)
            cell["count"] += int(count)

    # ------------------------------------------------------------- consuming
    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def series(self, name: str, last: Optional[int] = None) -> List[list]:
        """[[bucket_start, cell], ...] oldest-first (copies, detached from
        the live ring)."""
        with self._lock:
            entry = self._series.get(name)
            if entry is None:
                return []
            pts = list(entry[1])
        if last is not None:
            pts = pts[-int(last):]
        return [[t, dict(c)] for t, c in pts]

    def snapshot(self, names: Optional[Iterable[str]] = None,
                 last: Optional[int] = None) -> Dict[str, Dict]:
        """The RPC/dashboard payload: {name: {kind, points}}."""
        with self._lock:
            wanted = list(names) if names is not None \
                else sorted(self._series)
            raw = {n: (self._series[n][0], list(self._series[n][1]))
                   for n in wanted if n in self._series}
        out = {}
        for n, (kind, pts) in raw.items():
            if last is not None:
                pts = pts[-int(last):]
            out[n] = {"kind": kind,
                      "points": [[t, dict(c)] for t, c in pts]}
        return out


# --------------------------------------------------------------------------
# consumers: windows, quantiles, sparklines
# --------------------------------------------------------------------------

def window_sum(points: Sequence[Sequence], since: float) -> float:
    """Sum of delta-cell increments in buckets starting at/after ``since``."""
    return sum(c["sum"] for t, c in points if t >= since)


def window_rate(points: Sequence[Sequence], since: float,
                now: Optional[float] = None) -> float:
    """Average events/second over the window — denominated in wall time,
    not bucket count, so sparse rings don't overstate the rate."""
    if now is None:
        now = time.time()
    span = max(now - since, 1e-9)
    return window_sum(points, since) / span


def latest_value(points: Sequence[Sequence],
                 key: str = "last") -> Optional[float]:
    """Newest bucket's cell value (``last`` for gauges, pass ``sum`` for
    delta cells); None when the series is empty. The one-liner every
    'current value of this gauge series' consumer (`cli top` rows,
    `cli doctor` snapshots) kept re-writing."""
    if not points:
        return None
    cell = points[-1][1]
    return cell.get(key)


def gauge_window(points: Sequence[Sequence], since: float,
                 key: str = "last") -> List[float]:
    """Every gauge-cell ``key`` value in buckets at/after ``since``,
    oldest-first. The sustained-breach primitive: a gauge-ceiling SLO
    fires only when min() of this window exceeds the threshold, and the
    `cli top`/`cli loops` loop-lag rows read the same slice."""
    return [c[key] for t, c in points
            if t >= since and c.get(key) is not None]


def merge_hist(cells: Iterable[Dict]) -> Dict:
    """Additively merge hist cells (e.g. every bucket of a window) into one
    {buckets, sum, count} distribution."""
    out: Dict[str, Any] = {"buckets": {}, "sum": 0.0, "count": 0}
    for c in cells:
        for bound, n in c.get("buckets", {}).items():
            out["buckets"][bound] = out["buckets"].get(bound, 0) + int(n)
        out["sum"] += float(c.get("sum", 0.0))
        out["count"] += int(c.get("count", 0))
    return out


def quantile_from_hist(cell: Dict, q: float) -> Optional[float]:
    """Estimate the q-quantile from a bucketed distribution (upper-bound
    convention, same as Prometheus ``histogram_quantile``): the first
    boundary whose cumulative count covers q. None when empty. ``+inf``
    entries clamp to the largest finite boundary."""
    total = cell.get("count") or sum(cell.get("buckets", {}).values())
    if not total:
        return None
    import math

    finite = []
    for bound, n in cell.get("buckets", {}).items():
        try:
            b = float(bound)
        except (TypeError, ValueError):
            continue
        if math.isfinite(b):
            finite.append((b, int(n)))
    finite.sort()
    target = q * total
    cum = 0
    for bound, n in finite:
        cum += n
        if cum >= target:
            return bound
    return finite[-1][0] if finite else None


def sparkline(values: Sequence[float], width: int = 30) -> str:
    """Unicode block sparkline (``cli top`` / dashboard panels)."""
    vals = list(values)[-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return SPARK_BLOCKS[0] * len(vals)
    idx_hi = len(SPARK_BLOCKS) - 1
    return "".join(
        SPARK_BLOCKS[round((v - lo) / span * idx_hi)] for v in vals)

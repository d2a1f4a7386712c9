"""Metrics API (reference: src/ray/stats/metric.h — Gauge/Count/Sum/Histogram
over OpenCensus; here a dependency-free registry exported through the
dashboard and state API, plus a Prometheus text exposition renderer served
at the dashboard's ``/metrics``).

The port's copy of ``ray_tpu/metrics.py``: its own registry, which the
runtime's tracing, spill and flight-recorder counters and serve's fleet
series register in.
"""

from __future__ import annotations

import bisect
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

_REGISTRY: Dict[str, "Metric"] = {}
_LOCK = threading.Lock()


class Metric:
    kind = "metric"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._lock = threading.Lock()
        with _LOCK:
            existing = _REGISTRY.get(name)
            if existing is not None and type(existing) is not type(self):
                raise ValueError(
                    f"metric {name!r} already registered as {existing.kind}")
            _REGISTRY[name] = self

    def _tags_key(self, tags: Optional[Dict[str, str]]) -> Tuple:
        tags = tags or {}
        return tuple((k, tags.get(k, "")) for k in self.tag_keys)

    def collect(self) -> Dict:
        raise NotImplementedError


class Count(Metric):
    """Monotonic counter (reference stats::Count)."""

    kind = "count"

    def __init__(self, name, description="", tag_keys=()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def record(self, value: float = 1.0,
               tags: Optional[Dict[str, str]] = None) -> None:
        key = self._tags_key(tags)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def collect(self) -> Dict:
        with self._lock:
            return {"kind": self.kind, "description": self.description,
                    "values": {str(dict(k)): v
                               for k, v in self._values.items()}}


class Gauge(Metric):
    """Last-value-wins (reference stats::Gauge)."""

    kind = "gauge"

    def __init__(self, name, description="", tag_keys=()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, Tuple[float, float]] = {}

    def record(self, value: float,
               tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[self._tags_key(tags)] = (value, time.time())

    def collect(self) -> Dict:
        with self._lock:
            return {"kind": self.kind, "description": self.description,
                    "values": {str(dict(k)): v for k, (v, _)
                               in self._values.items()}}


class Histogram(Metric):
    """Bucketed distribution (reference stats::Histogram)."""

    kind = "histogram"

    def __init__(self, name, description="", boundaries: Sequence[float] = (),
                 tag_keys=()):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries) or [
            1, 5, 10, 25, 50, 100, 250, 500, 1000]
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._totals: Dict[Tuple, int] = {}

    def record(self, value: float,
               tags: Optional[Dict[str, str]] = None) -> None:
        key = self._tags_key(tags)
        bucket = bisect.bisect_left(self.boundaries, value)
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.boundaries) + 1))
            counts[bucket] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def collect(self) -> Dict:
        with self._lock:
            out = {}
            for key, counts in self._counts.items():
                total = self._totals[key]
                out[str(dict(key))] = {
                    "count": total,
                    "sum": self._sums[key],
                    "mean": self._sums[key] / max(total, 1),
                    "buckets": dict(zip(
                        [str(b) for b in self.boundaries] + ["+inf"], counts)),
                }
            return {"kind": self.kind, "description": self.description,
                    "values": out}


# Sum is an alias pattern in the reference; a Count covers it.
Sum = Count


def get_or_create(cls, name: str, **kwargs) -> "Metric":
    """Idempotent registration: returns the already-registered metric when
    one of the same type exists (re-instantiating would silently reset its
    accumulated values), else registers a fresh one. The shared pattern for
    library-internal metrics (e.g. the object-store spill counters) that
    may be touched from several modules."""
    with _LOCK:
        existing = _REGISTRY.get(name)
        if existing is not None and type(existing) is cls:
            return existing
    return cls(name, **kwargs)


def flight_recorder_metrics() -> Dict[str, "Metric"]:
    """``flight_recorder_*`` series for the continuous stack sampler:
    sampler starts by component. The reference's shipped-stacks and
    overhead series are recorded by the cluster's flush, which comes with
    A6. Lazily registered; idempotent."""
    return {
        "starts": get_or_create(
            Count, "flight_recorder_starts", tag_keys=("component",),
            description="flight-recorder sampler threads started"),
    }


def serve_fleet_metrics() -> Dict[str, "Metric"]:
    """``serve_*`` series for the self-healing serving fleet, pushed by
    the ServeMaster's reconcile loop: per-route latency quantiles and
    error rate (mirrored from the router's in-actor windows so Prometheus
    can scrape them from the dashboard's /metrics), replica counts by
    state, fleet events (down-marks, retries, failovers, replacements,
    scale-ups/downs), and the untagged worst-case route gauges the
    monitor's serve SLO rules key on. Lazily registered; idempotent."""
    return {
        "p50": get_or_create(
            Gauge, "serve_route_latency_p50_ms", tag_keys=("endpoint",),
            description="p50 request latency per serve endpoint (ms)"),
        "p99": get_or_create(
            Gauge, "serve_route_latency_p99_ms", tag_keys=("endpoint",),
            description="p99 request latency per serve endpoint (ms)"),
        "error_rate": get_or_create(
            Gauge, "serve_route_error_rate", tag_keys=("endpoint",),
            description="fraction of failed requests per serve endpoint "
                        "over the router's sliding window"),
        "worst_p99": get_or_create(
            Gauge, "serve_route_p99_ms_max",
            description="worst per-endpoint p99 latency (ms) — the serve "
                        "latency SLO rule's subject"),
        "worst_error_rate": get_or_create(
            Gauge, "serve_route_error_rate_max",
            description="worst per-endpoint error rate — the serve "
                        "error-rate SLO rule's subject"),
        "replicas": get_or_create(
            Gauge, "serve_replicas", tag_keys=("backend", "state"),
            description="replica count per backend by state "
                        "(up / down / draining)"),
        "events": get_or_create(
            Count, "serve_fleet_events", tag_keys=("kind",),
            description="fleet lifecycle events (replicas_down / retries / "
                        "failovers / stream_failfast / replicas_replaced / "
                        "scale_ups / scale_downs)"),
    }


def collect_all() -> Dict[str, Dict]:
    """Snapshot every registered metric (the dashboard's /api/metrics)."""
    with _LOCK:
        metrics = list(_REGISTRY.items())
    return {name: m.collect() for name, m in metrics}


def histogram_cells(name: str) -> Dict[Tuple, Dict]:
    """Raw per-tags histogram cells of one registered Histogram:
    {tags_tuple: {"buckets": {boundary_str: count}, "sum", "count"}}.
    Cumulative — the driver stats flush diffs consecutive snapshots into
    the per-bucket deltas the GCS time-series store merges."""
    with _LOCK:
        m = _REGISTRY.get(name)
    if not isinstance(m, Histogram):
        return {}
    bounds = [str(b) for b in m.boundaries] + ["+inf"]
    with m._lock:
        return {
            key: {"buckets": dict(zip(bounds, counts)),
                  "sum": m._sums[key], "count": m._totals[key]}
            for key, counts in m._counts.items()
        }


def reset_all() -> None:
    with _LOCK:
        _REGISTRY.clear()


# ---------------------------------------------------------------------------
# Prometheus text exposition (version 0.0.4)
# ---------------------------------------------------------------------------

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _prom_escape(value: str) -> str:
    """Label-value escaping per the exposition format: backslash, double
    quote, and newline must be escaped."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labels(tags: Tuple, extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = [(k, v) for k, v in tags]
    if extra is not None:
        pairs.append(extra)
    if not pairs:
        return ""
    return ("{" + ",".join(
        f'{_prom_name(k)}="{_prom_escape(v)}"' for k, v in pairs) + "}")


def _prom_num(v: float) -> str:
    return repr(float(v)) if v != int(v) else str(int(v))


def render_prometheus() -> str:
    """Render every registered metric in Prometheus text exposition format.

    Counters get the conventional ``_total`` suffix; histograms expose
    cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``. Values
    are point-in-time snapshots of the (monotonic for counters) registry
    cells, so scrape-to-scrape deltas are well defined.
    """
    with _LOCK:
        metrics = sorted(_REGISTRY.items())
    lines: List[str] = []
    for name, m in metrics:
        pname = _prom_name(name)
        if isinstance(m, Histogram):
            lines.append(f"# HELP {pname} {m.description or pname}")
            lines.append(f"# TYPE {pname} histogram")
            with m._lock:
                for key, counts in m._counts.items():
                    cum = 0
                    for bound, c in zip(m.boundaries, counts):
                        cum += c
                        lines.append(
                            f"{pname}_bucket"
                            f"{_prom_labels(key, ('le', _prom_num(bound)))}"
                            f" {cum}")
                    cum += counts[len(m.boundaries)]
                    lines.append(
                        f"{pname}_bucket{_prom_labels(key, ('le', '+Inf'))}"
                        f" {cum}")
                    lines.append(
                        f"{pname}_sum{_prom_labels(key)}"
                        f" {_prom_num(m._sums[key])}")
                    lines.append(
                        f"{pname}_count{_prom_labels(key)}"
                        f" {m._totals[key]}")
            continue
        if isinstance(m, Count):
            cname = pname if pname.endswith("_total") else pname + "_total"
            lines.append(f"# HELP {cname} {m.description or pname}")
            lines.append(f"# TYPE {cname} counter")
            with m._lock:
                samples = list(m._values.items())
            for key, value in samples:
                lines.append(
                    f"{cname}{_prom_labels(key)} {_prom_num(value)}")
            continue
        if isinstance(m, Gauge):
            lines.append(f"# HELP {pname} {m.description or pname}")
            lines.append(f"# TYPE {pname} gauge")
            with m._lock:
                samples = [(k, v) for k, (v, _) in m._values.items()]
            for key, value in samples:
                lines.append(
                    f"{pname}{_prom_labels(key)} {_prom_num(value)}")
    return "\n".join(lines) + ("\n" if lines else "")

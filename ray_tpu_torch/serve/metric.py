"""Serve metrics: per-endpoint/backend counters + latency distributions
(reference: python/ray/serve/metric/ — MetricClient with InMemoryExporter /
PrometheusExporter, surfaced through serve.stat()).

The reference pushes metrics from replicas to an exporter actor; here the
router IS the single data-plane chokepoint, so it records in place (no extra
actor, no push RPCs) and exporters are just render strategies over the
router's state — ``serve.stat()`` fetches one snapshot.

The port's copy of ``ray_tpu/serve/metric.py``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List


class LatencyWindow:
    """Fixed-size reservoir of recent latencies (seconds) + total counters."""

    def __init__(self, maxlen: int = 2048):
        self.samples: deque = deque(maxlen=maxlen)
        self.stamps: deque = deque(maxlen=maxlen)
        self.count = 0
        self.errors = 0
        self.started = time.time()

    def record(self, latency_s: float, error: bool = False) -> None:
        self.samples.append(latency_s)
        self.stamps.append(time.time())
        self.count += 1
        if error:
            self.errors += 1

    def snapshot(self) -> Dict[str, float]:
        import math

        xs: List[float] = sorted(self.samples)
        n = len(xs)

        def pct(p: float) -> float:
            # Nearest-rank: ceil(p*n)-1, NOT int(p*n) — the latter is one
            # rank high (p99 of 100 samples would report the max).
            if not n:
                return 0.0
            return xs[max(0, min(n - 1, math.ceil(p * n) - 1))]

        # qps over the retained sample window (first kept stamp -> now), not
        # a lifetime average: after an idle period a lifetime rate would
        # under-report the current load. The 1s floor only applies while the
        # deque is NOT full: it stops a snapshot taken moments after the
        # first sample from reporting a phantom spike, while a full deque
        # uses its true span so sustained rates above maxlen/1s aren't
        # clamped to maxlen.
        if self.stamps:
            window = time.time() - self.stamps[0]
            if len(self.stamps) < self.stamps.maxlen:
                window = max(window, 1.0)
            window = max(window, 1e-3)
        else:
            window = 1.0
        return {
            "count": self.count,
            "errors": self.errors,
            "qps": round(len(self.stamps) / window, 2) if self.stamps
            else 0.0,
            "latency_ms_mean": round(1e3 * sum(xs) / n, 3) if n else 0.0,
            "latency_ms_p50": round(1e3 * pct(0.50), 3),
            "latency_ms_p90": round(1e3 * pct(0.90), 3),
            "latency_ms_p99": round(1e3 * pct(0.99), 3),
        }


class MetricRecorder:
    """Lives inside the router; one LatencyWindow per endpoint and backend."""

    def __init__(self):
        self.endpoints: Dict[str, LatencyWindow] = {}
        self.backends: Dict[str, LatencyWindow] = {}

    def record(self, endpoint: str, backend: str, latency_s: float,
               error: bool = False) -> None:
        self.endpoints.setdefault(endpoint, LatencyWindow()).record(
            latency_s, error)
        self.backends.setdefault(backend, LatencyWindow()).record(
            latency_s, error)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "endpoints": {k: w.snapshot() for k, w in self.endpoints.items()},
            "backends": {k: w.snapshot() for k, w in self.backends.items()},
        }


class ExporterInterface:
    """Render strategy over a metrics snapshot (reference
    serve/metric/exporter.py ExporterInterface)."""

    def export(self, snapshot: Dict[str, Any]):
        raise NotImplementedError


class InMemoryExporter(ExporterInterface):
    """Returns the snapshot dict verbatim (reference InMemoryExporter)."""

    def export(self, snapshot: Dict[str, Any]):
        return snapshot


class PrometheusExporter(ExporterInterface):
    """Renders the Prometheus text exposition format — no client library,
    the format is just lines (reference PrometheusExporter)."""

    @staticmethod
    def _escape(value: str) -> str:
        """Prometheus label-value escaping: backslash, quote, newline."""
        return (value.replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    def export(self, snapshot: Dict[str, Any]) -> str:
        lines: List[str] = []

        def emit(scope: str, name: str, stats: Dict[str, float]) -> None:
            label = f'{{{scope}="{self._escape(name)}"}}'
            for key, val in stats.items():
                metric = f"ray_serve_{scope}_{key}"
                lines.append(f"{metric}{label} {val}")

        for ep, stats in snapshot.get("endpoints", {}).items():
            emit("endpoint", ep, stats)
        for b, stats in snapshot.get("backends", {}).items():
            emit("backend", b, stats)
        return "\n".join(lines) + "\n"

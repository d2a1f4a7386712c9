"""Progress reporting (reference: python/ray/tune/progress_reporter.py)."""

from __future__ import annotations

import sys
import time
from typing import List, Optional


class ProgressReporter:
    def should_report(self, trials: List, done: bool = False) -> bool:
        raise NotImplementedError

    def report(self, trials: List, done: bool = False) -> None:
        raise NotImplementedError


class CLIReporter(ProgressReporter):
    def __init__(self, metric_columns: Optional[List[str]] = None,
                 max_report_frequency: float = 5.0):
        self._metrics = metric_columns or [
            "training_iteration", "episode_reward_mean", "mean_loss"]
        self._freq = max_report_frequency
        self._last = 0.0

    def should_report(self, trials: List, done: bool = False) -> bool:
        return done or (time.time() - self._last) >= self._freq

    def report(self, trials: List, done: bool = False) -> None:
        self._last = time.time()
        by_status: dict = {}
        for t in trials:
            by_status.setdefault(t.status, []).append(t)
        counts = ", ".join(f"{len(v)} {k}" for k, v in sorted(by_status.items()))
        lines = [f"== Status: {counts} =="]
        for t in trials[:20]:
            metrics = " ".join(
                f"{m}={t.last_result[m]:.4g}" for m in self._metrics
                if isinstance(t.last_result.get(m), (int, float)))
            lines.append(f"  {t} [{t.status}] {metrics}")
        print("\n".join(lines), file=sys.stderr)

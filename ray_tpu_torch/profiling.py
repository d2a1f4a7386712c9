"""User-facing profiling (reference: python/ray/profiling.py:17 ray.profile).

``with ray_tpu_torch.profile("fetch weights"):`` records a span into the worker's
event log; ``ray_tpu_torch.timeline()`` exports every span (task/actor/user) as
chrome://tracing JSON, same as the reference's state.chrome_tracing_dump.

The port's copy of ``ray_tpu/profiling.py``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from ._private.worker import global_worker


class _ProfileSpan:
    def __init__(self, event_type: str, extra_data: Optional[Dict[str, Any]]):
        self.event_type = event_type
        self.extra_data = extra_data or {}
        self.start = 0.0

    def __enter__(self):
        self.start = time.monotonic()
        return self

    def set_attribute(self, key: str, value: Any) -> None:
        self.extra_data[key] = value

    def __exit__(self, exc_type, exc, tb):
        worker = global_worker()
        if worker.connected:
            worker.core.events.record(
                "user", self.event_type, self.start, time.monotonic(),
                **self.extra_data)
        return False


def profile(event_type: str,
            extra_data: Optional[Dict[str, Any]] = None) -> _ProfileSpan:
    return _ProfileSpan(event_type, extra_data)

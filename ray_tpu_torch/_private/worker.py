"""Process-global worker state (reference: python/ray/worker.py Worker :83).

The port's copy of ``ray_tpu/_private/worker.py``. Only the local runtime
connects it for now.
"""

from __future__ import annotations

import threading
from typing import Optional


class Worker:
    def __init__(self):
        self.core = None          # LocalRuntime or cluster CoreWorker
        self.mode: Optional[str] = None  # "local" | "driver" | "worker"
        self.connected = False

    def check_connected(self):
        if not self.connected:
            raise RuntimeError(
                "ray_tpu_torch.init() must be called before using the API"
            )


_worker = Worker()
_lock = threading.Lock()


def global_worker() -> Worker:
    return _worker

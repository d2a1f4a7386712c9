"""Thread CPU truth from ``/proc/self/task/*`` for the flight recorder's
on-CPU stack tagging.

The port's copy of the two functions of ``ray_tpu/_private/loopmon.py``
that the local runtime reaches: ``enabled()``, the kill switch
(``RAY_TPU_TORCH_LOOPMON=0``, which also turns the recorder's tagging
reads off), and ``thread_cpu_ns()``. The event-loop observatory
(``LoopMonitor``, ``ThreadCpuSampler``) serves the cluster's control-plane
loops and comes with the cluster runtime (A6 of ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import Optional


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

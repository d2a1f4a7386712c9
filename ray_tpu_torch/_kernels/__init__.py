"""Build and load the port's hand-written CUDA kernels (see build.py), and
count their launches.

Each kernel wrapper keeps its launch count in an attribute of its own
function (``rms_norm.launches``, ``rms_norm.backward_launches``, ...).
``count_launch`` adds one under a lock, so threads that launch at once
(two trainer workers sharing the card) lose no count.
"""

from __future__ import annotations

import threading

_COUNT_LOCK = threading.Lock()


def count_launch(fn, attr: str = "launches") -> None:
    """Add one to ``fn.<attr>``, atomically across threads."""
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + 1)

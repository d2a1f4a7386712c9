"""SIGUSR1 stack dumps for cluster processes.

Reference: ``ray stack`` (python/ray/scripts/scripts.py:1000) shells out to
py-spy; py-spy isn't in this image, so every cluster process registers a
faulthandler that appends all-thread tracebacks to a per-pid file under
``<tmpdir>/ray_tpu_torch_stacks/`` on SIGUSR1. ``cli stack`` signals the session's
process tree and prints the files.
"""

from __future__ import annotations

import faulthandler
import os
import signal
import tempfile

STACK_DIR = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_stacks")

_registered_file = None


def register_stack_dump() -> str:
    """Idempotently register the SIGUSR1 all-threads dump for this process."""
    global _registered_file
    path = os.path.join(STACK_DIR, f"{os.getpid()}.txt")
    if _registered_file is not None:
        return path
    try:
        os.makedirs(STACK_DIR, exist_ok=True)
        _registered_file = open(path, "a")
        faulthandler.register(
            signal.SIGUSR1, file=_registered_file, all_threads=True
        )
    except (OSError, ValueError, AttributeError):
        # Non-main interpreter / restricted platform: stacks are a debug
        # aid, never a startup failure.
        _registered_file = None
    return path

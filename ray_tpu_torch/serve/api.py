"""Serve API (counterpart: ``ray_tpu/serve/api.py``). This slice carries
only ``accept_batch``; the control plane (master, router, replicas, HTTP
ingress) arrives with the runtime slice."""

from __future__ import annotations

from typing import Callable


def accept_batch(fn: Callable) -> Callable:
    """Mark a callable as batch-aware: it receives List[ServeRequest]."""
    fn.__serve_accept_batch__ = True
    return fn

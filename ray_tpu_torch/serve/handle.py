"""ServeHandle: Python-side handle to an endpoint (reference: python/ray/serve/handle.py).

The port's copy of ``ray_tpu/serve/handle.py``."""

from __future__ import annotations

from typing import Any, Optional


class ServeHandle:
    """Submit queries to an endpoint from Python; returns ObjectRefs.

    ``handle.remote(x)`` routes through the Router actor (traffic split,
    batching, replica selection) and resolves to the backend's return value.
    """

    def __init__(self, router_handle: Any, endpoint: str,
                 method: Optional[str] = None):
        self._router = router_handle
        self._endpoint = endpoint
        self._method = method or ""

    def options(self, *, method: Optional[str] = None) -> "ServeHandle":
        """A handle that invokes a named method of a class backend."""
        return ServeHandle(self._router, self._endpoint, method)

    def remote(self, *args, **kwargs):
        return self._router.route.remote(
            self._endpoint, self._method, args, kwargs)

    def stream(self, *args, **kwargs):
        """Generator of incremental results from a streaming backend.

        Requires the backend to expose ``stream_start``/``stream_poll``
        (e.g. serve.lm.LMBackend): yields each token as the replica's
        engine produces it. Polls are LONG-POLLS — the replica replies as
        soon as it has buffered tokens (its pump thread decodes
        independently of this loop), so one round-trip carries a batch of
        tokens. Closing the generator early cancels the server-side
        stream.
        """
        import ray_tpu_torch

        wait_s = float(kwargs.pop("poll_wait_s", 2.0))
        token = ray_tpu_torch.get(self._router.route.remote(
            self._endpoint, "stream_start", args, kwargs))
        finished = False
        try:
            while True:
                out = ray_tpu_torch.get(self._router.route.remote(
                    self._endpoint, "stream_poll", (token,),
                    {"wait_s": wait_s}))
                for t in out["tokens"]:
                    yield t
                if out["done"]:
                    finished = True
                    return
        finally:
            if not finished:
                try:
                    ray_tpu_torch.get(self._router.route.remote(
                        self._endpoint, "stream_cancel", (token,), {}))
                except Exception:  # noqa: BLE001 - best-effort cleanup
                    pass

    def __repr__(self):
        return f"ServeHandle(endpoint={self._endpoint!r})"

    def __reduce__(self):
        return (ServeHandle, (self._router, self._endpoint, self._method or None))

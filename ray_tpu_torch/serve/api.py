"""Public serve API (reference: python/ray/serve/api.py).

serve.init() -> master actor; create_backend/create_endpoint/set_traffic wire
the control plane; get_handle() returns the data-plane handle.

The port's copy of ``ray_tpu/serve/api.py``. Backends run where their own
arguments put them: ``LMBackend`` takes ``device`` among its keyword
arguments (``create_backend(..., device="cpu")``), and serve never moves a
backend off the card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch

from .config import BackendConfig
from .handle import ServeHandle
from .master import MASTER_NAME, ServeMaster

_master = None


def init(http_host: Optional[str] = None,
         http_port: Optional[int] = None) -> None:
    """Start (or connect to) the serve control plane.

    ``http_port`` starts the HTTP ingress (0 = auto-pick a free port);
    None = no HTTP, python-handle-only serving.
    """
    global _master
    if _master is not None:
        return
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    try:
        _master = ray_tpu_torch.get_actor(MASTER_NAME)
    except Exception:
        # Infinite restarts: a crashed control plane recovers from its
        # checkpoint (load_checkpoint) while replicas keep serving.
        _master = ray_tpu_torch.remote(num_cpus=0, max_restarts=-1)(
            ServeMaster).options(name=MASTER_NAME).remote(http_host, http_port)
        # Force construction so later calls can't race a half-built master.
        ray_tpu_torch.get(_master.get_router.remote())


def shutdown() -> None:
    global _master
    if _master is None:
        return
    try:
        proxy = ray_tpu_torch.get(_master.get_http_proxy.remote())[0]
        if proxy is not None:
            ray_tpu_torch.get(proxy.stop.remote())
            ray_tpu_torch.kill(proxy)
        ray_tpu_torch.get(_master.shutdown_children.remote())
        router = ray_tpu_torch.get(_master.get_router.remote())[0]
        ray_tpu_torch.kill(router)
        ray_tpu_torch.kill(_master)
    finally:
        _master = None


def _require_master():
    if _master is None:
        raise RuntimeError("serve.init() must be called first")
    return _master


def create_backend(backend_tag: str, func_or_class: Any, *init_args,
                   config: Optional[BackendConfig] = None,
                   **init_kwargs) -> None:
    """Extra keyword arguments are passed to the backend class constructor
    (e.g. ``LMBackend(..., paged=True, page_size=128)``)."""
    cfg = (config or BackendConfig()).to_dict()
    ray_tpu_torch.get(_require_master().create_backend.remote(
        backend_tag, func_or_class, init_args, cfg, init_kwargs))


def delete_backend(backend_tag: str) -> None:
    ray_tpu_torch.get(_require_master().delete_backend.remote(backend_tag))


def update_backend_config(backend_tag: str, config: Dict[str, Any]) -> None:
    ray_tpu_torch.get(_require_master().update_backend_config.remote(
        backend_tag, dict(config)))


def list_backends() -> Dict[str, dict]:
    return ray_tpu_torch.get(_require_master().list_backends.remote())


def create_endpoint(endpoint: str, *, backend: str,
                    route: Optional[str] = None,
                    methods: Optional[List[str]] = None) -> None:
    ray_tpu_torch.get(_require_master().create_endpoint.remote(
        endpoint, backend, route, [m.upper() for m in (methods or ["GET"])]))


def delete_endpoint(endpoint: str) -> None:
    ray_tpu_torch.get(_require_master().delete_endpoint.remote(endpoint))


def list_endpoints() -> Dict[str, dict]:
    return ray_tpu_torch.get(_require_master().list_endpoints.remote())


def set_traffic(endpoint: str, traffic: Dict[str, float]) -> None:
    ray_tpu_torch.get(_require_master().set_traffic.remote(
        endpoint, dict(traffic)))


def get_handle(endpoint: str) -> ServeHandle:
    router = ray_tpu_torch.get(_require_master().get_router.remote())[0]
    return ServeHandle(router, endpoint)


def stat(exporter=None):
    """Routing stats + per-endpoint/backend latency metrics
    (reference: serve/api.py:377 stat + serve/metric/ exporters).

    ``exporter``: an ``ExporterInterface`` deciding the render format —
    default ``InMemoryExporter`` (plain dict); ``PrometheusExporter()``
    returns the text exposition format.
    """
    from .metric import InMemoryExporter

    master = _require_master()
    router = ray_tpu_torch.get(master.get_router.remote())[0]
    rendered = (exporter or InMemoryExporter()).export(
        ray_tpu_torch.get(router.metric_snapshot.remote()))
    if isinstance(rendered, dict):
        # Dict renders merge with the routing stats; text renders (e.g.
        # Prometheus scrapes) skip the extra control-plane RPC entirely.
        base = ray_tpu_torch.get(master.stat.remote())
        return {**base, "metrics": rendered}
    return rendered


def accept_batch(fn: Callable) -> Callable:
    """Mark a callable as batch-aware: it receives List[ServeRequest]."""
    fn.__serve_accept_batch__ = True
    return fn


def http_address() -> Optional[str]:
    proxy = ray_tpu_torch.get(_require_master().get_http_proxy.remote())[0]
    if proxy is None:
        return None
    return ray_tpu_torch.get(proxy.address.remote())

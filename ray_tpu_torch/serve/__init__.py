"""Model serving (counterpart: ``ray_tpu/serve``; reference:
``python/ray/serve/``): a control-plane master actor, an asyncio router
actor with per-backend batching and traffic splitting, replica actors, and
an HTTP ingress, on the port's local runtime. The data plane is plain actor
calls, so a backend keeps its weights and caches on the card between
requests; ``LMBackend`` is the flagship model's backend.

    serve.init(http_port=0)
    serve.create_backend("lm:v1", LMBackend, params, cfg,
                         config=BackendConfig(max_batch_size=8))
    serve.create_endpoint("gen", backend="lm:v1", route="/generate")
    tokens = ray_tpu_torch.get(serve.get_handle("gen").remote([1, 2, 3]))
"""

from .api import (  # noqa: F401
    accept_batch,
    create_backend,
    create_endpoint,
    delete_backend,
    delete_endpoint,
    get_handle,
    http_address,
    init,
    list_backends,
    list_endpoints,
    set_traffic,
    shutdown,
    stat,
    update_backend_config,
)
from ..exceptions import ReplicaUnavailableError  # noqa: F401
from .config import BackendConfig, ServeRequest  # noqa: F401
from .handle import ServeHandle  # noqa: F401
from .metric import (  # noqa: F401
    ExporterInterface, InMemoryExporter, PrometheusExporter,
)
from .lm import LMBackend  # noqa: F401

__all__ = [
    "init",
    "shutdown",
    "create_backend",
    "create_endpoint",
    "delete_backend",
    "delete_endpoint",
    "set_traffic",
    "get_handle",
    "list_backends",
    "list_endpoints",
    "update_backend_config",
    "accept_batch",
    "stat",
    "http_address",
    "BackendConfig",
    "ServeRequest",
    "ReplicaUnavailableError",
    "ServeHandle",
    "ExporterInterface",
    "InMemoryExporter",
    "PrometheusExporter",
    "LMBackend",
]

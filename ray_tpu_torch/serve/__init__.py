"""Model serving (counterpart: ``ray_tpu/serve``). This slice holds the LM
backend that a serve replica hosts, called directly as serve's replicas
call it; the control plane arrives with the runtime slice."""

from .api import accept_batch  # noqa: F401
from .config import BackendConfig, ServeRequest  # noqa: F401
from .lm import LMBackend  # noqa: F401

__all__ = ["accept_batch", "BackendConfig", "ServeRequest", "LMBackend"]

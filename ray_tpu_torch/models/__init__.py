"""Models (counterpart: ``ray_tpu/models``). This slice holds the flagship
transformer's serving path; training, MoE and vision arrive later."""

from .transformer import (  # noqa: F401
    TransformerConfig,
    init_params,
    params_from_numpy,
)
# generate deliberately NOT re-exported: `from .generate import generate`
# would shadow the ray_tpu_torch.models.generate submodule itself.

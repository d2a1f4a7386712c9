"""Models (counterpart: ``ray_tpu/models``). The flagship transformer's
serving path and its train step; MoE and vision arrive later."""

from .transformer import (  # noqa: F401
    TransformerConfig,
    forward,
    init_params,
    loss_fn,
    make_train_step,
    named_leaves,
    params_from_numpy,
    to_compute,
)
# generate deliberately NOT re-exported: `from .generate import generate`
# would shadow the ray_tpu_torch.models.generate submodule itself.

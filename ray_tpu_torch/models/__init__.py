"""Models (counterpart: ``ray_tpu/models``): the flagship transformer (its
serving engines and its train step), the MoE transformer and the vision
family, each on one device or across the ranks of a mesh.

Exported as in the JAX package: the flagship's config, init, forward, loss,
train step and shardings, and the vision family's. ``moe_transformer`` is
imported as a module (its names mirror the dense model's), and so is
``generate``.
"""

from .transformer import (  # noqa: F401
    TransformerConfig,
    forward,
    init_params,
    loss_fn,
    make_train_step,
    named_leaves,
    param_shardings,
    params_from_numpy,
    to_compute,
)
# moe_transformer deliberately NOT re-exported: its public names
# (init_params/forward/loss_fn/...) mirror transformer's and would shadow
# them; import ray_tpu_torch.models.moe_transformer.
from .vision import (  # noqa: F401
    VisionConfig,
    init_vision_params,
    vision_accuracy,
    vision_apply,
    vision_loss,
    vision_param_shardings,
    vision_params_from_numpy,
)
# generate deliberately NOT re-exported: `from .generate import generate`
# would shadow the ray_tpu_torch.models.generate submodule itself.

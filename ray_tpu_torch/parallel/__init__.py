"""Parallelism layer (counterpart: ``ray_tpu/parallel``).

The routed Mixture-of-Experts FFN on one device. The device meshes, the
collectives, ring and Ulysses attention, the pipeline and the experts'
shardings (``make_mesh``, ``moe_param_shardings``, ...) come with the
parallelism slice (A7b) of ROADMAP.md.
"""

from .moe import MoEConfig, init_moe_params, moe_ffn  # noqa: F401

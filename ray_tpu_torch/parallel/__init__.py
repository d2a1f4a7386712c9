"""Parallelism layer (counterpart: ``ray_tpu/parallel``).

SPMD in processes: ``launch`` (or torchrun) starts one process a rank in a
gloo world, ``make_mesh`` names the world's axes (dp, pp, sp, tp), each
rank holds its shard of every parameter and batch (``shard``, ``gather``)
and ``collectives`` moves data between them, CUDA tensors through pinned
host memory. On top: ring and Ulysses attention over sp, the GPipe
pipeline over pp, and the routed Mixture-of-Experts FFN with its experts
sharded over tp.
"""

from .mesh import (  # noqa: F401
    AXIS_ORDER, Mesh, MeshSpec, NamedSharding, P, World, gather, launch,
    make_mesh, named, rank_state, replicated, shard,
)
from .ring_attention import (  # noqa: F401
    ring_attention, ring_attention_sharded,
)
from .ulysses import ulysses_attention, ulysses_attention_sharded  # noqa: F401
from .pipeline import gpipe, gpipe_sharded  # noqa: F401
from .moe import (  # noqa: F401
    MoEConfig, init_moe_params, moe_ffn, moe_param_shardings,
)
from . import collectives  # noqa: F401

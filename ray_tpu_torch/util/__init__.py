"""ray_tpu_torch.util: dataflow and compatibility utilities over tasks/actors.

Reference surface: ``python/ray/util/`` — ParallelIterator (iter.py), ActorPool
(actor_pool.py), multiprocessing.Pool shim, joblib backend, named actors.
All layers here are pure orchestration over the core task/actor API; the
compute inside each shard/worker is the caller's own torch code, on the
device the caller puts it on.
"""

from .actor_pool import ActorPool  # noqa: F401
from .iter import (  # noqa: F401
    LocalIterator,
    ParallelIterator,
    ParallelIteratorWorker,
    from_actors,
    from_items,
    from_iterators,
    from_range,
)
from .named_actors import get_actor, register_actor  # noqa: F401
from .queue import Empty, Full, Queue  # noqa: F401

__all__ = [
    "ActorPool",
    "ParallelIterator",
    "LocalIterator",
    "ParallelIteratorWorker",
    "from_items",
    "from_range",
    "from_iterators",
    "from_actors",
    "Queue",
    "Empty",
    "Full",
    "get_actor",
    "register_actor",
]

"""Multi-process / multi-node cluster runtime.

The distributed control plane equivalent to the reference's raylet + GCS
(reference: ``src/ray/raylet/``, ``src/ray/gcs/gcs_server/``), re-architected
around a data-parallel placement pass:

  - one GCS head process: tables (nodes/actors/objects/functions), pubsub,
    heartbeat death detection, and the global placement service backed by the
    batch placement pass (ray_tpu_torch.scheduler.BatchScheduler) on the
    head's device, the card unless ``device="cpu"`` is named;
  - one NodeController per host (the raylet equivalent): worker pool, local
    object store, dependency fetching, task dispatch;
  - worker processes executing tasks/actors with the same public API
    (nested submits route through their node controller).

Transport is a length-prefixed pickle protocol over TCP (protocol.py); bulk
object payloads ride the same channel chunked. The shared-memory C++ arena
(ray_tpu_torch/_native) backs the local object store when built.

Object tracking is ownership-sharded (ownership.py): each driver owns the
inline results its job creates and serves them from an in-process owner
table over wire-v9 frames; the GCS keeps only membership plus a
consistent-hash directory of owners (kill switch ``RAY_TPU_TORCH_OWNERSHIP=0``).

The port's copy of ``ray_tpu/cluster``: the wire format is byte-identical
to the JAX package's; shared-memory names (``rtts-`` arenas, ``rttr-``
completion rings) and spill directories (``ray_tpu_torch_spill``) are the
port's own, so the two packages' clusters can share a machine.
"""

from .ownership import OwnerRing, OwnerServer, OwnerTable  # noqa: F401
from .testing import Cluster  # noqa: F401

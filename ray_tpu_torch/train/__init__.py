"""Training library (counterpart: ``ray_tpu/train``).

- ``MeshTrainer`` — a train step of any ``(init_fn, loss_fn)`` pair with a
  torch optimizer, on one device or SPMD over a mesh (each rank its
  parameter shard and batch block, gradients averaged over dp and sp), its
  losses kept on the device until the end of ``train``.
- ``TPUTrainer`` — actor-based data parallelism with elastic fault
  tolerance, the reference's TorchTrainer contract: N worker actors compute
  gradients on their data shards, the driver averages them and steps the
  optimizer, and a dead worker's set is rebuilt. The name is the JAX
  package's; its workers run on the card.
"""

from .mesh_trainer import MeshTrainer, TrainState  # noqa: F401
from .trainer import TPUTrainer  # noqa: F401

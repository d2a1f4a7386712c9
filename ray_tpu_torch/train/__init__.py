"""Training library (counterpart: ``ray_tpu/train``).

- ``MeshTrainer`` — one program, one device: a train step of any
  ``(init_fn, loss_fn)`` pair with a torch optimizer, its losses kept on the
  device until the end of ``train``. Its mesh, parameter shardings and
  batch spec come with the parallelism slice (A7b) of ROADMAP.md.
- ``TPUTrainer`` — actor-based data parallelism with elastic fault
  tolerance, the reference's TorchTrainer contract: N worker actors compute
  gradients on their data shards, the driver averages them and steps the
  optimizer, and a dead worker's set is rebuilt. The name is the JAX
  package's; its workers run on the card.
"""

from .mesh_trainer import MeshTrainer, TrainState  # noqa: F401
from .trainer import TPUTrainer  # noqa: F401

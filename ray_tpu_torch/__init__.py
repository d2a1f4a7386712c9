"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for one NVIDIA H100.

A package of its own beside ``ray_tpu`` (the JAX reference), with the same
module names so each counterpart is easy to find. It imports ``torch`` and
numpy, never ``jax`` nor anything of ``ray_tpu``. Kernels that the JAX
package wrote in Pallas for the TPU are CUDA C++ sources under ``csrc/``,
built with nvcc at first use (``_kernels/build.py``).

Entry points take an explicit ``device`` and default to CUDA: without a
card they raise unless the caller passes ``device="cpu"``. They never fall
back to the CPU on their own.

The port grows slice by slice (see ROADMAP.md). Slice 1 is the serving path:
``serve.LMBackend`` -> ``models.engine.GenerationEngine`` -> the RMSNorm
and flash-decode kernels. Slice 2 is the train step:
``models.make_train_step`` -> ``models.loss_fn`` -> the RMSNorm,
cross-entropy and flash-attention forward/backward kernels. Slice 3 is the
paged serving path: ``serve.LMBackend(paged=True)`` ->
``models.paged_engine.PagedGenerationEngine`` (page pool, prefix caching)
-> the RMSNorm and paged flash-decode kernels. The substrate
(``exceptions``, ``object_ref``, ``_private``'s ids, resources, config,
task specs and serialization) and the batch placement passes
(``scheduler``: ``schedule_dag``, ``BatchScheduler``, the gang,
pending-reason and locality passes) are torch ops on the card, equal bit
for bit to the JAX package's. The local runtime is the framework itself:
``init()``, ``@remote`` tasks and actors, ``put``/``get``/``wait``, the
in-process object store with spill to disk and reference counting,
placement groups, ``timeline()`` and ``state``, with ``num_gpus`` and the
``GPU`` resource in place of the JAX package's ``num_tpus`` and ``TPU``.
Tasks and actors run on threads that share torch's default CUDA stream, so
a CUDA tensor passes between them in order and without a copy. The cluster
runtime (``cluster``: ``init(address=...)``, a GCS head, node controllers
and worker processes on one or more hosts) runs the same API across
processes; its GCS places with the batch placement passes on the head's
device, and a CUDA tensor crosses processes as its bytes, copied to the
host on the way out and back to the card on the way in.
"""

from __future__ import annotations

from typing import Optional, Union

__version__ = "0.1.0"

# torch is imported by the first module that computes with it, not by the
# package: a cluster worker process that runs no tensor code starts
# without torch's import (seconds a process).
Device = Union[str, "torch.device", None]


def default_device(device: Device = None) -> "torch.device":
    """Resolve an entry point's ``device`` argument.

    ``None`` means the card. A CUDA device (named or defaulted) raises
    RuntimeError when no card is present, so no entry point silently runs
    on the CPU; the CPU is used only when asked for by name."""
    import torch

    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"ray_tpu_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev


from .api import (  # noqa: E402,F401
    available_resources,
    cancel,
    free,
    cluster_resources,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    shutdown,
    timeline,
    wait,
)
from .exceptions import (  # noqa: E402,F401
    ActorDiedError,
    ActorError,
    GetTimeoutError,
    ObjectLostError,
    PlacementGroupError,
    RayTpuError,
    ReplicaUnavailableError,
    TaskCancelledError,
    TaskError,
    TaskPoisonedError,
    TaskTimeoutError,
    WorkerCrashedError,
)
from .object_ref import ObjectRef  # noqa: E402,F401
from .placement_group import (  # noqa: E402,F401
    PlacementGroup,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from .remote_function import remote  # noqa: E402,F401
from .actor import Checkpointable, exit_actor  # noqa: E402,F401
from .profiling import profile  # noqa: E402,F401
from . import state  # noqa: E402,F401


def register_custom_serializer(cls, *, serializer, deserializer) -> None:
    """Install a custom (de)serializer for a type
    (reference: worker.py:1397 register_custom_serializer)."""
    from ._private.serialization import get_context

    get_context().register_custom_serializer(cls, serializer, deserializer)


__all__ = [
    "__version__",
    "default_device",
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "get",
    "put",
    "wait",
    "kill",
    "cancel",
    "free",
    "get_actor",
    "nodes",
    "cluster_resources",
    "available_resources",
    "timeline",
    "placement_group",
    "remove_placement_group",
    "placement_group_table",
    "PlacementGroup",
    "profile",
    "state",
    "exit_actor",
    "Checkpointable",
    "register_custom_serializer",
    "ObjectRef",
    "RayTpuError",
    "TaskError",
    "ActorError",
    "ActorDiedError",
    "ObjectLostError",
    "PlacementGroupError",
    "GetTimeoutError",
    "TaskCancelledError",
    "TaskTimeoutError",
    "TaskPoisonedError",
    "WorkerCrashedError",
    "ReplicaUnavailableError",
]

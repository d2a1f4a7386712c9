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
-> the RMSNorm and paged flash-decode kernels.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"

Device = Union[str, torch.device, None]


def default_device(device: Device = None) -> torch.device:
    """Resolve an entry point's ``device`` argument.

    ``None`` means the card. A CUDA device (named or defaulted) raises
    RuntimeError when no card is present, so no entry point silently runs
    on the CPU; the CPU is used only when asked for by name."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"ray_tpu_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev


__all__ = ["__version__", "default_device"]

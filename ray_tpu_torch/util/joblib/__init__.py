"""joblib backend so sklearn-style code parallelizes over the cluster.

Reference behavior: ``python/ray/util/joblib/`` — ``register_ray()`` installs
a joblib parallel backend named "ray" built on the multiprocessing Pool shim.
The port registers it under its package's name, "ray_tpu_torch", and under
the reference's "ray" as well. Usage::

    from ray_tpu_torch.util.joblib import register_ray
    register_ray()
    with joblib.parallel_backend("ray_tpu_torch"):
        ...
"""

from __future__ import annotations


def register_ray() -> None:
    import joblib
    from joblib.parallel import register_parallel_backend

    from .ray_backend import RayTpuBackend

    register_parallel_backend("ray_tpu_torch", RayTpuBackend)
    # Alias under the reference's name for drop-in compatibility.
    register_parallel_backend("ray", RayTpuBackend)


__all__ = ["register_ray"]

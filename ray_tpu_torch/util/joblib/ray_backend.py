"""joblib parallel backend on the actor pool (reference: util/joblib/ray_backend.py)."""

from __future__ import annotations

from joblib._parallel_backends import (
    FallbackToBackend,
    MultiprocessingBackend,
    SequentialBackend,
)

import ray_tpu_torch
from ray_tpu_torch.util.multiprocessing.pool import Pool


class RayTpuBackend(MultiprocessingBackend):
    """Joblib backend dispatching batches to ray_tpu_torch actors."""

    supports_timeout = True

    def configure(self, n_jobs: int = 1, parallel=None, prefer=None,
                  require=None, **memmapping_args):
        n_jobs = self.effective_n_jobs(n_jobs)
        if n_jobs == 1:
            raise FallbackToBackend(
                SequentialBackend(nesting_level=self.nesting_level))
        self._pool = Pool(n_jobs)
        self.parallel = parallel
        return n_jobs

    def effective_n_jobs(self, n_jobs: int) -> int:
        if n_jobs == 0:
            raise ValueError("n_jobs == 0 in Parallel has no meaning")
        if n_jobs is None:
            n_jobs = 1
        if n_jobs < 0:
            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init()
            n_jobs = max(1, int(ray_tpu_torch.cluster_resources().get("CPU", 1)))
        return n_jobs

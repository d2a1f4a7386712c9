"""WorkerSet: local learner + remote rollout actors
(reference: rllib/evaluation/worker_set.py)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch

from .rollout_worker import RolloutWorker


class WorkerSet:
    def __init__(self, env_spec: Any, policy_cls, config: Dict[str, Any],
                 num_workers: int):
        # The local worker holds the canonical ("learner") policy state.
        self._local = RolloutWorker(env_spec, policy_cls, config,
                                    worker_index=0)
        remote_cls = ray_tpu_torch.remote(
            num_cpus=config.get("num_cpus_per_worker", 1))(RolloutWorker)
        self._remote = [
            remote_cls.remote(env_spec, policy_cls, config, i + 1)
            for i in range(num_workers)
        ]

    def local_worker(self) -> RolloutWorker:
        return self._local

    def remote_workers(self) -> List:
        return list(self._remote)

    def sync_weights(self, global_steps: Optional[int] = None) -> None:
        """Broadcast learner weights to all rollout workers. The weights ref
        is put once and shared (reference worker_set.sync_weights).

        ``global_steps``: for policies with a step-driven exploration
        schedule (DQN family), the learner never acts, so its counter would
        broadcast as ~0 and reset every actor's epsilon clock. Passing the
        trainer's globally-sampled step count advances the learner's counter
        before the snapshot — centralized here so no trainer can forget it.
        """
        if not self._remote:
            return
        pol = self._local.policy
        if global_steps is not None and hasattr(pol, "steps"):
            pol.steps = max(pol.steps, int(global_steps))
        weights = ray_tpu_torch.put(self._local.get_weights())
        ray_tpu_torch.get([w.set_weights.remote(weights) for w in self._remote])

    def foreach_worker(self, fn: Callable) -> List:
        out = [fn(self._local)]
        out.extend(ray_tpu_torch.get([w.apply.remote(fn) for w in self._remote]))
        return out

    def stop(self) -> None:
        for w in self._remote:
            ray_tpu_torch.kill(w)
        self._remote = []

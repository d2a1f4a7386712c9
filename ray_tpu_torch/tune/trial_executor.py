"""Actor-based trial executor.

Reference behavior: ``python/ray/tune/ray_trial_executor.py:91`` — owns the
Trainable actor lifecycle (create with trial resources, restore from
checkpoint, train futures, save, stop), and the committed-resource ledger
used by ``has_resources``.

The port's copy of ``ray_tpu/tune/trial_executor.py``: a trial's ``GPU``
request reaches its actor as ``num_gpus``, where the JAX package's ``TPU``
request becomes ``num_tpus``.
"""

from __future__ import annotations

import traceback
from typing import Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.remote_function import remote

from .checkpoint_manager import Checkpoint
from .trial import Trial


class RayTrialExecutor:
    def __init__(self, reuse_actors: bool = False):
        self._committed: Dict[str, float] = {}
        self._running: Dict = {}  # train future -> trial
        self._reuse_actors = reuse_actors
        self._cached_actor = None

    # ------------------------------------------------------------ resources
    def committed_resources(self) -> Dict[str, float]:
        return dict(self._committed)

    def has_resources(self, resources: Dict[str, float]) -> bool:
        total = ray_tpu_torch.cluster_resources()
        for key, amount in resources.items():
            if self._committed.get(key, 0) + amount > total.get(key, 0):
                return False
        return True

    def _commit(self, resources: Dict[str, float], sign: int) -> None:
        for key, amount in resources.items():
            self._committed[key] = self._committed.get(key, 0) + sign * amount

    # ------------------------------------------------------------ lifecycle
    def start_trial(self, trial: Trial,
                    checkpoint: Optional[Checkpoint] = None) -> bool:
        try:
            cfg = dict(trial.config)
            cfg["__trial_id__"] = trial.trial_id
            actor_cls = remote(
                num_cpus=trial.resources.get("CPU", 1),
                num_gpus=trial.resources.get("GPU") or None,
                resources={k: v for k, v in trial.resources.items()
                           if k not in ("CPU", "GPU")} or None,
            )(trial.trainable_cls)
            trial.runner = actor_cls.remote(cfg)
            self._commit(trial.resources, +1)
            ckpt = checkpoint or trial.checkpoint
            if trial.paused_state is not None:
                ray_tpu_torch.get(trial.runner.restore_from_object.remote(
                    trial.paused_state))
                trial.paused_state = None
            elif ckpt is not None:
                if ckpt.storage == Checkpoint.MEMORY:
                    ray_tpu_torch.get(
                        trial.runner.restore_from_object.remote(ckpt.value))
                else:
                    ray_tpu_torch.get(trial.runner.restore.remote(ckpt.value))
            elif trial.restore_path:
                ray_tpu_torch.get(trial.runner.restore.remote(trial.restore_path))
            trial.status = Trial.RUNNING
            self.continue_training(trial)
            return True
        except Exception:
            trial.error_msg = traceback.format_exc()
            trial.status = Trial.ERROR
            if trial.runner is not None:
                self._cleanup_actor(trial)
            return False

    def continue_training(self, trial: Trial) -> None:
        future = trial.runner.train.remote()
        self._running[future] = trial

    def get_next_available_result(self, timeout: Optional[float] = None):
        """Block for one finished train() future; returns (trial, result|exc)."""
        if not self._running:
            return None, None
        ready, _ = ray_tpu_torch.wait(list(self._running), num_returns=1,
                                timeout=timeout)
        if not ready:
            return None, None
        future = ready[0]
        trial = self._running.pop(future)
        try:
            return trial, ray_tpu_torch.get(future)
        except Exception as e:
            return trial, e

    def drop_inflight(self, trial: Trial) -> None:
        for fut, t in list(self._running.items()):
            if t is trial:
                del self._running[fut]

    def save(self, trial: Trial, to_memory: bool = False) -> Checkpoint:
        if to_memory:
            blob = ray_tpu_torch.get(trial.runner.save_to_object.remote())
            ckpt = Checkpoint(Checkpoint.MEMORY, blob, trial.last_result)
        else:
            path = ray_tpu_torch.get(trial.runner.save.remote())
            ckpt = Checkpoint(Checkpoint.DISK, path, trial.last_result)
        trial.checkpoint_manager.on_checkpoint(ckpt)
        return ckpt

    def pause_trial(self, trial: Trial) -> None:
        trial.paused_state = ray_tpu_torch.get(trial.runner.save_to_object.remote())
        self.stop_trial(trial, Trial.PAUSED)

    def stop_trial(self, trial: Trial, status: str = Trial.TERMINATED,
                   error_msg: Optional[str] = None) -> None:
        trial.status = status
        if error_msg:
            trial.error_msg = error_msg
        if trial.runner is not None:
            self.drop_inflight(trial)
            self._cleanup_actor(trial)

    def _cleanup_actor(self, trial: Trial) -> None:
        try:
            ray_tpu_torch.get(trial.runner.stop.remote())
        except Exception:
            pass
        try:
            ray_tpu_torch.kill(trial.runner)
        except Exception:
            pass
        trial.runner = None
        self._commit(trial.resources, -1)

    def restart_trial(self, trial: Trial, new_config: Dict,
                      state: Optional[bytes] = None) -> None:
        """Stop the trial's actor and restart it with a new config (+ state
        blob) — the PBT exploit path."""
        self.drop_inflight(trial)
        self._cleanup_actor(trial)
        trial.config = dict(new_config)
        trial.paused_state = state
        trial.status = Trial.PENDING
        self.start_trial(trial)

    def in_flight(self) -> int:
        return len(self._running)

"""Trainer base: the Trainable that owns a WorkerSet
(reference: rllib/agents/trainer.py:394 + trainer_template.py:build_trainer).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Callable, Dict, Optional

import numpy as np

from ...tune.trainable import Trainable
from ..worker_set import WorkerSet

COMMON_CONFIG: Dict[str, Any] = {
    "env": None,
    "num_workers": 0,
    "num_envs_per_worker": 1,
    "rollout_fragment_length": 64,
    "train_batch_size": 256,
    "gamma": 0.99,
    "lr": 5e-4,
    "seed": 0,
    "num_cpus_per_worker": 1,
    "metrics_window": 100,
    # Where every policy of the trainer runs, the learner's and each
    # rollout worker's (ray_tpu_torch.default_device): None is the card,
    # and raises without one; "cpu" only when named.
    "device": None,
}


def _deep_merge(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


class Trainer(Trainable):
    """Subclasses define ``_policy_cls``, ``_default_config`` and either an
    execution plan (``_make_plan``) or a custom ``_train_step``."""

    _policy_cls = None
    _default_config: Dict[str, Any] = {}
    _name = "Trainer"

    def setup(self, config: Dict) -> None:
        self.raw_config = _deep_merge(
            _deep_merge(COMMON_CONFIG, self._default_config), config)
        env_spec = self.raw_config.get("env")
        if env_spec is None:
            raise ValueError(f"{self._name}: config['env'] is required")
        self.workers = WorkerSet(
            env_spec, self._policy_cls, self.raw_config,
            num_workers=self.raw_config["num_workers"])
        self._episode_history = []
        self._steps_sampled = 0
        self._steps_trained = 0
        self._build(self.raw_config)

    def _build(self, config: Dict) -> None:
        """Subclass hook: construct the execution plan / buffers."""

    def _train_step(self) -> Dict:
        raise NotImplementedError

    def step(self) -> Dict:
        stats = self._train_step() or {}
        # Collect episode metrics from all workers (reference:
        # rllib/evaluation/metrics.py collect_episodes).
        episodes = self.workers.foreach_worker(
            lambda w: w.episode_stats())
        for ep_list in episodes:
            self._episode_history.extend(ep_list)
        window = self.raw_config["metrics_window"]
        self._episode_history = self._episode_history[-window:]
        rewards = [r for r, _ in self._episode_history]
        lens = [l for _, l in self._episode_history]
        result = {
            "episode_reward_mean": float(np.mean(rewards)) if rewards else np.nan,
            "episode_reward_max": float(np.max(rewards)) if rewards else np.nan,
            "episode_reward_min": float(np.min(rewards)) if rewards else np.nan,
            "episode_len_mean": float(np.mean(lens)) if lens else np.nan,
            "episodes_total": len(self._episode_history),
            "timesteps_total": self._steps_sampled,
            **stats,
        }
        return result

    # ---- checkpointing (Trainable contract) ----

    def save_checkpoint(self, checkpoint_dir: str) -> str:
        path = os.path.join(checkpoint_dir, "policy.pkl")
        with open(path, "wb") as f:
            pickle.dump({
                "weights": self.workers.local_worker().get_weights(),
                "steps_sampled": self._steps_sampled,
                "steps_trained": self._steps_trained,
            }, f)
        return checkpoint_dir

    def load_checkpoint(self, checkpoint_path: str) -> None:
        if os.path.isdir(checkpoint_path):
            checkpoint_path = os.path.join(checkpoint_path, "policy.pkl")
        with open(checkpoint_path, "rb") as f:
            state = pickle.load(f)
        self.workers.local_worker().set_weights(state["weights"])
        self._steps_sampled = state["steps_sampled"]
        self._steps_trained = state["steps_trained"]
        self.workers.sync_weights()

    def cleanup(self) -> None:
        self.workers.stop()

    # ---- convenience (reference Trainer.compute_action) ----

    def compute_action(self, obs, explore: bool = False):
        action, _, _ = self.workers.local_worker().policy.compute_actions(
            np.asarray(obs)[None], explore=explore)
        return int(action[0])

    def get_policy(self):
        return self.workers.local_worker().policy


def build_trainer(*, name: str, policy_cls, default_config: Dict,
                  train_step: Callable[["Trainer"], Dict],
                  build: Optional[Callable[["Trainer", Dict], None]] = None):
    """Assemble a Trainer subclass from parts
    (reference: rllib/agents/trainer_template.py:build_trainer)."""

    def _build(self, config):
        if build is not None:
            build(self, config)

    cls = type(name, (Trainer,), {
        "_policy_cls": policy_cls,
        "_default_config": default_config,
        "_name": name,
        "_build": _build,
        "_train_step": lambda self: train_step(self),
    })
    return cls

"""DQN with (prioritized) replay (reference: rllib/agents/dqn/dqn.py)."""

from __future__ import annotations

from typing import Dict

import numpy as np

import ray_tpu_torch

from ..execution import PrioritizedReplayBuffer, ReplayBuffer
from ..policy import DQNPolicy
from ..sample_batch import SampleBatch
from .trainer import Trainer

DQN_CONFIG = {
    "rollout_fragment_length": 32,
    "train_batch_size": 64,
    "buffer_size": 50000,
    "prioritized_replay": True,
    "prioritized_replay_alpha": 0.6,
    "prioritized_replay_beta": 0.4,
    "learning_starts": 500,
    "target_network_update_freq": 10,  # in train iterations
    "num_train_batches_per_step": 4,
    "lr": 1e-3,
    "initial_epsilon": 1.0,
    "final_epsilon": 0.05,
    "epsilon_timesteps": 5000,
    "hiddens": [64, 64],
}


class DQNTrainer(Trainer):
    _policy_cls = DQNPolicy
    _default_config = DQN_CONFIG
    _name = "DQN"

    def _build(self, config: Dict) -> None:
        if config["prioritized_replay"]:
            self.replay = PrioritizedReplayBuffer(
                config["buffer_size"], alpha=config["prioritized_replay_alpha"],
                seed=config["seed"])
        else:
            self.replay = ReplayBuffer(config["buffer_size"],
                                       seed=config["seed"])

    def _train_step(self) -> Dict:
        cfg = self.raw_config
        remote = self.workers.remote_workers()
        if remote:
            batches = ray_tpu_torch.get([w.sample.remote() for w in remote])
        else:
            batches = [self.workers.local_worker().sample()]
        for b in batches:
            self.replay.add_batch(b)
            self._steps_sampled += b.count

        stats: Dict = {"buffer_size": len(self.replay)}
        if self._steps_sampled < cfg["learning_starts"]:
            return stats
        policy: DQNPolicy = self.workers.local_worker().policy
        for _ in range(cfg["num_train_batches_per_step"]):
            if isinstance(self.replay, PrioritizedReplayBuffer):
                batch = self.replay.sample(
                    cfg["train_batch_size"], beta=cfg["prioritized_replay_beta"])
                stats.update(policy.learn_on_batch(batch))
                self.replay.update_priorities(
                    batch["batch_indexes"], policy.last_td_error)
            else:
                batch = self.replay.sample(cfg["train_batch_size"])
                stats.update(policy.learn_on_batch(batch))
            self._steps_trained += batch.count

        if self._iteration % cfg["target_network_update_freq"] == 0:
            policy.update_target()
        self.workers.sync_weights(global_steps=self._steps_sampled)
        return stats

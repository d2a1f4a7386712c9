"""PPO + decentralized DD-PPO (reference: rllib/agents/ppo/ppo.py, ddppo.py)."""

from __future__ import annotations

from typing import Dict

import numpy as np

import ray_tpu_torch

from ..._tree import tree_map

from ..execution import ParallelRollouts, TrainOneStep
from ..policy import PPOPolicy
from ..sample_batch import SampleBatch
from .trainer import Trainer

PPO_CONFIG = {
    "rollout_fragment_length": 128,
    "train_batch_size": 512,
    "sgd_minibatch_size": 128,
    "num_sgd_iter": 8,
    "lr": 5e-4,
    "lambda": 0.95,
    "clip_param": 0.2,
    "vf_loss_coeff": 0.5,
    "entropy_coeff": 0.0,
    "use_gae": True,
    "hiddens": [64, 64],
}


class PPOTrainer(Trainer):
    """Synchronous PPO: ParallelRollouts(bulk_sync) -> TrainOneStep."""

    _policy_cls = PPOPolicy
    _default_config = PPO_CONFIG
    _name = "PPO"

    def _build(self, config: Dict) -> None:
        self._train_op = TrainOneStep(self.workers)

    def _train_step(self) -> Dict:
        target = self.raw_config["train_batch_size"]
        remote = self.workers.remote_workers()
        batches = []
        count = 0
        while count < target:
            if remote:
                got = ray_tpu_torch.get([w.sample.remote() for w in remote])
            else:
                got = [self.workers.local_worker().sample()]
            batches.extend(got)
            count += sum(b.count for b in got)
            self._steps_sampled += sum(b.count for b in got)
        batch = SampleBatch.concat_samples(batches)
        stats = self._train_op(batch)
        self._steps_trained += batch.count
        return stats


class DDPPOTrainer(Trainer):
    """Decentralized distributed PPO (reference: rllib/agents/ppo/ddppo.py).

    Each rollout worker updates its own policy replica locally
    (sample_and_learn); instead of torch.distributed allreduce among workers,
    parameter averaging runs through the object store every
    ``ddppo_sync_period`` iterations — the host-level analogue.
    """

    _policy_cls = PPOPolicy
    _default_config = {**PPO_CONFIG, "num_workers": 2, "ddppo_sync_period": 1}
    _name = "DDPPO"

    def _train_step(self) -> Dict:
        remote = self.workers.remote_workers()
        if not remote:
            w = self.workers.local_worker()
            stats = w.sample_and_learn()
            self._steps_sampled += stats.pop("steps")
            return stats
        all_stats = ray_tpu_torch.get(
            [w.sample_and_learn.remote() for w in remote])
        self._steps_sampled += sum(s.pop("steps") for s in all_stats)
        if self._iteration % self.raw_config["ddppo_sync_period"] == 0:
            self._average_weights(remote)
        return {k: float(np.mean([s[k] for s in all_stats]))
                for k in all_stats[0]}

    def _average_weights(self, remote) -> None:
        weight_sets = ray_tpu_torch.get([w.get_weights.remote() for w in remote])
        avg = tree_map(
            lambda *xs: sum(np.asarray(x) for x in xs) / len(xs),
            *weight_sets)
        ref = ray_tpu_torch.put(avg)
        ray_tpu_torch.get([w.set_weights.remote(ref) for w in remote])
        self.workers.local_worker().set_weights(avg)

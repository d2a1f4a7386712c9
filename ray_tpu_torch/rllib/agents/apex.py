"""APEX-DQN: distributed prioritized experience replay
(reference: rllib/agents/dqn/apex.py + rllib/optimizers/async_replay_optimizer.py).

The reference's architecture: many rollout workers push experience into
sharded replay-buffer ACTORS; a learner pulls prioritized samples from the
shards, trains, and pushes priority corrections back; weights broadcast
periodically. Same shape here, with the framework's own pieces: batches
travel by ObjectRef through the object store (the replay actors borrow the
refs), and the learner update is the DQN TD step.

Deliberate simplification vs the reference: the learner runs in the driver's
train step (no separate learner thread with 4 queues) — the async part is
sampling and replay sharding, which is where the reference's scalability
comes from.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

import ray_tpu_torch

from ..execution import PrioritizedReplayBuffer
from ..policy import DQNPolicy
from ..sample_batch import SampleBatch
from .dqn import DQN_CONFIG
from .trainer import Trainer

APEX_CONFIG = dict(
    DQN_CONFIG,
    num_workers=2,
    num_replay_shards=2,
    learning_starts=300,
    train_batch_size=64,
    num_train_batches_per_step=8,
    target_network_update_freq=5,
    broadcast_interval=1,      # train steps between weight broadcasts
    max_requests_in_flight=2,  # outstanding sample() calls per worker
)


@ray_tpu_torch.remote
class ReplayActor:
    """One shard of the distributed replay buffer
    (reference: async_replay_optimizer.py:ReplayActor)."""

    def __init__(self, capacity: int, alpha: float, seed: int):
        self.buffer = PrioritizedReplayBuffer(capacity, alpha=alpha, seed=seed)

    def add_batch(self, batch) -> int:
        self.buffer.add_batch(batch)
        return len(self.buffer)

    def replay(self, batch_size: int, beta: float):
        if len(self.buffer) < batch_size:
            return None
        return self.buffer.sample(batch_size, beta=beta)

    def update_priorities(self, idxes, priorities) -> None:
        self.buffer.update_priorities(idxes, priorities)

    def stats(self) -> Dict:
        return {"len": len(self.buffer)}


class ApexTrainer(Trainer):
    _policy_cls = DQNPolicy
    _default_config = APEX_CONFIG
    _name = "APEX"

    def _build(self, config: Dict) -> None:
        n_shards = max(1, config["num_replay_shards"])
        self.replay_actors: List = [
            ReplayActor.remote(
                config["buffer_size"] // n_shards,
                config["prioritized_replay_alpha"],
                config["seed"] * 131 + i,
            )
            for i in range(n_shards)
        ]
        self._next_shard = 0
        self._train_calls = 0
        # Continuous sampling pipeline: keep max_requests_in_flight sample()
        # calls outstanding per rollout worker.
        self._inflight: Dict = {}
        for w in self.workers.remote_workers():
            for _ in range(config["max_requests_in_flight"]):
                self._inflight[w.sample.remote()] = w

    def _drain_samples(self, block: bool) -> None:
        """Route finished sample batches to replay shards (by ref — the
        shard actor pulls the batch through the object store)."""
        if not self._inflight:
            batch = self.workers.local_worker().sample()
            self._steps_sampled += batch.count
            shard = self.replay_actors[self._next_shard]
            self._next_shard = (self._next_shard + 1) % len(self.replay_actors)
            ray_tpu_torch.get(shard.add_batch.remote(batch))
            return
        num = 1 if block else 0
        ready, _ = ray_tpu_torch.wait(
            list(self._inflight.keys()),
            num_returns=num if block else len(self._inflight), timeout=0.0
            if not block else None)
        for ref in ready:
            worker = self._inflight.pop(ref)
            shard = self.replay_actors[self._next_shard]
            self._next_shard = (self._next_shard + 1) % len(self.replay_actors)
            # Hand the REF to the shard: the batch moves store-to-store,
            # never through the driver.
            shard.add_batch.remote(ref)
            self._steps_sampled += self.raw_config["rollout_fragment_length"] \
                * self.raw_config["num_envs_per_worker"]
            self._inflight[worker.sample.remote()] = worker

    def _train_step(self) -> Dict:
        cfg = self.raw_config
        self._train_calls += 1
        self._drain_samples(block=True)
        self._drain_samples(block=False)

        stats: Dict = {}
        if self._steps_sampled < cfg["learning_starts"]:
            return {"buffer_waiting": True}

        policy: DQNPolicy = self.workers.local_worker().policy
        trained = 0
        for i in range(cfg["num_train_batches_per_step"]):
            shard = self.replay_actors[i % len(self.replay_actors)]
            batch = ray_tpu_torch.get(shard.replay.remote(
                cfg["train_batch_size"], cfg["prioritized_replay_beta"]))
            if batch is None:
                continue
            stats.update(policy.learn_on_batch(batch))
            shard.update_priorities.remote(
                batch["batch_indexes"], np.asarray(policy.last_td_error))
            trained += batch.count
        self._steps_trained += trained

        if self._train_calls % cfg["target_network_update_freq"] == 0:
            policy.update_target()
        if self._train_calls % cfg["broadcast_interval"] == 0:
            self.workers.sync_weights(global_steps=self._steps_sampled)
        shard_sizes = ray_tpu_torch.get(
            [ra.stats.remote() for ra in self.replay_actors])
        stats["replay_shard_sizes"] = [s["len"] for s in shard_sizes]
        stats["steps_trained_this_iter"] = trained
        return stats

    def cleanup(self) -> None:
        for ra in self.replay_actors:
            ray_tpu_torch.kill(ra)
        super().cleanup()

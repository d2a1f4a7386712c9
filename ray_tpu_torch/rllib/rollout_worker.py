"""RolloutWorker: env interaction actor (reference: rllib/evaluation/rollout_worker.py).

Each worker owns a VectorEnv and a policy replica; ``sample()`` runs the
vectorized env loop (one batched forward per step) and returns a
post-processed SampleBatch. Like the reference (which subclasses
ParallelIteratorWorker), workers plug into util.iter dataflows.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..util.iter import ParallelIteratorWorker
from .env import VectorEnv, make_env
from .policy import Policy
from .sample_batch import (
    ACTIONS, DONES, LOGPS, NEXT_OBS, OBS, REWARDS, SampleBatch, VF_PREDS,
    compute_gae,
)


class RolloutWorker(ParallelIteratorWorker):
    def __init__(self, env_spec: Any, policy_cls, config: Dict[str, Any],
                 worker_index: int = 0):
        self.config = dict(config)
        self.worker_index = worker_index
        num_envs = config.get("num_envs_per_worker", 1)
        self.vec_env = VectorEnv(
            lambda: make_env(env_spec), num_envs,
            base_seed=config.get("seed", 0) * 1000 + worker_index * num_envs)
        cfg = dict(config)
        cfg["seed"] = config.get("seed", 0) * 7919 + worker_index
        # Continuous envs expose action_dim; discrete ones num_actions —
        # either way the second policy arg is the action-space size.
        act_size = self.vec_env.action_dim or self.vec_env.num_actions
        self.policy: Policy = policy_cls(
            self.vec_env.observation_dim, act_size, cfg)
        self.obs = self.vec_env.reset()
        self.total_steps = 0
        ParallelIteratorWorker.__init__(self, self._sample_forever(), False)

    def _sample_forever(self):
        while True:
            yield self.sample()

    def sample(self) -> SampleBatch:
        """Collect ``rollout_fragment_length`` steps from every sub-env."""
        horizon = self.config.get("rollout_fragment_length", 64)
        use_gae = self.config.get("use_gae", True)
        E = self.vec_env.num_envs
        cols: Dict[str, List] = {k: [] for k in
                                 (OBS, ACTIONS, REWARDS, DONES, NEXT_OBS)}
        logps: List[np.ndarray] = []
        vfs: List[np.ndarray] = []
        for _ in range(horizon):
            actions, logp, vf = self.policy.compute_actions(self.obs)
            next_obs, rew, done, _ = self.vec_env.step(actions)
            cols[OBS].append(self.obs)
            cols[ACTIONS].append(np.asarray(actions))
            cols[REWARDS].append(rew)
            cols[DONES].append(done.astype(np.float32))
            cols[NEXT_OBS].append(next_obs)
            if logp is not None:
                logps.append(np.asarray(logp))
                vfs.append(np.asarray(vf))
            self.obs = next_obs
            self.total_steps += E

        # [T, E, ...] -> per-env fragments, then concat: keeps each env's
        # timeline contiguous so GAE sees proper trajectories.
        per_env = []
        for e in range(E):
            b = SampleBatch({k: np.stack([row[e] for row in v])
                             for k, v in cols.items()})
            if logps:
                b[LOGPS] = np.stack([row[e] for row in logps])
                b[VF_PREDS] = np.stack([row[e] for row in vfs])
                if use_gae:
                    last_done = bool(b[DONES][-1])
                    last_value = 0.0 if last_done else float(
                        self.policy.value(b[NEXT_OBS][-1:])[0])
                    b = compute_gae(
                        b, last_value, self.config.get("gamma", 0.99),
                        self.config.get("lambda", 0.95))
            per_env.append(b)
        return SampleBatch.concat_samples(per_env)

    # ---- weights / metrics (reference rollout_worker get/set_weights) ----

    def get_weights(self):
        return self.policy.get_weights()

    def set_weights(self, weights) -> None:
        self.policy.set_weights(weights)

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        return self.policy.learn_on_batch(batch)

    def sample_and_learn(self) -> Dict[str, float]:
        """DD-PPO style: sample and update locally, return stats
        (reference: rllib/agents/ppo/ddppo.py)."""
        batch = self.sample()
        stats = self.policy.learn_on_batch(batch)
        stats["steps"] = batch.count
        return stats

    def apply(self, fn: Callable) -> Any:
        """Run fn(self) on the worker (reference rollout_worker.apply)."""
        return fn(self)

    def episode_stats(self) -> List:
        return self.vec_env.pop_episode_stats()

    def steps_sampled(self) -> int:
        return self.total_steps

    def ping(self) -> bool:
        return True

"""Multi-agent sampling + independent-learner training
(reference: rllib/env/multi_agent_env.py + the multiagent policy-mapping
machinery of rllib/evaluation/episode.py / sample_batch_builder.py).

Policies live in a dict keyed by policy_id; ``policy_mapping_fn(agent_id)``
routes each agent to its policy. The sampler batches all agents that share a
policy into ONE forward pass per step (one batched forward on the card), builds
per-agent trajectories, and flushes them into per-policy SampleBatches with
GAE computed per trajectory.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch

from .env import MultiAgentEnv, make_env
from .sample_batch import (
    ACTIONS, DONES, LOGPS, NEXT_OBS, OBS, REWARDS, SampleBatch, VF_PREDS,
    compute_gae,
)


class MultiAgentRolloutWorker:
    """Env-interaction worker over a MultiAgentEnv."""

    def __init__(self, env_spec: Any, policy_specs: Dict[str, Dict],
                 policy_mapping_fn: Callable[[Any], str],
                 policy_cls, config: Dict[str, Any], worker_index: int = 0):
        self.config = dict(config)
        self.env: MultiAgentEnv = make_env(env_spec)
        self.env.seed(config.get("seed", 0) * 1000 + worker_index)
        self.mapping = policy_mapping_fn
        self.policies = {}
        for pid, spec in policy_specs.items():
            cfg = dict(config)
            cfg.update(spec.get("config", {}))
            cfg["seed"] = cfg.get("seed", 0) * 7919 + hash(pid) % 1000
            self.policies[pid] = policy_cls(
                spec.get("obs_dim", self.env.observation_dim),
                spec.get("num_actions", self.env.num_actions), cfg)
        self.obs: Dict = self.env.reset()
        # Per-agent open trajectory buffers.
        self._traj: Dict[Any, Dict[str, List]] = {}
        self.completed: List = []  # (total episode reward, length)
        self._ep_reward = 0.0
        self._ep_len = 0

    def _append(self, agent, obs, action, logp, vf, reward, done, next_obs):
        t = self._traj.setdefault(agent, {
            OBS: [], ACTIONS: [], LOGPS: [], VF_PREDS: [], REWARDS: [],
            DONES: [], NEXT_OBS: []})
        t[OBS].append(obs)
        t[ACTIONS].append(action)
        t[LOGPS].append(logp)
        t[VF_PREDS].append(vf)
        t[REWARDS].append(reward)
        t[DONES].append(float(done))
        t[NEXT_OBS].append(next_obs)

    def _flush_agent(self, agent, builders: Dict[str, List]) -> None:
        t = self._traj.pop(agent, None)
        if not t or not t[OBS]:
            return
        b = SampleBatch({k: np.asarray(v, dtype=np.float32)
                         for k, v in t.items()})
        pid = self.mapping(agent)
        policy = self.policies[pid]
        last_done = bool(b[DONES][-1])
        last_value = 0.0 if last_done else float(
            policy.value(b[NEXT_OBS][-1:])[0])
        b = compute_gae(b, last_value, self.config.get("gamma", 0.99),
                        self.config.get("lambda", 0.95))
        builders.setdefault(pid, []).append(b)

    def sample(self) -> Dict[str, SampleBatch]:
        """Collect ~rollout_fragment_length env steps; returns one
        SampleBatch per policy id."""
        horizon = self.config.get("rollout_fragment_length", 32)
        builders: Dict[str, List] = {}
        for _ in range(horizon):
            # Group agents by policy: one batched forward pass per policy.
            by_policy: Dict[str, List] = {}
            for agent in self.obs:
                by_policy.setdefault(self.mapping(agent), []).append(agent)
            actions: Dict[Any, int] = {}
            meta: Dict[Any, tuple] = {}
            for pid, agents in by_policy.items():
                stacked = np.stack([self.obs[a] for a in agents])
                acts, logps, vfs = self.policies[pid].compute_actions(stacked)
                if logps is None:
                    logps = np.zeros(len(agents), np.float32)
                    vfs = np.zeros(len(agents), np.float32)
                for i, a in enumerate(agents):
                    actions[a] = int(acts[i])
                    meta[a] = (float(logps[i]), float(vfs[i]))
            next_obs, rewards, dones, _ = self.env.step(actions)
            for a, act in actions.items():
                done = bool(dones.get(a, dones.get("__all__", False)))
                nxt = next_obs.get(a, self.obs[a])
                logp, vf = meta[a]
                self._append(a, self.obs[a], act, logp, vf,
                             float(rewards.get(a, 0.0)), done, nxt)
                self._ep_reward += float(rewards.get(a, 0.0))
                if done:
                    self._flush_agent(a, builders)
            self._ep_len += 1
            if dones.get("__all__", False):
                self.completed.append((self._ep_reward, self._ep_len))
                self._ep_reward, self._ep_len = 0.0, 0
                for a in list(self._traj):
                    self._flush_agent(a, builders)
                self.obs = self.env.reset()
            else:
                self.obs = next_obs
        # Truncation: flush open trajectories (bootstrapped by GAE).
        for a in list(self._traj):
            self._flush_agent(a, builders)
        return {pid: SampleBatch.concat_samples(bs)
                for pid, bs in builders.items()}

    def learn_on_batches(self, batches: Dict[str, SampleBatch]) -> Dict:
        stats = {}
        for pid, batch in batches.items():
            for k, v in self.policies[pid].learn_on_batch(batch).items():
                stats[f"{pid}/{k}"] = v
        return stats

    def get_weights(self) -> Dict:
        return {pid: p.get_weights() for pid, p in self.policies.items()}

    def set_weights(self, weights: Dict) -> None:
        for pid, w in weights.items():
            self.policies[pid].set_weights(w)

    def episode_stats(self) -> List:
        out, self.completed = self.completed, []
        return out

    def apply(self, fn: Callable) -> Any:
        return fn(self)


class MultiAgentTrainer:
    """Independent learners over a MultiAgentEnv (reference: the default
    multiagent path of rllib/agents/trainer.py — one policy per group,
    trained on its own experience). Tune-compatible Trainable surface."""

    def __init__(self, env_spec: Any, *, policies: Dict[str, Dict],
                 policy_mapping_fn: Callable[[Any], str],
                 policy_cls=None, config: Optional[Dict] = None,
                 num_workers: int = 0):
        from .agents.pg import A2CPolicy

        self.config = dict({"rollout_fragment_length": 32, "gamma": 0.99,
                            "lambda": 0.95, "lr": 5e-3, "seed": 0,
                            "entropy_coeff": 0.01, "use_critic": True,
                            "use_gae": True, "hiddens": [32, 32]},
                           **(config or {}))
        policy_cls = policy_cls or A2CPolicy
        self.local = MultiAgentRolloutWorker(
            env_spec, policies, policy_mapping_fn, policy_cls, self.config)
        remote_cls = ray_tpu_torch.remote(MultiAgentRolloutWorker)
        self.remote = [
            remote_cls.remote(env_spec, policies, policy_mapping_fn,
                              policy_cls, self.config, i + 1)
            for i in range(num_workers)
        ]
        self._episode_history: List = []
        self.iteration = 0

    def train(self) -> Dict:
        self.iteration += 1
        if self.remote:
            all_batches = ray_tpu_torch.get(
                [w.sample.remote() for w in self.remote])
            merged: Dict[str, List] = {}
            for batches in all_batches:
                for pid, b in batches.items():
                    merged.setdefault(pid, []).append(b)
            batches = {pid: SampleBatch.concat_samples(bs)
                       for pid, bs in merged.items()}
        else:
            batches = self.local.sample()
        stats = self.local.learn_on_batches(batches)
        if self.remote:
            weights = ray_tpu_torch.put(self.local.get_weights())
            ray_tpu_torch.get([w.set_weights.remote(weights) for w in self.remote])
            for w in self.remote:
                self._episode_history.extend(
                    ray_tpu_torch.get(w.episode_stats.remote()))
        self._episode_history.extend(self.local.episode_stats())
        self._episode_history = self._episode_history[-200:]
        rewards = [r for r, _ in self._episode_history]
        return {
            "episode_reward_mean": float(np.mean(rewards)) if rewards
            else float("nan"),
            "episodes_total": len(self._episode_history),
            **stats,
        }

    def stop(self) -> None:
        for w in self.remote:
            ray_tpu_torch.kill(w)
        self.remote = []

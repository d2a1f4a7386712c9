"""QMIX: cooperative multi-agent Q-learning with monotonic value mixing
(reference: rllib/agents/qmix/ — qmix_policy.py's QMixer; Rashid et al. 2018).

Per-agent Q networks pick decentralized greedy actions; a mixing network
whose weights are produced by hypernetworks over the GLOBAL state combines
the chosen per-agent Q values into Q_tot. The mixer's weights pass through
abs() so Q_tot is monotone in every agent Q — which is what makes the joint
argmax decompose into per-agent argmaxes (the centralized-training /
decentralized-execution trick). One update takes the per-agent target
maxes, two mixer passes, the TD loss and one Adam step; the target network
is synced whole every ``target_update_freq`` train calls.

Trainer side: episodes come from a cooperative MultiAgentEnv with a fixed
agent set; joint transitions (all agents stacked) go into a uniform replay
buffer.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..._tree import tree_map
from ..env import MultiAgentEnv, make_env
from ..models import apply_mlp, init_mlp
from ..policy import (
    Adam, policy_device, policy_generator, stats_to_floats, value_and_grad,
)

QMIX_CONFIG = {
    "buffer_size": 5_000,
    "train_batch_size": 32,
    "learning_starts": 100,
    "episodes_per_step": 8,
    "num_train_batches_per_step": 4,
    "target_update_freq": 10,   # train calls between hard target syncs
    "lr": 5e-3,
    "gamma": 0.99,
    "initial_epsilon": 1.0,
    "final_epsilon": 0.05,
    "epsilon_timesteps": 1_500,
    "hiddens": [32, 32],
    "mixing_embed": 16,
    "seed": 0,
    # Where the policy runs (ray_tpu_torch.default_device): None is the
    # card, and raises without one; "cpu" only when named.
    "device": None,
}


def _init_qmix_params(gen: torch.Generator, n_agents: int, obs_dim: int,
                      num_actions: int, state_dim: int, hid: List[int],
                      embed: int):
    return {
        # One Q net shared across agents, with the agent id one-hot appended
        # to its observation (standard parameter sharing).
        "q": init_mlp(gen, [obs_dim + n_agents] + hid + [num_actions]),
        # Hypernetworks: state -> mixer weights (abs() at use site).
        "hyper_w1": init_mlp(gen, [state_dim, embed * n_agents]),
        "hyper_b1": init_mlp(gen, [state_dim, embed]),
        "hyper_w2": init_mlp(gen, [state_dim, embed]),
        "hyper_b2": init_mlp(gen, [state_dim, embed, 1]),
    }


class QMIXPolicy:
    """Joint policy over a fixed agent set."""

    def __init__(self, n_agents: int, obs_dim: int, num_actions: int,
                 state_dim: int, config: Dict[str, Any]):
        self.config = config
        self.n_agents = n_agents
        self.num_actions = num_actions
        self.device = policy_device(config)
        gen = policy_generator(config, self.device)
        # Dedicated exploration RNG: the global np.random would make the
        # epsilon-greedy trajectory depend on unrelated process history.
        self._np_rng = np.random.RandomState(config.get("seed", 0) * 31 + 7)
        hid = list(config.get("hiddens", [32, 32]))
        self.embed = config.get("mixing_embed", 16)
        self.params = _init_qmix_params(
            gen, n_agents, obs_dim, num_actions, state_dim, hid, self.embed)
        self.target = tree_map(torch.clone, self.params)
        self.opt = Adam(config.get("lr", 5e-3))
        self.opt_state = self.opt.init(self.params)
        self.epsilon = config.get("initial_epsilon", 1.0)
        self.steps = 0
        self.gamma = config.get("gamma", 0.99)
        self._ids = torch.eye(n_agents, device=self.device)

    def agent_qs(self, params, obs: torch.Tensor) -> torch.Tensor:
        """obs [B, N, obs_dim] -> per-agent Q [B, N, A]."""
        B, N = obs.shape[0], self.n_agents
        ids = self._ids.expand(B, N, N)
        x = torch.cat([obs, ids], dim=-1).reshape(B * N, -1)
        return apply_mlp(params["q"], x).reshape(B, N, -1)

    def mix(self, params, chosen_q: torch.Tensor,
            state: torch.Tensor) -> torch.Tensor:
        """chosen_q [B, N], state [B, S] -> Q_tot [B]."""
        B = chosen_q.shape[0]
        w1 = torch.abs(apply_mlp(params["hyper_w1"], state))
        w1 = w1.reshape(B, self.n_agents, self.embed)
        b1 = apply_mlp(params["hyper_b1"], state)           # [B, E]
        hidden = F.elu(torch.einsum("bn,bne->be", chosen_q, w1) + b1)
        w2 = torch.abs(apply_mlp(params["hyper_w2"], state))  # [B, E]
        b2 = apply_mlp(params["hyper_b2"], state)[..., 0]    # [B]
        return torch.sum(hidden * w2, dim=-1) + b2

    def loss(self, params, target, batch):
        q = self.agent_qs(params, batch["obs"])              # [B, N, A]
        acts = batch["actions"].long()                       # [B, N]
        chosen = q.gather(-1, acts[..., None])[..., 0]       # [B, N]
        q_tot = self.mix(params, chosen, batch["state"])
        # Monotonicity makes the joint max decompose: target Q_tot of the
        # per-agent greedy actions.
        with torch.no_grad():
            q_next_t = self.agent_qs(target, batch["next_obs"]).amax(-1)
            q_tot_next = self.mix(target, q_next_t, batch["next_state"])
            y = (batch["rewards"]
                 + self.gamma * (1.0 - batch["dones"]) * q_tot_next)
        loss = torch.mean((q_tot - y) ** 2)
        return loss, {"td_loss": loss, "q_tot_mean": torch.mean(q_tot)}

    def update(self, params, target, opt_state, batch):
        _, stats, grads = value_and_grad(
            lambda p, b: self.loss(p, target, b), params, batch)
        params, opt_state = self.opt.step(params, grads, opt_state)
        return params, opt_state, stats

    def compute_actions(self, obs_stack: np.ndarray,
                        explore: bool = True) -> np.ndarray:
        """obs_stack [N, obs_dim] -> one action per agent."""
        with torch.no_grad():
            q = self.agent_qs(self.params, torch.as_tensor(
                np.asarray(obs_stack, dtype=np.float32),
                device=self.device)[None])[0].cpu().numpy()
        actions = q.argmax(axis=-1)
        if explore:
            cfg = self.config
            frac = min(1.0, self.steps / max(cfg["epsilon_timesteps"], 1))
            eps0 = cfg.get("initial_epsilon", 1.0)
            self.epsilon = eps0 + frac * (cfg["final_epsilon"] - eps0)
            mask = self._np_rng.rand(self.n_agents) < self.epsilon
            actions = np.where(
                mask,
                self._np_rng.randint(self.num_actions, size=self.n_agents),
                actions)
            self.steps += self.n_agents
        return actions

    def learn_on_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        dev = {k: torch.as_tensor(np.asarray(v, dtype=np.float32),
                                  device=self.device)
               for k, v in batch.items()}
        self.params, self.opt_state, stats = self.update(
            self.params, self.target, self.opt_state, dev)
        return stats_to_floats(stats)

    def update_target(self) -> None:
        self.target = tree_map(torch.clone, self.params)


class QMIXTrainer:
    """Episode-based trainer over a cooperative MultiAgentEnv with a fixed
    agent set (reference: rllib/agents/qmix/qmix.py). The team reward is
    agent 0's reward (cooperative envs pay every agent the same)."""

    def __init__(self, env_spec: Any, config: Dict[str, Any] = None):
        self.config = dict(QMIX_CONFIG, **(config or {}))
        self.env: MultiAgentEnv = make_env(env_spec)
        self.env.seed(self.config["seed"])
        first = self.env.reset()
        self.agents = sorted(first.keys())
        n = len(self.agents)
        obs_dim = self.env.observation_dim
        self.policy = QMIXPolicy(
            n, obs_dim, self.env.num_actions, state_dim=n * obs_dim,
            config=self.config)
        self._replay: List[Dict] = []
        self._train_calls = 0
        self._steps_sampled = 0
        self._episode_rewards: List[float] = []

    def _stack(self, obs_dict) -> np.ndarray:
        return np.stack([obs_dict[a] for a in self.agents]).astype(np.float32)

    def _run_episode(self) -> float:
        obs = self._stack(self.env.reset())
        total = 0.0
        done = False
        while not done:
            actions = self.policy.compute_actions(obs)
            action_dict = {a: int(actions[i])
                           for i, a in enumerate(self.agents)}
            next_obs_d, rewards, dones, _ = self.env.step(action_dict)
            done = bool(dones.get("__all__", False))
            next_obs = (self._stack(next_obs_d) if next_obs_d else obs)
            team_r = float(rewards.get(self.agents[0], 0.0))
            total += sum(float(r) for r in rewards.values())
            self._replay.append({
                "obs": obs, "state": obs.reshape(-1),
                "actions": actions.astype(np.int64),
                "rewards": team_r,
                "next_obs": next_obs, "next_state": next_obs.reshape(-1),
                "dones": float(done),
            })
            if len(self._replay) > self.config["buffer_size"]:
                self._replay.pop(0)
            self._steps_sampled += 1
            obs = next_obs
        return total

    def train(self) -> Dict:
        self._train_calls += 1
        for _ in range(self.config["episodes_per_step"]):
            self._episode_rewards.append(self._run_episode())
        self._episode_rewards = self._episode_rewards[-100:]

        stats: Dict[str, Any] = {}
        if self._steps_sampled >= self.config["learning_starts"]:
            rng = np.random.RandomState(self._train_calls)
            for _ in range(self.config["num_train_batches_per_step"]):
                idx = rng.randint(0, len(self._replay),
                                  self.config["train_batch_size"])
                rows = [self._replay[i] for i in idx]
                batch = {k: np.stack([r[k] for r in rows])
                         for k in rows[0]}
                stats.update(self.policy.learn_on_batch(batch))
            if self._train_calls % self.config["target_update_freq"] == 0:
                self.policy.update_target()
        return {
            "episode_reward_mean": float(np.mean(self._episode_rewards)),
            "epsilon": self.policy.epsilon,
            "timesteps_total": self._steps_sampled,
            **stats,
        }

    def stop(self) -> None:
        pass

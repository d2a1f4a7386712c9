"""DDPG / TD3 for continuous action spaces
(reference: rllib/agents/ddpg/ — ddpg.py + td3.py; Fujimoto et al. 2018).

Deterministic tanh actor + twin Q critics on (s, a). TD3's three fixes over
DDPG are all config switches here: clipped double-Q targets
(``twin_q``), target policy smoothing noise, and delayed actor updates
(``policy_delay``). One update steps both critics and the actor in one Adam
step, then moves the targets by polyak. On a step that the delay skips the
actor's gradient is zeros and Adam still steps it, as the JAX package's
``lax.cond`` does: its moments decay and its weights keep moving.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch

from ..._tree import tree_map
from ..execution import ReplayBuffer
from ..models import apply_mlp, init_mlp
from ..policy import (
    Adam, Policy, batch_to, policy_device, policy_generator, stats_to_floats,
    to_device, to_host, value_and_grad,
)
from ..sample_batch import ACTIONS, DONES, NEXT_OBS, OBS, REWARDS, SampleBatch
from .trainer import Trainer

DDPG_CONFIG = {
    "rollout_fragment_length": 16,
    "train_batch_size": 64,
    "buffer_size": 50_000,
    "learning_starts": 300,
    "num_train_batches_per_step": 8,
    "lr": 1e-3,
    "tau": 0.02,                   # polyak coefficient
    "exploration_noise": 0.2,      # gaussian action noise while sampling
    "twin_q": False,               # TD3 switch 1
    "target_noise": 0.0,           # TD3 switch 2: smoothing sigma
    "target_noise_clip": 0.5,
    "policy_delay": 1,             # TD3 switch 3
    "hiddens": [64, 64],
}

TD3_CONFIG = dict(
    DDPG_CONFIG,
    twin_q=True,
    target_noise=0.2,
    policy_delay=2,
)


def actor(params, obs: torch.Tensor) -> torch.Tensor:
    return torch.tanh(apply_mlp(params["actor"], obs))


def q_value(q, obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    return apply_mlp(q, torch.cat([obs, act], -1))[..., 0]


class DDPGPolicy(Policy):
    _batch_keys = (OBS, ACTIONS, REWARDS, DONES, NEXT_OBS)

    def __init__(self, obs_dim: int, action_dim: int, config: Dict[str, Any]):
        self.config = config
        self.action_dim = action_dim
        self.device = policy_device(config)
        self.gen = policy_generator(config, self.device)
        hid = config.get("hiddens", [64, 64])
        self.params = {
            "actor": init_mlp(self.gen, [obs_dim] + hid + [action_dim]),
            "q1": init_mlp(self.gen, [obs_dim + action_dim] + hid + [1]),
            "q2": init_mlp(self.gen, [obs_dim + action_dim] + hid + [1]),
        }
        self.target = tree_map(torch.clone, self.params)
        self.opt = Adam(config.get("lr", 1e-3))
        self.opt_state = self.opt.init(self.params)
        self._updates = 0
        self.gamma = config.get("gamma", 0.99)
        self.tau = config.get("tau", 0.02)
        self.twin = bool(config.get("twin_q", False))
        self.t_noise = float(config.get("target_noise", 0.0))
        self.t_clip = float(config.get("target_noise_clip", 0.5))
        self.delay = int(config.get("policy_delay", 1))
        self.noise = float(config.get("exploration_noise", 0.2))

    def critic_target(self, target, batch, noise: Optional[torch.Tensor]):
        """The critics' regression target from the target networks;
        ``noise`` holds the standard normal draws of the target policy's
        smoothing, one per action (unused when ``target_noise`` is 0)."""
        with torch.no_grad():
            a_next = actor(target, batch[NEXT_OBS])
            if self.t_noise > 0:
                eps = torch.clamp(self.t_noise * noise, -self.t_clip,
                                  self.t_clip)
                a_next = torch.clamp(a_next + eps, -1.0, 1.0)
            q_next = q_value(target["q1"], batch[NEXT_OBS], a_next)
            if self.twin:
                q_next = torch.minimum(
                    q_next, q_value(target["q2"], batch[NEXT_OBS], a_next))
            return batch[REWARDS] + self.gamma * (1.0 - batch[DONES]) * q_next

    def critic_loss(self, params, batch, y):
        loss = torch.mean((q_value(params["q1"], batch[OBS], batch[ACTIONS])
                           - y) ** 2)
        if self.twin:
            loss = loss + torch.mean(
                (q_value(params["q2"], batch[OBS], batch[ACTIONS]) - y) ** 2)
        return loss, {}

    @staticmethod
    def actor_loss(actor_params, q1, batch):
        """Maximize Q1 under the current policy; the critic is frozen: the
        gradient is the actor's leaves' alone."""
        a = actor({"actor": actor_params}, batch[OBS])
        return -torch.mean(q_value(q1, batch[OBS], a)), {}

    def gradients(self, params, target, n_updates: int, batch,
                  noise: Optional[torch.Tensor]):
        """(stats, gradients of the whole tree) of update number
        ``n_updates``: the actor's are zeros on a step the delay skips."""
        y = self.critic_target(target, batch, noise)
        c_loss, _, grads = value_and_grad(self.critic_loss, params, batch, y)
        if n_updates % self.delay == 0:
            a_loss, _, a_grads = value_and_grad(
                self.actor_loss, params["actor"], params["q1"], batch)
        else:
            a_loss = torch.zeros((), device=c_loss.device)
            a_grads = tree_map(torch.zeros_like, params["actor"])
        return ({"critic_loss": c_loss, "actor_loss": a_loss},
                dict(grads, actor=a_grads))

    def update(self, params, target, opt_state, n_updates: int, batch,
               noise: Optional[torch.Tensor]):
        """One update: (params, target, opt_state, n_updates + 1, stats)."""
        stats, grads = self.gradients(params, target, n_updates, batch,
                                      noise)
        params, opt_state = self.opt.step(params, grads, opt_state)
        with torch.no_grad():
            target = tree_map(
                lambda t, o: (1.0 - self.tau) * t + self.tau * o,
                target, params)
        return params, target, opt_state, n_updates + 1, stats

    def compute_actions(self, obs: np.ndarray, explore: bool = True):
        with torch.no_grad():
            a = actor(self.params, torch.as_tensor(
                np.asarray(obs, dtype=np.float32), device=self.device))
            if explore:
                a = torch.clamp(a + self.noise * torch.randn(
                    a.shape, generator=self.gen, device=self.device),
                    -1.0, 1.0)
            return a.cpu().numpy(), None, None

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        dev = batch_to(batch, self._batch_keys, self.device)
        noise = None
        if self.t_noise > 0:
            noise = torch.randn((batch.count, self.action_dim),
                                generator=self.gen, device=self.device)
        (self.params, self.target, self.opt_state, self._updates,
         stats) = self.update(self.params, self.target, self.opt_state,
                              self._updates, dev, noise)
        return stats_to_floats(stats)

    def get_weights(self):
        return to_host({"params": self.params, "target": self.target})

    def set_weights(self, weights) -> None:
        self.params = to_device(weights["params"], self.device)
        self.target = to_device(weights["target"], self.device)


class _ContinuousReplayTrainer(Trainer):
    def _build(self, config: Dict) -> None:
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
        policy = self.workers.local_worker().policy
        for _ in range(cfg["num_train_batches_per_step"]):
            batch = self.replay.sample(cfg["train_batch_size"])
            stats.update(policy.learn_on_batch(batch))
            self._steps_trained += batch.count
        self.workers.sync_weights()
        return stats


class DDPGTrainer(_ContinuousReplayTrainer):
    _policy_cls = DDPGPolicy
    _default_config = DDPG_CONFIG
    _name = "DDPG"


class TD3Trainer(_ContinuousReplayTrainer):
    _policy_cls = DDPGPolicy
    _default_config = TD3_CONFIG
    _name = "TD3"

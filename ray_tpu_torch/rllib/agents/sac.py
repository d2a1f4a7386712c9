"""Soft Actor-Critic, discrete-action variant
(reference: rllib/agents/sac/sac.py + sac_tf_policy.py; discrete form per
Christodoulou 2019).

Twin Q networks with polyak-averaged targets, a categorical actor, and a
learned entropy temperature alpha driven toward a target entropy. One update
takes the two critic losses, the actor loss and the alpha loss as one sum,
one gradient and one Adam step over the whole tree (``log_alpha`` a 0-dim
leaf of it), then the polyak step of the targets.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

import ray_tpu_torch

from ..._tree import tree_map
from ..execution import ReplayBuffer
from ..models import apply_mlp, gumbel_argmax, init_mlp
from ..policy import (
    Adam, Policy, batch_to, policy_device, policy_generator, stats_to_floats,
    to_device, to_host, value_and_grad,
)
from ..sample_batch import ACTIONS, DONES, NEXT_OBS, OBS, REWARDS, SampleBatch
from .trainer import Trainer

SAC_CONFIG = {
    "rollout_fragment_length": 32,
    "train_batch_size": 64,
    "buffer_size": 50_000,
    "learning_starts": 500,
    "num_train_batches_per_step": 4,
    "lr": 3e-3,
    "alpha_lr": 3e-3,
    "tau": 0.01,                 # polyak coefficient for target nets
    "initial_alpha": 0.2,
    "target_entropy": None,      # default: 0.98 * log(num_actions)
    "hiddens": [64, 64],
}


def pi_dist(params, obs: torch.Tensor):
    """(probabilities, log-probabilities) of the categorical actor."""
    logp = torch.log_softmax(apply_mlp(params["pi"], obs), dim=-1)
    return torch.exp(logp), logp


class SACPolicy(Policy):
    _batch_keys = (OBS, ACTIONS, REWARDS, DONES, NEXT_OBS)

    def __init__(self, obs_dim: int, num_actions: int, config: Dict[str, Any]):
        self.config = config
        self.device = policy_device(config)
        self.gen = policy_generator(config, self.device)
        hid = config.get("hiddens", [64, 64])
        self.params = {
            "pi": init_mlp(self.gen, [obs_dim] + hid + [num_actions]),
            "q1": init_mlp(self.gen, [obs_dim] + hid + [num_actions]),
            "q2": init_mlp(self.gen, [obs_dim] + hid + [num_actions]),
            "log_alpha": torch.log(torch.tensor(
                float(config.get("initial_alpha", 0.2)),
                dtype=torch.float32, device=self.device)),
        }
        self.target = {"q1": tree_map(torch.clone, self.params["q1"]),
                       "q2": tree_map(torch.clone, self.params["q2"])}
        self.opt = Adam(config.get("lr", 3e-3))
        self.opt_state = self.opt.init(self.params)
        self.gamma = config.get("gamma", 0.99)
        self.tau = config.get("tau", 0.01)
        self.target_entropy = config.get("target_entropy") or (
            0.98 * float(np.log(num_actions)))

    def loss(self, params, target, batch):
        """(critic + actor + alpha loss, stats). ``alpha``, the critics'
        target, their minimum in the actor's loss and the entropy in the
        temperature's are constants of the gradient."""
        alpha = torch.exp(params["log_alpha"]).detach()
        acts = batch[ACTIONS].long()[:, None]

        # Critic targets: soft state value of s' under the target twins and
        # the CURRENT policy (discrete SAC: expectation over actions
        # instead of a sampled squashed action).
        probs_n, logp_n = pi_dist(params, batch[NEXT_OBS])
        q1_t = apply_mlp(target["q1"], batch[NEXT_OBS])
        q2_t = apply_mlp(target["q2"], batch[NEXT_OBS])
        v_next = torch.sum(
            probs_n * (torch.minimum(q1_t, q2_t) - alpha * logp_n), dim=-1)
        y = (batch[REWARDS]
             + self.gamma * (1.0 - batch[DONES]) * v_next).detach()

        q1 = apply_mlp(params["q1"], batch[OBS])
        q2 = apply_mlp(params["q2"], batch[OBS])
        critic_loss = (torch.mean((q1.gather(-1, acts)[:, 0] - y) ** 2)
                       + torch.mean((q2.gather(-1, acts)[:, 0] - y) ** 2))

        # Actor: minimize E_s[ pi(s) . (alpha*log pi - min Q) ] against
        # FROZEN critics.
        probs, logp = pi_dist(params, batch[OBS])
        q_min = torch.minimum(q1, q2).detach()
        actor_loss = torch.mean(
            torch.sum(probs * (alpha * logp - q_min), dim=-1))

        # Temperature: drive policy entropy toward target_entropy.
        entropy = -torch.sum((probs * logp).detach(), dim=-1)
        alpha_loss = torch.mean(
            params["log_alpha"] * (entropy - self.target_entropy))

        total = critic_loss + actor_loss + alpha_loss
        return total, {"critic_loss": critic_loss, "actor_loss": actor_loss,
                       "alpha": torch.exp(params["log_alpha"]),
                       "entropy": torch.mean(entropy)}

    def update(self, params, target, opt_state, batch):
        _, stats, grads = value_and_grad(
            lambda p, b: self.loss(p, target, b), params, batch)
        params, opt_state = self.opt.step(params, grads, opt_state)
        with torch.no_grad():
            target = tree_map(
                lambda t, o: (1.0 - self.tau) * t + self.tau * o,
                target, {"q1": params["q1"], "q2": params["q2"]})
        return params, target, opt_state, stats

    def compute_actions(self, obs: np.ndarray, explore: bool = True):
        with torch.no_grad():
            logits = apply_mlp(self.params["pi"], torch.as_tensor(
                np.asarray(obs, dtype=np.float32), device=self.device))
            a = (gumbel_argmax(self.gen, logits) if explore
                 else torch.argmax(logits, dim=-1))
            return a.to(torch.int32).cpu().numpy(), None, None

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        dev = batch_to(batch, self._batch_keys, self.device)
        self.params, self.target, self.opt_state, stats = self.update(
            self.params, self.target, self.opt_state, dev)
        return stats_to_floats(stats)

    def get_weights(self):
        return to_host({"params": self.params, "target": self.target})

    def set_weights(self, weights) -> None:
        self.params = to_device(weights["params"], self.device)
        self.target = to_device(weights["target"], self.device)


class SACTrainer(Trainer):
    _policy_cls = SACPolicy
    _default_config = SAC_CONFIG
    _name = "SAC"

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
        policy: SACPolicy = self.workers.local_worker().policy
        for _ in range(cfg["num_train_batches_per_step"]):
            batch = self.replay.sample(cfg["train_batch_size"])
            stats.update(policy.learn_on_batch(batch))
            self._steps_trained += batch.count
        self.workers.sync_weights()
        return stats

"""Dyna: model-based RL with imagined transitions
(reference: rllib's DYNA lineage — learn a dynamics model from real
transitions, then train the value-based policy on a mixture of real and
model-generated experience; Sutton 1991).

The dynamics model is one MLP ``f(s, onehot(a)) -> (Δs, r, done_logit)``
trained by a regression step, and imagination is a single batched forward
pass — sample B states from replay, roll random candidate actions through
the model at once, and feed the synthetic batch to the same TD update the
real batches use. No per-step Python loop: one imagined batch is one
forward and one copy to the host.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch

from ..execution import ReplayBuffer
from ..models import apply_mlp, init_mlp
from ..policy import (
    Adam, DQNPolicy, batch_to, policy_device, policy_generator,
    value_and_grad,
)
from ..sample_batch import (
    ACTIONS, DONES, NEXT_OBS, OBS, REWARDS, SampleBatch,
)
from .trainer import Trainer

DYNA_CONFIG = {
    "rollout_fragment_length": 32,
    "train_batch_size": 64,
    "buffer_size": 50000,
    "learning_starts": 200,
    "target_network_update_freq": 10,
    "num_train_batches_per_step": 2,
    "imagined_batches_per_step": 4,   # the Dyna ratio: model steps per real
    "model_train_batches_per_step": 4,
    "model_lr": 1e-3,
    "model_hiddens": [64, 64],
    "lr": 1e-3,
    "initial_epsilon": 1.0,
    "final_epsilon": 0.05,
    "epsilon_timesteps": 3000,
    "hiddens": [64, 64],
}


class _DynamicsModel:
    """Deterministic one-step model: predicts (next_obs - obs, reward,
    done logit) from (obs, onehot action). One train step, one batched
    rollout."""

    _batch_keys = (OBS, ACTIONS, REWARDS, DONES, NEXT_OBS)

    def __init__(self, obs_dim: int, num_actions: int,
                 config: Dict[str, Any]):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.device = policy_device(config)
        gen = policy_generator({"seed": config.get("seed", 0) + 17},
                               self.device)
        hid = config.get("model_hiddens", [64, 64])
        self.params = init_mlp(
            gen, [obs_dim + num_actions] + hid + [obs_dim + 2])
        self.opt = Adam(config.get("model_lr", 1e-3))
        self.opt_state = self.opt.init(self.params)

    def forward(self, params, obs: torch.Tensor, actions: torch.Tensor):
        """(predicted next obs, reward, done logit) of float ``actions``."""
        onehot = F.one_hot(actions.long(), self.num_actions).to(obs.dtype)
        out = apply_mlp(params, torch.cat([obs, onehot], dim=-1))
        d = self.obs_dim
        return obs + out[..., :d], out[..., d], out[..., d + 1]

    def loss(self, params, batch):
        pred_next, pred_rew, done_logit = self.forward(
            params, batch[OBS], batch[ACTIONS])
        obs_loss = torch.mean((pred_next - batch[NEXT_OBS]) ** 2)
        rew_loss = torch.mean((pred_rew - batch[REWARDS]) ** 2)
        done_loss = F.binary_cross_entropy_with_logits(done_logit,
                                                       batch[DONES])
        return obs_loss + rew_loss + done_loss, {}

    def train_step(self, params, opt_state, batch):
        loss, _, grads = value_and_grad(self.loss, params, batch)
        params, opt_state = self.opt.step(params, grads, opt_state)
        return params, opt_state, loss

    def train_on_batch(self, batch: SampleBatch) -> float:
        dev = batch_to(batch, self._batch_keys, self.device)
        self.params, self.opt_state, loss = self.train_step(
            self.params, self.opt_state, dev)
        return float(loss)

    def imagine_batch(self, obs: np.ndarray,
                      actions: np.ndarray) -> SampleBatch:
        obs = np.asarray(obs, dtype=np.float32)
        actions = np.asarray(actions, dtype=np.float32)
        with torch.no_grad():
            next_obs, rew, done_logit = self.forward(
                self.params, torch.as_tensor(obs, device=self.device),
                torch.as_tensor(actions, device=self.device))
            host = torch.cat([next_obs, rew[:, None],
                              torch.sigmoid(done_logit)[:, None]],
                             dim=-1).cpu().numpy()
        d = self.obs_dim
        return SampleBatch({
            OBS: obs,
            ACTIONS: actions,
            REWARDS: host[:, d],
            # Hard-threshold the done head: DQN's (1-done) bootstrap mask
            # wants {0,1}, and a soft 0.5 would leak half a bootstrap.
            DONES: (host[:, d + 1] > 0.5).astype(np.float32),
            NEXT_OBS: host[:, :d],
        })


class DynaTrainer(Trainer):
    _policy_cls = DQNPolicy
    _default_config = DYNA_CONFIG
    _name = "Dyna"

    def _build(self, config: Dict) -> None:
        self.replay = ReplayBuffer(config["buffer_size"],
                                   seed=config["seed"])
        local = self.workers.local_worker()
        self.model = _DynamicsModel(
            local.vec_env.observation_dim, local.vec_env.num_actions, config)
        self._model_rng = np.random.RandomState(config["seed"] + 29)

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

        model_losses = []
        for _ in range(cfg["model_train_batches_per_step"]):
            batch = self.replay.sample(cfg["train_batch_size"])
            model_losses.append(self.model.train_on_batch(batch))
        if model_losses:
            stats["model_loss"] = float(np.mean(model_losses))

        policy: DQNPolicy = self.workers.local_worker().policy
        for _ in range(cfg["num_train_batches_per_step"]):
            batch = self.replay.sample(cfg["train_batch_size"])
            stats.update(policy.learn_on_batch(batch))
            self._steps_trained += batch.count

        # Imagination: replayed states, random candidate actions, model
        # transitions — trained with the same TD update.
        num_actions = self.model.num_actions
        imagined_losses = []
        for _ in range(cfg["imagined_batches_per_step"]):
            seed_batch = self.replay.sample(cfg["train_batch_size"])
            obs = np.asarray(seed_batch[OBS], dtype=np.float32)
            actions = self._model_rng.randint(num_actions, size=len(obs))
            imagined = self.model.imagine_batch(obs, actions)
            im_stats = policy.learn_on_batch(imagined)
            imagined_losses.append(im_stats["loss"])
            self._steps_trained += imagined.count
        if imagined_losses:
            stats["imagined_loss"] = float(np.mean(imagined_losses))

        if self._iteration % cfg["target_network_update_freq"] == 0:
            policy.update_target()
        self.workers.sync_weights(global_steps=self._steps_sampled)
        return stats

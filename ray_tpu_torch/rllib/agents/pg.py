"""Vanilla policy gradient + A2C (reference: rllib/agents/pg, rllib/agents/a3c/a2c).

Both are one-update policies over the same MLP actor(-critic):
PG = REINFORCE with return targets; A2C adds the learned value baseline and
a single synchronous update per sampled batch.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

import ray_tpu_torch

from ..models import apply_mlp, init_mlp
from ..policy import (
    Adam, Policy, batch_to, greedy_actions, policy_device, policy_generator,
    sample_actions, stats_to_floats, to_device, to_host, value_and_grad,
)
from ..sample_batch import ACTIONS, ADVANTAGES, OBS, SampleBatch, VALUE_TARGETS
from .trainer import Trainer


def make_a2c_loss(vf_coeff: float, ent_coeff: float, use_baseline: bool):
    """The shared actor-critic surrogate: REINFORCE term on normalized
    advantages + value regression + entropy bonus. Returns
    ``loss_fn(params, batch) -> (loss, stats)`` — used by both the fused
    A2C update and A3C's split compute/apply gradient path."""

    def loss_fn(params, batch):
        logits = apply_mlp(params["pi"], batch[OBS])
        logp_all = torch.log_softmax(logits, dim=-1)
        acts = batch[ACTIONS].long()
        logp = logp_all.gather(-1, acts[:, None])[:, 0]
        adv = batch[ADVANTAGES]
        # jnp's std is the population std.
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg_loss = -torch.mean(logp * adv)
        vf = apply_mlp(params["vf"], batch[OBS])[..., 0]
        vf_loss = torch.mean((vf - batch[VALUE_TARGETS]) ** 2)
        entropy = -torch.mean(
            torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        total = pg_loss - ent_coeff * entropy
        if use_baseline:
            total = total + vf_coeff * vf_loss
        return total, {"policy_loss": pg_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    return loss_fn


class A2CPolicy(Policy):
    """Actor-critic with one update a batch (no ratio clipping — the batch
    is always on-policy)."""

    _batch_keys = (OBS, ACTIONS, ADVANTAGES, VALUE_TARGETS)

    def __init__(self, obs_dim: int, num_actions: int, config: Dict[str, Any]):
        self.config = config
        self.device = policy_device(config)
        self.gen = policy_generator(config, self.device)
        hid = config.get("hiddens", [64, 64])
        self.params = {
            "pi": init_mlp(self.gen, [obs_dim] + hid + [num_actions]),
            "vf": init_mlp(self.gen, [obs_dim] + hid + [1]),
        }
        self.opt = Adam(config.get("lr", 5e-4))
        self.opt_state = self.opt.init(self.params)
        self._loss_fn = make_a2c_loss(
            config.get("vf_loss_coeff", 0.5),
            config.get("entropy_coeff", 0.01),
            config.get("use_critic", True))

    def update(self, params, opt_state, batch):
        _, stats, grads = value_and_grad(self._loss_fn, params, batch)
        params, opt_state = self.opt.step(params, grads, opt_state)
        return params, opt_state, stats

    def compute_actions(self, obs, explore: bool = True):
        params = self.params
        with torch.no_grad():
            obs = torch.as_tensor(np.asarray(obs, dtype=np.float32),
                                  device=self.device)
            if explore:
                return sample_actions(self.gen, params, obs)
            return greedy_actions(params, obs), None, None

    def value(self, obs):
        with torch.no_grad():
            obs = torch.as_tensor(np.asarray(obs, dtype=np.float32),
                                  device=self.device)
            return apply_mlp(self.params["vf"], obs)[..., 0].cpu().numpy()

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        dev = batch_to(batch, self._batch_keys, self.device)
        params, opt_state, stats = self.update(
            self.params, self.opt_state, dev)
        self.params, self.opt_state = params, opt_state
        return stats_to_floats(stats)

    def get_weights(self):
        return to_host(self.params)

    def set_weights(self, weights) -> None:
        self.params = to_device(weights, self.device)


class _SyncTrainerMixin:
    def _train_step(self) -> Dict:
        remote = self.workers.remote_workers()
        if remote:
            batches = ray_tpu_torch.get([w.sample.remote() for w in remote])
        else:
            batches = [self.workers.local_worker().sample()]
        batch = SampleBatch.concat_samples(batches)
        self._steps_sampled += batch.count
        stats = self.workers.local_worker().learn_on_batch(batch)
        self._steps_trained += batch.count
        self.workers.sync_weights()
        return stats


class A2CTrainer(_SyncTrainerMixin, Trainer):
    _policy_cls = A2CPolicy
    _default_config = {
        "rollout_fragment_length": 32,
        "use_gae": True,
        "use_critic": True,
        "lambda": 1.0,
        "entropy_coeff": 0.01,
        "hiddens": [64, 64],
    }
    _name = "A2C"


class PGTrainer(_SyncTrainerMixin, Trainer):
    """REINFORCE: Monte-Carlo returns, no critic in the loss
    (the value head still exists but gets zero weight)."""

    _policy_cls = A2CPolicy
    _default_config = {
        "rollout_fragment_length": 32,
        "use_gae": True,
        "use_critic": False,
        "lambda": 1.0,  # lambda=1 + zero critic ~ Monte-Carlo returns
        "entropy_coeff": 0.0,
        "hiddens": [64, 64],
    }
    _name = "PG"

"""MARWIL / behavior cloning from offline data (reference: rllib/agents/marwil).

Exponentially advantage-weighted imitation: loss = -E[exp(beta * A) * log
pi(a|s)] with a learned value baseline. beta=0 degenerates to plain behavior
cloning (the reference's BC mode). Trains purely from JsonReader batches — no
environment interaction. The offline rows are copied to the device once;
each update gathers its minibatch there.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np
import torch

from ...tune.trainable import Trainable
from ..models import apply_mlp, init_mlp
from ..offline import JsonReader
from ..policy import (
    Adam, policy_device, policy_generator, stats_to_floats, to_device,
    to_host, value_and_grad,
)
from ..sample_batch import ACTIONS, DONES, OBS, REWARDS, SampleBatch

MARWIL_CONFIG: Dict[str, Any] = {
    "input_path": None,       # JsonWriter directory (required)
    "obs_dim": None,          # required (no env to infer from)
    "num_actions": None,      # required
    "beta": 1.0,              # 0 => plain behavior cloning
    "vf_coeff": 1.0,
    "lr": 1e-3,
    "gamma": 0.99,
    "train_batch_size": 256,
    "updates_per_step": 8,
    "hiddens": [64, 64],
    "seed": 0,
    # Where the learner runs (ray_tpu_torch.default_device): None is the
    # card, and raises without one; "cpu" only when named.
    "device": None,
}


def make_marwil_loss(beta: float, vf_coeff: float):
    """``loss_fn(params, batch) -> (loss, stats)`` of the batch's
    observations, actions and returns."""

    def loss_fn(params, batch):
        obs, returns = batch[OBS], batch["returns"]
        logp_all = torch.log_softmax(apply_mlp(params["pi"], obs), dim=-1)
        logp = logp_all.gather(-1, batch[ACTIONS].long()[:, None])[:, 0]
        vf = apply_mlp(params["vf"], obs)[..., 0]
        adv = returns - vf.detach()
        # normalized exponential advantage weights (clipped for stability,
        # as the reference does); jnp's std is the population std
        if beta > 0:
            w = torch.exp(torch.clamp(
                beta * (adv - adv.mean()) / (adv.std(correction=0) + 1e-8),
                -5.0, 5.0))
        else:
            w = torch.ones_like(adv)
        bc_loss = -torch.mean(w * logp)
        vf_loss = torch.mean((vf - returns) ** 2)
        return bc_loss + vf_coeff * vf_loss, {"bc_loss": bc_loss,
                                              "vf_loss": vf_loss}

    return loss_fn


class MARWILTrainer(Trainable):
    def setup(self, config: Dict) -> None:
        self.config = {**MARWIL_CONFIG, **config}
        cfg = self.config
        for req in ("input_path", "obs_dim", "num_actions"):
            if cfg[req] is None:
                raise ValueError(f"MARWIL: config[{req!r}] is required")
        self.device = policy_device(cfg)
        self.reader = JsonReader(cfg["input_path"], seed=cfg["seed"])
        self._rows = self._with_returns(self.reader.all(), cfg["gamma"])
        self._dev_rows = {
            k: torch.as_tensor(np.asarray(self._rows[k], dtype=np.float32),
                               device=self.device)
            for k in (OBS, ACTIONS, "returns")}
        gen = policy_generator(cfg, self.device)
        hid = cfg["hiddens"]
        self.params = {
            "pi": init_mlp(gen, [cfg["obs_dim"]] + hid + [cfg["num_actions"]]),
            "vf": init_mlp(gen, [cfg["obs_dim"]] + hid + [1]),
        }
        self.opt = Adam(cfg["lr"])
        self.opt_state = self.opt.init(self.params)
        self.rng = np.random.RandomState(cfg["seed"])
        self._loss_fn = make_marwil_loss(cfg["beta"], cfg["vf_coeff"])

    def update(self, params, opt_state, batch):
        _, stats, grads = value_and_grad(self._loss_fn, params, batch)
        params, opt_state = self.opt.step(params, grads, opt_state)
        return params, opt_state, stats

    @staticmethod
    def _with_returns(batch: SampleBatch, gamma: float) -> SampleBatch:
        rewards = np.asarray(batch[REWARDS], dtype=np.float32)
        dones = np.asarray(batch[DONES], dtype=np.float32)
        returns = np.zeros_like(rewards)
        acc = 0.0
        for t in range(len(rewards) - 1, -1, -1):
            acc = rewards[t] + gamma * acc * (1.0 - dones[t])
            returns[t] = acc
        batch["returns"] = returns
        return batch

    def step(self) -> Dict:
        cfg = self.config
        n = self._rows.count
        stats = {"bc_loss": torch.zeros(()), "vf_loss": torch.zeros(())}
        for _ in range(cfg["updates_per_step"]):
            idx = torch.as_tensor(
                self.rng.randint(0, n, size=min(cfg["train_batch_size"], n)),
                device=self.device)
            batch = {k: v.index_select(0, idx)
                     for k, v in self._dev_rows.items()}
            self.params, self.opt_state, stats = self.update(
                self.params, self.opt_state, batch)
        return {**stats_to_floats(stats), "num_samples": int(n)}

    def compute_action(self, obs) -> int:
        with torch.no_grad():
            obs = torch.as_tensor(np.asarray(obs, dtype=np.float32)[None],
                                  device=self.device)
            return int(torch.argmax(apply_mlp(self.params["pi"], obs),
                                    dim=-1)[0])

    def save_checkpoint(self, checkpoint_dir: str) -> str:
        with open(os.path.join(checkpoint_dir, "marwil.pkl"), "wb") as f:
            pickle.dump(to_host(self.params), f)
        return checkpoint_dir

    def load_checkpoint(self, checkpoint_path: str) -> None:
        if os.path.isdir(checkpoint_path):
            checkpoint_path = os.path.join(checkpoint_path, "marwil.pkl")
        with open(checkpoint_path, "rb") as f:
            self.params = to_device(pickle.load(f), self.device)

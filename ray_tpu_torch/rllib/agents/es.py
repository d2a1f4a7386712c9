"""Evolution strategies (reference: rllib/agents/es/es.py).

The reference farms perturbed-policy rollouts to actors and applies the
rank-normalized gradient on the driver. Each worker evaluates its slice of
the population one episode at a time, the policy's forward on the worker's
device (the card unless ``config["device"]`` names the CPU) and one host
sync an env step for the greedy action; the noise and the rank transform
stay numpy, so a perturbation is the same bits in either package.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

import ray_tpu_torch

from ..env import make_env
from ..policy import policy_device
from ..models import apply_mlp, flatten_params, init_mlp, unflatten_like
from .trainer import Trainer


def _noise_for(seed, size: int) -> np.ndarray:
    """THE perturbation generator: trainer-side gradient reconstruction is
    only valid if this reproduces byte-for-byte the noise the worker
    applied, so both sides MUST call this one function."""
    return np.random.RandomState(seed).randn(size).astype(np.float32)


def _rank_transform(returns: np.ndarray) -> np.ndarray:
    """Centered rank in [-0.5, 0.5] (reference es.py compute_centered_ranks)."""
    ranks = np.empty(len(returns), dtype=np.float32)
    ranks[returns.argsort()] = np.arange(len(returns), dtype=np.float32)
    return ranks / (len(returns) - 1) - 0.5


class _ESWorker:
    """Evaluates antithetic perturbation pairs for a slice of the population."""

    def __init__(self, env_spec, hiddens: List[int], sigma: float, seed: int,
                 device=None):
        self.env = make_env(env_spec)
        self.sigma = sigma
        self.device = policy_device({"device": device})
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        self.params = init_mlp(
            gen, [self.env.observation_dim] + list(hiddens)
            + [self.env.num_actions])
        self.flat = flatten_params(self.params).cpu().numpy()
        self.rng = np.random.RandomState(seed)

    def _apply(self, flat: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        """Greedy actions of the policy whose flat parameters are ``flat``."""
        with torch.no_grad():
            return torch.argmax(
                apply_mlp(unflatten_like(flat, self.params), obs), dim=-1)

    def _on_device(self, flat: np.ndarray) -> torch.Tensor:
        return torch.tensor(flat, dtype=torch.float32, device=self.device)

    def set_flat(self, flat: np.ndarray) -> None:
        self.flat = np.asarray(flat)

    def _episode_return(self, flat: torch.Tensor, max_steps: int) -> float:
        obs = self.env.reset()
        total = 0.0
        for _ in range(max_steps):
            a = int(self._apply(flat, torch.as_tensor(
                np.asarray(obs[None], dtype=np.float32),
                device=self.device))[0])
            obs, r, done, _ = self.env.step(a)
            total += r
            if done:
                break
        return total

    def evaluate(self, num_pairs: int, max_steps: int) -> Dict:
        """Antithetic sampling: for each noise vector e, evaluate +e and -e."""
        seeds = self.rng.randint(0, 2**31 - 1, size=num_pairs)
        pos, neg = [], []
        for s in seeds:
            noise = _noise_for(s, self.flat.size)
            pos.append(self._episode_return(
                self._on_device(self.flat + self.sigma * noise), max_steps))
            neg.append(self._episode_return(
                self._on_device(self.flat - self.sigma * noise), max_steps))
        return {"seeds": seeds, "pos": np.asarray(pos), "neg": np.asarray(neg)}

    def eval_current(self, max_steps: int) -> float:
        return self._episode_return(self._on_device(self.flat), max_steps)


ES_CONFIG = {
    "num_workers": 2,
    "episodes_per_batch": 16,  # perturbation pairs per iteration (total)
    "sigma": 0.05,
    "step_size": 0.05,
    "max_episode_steps": 200,
    "hiddens": [32],
    "l2_coeff": 0.005,
}


class ESTrainer(Trainer):
    """Population-parallel black-box optimization. Does not use WorkerSet
    (no gradient policy), so overrides setup entirely."""

    _name = "ES"
    _default_config = ES_CONFIG

    def setup(self, config: Dict) -> None:
        from .trainer import COMMON_CONFIG, _deep_merge

        self.raw_config = _deep_merge(
            _deep_merge(COMMON_CONFIG, self._default_config), config)
        cfg = self.raw_config
        if cfg.get("env") is None:
            raise ValueError("ES: config['env'] is required")
        policy_device(cfg)  # no card and no "cpu": raise before any actor
        worker_cls = ray_tpu_torch.remote(num_cpus=1)(_ESWorker)
        self._es_workers = [
            worker_cls.remote(cfg["env"], cfg["hiddens"], cfg["sigma"], i,
                              cfg.get("device"))
            for i in range(max(cfg["num_workers"], 1))
        ]
        probe = _ESWorker(cfg["env"], cfg["hiddens"], cfg["sigma"], 0,
                          cfg.get("device"))
        self.flat = probe.flat.copy()
        self._steps_sampled = 0

    def _evaluate_population(self):
        """Fan antithetic rollouts across the workers; returns
        (seeds, pos_returns, neg_returns)."""
        cfg = self.raw_config
        n_workers = len(self._es_workers)
        pairs_per_worker = max(cfg["episodes_per_batch"] // n_workers, 1)
        results = ray_tpu_torch.get([
            w.evaluate.remote(pairs_per_worker, cfg["max_episode_steps"])
            for w in self._es_workers
        ])
        return (np.concatenate([r["seeds"] for r in results]),
                np.concatenate([r["pos"] for r in results]),
                np.concatenate([r["neg"] for r in results]))

    def _broadcast_and_eval(self) -> float:
        """Push the updated flat params to every worker, return the greedy
        evaluation episode's return."""
        flat_ref = ray_tpu_torch.put(self.flat)
        ray_tpu_torch.get([w.set_flat.remote(flat_ref) for w in self._es_workers])
        return float(ray_tpu_torch.get(self._es_workers[0].eval_current.remote(
            self.raw_config["max_episode_steps"])))

    def step(self) -> Dict:
        cfg = self.raw_config
        seeds, pos, neg = self._evaluate_population()

        all_returns = np.concatenate([pos, neg])
        ranks = _rank_transform(all_returns)
        pos_r, neg_r = ranks[:len(pos)], ranks[len(pos):]
        grad = np.zeros_like(self.flat)
        for s, rp, rn in zip(seeds, pos_r, neg_r):
            grad += (rp - rn) * _noise_for(s, self.flat.size)
        grad /= (2 * len(seeds) * cfg["sigma"])
        self.flat += cfg["step_size"] * grad - cfg["l2_coeff"] * self.flat

        return {
            "episode_reward_mean": float(np.mean(all_returns)),
            "eval_return": self._broadcast_and_eval(),
            "episodes_this_iter": int(len(all_returns)),
        }

    def save_checkpoint(self, checkpoint_dir: str) -> str:
        import os
        np.save(os.path.join(checkpoint_dir, "flat_params.npy"), self.flat)
        return checkpoint_dir

    def load_checkpoint(self, checkpoint_path: str) -> None:
        import os
        if os.path.isdir(checkpoint_path):
            checkpoint_path = os.path.join(checkpoint_path, "flat_params.npy")
        self.flat = np.load(checkpoint_path)
        flat_ref = ray_tpu_torch.put(self.flat)
        ray_tpu_torch.get([w.set_flat.remote(flat_ref) for w in self._es_workers])

    def cleanup(self) -> None:
        for w in self._es_workers:
            ray_tpu_torch.kill(w)


ARS_CONFIG = dict(
    ES_CONFIG,
    top_directions=8,   # use only the best directions for the update
    step_size=0.1,
)


class ARSTrainer(ESTrainer):
    """Augmented Random Search (reference: rllib/agents/ars/ars.py;
    Mania et al. 2018). Same antithetic-rollout machinery as ES with ARS's
    two changes: only the ``top_directions`` by max(pos, neg) return
    contribute to the update, and the step is scaled by the selected
    directions' reward standard deviation instead of rank normalization.
    (The reference's observation-filter normalization is omitted — the
    built-in envs are already bounded.)"""

    _name = "ARS"
    _default_config = ARS_CONFIG

    def step(self) -> Dict:
        cfg = self.raw_config
        seeds, pos, neg = self._evaluate_population()

        k = min(int(cfg["top_directions"]), len(seeds))
        top = np.argsort(-np.maximum(pos, neg))[:k]
        reward_std = float(np.concatenate([pos[top], neg[top]]).std()) + 1e-8
        grad = np.zeros_like(self.flat)
        for idx in top:
            grad += (pos[idx] - neg[idx]) * _noise_for(
                seeds[idx], self.flat.size)
        self.flat += (cfg["step_size"] / (k * reward_std)) * grad

        return {
            "episode_reward_mean": float(np.mean(np.concatenate([pos, neg]))),
            "eval_return": self._broadcast_and_eval(),
            "episodes_this_iter": int(2 * len(seeds)),
        }

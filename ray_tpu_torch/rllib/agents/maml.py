"""MAML: model-agnostic meta-learning over a task distribution
(reference: rllib/agents/maml — present in the reference lineage as the
meta-RL trainer; Finn et al. 2017).

The inner adaptation is ``θ' = θ - α·grad(L)(θ, support)``, the
meta-objective is the query loss at ``θ'``, and the gradient through the
adaptation is the exact second-order meta-gradient (no first-order
approximation): each inner step's gradient is taken with
``create_graph=True``, so the outer gradient differentiates through it.
The tasks of a meta-batch run one after another and their query losses are
averaged.

Workers sample per-task support/query fragments (each remote worker adapts
its own policy replica in place); the driver stacks them [tasks, batch, ...]
and takes one meta-step.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

import ray_tpu_torch

from ..._tree import tree_leaves, tree_map
from ..models import apply_mlp, gumbel_argmax, init_mlp
from ..policy import (
    Adam, Policy, policy_device, policy_generator, to_device, to_host,
    value_and_grad,
)
from ..sample_batch import ACTIONS, DONES, OBS, REWARDS, SampleBatch
from .trainer import Trainer

MAML_CONFIG = {
    "rollout_fragment_length": 16,
    "use_gae": False,           # advantages = centered returns-to-go (host)
    "inner_lr": 1.0,            # inner SGD step size (alpha)
    "meta_lr": 1e-2,            # outer Adam step size (beta)
    "meta_batch_size": 8,       # tasks per meta-update
    "inner_steps": 1,
    "hiddens": [32],
}

_ADV = "maml_adv"


def _returns_to_go(batch: SampleBatch, gamma: float,
                   fragment_len: int) -> np.ndarray:
    """Monte-Carlo reward-to-go, centered. The batch is the concat of
    per-env fragments of ``fragment_len`` contiguous rows
    (rollout_worker.sample's layout), so the accumulator must reset at both
    episode ends AND fragment boundaries — otherwise env i+1's head rows
    would discount into env i's unterminated tail."""
    rew = np.asarray(batch[REWARDS], dtype=np.float32)
    done = np.asarray(batch[DONES], dtype=np.float32)
    n = len(rew)
    if fragment_len <= 0 or n % fragment_len:
        fragment_len = n  # unknown layout: treat as one fragment
    out = np.zeros_like(rew)
    for start in range(0, n, fragment_len):
        acc = 0.0
        for t in range(start + fragment_len - 1, start - 1, -1):
            acc = rew[t] + gamma * acc * (1.0 - done[t])
            out[t] = acc
    return out - out.mean()


def surrogate_loss(params, batch) -> torch.Tensor:
    logp_all = torch.log_softmax(apply_mlp(params, batch[OBS]), dim=-1)
    logp = logp_all.gather(-1, batch[ACTIONS].long()[:, None])[:, 0]
    return -torch.mean(logp * batch[_ADV])


class MAMLPolicy(Policy):
    """Categorical policy whose update is the full second-order MAML step."""

    def __init__(self, obs_dim: int, num_actions: int, config: Dict[str, Any]):
        self.config = config
        self.device = policy_device(config)
        self.gen = policy_generator(config, self.device)
        hid = config.get("hiddens", [32])
        self.params = init_mlp(self.gen, [obs_dim] + hid + [num_actions])
        self.opt = Adam(config.get("meta_lr", 1e-2))
        self.opt_state = self.opt.init(self.params)
        self.inner_lr = config.get("inner_lr", 1.0)
        self.inner_steps = config.get("inner_steps", 1)

    def adapt_fn(self, params, support, create_graph: bool = False):
        """``inner_steps`` plain gradient steps on the support's loss. With
        ``create_graph`` the adapted parameters keep the graph of every
        step (their gradient is second order), else they are detached."""
        if not create_graph:
            params = tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
        for _ in range(self.inner_steps):
            leaves = tree_leaves(params)
            grads = iter(torch.autograd.grad(
                surrogate_loss(params, support), leaves,
                create_graph=create_graph))
            params = tree_map(lambda w: w - self.inner_lr * next(grads),
                              params)
        if not create_graph:
            params = tree_map(torch.detach, params)
        return params

    def meta_loss(self, params, supports, queries):
        """The mean over tasks of the query loss at the adapted params."""
        losses = [surrogate_loss(self.adapt_fn(params, sup, True), qry)
                  for sup, qry in zip(supports, queries)]
        return torch.mean(torch.stack(losses)), {}

    def meta_update(self, params, opt_state, supports, queries):
        loss, _, grads = value_and_grad(self.meta_loss, params, supports,
                                        queries)
        params, opt_state = self.opt.step(params, grads, opt_state)
        return params, opt_state, loss

    # ---- acting ----

    def compute_actions(self, obs, explore: bool = True):
        with torch.no_grad():
            obs = torch.as_tensor(np.asarray(obs, dtype=np.float32),
                                  device=self.device)
            logits = apply_mlp(self.params, obs)
            if not explore:
                return (torch.argmax(logits, dim=-1).to(torch.int32)
                        .cpu().numpy(), None, None)
            a = gumbel_argmax(self.gen, logits)
            logp = torch.log_softmax(logits, dim=-1).gather(
                -1, a[:, None])[:, 0]
            out = torch.stack([a.float(), logp]).cpu().numpy()
            return (out[0].astype(np.int32), out[1],
                    np.zeros(obs.shape[0], np.float32))

    # ---- adaptation ----

    def _to_device(self, batches: List[SampleBatch]
                   ) -> List[Dict[str, torch.Tensor]]:
        """Each batch's observations, actions and centered returns-to-go,
        stacked on the host and copied to the device once a column."""
        cols = {
            OBS: np.stack([np.asarray(b[OBS], dtype=np.float32)
                           for b in batches]),
            ACTIONS: np.stack([np.asarray(b[ACTIONS], np.float32)
                               for b in batches]),
            _ADV: np.stack([_returns_to_go(
                b, self.config.get("gamma", 0.99),
                self.config.get("rollout_fragment_length", 0))
                for b in batches]),
        }
        dev = {k: torch.as_tensor(v, device=self.device)
               for k, v in cols.items()}
        return [{k: v[i] for k, v in dev.items()}
                for i in range(len(batches))]

    def adapt(self, support: SampleBatch):
        """One-or-more inner SGD steps; returns adapted params (no mutation)."""
        return self.adapt_fn(self.params, self._to_device([support])[0])

    def set_params(self, params) -> None:
        self.params = params

    def meta_learn(self, supports: List[SampleBatch],
                   queries: List[SampleBatch]) -> float:
        self.params, self.opt_state, loss = self.meta_update(
            self.params, self.opt_state, self._to_device(supports),
            self._to_device(queries))
        return float(loss)

    def get_weights(self):
        return to_host(self.params)

    def set_weights(self, weights) -> None:
        self.params = to_device(weights, self.device)


def _run_task(worker, task, weights) -> Tuple[SampleBatch, SampleBatch]:
    """On the worker: set task, sample support at θ, adapt, sample query at θ'."""
    if isinstance(weights, ray_tpu_torch.ObjectRef):
        weights = ray_tpu_torch.get(weights)  # put once, fetched per node
    for env in worker.vec_env.envs:
        env.set_task(task)
    worker.policy.set_weights(weights)
    support = worker.sample()
    adapted = worker.policy.adapt(support)
    worker.policy.set_params(adapted)
    query = worker.sample()
    return support, query


class MAMLTrainer(Trainer):
    _policy_cls = MAMLPolicy
    _default_config = MAML_CONFIG
    _name = "MAML"

    def _train_step(self) -> Dict:
        local = self.workers.local_worker()
        policy: MAMLPolicy = local.policy
        n_tasks = self.raw_config["meta_batch_size"]
        tasks = local.vec_env.envs[0].sample_tasks(n_tasks)
        theta = policy.get_weights()

        remote = self.workers.remote_workers()
        pairs: List[Tuple[SampleBatch, SampleBatch]] = []
        if remote:
            theta_ref = ray_tpu_torch.put(theta)  # one copy, not one per task
            refs = [remote[i % len(remote)].apply.remote(
                partial(_run_task, task=t, weights=theta_ref))
                for i, t in enumerate(tasks)]
            pairs = ray_tpu_torch.get(refs)
        else:
            for t in tasks:
                # _run_task resets the policy to theta on entry each time.
                pairs.append(_run_task(local, t, theta))

        supports = [p[0] for p in pairs]
        queries = [p[1] for p in pairs]
        policy.set_weights(theta)
        meta_loss = policy.meta_learn(supports, queries)
        for b in supports + queries:
            self._steps_sampled += b.count
            self._steps_trained += b.count
        # No broadcast here: _run_task re-sets weights from the fresh theta
        # at the start of every per-task rollout, so a sync would be dead
        # work repeated each meta-step.
        pre = float(np.mean([np.mean(b[REWARDS]) for b in supports]))
        post = float(np.mean([np.mean(b[REWARDS]) for b in queries]))
        return {"meta_loss": meta_loss,
                "pre_adapt_reward_mean": pre,
                "post_adapt_reward_mean": post}

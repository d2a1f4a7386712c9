"""A3C: asynchronous advantage actor-critic (reference: rllib/agents/a3c/a3c.py).

The reference's A3C has each rollout worker compute gradients against its own
(slightly stale) weights and ship them to the driver, which applies them to the
central params as they arrive — no barrier, no batch concat. Here the gradient
computation is one function on the worker (actor-critic loss →
``torch.autograd.grad``), the tree of numpy gradients rides the object store
back, and the driver's Adam step is a second function that builds new
tensors and rebinds the tree. Fresh weights go back to exactly the worker
whose gradient was consumed (the hogwild pattern), so one slow worker never
stalls the rest.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

import ray_tpu_torch

from ..policy import (
    batch_to, stats_to_floats, to_device, to_host, value_and_grad,
)
from .pg import A2CPolicy
from .trainer import Trainer

A3C_CONFIG = {
    "rollout_fragment_length": 32,
    "use_gae": True,
    "use_critic": True,
    "lambda": 1.0,
    "entropy_coeff": 0.01,
    "hiddens": [64, 64],
    "grads_per_step": 4,   # async gradient applications per train iteration
}


class A3CPolicy(A2CPolicy):
    """A2C loss split into compute_gradients / apply_gradients halves so the
    two ends can run on different processes (reference:
    rllib/policy/policy.py compute_gradients, a3c.py apply_gradients)."""

    def compute_gradients(self, batch):
        dev = batch_to(batch, self._batch_keys, self.device)
        # Same surrogate as the fused A2C update (self._loss_fn is built by
        # A2CPolicy from this config's vf/entropy/use_critic knobs).
        _, stats, grads = value_and_grad(self._loss_fn, self.params, dev)
        return to_host(grads), stats_to_floats(stats)

    def apply_gradients(self, grads) -> None:
        self.params, self.opt_state = self.opt.step(
            self.params, to_device(grads, self.device), self.opt_state)


def _sample_and_grads(worker):
    """Runs on the rollout worker: one fragment → gradient pytree."""
    batch = worker.sample()
    grads, stats = worker.policy.compute_gradients(batch)
    return grads, stats, batch.count


class A3CTrainer(Trainer):
    _policy_cls = A3CPolicy
    _default_config = A3C_CONFIG
    _name = "A3C"

    def _build(self, config: Dict) -> None:
        self._inflight: Dict = {}  # ObjectRef -> worker
        # Workers start from different random inits; the hogwild contract is
        # "gradients at *stale driver* weights", so align everyone first.
        self.workers.sync_weights()

    def _train_step(self) -> Dict:
        remote = self.workers.remote_workers()
        local = self.workers.local_worker()
        if not remote:
            # Degenerate synchronous mode (num_workers=0): still exercises the
            # grads/apply split so the two paths can't drift apart.
            batch = local.sample()
            grads, stats = local.policy.compute_gradients(batch)
            local.policy.apply_gradients(grads)
            self._steps_sampled += batch.count
            self._steps_trained += batch.count
            return stats

        # Keep every worker busy; consume whichever gradient lands first.
        for w in remote:
            if w not in self._inflight.values():
                self._inflight[w.apply.remote(_sample_and_grads)] = w
        collected: list = []
        for _ in range(self.raw_config["grads_per_step"]):
            ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1)
            ref = ready[0]
            w = self._inflight.pop(ref)
            grads, stats, n = ray_tpu_torch.get(ref)
            collected.append(stats)
            local.policy.apply_gradients(grads)
            self._steps_sampled += n
            self._steps_trained += n
            # Ship fresh weights to the worker we just drained, then rearm it.
            w.set_weights.remote(local.get_weights())
            self._inflight[w.apply.remote(_sample_and_grads)] = w
        # Mean over the gradients consumed this iteration, not a single
        # last-to-land snapshot.
        return {k: float(np.mean([s[k] for s in collected]))
                for k in collected[0]} if collected else {}

    def cleanup(self) -> None:
        self._inflight.clear()
        super().cleanup()

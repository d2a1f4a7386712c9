"""IMPALA-style async learner (reference: rllib/agents/impala/impala.py +
rllib/execution/learner_thread.py).

Rollout workers sample continuously; batches stream into the learner thread's
queue; the learner updates off-thread and workers refresh weights between
samples. V-trace is approximated by PPO's clipped importance ratios (the
reference offers both; the clipped-surrogate form is the batched one —
same stale-policy correction, no per-timestep recursion).
"""

from __future__ import annotations

import time
from typing import Dict

import ray_tpu_torch

from ..execution import LearnerThread
from ..policy import PPOPolicy
from .trainer import Trainer

IMPALA_CONFIG = {
    "rollout_fragment_length": 64,
    "train_batch_size": 256,
    "sgd_minibatch_size": 64,
    "num_sgd_iter": 2,
    "num_workers": 2,
    "lr": 5e-4,
    "lambda": 0.95,
    "clip_param": 0.3,
    "vf_loss_coeff": 0.5,
    "entropy_coeff": 0.01,
    "use_gae": True,
    "hiddens": [64, 64],
    "broadcast_interval": 1,  # learner updates between weight broadcasts
    "max_requests_in_flight": 2,
    # > 0: insert a layer of aggregator actors between rollout workers and
    # the learner (reference: rllib/execution/tree_agg.py — hierarchical
    # experience aggregation for large worker counts).
    "num_aggregation_workers": 0,
}


class ImpalaTrainer(Trainer):
    _policy_cls = PPOPolicy
    _default_config = IMPALA_CONFIG
    _name = "IMPALA"

    def _build(self, config: Dict) -> None:
        self.learner = LearnerThread(self.workers.local_worker())
        self.learner.start()
        self._inflight: Dict = {}  # ref -> worker-or-aggregator
        # The learner's weights_seq at each sampler's last broadcast, by
        # sampler (a rollout worker or an aggregator).
        self._last_broadcast_seq: Dict[int, int] = {}
        self.aggregators = []
        if (config["num_aggregation_workers"] > 0
                and self.workers.remote_workers()):
            from ..execution import make_aggregation_tree

            self.aggregators = make_aggregation_tree(
                self.workers, config["num_aggregation_workers"],
                config["train_batch_size"])
            for agg in self.aggregators:
                self._inflight[agg.aggregate.remote()] = agg
            return
        for w in self.workers.remote_workers():
            for _ in range(self.raw_config["max_requests_in_flight"]):
                self._inflight[w.sample.remote()] = w

    def _stale(self, sampler) -> bool:
        """Whether the learner has made ``broadcast_interval`` updates since
        ``sampler`` last had its weights; if so, they count as sent now.

        The port's: the JAX package keeps one sequence for all samplers, so
        a sampler whose batches always land just after another's, while the
        learner finishes one update for every two batches, never gets
        weights again and samples its first policy for ever (C17)."""
        seq = self.learner.weights_seq
        if seq - self._last_broadcast_seq.get(id(sampler), 0) \
                < self.raw_config["broadcast_interval"]:
            return False
        self._last_broadcast_seq[id(sampler)] = seq
        return True

    def _train_step(self) -> Dict:
        cfg = self.raw_config
        if self.aggregators:
            return self._train_step_tree()
        remote = self.workers.remote_workers()
        if not remote:
            # Degenerate sync fallback (no async pipeline without workers).
            batch = self.workers.local_worker().sample()
            self._steps_sampled += batch.count
            self.learner.inqueue.put(batch)
            while self.learner.steps_trained < self._steps_sampled:
                time.sleep(0.005)
            return dict(self.learner.last_stats)

        target = self._steps_sampled + cfg["train_batch_size"]
        while self._steps_sampled < target:
            ready, _ = ray_tpu_torch.wait(
                list(self._inflight.keys()), num_returns=1)
            ref = ready[0]
            worker = self._inflight.pop(ref)
            batch = ray_tpu_torch.get(ref)
            self._steps_sampled += batch.count
            self.learner.inqueue.put(batch)
            # Refresh the sampler's weights when the learner has advanced
            # (stale-policy gap bounded by broadcast_interval updates).
            if self._stale(worker):
                weights = ray_tpu_torch.put(
                    self.workers.local_worker().get_weights())
                worker.set_weights.remote(weights)
            self._inflight[worker.sample.remote()] = worker

        return {
            "learner_updates": self.learner.num_updates,
            "steps_trained": self.learner.steps_trained,
            "learner_queue_size": self.learner.inqueue.qsize(),
            **{k: float(v) for k, v in self.learner.last_stats.items()},
        }

    def _train_step_tree(self) -> Dict:
        """Aggregated path: one already-concatenated train batch per
        aggregator round; weight broadcasts fan out through the tree."""
        ready, _ = ray_tpu_torch.wait(list(self._inflight.keys()), num_returns=1)
        ref = ready[0]
        agg = self._inflight.pop(ref)
        batch = ray_tpu_torch.get(ref)
        self._steps_sampled += batch.count
        target = self.learner.steps_trained + batch.count
        self.learner.inqueue.put(batch)
        if self._stale(agg):
            # Boxed ref: the aggregator receives the ObjectRef itself (a
            # top-level ref arg would arrive resolved) and fans it out so
            # each worker pulls the ONE stored copy.
            weights = ray_tpu_torch.put(self.workers.local_worker().get_weights())
            agg.set_worker_weights.remote([weights])
        self._inflight[agg.aggregate.remote()] = agg
        # Wait (relative target — restored checkpoints reset the learner's
        # counter) until this batch is trained, so reported stats track it;
        # a dead learner thread must not hang the driver.
        while (self.learner.steps_trained < target
               and self.learner.is_alive()):
            time.sleep(0.005)
        return {
            "learner_updates": self.learner.num_updates,
            "steps_trained": self.learner.steps_trained,
            "num_aggregators": len(self.aggregators),
            **{k: float(v) for k, v in self.learner.last_stats.items()},
        }

    def cleanup(self) -> None:
        self.learner.stop()
        # The port's: no learner step outlives the trainer. A daemon thread
        # still inside a torch op when the interpreter exits is unwound
        # through torch's C++ frames, which aborts the process.
        self.learner.join()
        for agg in self.aggregators:
            ray_tpu_torch.kill(agg)
        super().cleanup()


APPO_CONFIG = dict(
    IMPALA_CONFIG,
    num_sgd_iter=1,
    clip_param=0.4,
)


class APPOTrainer(ImpalaTrainer):
    """Asynchronous PPO (reference: rllib/agents/ppo/appo.py): IMPALA's
    async sampling architecture with PPO's clipped-surrogate loss — which
    is exactly what this IMPALA implementation computes (the clipped-ratio
    form replaces v-trace; see the module docstring), so APPO is the same
    engine with APPO's default hyperparameters."""

    _name = "APPO"
    _default_config = APPO_CONFIG

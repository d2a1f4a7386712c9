"""Execution-plan building blocks (reference: rllib/execution/).

The reference composes training loops from declarative dataflow ops over
ParallelIterator (ParallelRollouts | TrainOneStep, replay buffers, learner
threads). Same shapes here; the learners step in PyTorch.
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch

from ..util.iter import LocalIterator, from_actors
from .sample_batch import SampleBatch


def ParallelRollouts(workers, mode: str = "bulk_sync") -> LocalIterator:
    """Iterator over sample batches from all remote workers
    (reference: rllib/execution/rollout_ops.py:ParallelRollouts).

    bulk_sync: one batch per worker per round, concatenated (barrier).
    async: batches arrive as ready (no barrier; IMPALA-style).
    """
    remote = workers.remote_workers()
    if not remote:
        local = workers.local_worker()

        def _local_gen():
            while True:
                yield local.sample()

        return LocalIterator(_local_gen)
    it = from_actors(remote, name="rollouts")
    if mode == "bulk_sync":
        return it.batch_across_shards().for_each(SampleBatch.concat_samples)
    if mode == "async":
        return it.gather_async(num_async=len(remote))
    raise ValueError(f"unknown mode {mode!r}")


class TrainOneStep:
    """fn: batch -> stats; updates the local (learner) policy then broadcasts
    weights (reference: rllib/execution/train_ops.py:TrainOneStep)."""

    def __init__(self, workers, sync_weights: bool = True):
        self.workers = workers
        self.sync_weights = sync_weights

    def __call__(self, batch: SampleBatch) -> Dict[str, Any]:
        stats = self.workers.local_worker().learn_on_batch(batch)
        if self.sync_weights:
            self.workers.sync_weights()
        stats["steps_trained"] = batch.count
        return stats


class _SumSegmentTree:
    """Array-backed sum segment tree (reference: rllib/execution/segment_tree.py)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.tree = np.zeros(2 * capacity, dtype=np.float64)

    def __setitem__(self, idx: int, val: float) -> None:
        i = idx + self.capacity
        self.tree[i] = val
        i //= 2
        while i >= 1:
            self.tree[i] = self.tree[2 * i] + self.tree[2 * i + 1]
            i //= 2

    def __getitem__(self, idx: int) -> float:
        return float(self.tree[idx + self.capacity])

    def sum(self) -> float:
        return float(self.tree[1])

    def find_prefixsum_idx(self, prefixsum: float) -> int:
        """Largest i such that sum(arr[:i]) <= prefixsum."""
        i = 1
        while i < self.capacity:
            left = 2 * i
            if self.tree[left] > prefixsum:
                i = left
            else:
                prefixsum -= self.tree[left]
                i = left + 1
        return i - self.capacity


class _MinSegmentTree:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.tree = np.full(2 * capacity, np.inf, dtype=np.float64)

    def __setitem__(self, idx: int, val: float) -> None:
        i = idx + self.capacity
        self.tree[i] = val
        i //= 2
        while i >= 1:
            self.tree[i] = min(self.tree[2 * i], self.tree[2 * i + 1])
            i //= 2

    def min(self) -> float:
        return float(self.tree[1])


class ReplayBuffer:
    """Uniform FIFO replay (reference: rllib/execution/replay_buffer.py:ReplayBuffer)."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._storage: List[SampleBatch] = []
        self._next_idx = 0
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self._storage)

    def add_batch(self, batch: SampleBatch) -> None:
        # store per-timestep rows so sampling mixes freely across time
        for i in range(batch.count):
            self.add(batch.slice(i, i + 1))

    def add(self, row: SampleBatch) -> None:
        if self._next_idx >= len(self._storage):
            self._storage.append(row)
        else:
            self._storage[self._next_idx] = row
        self._next_idx = (self._next_idx + 1) % self.capacity

    def sample(self, batch_size: int) -> SampleBatch:
        idx = self.rng.randint(0, len(self._storage), size=batch_size)
        return SampleBatch.concat_samples([self._storage[i] for i in idx])


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay with segment trees
    (reference: rllib/execution/replay_buffer.py:PrioritizedReplayBuffer)."""

    def __init__(self, capacity: int, alpha: float = 0.6, seed: int = 0):
        super().__init__(capacity, seed)
        cap2 = 1
        while cap2 < capacity:
            cap2 *= 2
        self._sum = _SumSegmentTree(cap2)
        self._min = _MinSegmentTree(cap2)
        self._alpha = alpha
        self._max_priority = 1.0

    def add(self, row: SampleBatch) -> None:
        idx = self._next_idx
        super().add(row)
        pr = self._max_priority ** self._alpha
        self._sum[idx] = pr
        self._min[idx] = pr

    def sample(self, batch_size: int, beta: float = 0.4):
        n = len(self._storage)
        idxes = []
        total = self._sum.sum()
        for _ in range(batch_size):
            mass = self.rng.uniform() * total
            idx = min(self._sum.find_prefixsum_idx(mass), n - 1)
            idxes.append(idx)
        # importance-sampling weights
        p_min = self._min.min() / total
        max_w = (p_min * n) ** (-beta)
        weights = np.array(
            [((self._sum[i] / total) * n) ** (-beta) / max_w for i in idxes],
            dtype=np.float32)
        batch = SampleBatch.concat_samples([self._storage[i] for i in idxes])
        batch["weights"] = weights
        batch["batch_indexes"] = np.asarray(idxes, dtype=np.int64)
        return batch

    def update_priorities(self, idxes, priorities) -> None:
        for idx, pr in zip(idxes, priorities):
            pr = float(max(pr, 1e-6))
            self._sum[idx] = pr ** self._alpha
            self._min[idx] = pr ** self._alpha
            self._max_priority = max(self._max_priority, pr)


class LearnerThread(threading.Thread):
    """Async learner: sample batches flow into a queue; the learner updates
    the policy off-thread (reference: rllib/execution/learner_thread.py)."""

    def __init__(self, local_worker, max_queue_size: int = 16):
        super().__init__(daemon=True, name="learner")
        self.local_worker = local_worker
        self.inqueue: _queue.Queue = _queue.Queue(maxsize=max_queue_size)
        self.stopped = False
        self.num_updates = 0
        self.errors = 0
        self.last_stats: Dict[str, float] = {}
        self.steps_trained = 0
        self.weights_seq = 0  # bumped on every update; samplers poll this

    def run(self) -> None:
        while not self.stopped:
            try:
                batch = self.inqueue.get(timeout=0.5)
            except _queue.Empty:
                continue
            if batch is None:
                break
            try:
                self.last_stats = self.local_worker.learn_on_batch(batch)
            except Exception:  # noqa: BLE001 - keep the thread alive
                import traceback

                traceback.print_exc()
                self.errors += 1
                self.last_stats = {"learner_errors": float(self.errors)}
            self.num_updates += 1
            self.steps_trained += batch.count
            self.weights_seq += 1

    def stop(self) -> None:
        self.stopped = True
        try:
            self.inqueue.put_nowait(None)
        except _queue.Full:
            pass


@ray_tpu_torch.remote
class AggregatorActor:
    """One level of hierarchical sample aggregation
    (reference: rllib/execution/tree_agg.py:gather_experiences_tree_agg).

    Each aggregator owns a subset of the rollout workers: it drives their
    sample() calls, concatenates fragments up to ``train_batch_size``
    timesteps, and hands the learner ONE large batch — so the learner's
    inbound fan-in is num_aggregators instead of num_workers, and concat
    cost is spread across the tree.
    """

    def __init__(self, worker_handles: List, train_batch_size: int):
        self.workers = list(worker_handles)
        self.train_batch_size = train_batch_size
        self._inflight = {w.sample.remote(): w for w in self.workers}
        self._pending: List[SampleBatch] = []
        self._count = 0

    def aggregate(self) -> SampleBatch:
        """Block until train_batch_size timesteps are buffered; return the
        concatenated batch."""
        while self._count < self.train_batch_size:
            ready, _ = ray_tpu_torch.wait(list(self._inflight.keys()),
                                    num_returns=1)
            worker = self._inflight.pop(ready[0])
            batch = ray_tpu_torch.get(ready[0])
            self._pending.append(batch)
            self._count += batch.count
            self._inflight[worker.sample.remote()] = worker
        out = SampleBatch.concat_samples(self._pending)
        self._pending, self._count = [], 0
        return out

    def set_worker_weights(self, weights_box) -> None:
        """Fan the learner's weight broadcast out through the tree.

        ``weights_box`` is ``[ObjectRef]`` — boxed so the ref survives the
        hop (a top-level ref arg arrives resolved); each worker then pulls
        the single stored copy instead of this actor re-shipping N inline
        copies."""
        ref = weights_box[0]
        ray_tpu_torch.get([w.set_weights.remote(ref) for w in self.workers])


def make_aggregation_tree(workers, num_aggregators: int,
                          train_batch_size: int) -> List:
    """Partition remote workers round-robin across aggregator actors."""
    remote = workers.remote_workers()
    num_aggregators = max(1, min(num_aggregators, len(remote)))
    groups: List[List] = [[] for _ in range(num_aggregators)]
    for i, w in enumerate(remote):
        groups[i % num_aggregators].append(w)
    return [
        AggregatorActor.remote(g, train_batch_size) for g in groups if g
    ]


class StoreToReplayBuffer:
    def __init__(self, buffer: ReplayBuffer):
        self.buffer = buffer

    def __call__(self, batch: SampleBatch) -> SampleBatch:
        self.buffer.add_batch(batch)
        return batch


class ConcatBatches:
    """Accumulate until at least min_batch_size timesteps
    (reference: rollout_ops.ConcatBatches)."""

    def __init__(self, min_batch_size: int):
        self.min_batch_size = min_batch_size
        self.buffer: List[SampleBatch] = []
        self.count = 0

    def __call__(self, batch: SampleBatch):
        self.buffer.append(batch)
        self.count += batch.count
        if self.count >= self.min_batch_size:
            out = SampleBatch.concat_samples(self.buffer)
            self.buffer = []
            self.count = 0
            return out
        return None

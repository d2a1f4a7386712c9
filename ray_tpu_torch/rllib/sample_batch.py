"""SampleBatch: columnar rollout storage (reference: rllib/policy/sample_batch.py).

A dict of equal-length numpy arrays. Columnar layout means a batch converts to
device tensors with one host-to-device copy per column and feeds the losses
without reshaping.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
NEXT_OBS = "new_obs"
LOGPS = "action_logp"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"


class SampleBatch(dict):
    @property
    def count(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    @staticmethod
    def concat_samples(batches: List["SampleBatch"]) -> "SampleBatch":
        if not batches:
            return SampleBatch()
        keys = batches[0].keys()
        return SampleBatch({
            k: np.concatenate([np.asarray(b[k]) for b in batches])
            for k in keys
        })

    def shuffle(self, rng: np.random.RandomState) -> "SampleBatch":
        perm = rng.permutation(self.count)
        return SampleBatch({k: np.asarray(v)[perm] for k, v in self.items()})

    def minibatches(self, size: int) -> Iterator["SampleBatch"]:
        n = self.count
        for start in range(0, n - size + 1, size):
            yield SampleBatch(
                {k: np.asarray(v)[start:start + size] for k, v in self.items()})

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch(
            {k: np.asarray(v)[start:end] for k, v in self.items()})

    def split_by_episode(self) -> List["SampleBatch"]:
        dones = np.asarray(self[DONES])
        ends = list(np.nonzero(dones)[0] + 1)
        if not ends or ends[-1] != self.count:
            ends.append(self.count)
        out, start = [], 0
        for end in ends:
            out.append(self.slice(start, end))
            start = end
        return out

    def __repr__(self):
        return f"SampleBatch({self.count}: {list(self.keys())})"


def compute_gae(batch: SampleBatch, last_value: float, gamma: float,
                lam: float) -> SampleBatch:
    """Generalized advantage estimation over one rollout fragment
    (reference: rllib/evaluation/postprocessing.py compute_advantages)."""
    rewards = np.asarray(batch[REWARDS], dtype=np.float32)
    dones = np.asarray(batch[DONES], dtype=np.float32)
    values = np.asarray(batch[VF_PREDS], dtype=np.float32)
    n = len(rewards)
    adv = np.zeros(n, dtype=np.float32)
    next_value = last_value
    next_adv = 0.0
    for t in range(n - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        next_adv = delta + gamma * lam * nonterminal * next_adv
        adv[t] = next_adv
        next_value = values[t]
    batch[ADVANTAGES] = adv
    batch[VALUE_TARGETS] = adv + values
    return batch

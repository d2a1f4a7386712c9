"""Trial schedulers: early stopping and population-based training.

Reference behavior: ``python/ray/tune/schedulers/`` —
- FIFOScheduler: run everything to completion (trial_scheduler.py:64).
- AsyncHyperBandScheduler (ASHA, async_hyperband.py): per-bracket milestone
  rungs at grace_period * rf^k; at each rung a trial continues only if its
  metric is in the top 1/rf of recorded results at that rung.
- HyperBandScheduler (hyperband.py): synchronous successive halving.
- MedianStoppingRule (median_stopping_rule.py): stop if running-average
  metric is below the median of other trials' averages at the same time.
- PopulationBasedTraining (pbt.py): at perturbation_interval, bottom
  quantile exploits (clones) a top-quantile trial's checkpoint and explores
  (mutates) its config.
"""

from __future__ import annotations

import copy
import math
import random
from collections import defaultdict
from typing import Dict, List, Optional

from .trial import Trial


class TrialScheduler:
    CONTINUE = "CONTINUE"
    PAUSE = "PAUSE"
    STOP = "STOP"

    def on_trial_add(self, trial_runner, trial: Trial) -> None:
        pass

    def on_trial_error(self, trial_runner, trial: Trial) -> None:
        pass

    def on_trial_result(self, trial_runner, trial: Trial, result: Dict) -> str:
        return TrialScheduler.CONTINUE

    def on_trial_complete(self, trial_runner, trial: Trial, result: Dict) -> None:
        pass

    def on_trial_remove(self, trial_runner, trial: Trial) -> None:
        pass

    def choose_trial_to_run(self, trial_runner) -> Optional[Trial]:
        raise NotImplementedError

    def debug_string(self) -> str:
        return type(self).__name__


class FIFOScheduler(TrialScheduler):
    def choose_trial_to_run(self, trial_runner) -> Optional[Trial]:
        for trial in trial_runner.get_trials():
            if trial.status == Trial.PENDING \
                    and trial_runner.has_resources(trial.resources):
                return trial
        for trial in trial_runner.get_trials():
            if trial.status == Trial.PAUSED \
                    and trial_runner.has_resources(trial.resources):
                return trial
        return None


class _AshaBracket:
    """One ASHA bracket: rungs at grace * rf^(k+s), recorded metrics per rung."""

    def __init__(self, grace: float, max_t: float, rf: float, s: int):
        self.rf = rf
        max_rungs = int(math.log(max(max_t / grace, 1)) / math.log(rf) - s + 1)
        self.rungs = [(grace * rf ** (k + s), {})
                      for k in reversed(range(max(max_rungs, 1)))]
        # rungs sorted high milestone -> low

    def on_result(self, trial: Trial, cur_t: float, metric: float) -> str:
        """Cutoff = (1 - 1/rf) percentile of results recorded at this rung
        so far (excluding the current trial); below it -> STOP. The current
        result is recorded either way (reference async_hyperband.py:146)."""
        action = TrialScheduler.CONTINUE
        for milestone, recorded in self.rungs:
            if cur_t < milestone or trial.trial_id in recorded:
                continue
            if recorded:
                cutoff = _percentile(list(recorded.values()),
                                     (1 - 1 / self.rf) * 100)
                if metric < cutoff:
                    action = TrialScheduler.STOP
            recorded[trial.trial_id] = metric
            break
        return action

    def debug_str(self) -> str:
        rungs = ", ".join(f"{m:.0f}:{len(r)}" for m, r in self.rungs)
        return f"Bracket[{rungs}]"


def _percentile(values: List[float], pct: float) -> float:
    """Linear-interpolated percentile (numpy.percentile semantics)."""
    vals = sorted(values)
    if len(vals) == 1:
        return vals[0]
    pos = (len(vals) - 1) * pct / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return vals[lo] * (1 - frac) + vals[hi] * frac


def _quantile_top(values: List[float], frac: float) -> float:
    """Value at the top-``frac`` boundary (trials >= this continue)."""
    vals = sorted(values, reverse=True)
    k = max(int(len(vals) * frac), 1)
    return vals[k - 1]


class AsyncHyperBandScheduler(FIFOScheduler):
    """ASHA (reference async_hyperband.py:9)."""

    def __init__(self, time_attr: str = "training_iteration",
                 metric: str = "episode_reward_mean", mode: str = "max",
                 max_t: float = 100, grace_period: float = 1,
                 reduction_factor: float = 4, brackets: int = 1):
        assert max_t >= grace_period > 0
        assert reduction_factor > 1
        assert mode in ("min", "max")
        self._time_attr = time_attr
        self._metric = metric
        self._op = 1.0 if mode == "max" else -1.0
        self._max_t = max_t
        self._brackets = [
            _AshaBracket(grace_period, max_t, reduction_factor, s)
            for s in range(brackets)
        ]
        self._trial_bracket: Dict[str, _AshaBracket] = {}
        self.num_stopped = 0

    def on_trial_add(self, trial_runner, trial: Trial) -> None:
        # Random bracket assignment, softmax-weighted like the reference.
        sizes = [len(b.rungs) for b in self._brackets]
        total = sum(math.exp(s) for s in sizes)
        r = random.random() * total
        acc = 0.0
        chosen = self._brackets[-1]
        for b, s in zip(self._brackets, sizes):
            acc += math.exp(s)
            if r <= acc:
                chosen = b
                break
        self._trial_bracket[trial.trial_id] = chosen

    def on_trial_result(self, trial_runner, trial: Trial, result: Dict) -> str:
        cur_t = result.get(self._time_attr, 0)
        if cur_t >= self._max_t:
            self.num_stopped += 1
            return TrialScheduler.STOP
        if self._metric not in result:
            return TrialScheduler.CONTINUE
        bracket = self._trial_bracket[trial.trial_id]
        action = bracket.on_result(
            trial, cur_t, self._op * result[self._metric])
        if action == TrialScheduler.STOP:
            self.num_stopped += 1
        return action

    def debug_string(self) -> str:
        return "AsyncHyperBand: " + " ".join(
            b.debug_str() for b in self._brackets)


class HyperBandScheduler(FIFOScheduler):
    """Synchronous successive halving: trials in a band all reach a
    milestone, then the bottom (1 - 1/rf) are stopped and the milestone
    multiplies by rf (simplified from reference hyperband.py, keeping the
    halving semantics without the pause/unpause bookkeeping)."""

    def __init__(self, time_attr: str = "training_iteration",
                 metric: str = "episode_reward_mean", mode: str = "max",
                 max_t: float = 81, reduction_factor: float = 3):
        self._time_attr = time_attr
        self._metric = metric
        self._op = 1.0 if mode == "max" else -1.0
        self._max_t = max_t
        self._rf = reduction_factor
        self._milestone_results: Dict[float, Dict[str, float]] = defaultdict(dict)
        self._stopped: set = set()

    def _next_milestone(self, cur_t: float) -> float:
        m = 1.0
        while m <= cur_t:
            m *= self._rf
        return m / self._rf  # largest milestone <= cur_t

    def on_trial_result(self, trial_runner, trial: Trial, result: Dict) -> str:
        cur_t = result.get(self._time_attr, 0)
        if cur_t >= self._max_t:
            return TrialScheduler.STOP
        if self._metric not in result or cur_t < 1:
            return TrialScheduler.CONTINUE
        milestone = self._next_milestone(cur_t)
        if milestone < 1:
            return TrialScheduler.CONTINUE
        recorded = self._milestone_results[milestone]
        if trial.trial_id not in recorded:
            recorded[trial.trial_id] = self._op * result[self._metric]
            # Halve once every live trial reported at this milestone.
            live = [t for t in trial_runner.get_trials()
                    if not t.is_finished()]
            if len(recorded) >= len(live) and len(recorded) > 1:
                cutoff = _quantile_top(list(recorded.values()), 1 / self._rf)
                for tid, val in recorded.items():
                    if val < cutoff:
                        self._stopped.add(tid)
        if trial.trial_id in self._stopped:
            return TrialScheduler.STOP
        return TrialScheduler.CONTINUE


class MedianStoppingRule(FIFOScheduler):
    """Stop a trial whose running-average metric falls below the median of
    other trials' running averages at or before the same time
    (reference median_stopping_rule.py)."""

    def __init__(self, time_attr: str = "time_total_s",
                 metric: str = "episode_reward_mean", mode: str = "max",
                 grace_period: float = 60.0, min_samples_required: int = 3):
        self._time_attr = time_attr
        self._metric = metric
        self._op = 1.0 if mode == "max" else -1.0
        self._grace = grace_period
        self._min_samples = min_samples_required
        self._results: Dict[str, List[Dict]] = defaultdict(list)

    def on_trial_result(self, trial_runner, trial: Trial, result: Dict) -> str:
        if self._metric not in result:
            return TrialScheduler.CONTINUE
        self._results[trial.trial_id].append(result)
        t = result.get(self._time_attr, 0)
        if t < self._grace:
            return TrialScheduler.CONTINUE
        medians = []
        for tid, results in self._results.items():
            if tid == trial.trial_id:
                continue
            window = [self._op * r[self._metric] for r in results
                      if r.get(self._time_attr, 0) <= t]
            if window:
                medians.append(sum(window) / len(window))
        if len(medians) < self._min_samples:
            return TrialScheduler.CONTINUE
        medians.sort()
        median = medians[len(medians) // 2]
        own = [self._op * r[self._metric]
               for r in self._results[trial.trial_id]]
        if sum(own) / len(own) < median:
            return TrialScheduler.STOP
        return TrialScheduler.CONTINUE


def explore(config: Dict, mutations: Dict, resample_probability: float,
            custom_explore_fn=None) -> Dict:
    """Perturb a config (reference pbt.py explore): lists step up/down or
    resample; callables/sample_from resample; numeric dist via factor."""
    from .sample import sample_from

    new_config = copy.deepcopy(config)
    for key, dist in mutations.items():
        if isinstance(dist, dict):
            new_config[key] = explore(config.get(key, {}), dist,
                                      resample_probability, None)
        elif isinstance(dist, list):
            if random.random() < resample_probability or \
                    config.get(key) not in dist:
                new_config[key] = random.choice(dist)
            elif random.random() > 0.5:
                new_config[key] = dist[max(0, dist.index(config[key]) - 1)]
            else:
                new_config[key] = dist[min(len(dist) - 1,
                                           dist.index(config[key]) + 1)]
        else:
            sampler = dist.func if isinstance(dist, sample_from) else dist
            if key not in config:
                # Donor config lacks this key: resample if possible.
                if callable(sampler):
                    new_config[key] = sampler(None)
                continue
            if random.random() < resample_probability:
                new_config[key] = sampler(None) if callable(sampler) \
                    else config[key]
            elif random.random() > 0.5:
                new_config[key] = config[key] * 1.2
            else:
                new_config[key] = config[key] * 0.8
            if isinstance(config[key], int):
                new_config[key] = int(new_config[key])
    if custom_explore_fn:
        new_config = custom_explore_fn(new_config)
    return new_config


class PopulationBasedTraining(FIFOScheduler):
    """PBT (reference pbt.py): every perturbation_interval, trials in the
    bottom quantile clone the state of a random top-quantile trial
    (exploit) and mutate hyperparameters (explore)."""

    def __init__(self, time_attr: str = "time_total_s",
                 metric: str = "episode_reward_mean", mode: str = "max",
                 perturbation_interval: float = 60.0,
                 hyperparam_mutations: Optional[Dict] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 custom_explore_fn=None):
        if not (0 <= quantile_fraction <= 0.5):
            raise ValueError("quantile_fraction must be in [0, 0.5]")
        self._time_attr = time_attr
        self._metric = metric
        self._op = 1.0 if mode == "max" else -1.0
        self._interval = perturbation_interval
        self._mutations = hyperparam_mutations or {}
        self._quantile = quantile_fraction
        self._resample_prob = resample_probability
        self._custom_explore = custom_explore_fn
        self._last_perturb: Dict[str, float] = defaultdict(float)
        self._scores: Dict[str, float] = {}
        self.num_perturbations = 0

    def _quantiles(self, trials: List[Trial]):
        # Only live trials participate: a TERMINATED trial has no runner to
        # donate state from, and perturbing a finished trial is meaningless.
        scored = [t for t in trials
                  if t.trial_id in self._scores and t.runner is not None]
        if len(scored) <= 1:
            return [], []
        scored.sort(key=lambda t: self._scores[t.trial_id])
        num = int(math.ceil(len(scored) * self._quantile))
        num = min(num, len(scored) // 2)
        if num < 1:
            return [], []
        return scored[:num], scored[-num:]

    def on_trial_result(self, trial_runner, trial: Trial, result: Dict) -> str:
        if self._metric not in result:
            return TrialScheduler.CONTINUE
        t = result.get(self._time_attr, 0)
        self._scores[trial.trial_id] = self._op * result[self._metric]
        if t - self._last_perturb[trial.trial_id] < self._interval:
            return TrialScheduler.CONTINUE
        self._last_perturb[trial.trial_id] = t
        bottom, top = self._quantiles(trial_runner.get_trials())
        if trial in bottom and top:
            donor = random.choice(top)
            self._exploit(trial_runner, trial, donor)
        return TrialScheduler.CONTINUE

    def _exploit(self, trial_runner, trial: Trial, donor: Trial) -> None:
        new_config = explore(donor.config, self._mutations,
                             self._resample_prob, self._custom_explore)
        self.num_perturbations += 1
        trial_runner.transfer_trial_state(donor, trial, new_config)

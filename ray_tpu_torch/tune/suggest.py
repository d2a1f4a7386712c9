"""Model-based search (reference: python/ray/tune/suggest/ — the reference
wraps external optimizers (hyperopt/skopt/bayesopt/...); none are in this
image, so SuggestSearcher is a self-contained sequential-model searcher with
the same SearchAlgorithm interface: suggest -> observe -> suggest better.

Surrogate: k-nearest-neighbour value estimate over [0,1]^d encodings with an
exploration bonus for sparse regions — a cheap stand-in for a GP that needs
no dependencies and behaves sensibly in <=20 dims.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

from .sample import Domain
from .search import SearchAlgorithm


class _SpaceSearcher(SearchAlgorithm):
    """Shared scaffolding for model-based searchers over a Domain space:
    space splitting, trial-tag issuing, live-trial tracking, completion
    bookkeeping. Subclasses implement ``_suggest`` and ``_observe``."""

    _tag_prefix = "search"

    def __init__(self, space: Dict[str, Any], *, metric: str,
                 mode: str = "max", num_samples: int = 16,
                 max_concurrent: int = 4, seed: int = 0,
                 base_config: Optional[Dict[str, Any]] = None):
        if mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")
        self._domains: Dict[str, Domain] = {}
        self._static: Dict[str, Any] = {}
        for name, dom in space.items():
            if isinstance(dom, Domain):
                self._domains[name] = dom
            else:
                self._static[name] = dom
        if not self._domains:
            raise ValueError("space contains no tunable Domain entries")
        self._names = sorted(self._domains)
        self._base = dict(base_config or {})
        self._metric = metric
        self._sign = 1.0 if mode == "max" else -1.0
        self._num_samples = num_samples
        self._max_concurrent = max_concurrent
        self._rng = random.Random(seed)
        self._suggested = 0
        self._live: Dict[str, Dict[str, Any]] = {}   # trial tag -> config

    # ---- SearchAlgorithm interface ----

    def next_trial_config(self) -> Optional[Tuple[str, Dict]]:
        if self._suggested >= self._num_samples:
            return None
        if len(self._live) >= self._max_concurrent:
            return None
        config = self._suggest()
        tag = f"{self._tag_prefix}_{self._suggested}"
        self._suggested += 1
        self._live[tag] = config
        return tag, {**self._base, **self._static, **config}

    def on_trial_complete(self, trial_id: str, result: Optional[Dict] = None,
                          error: bool = False) -> None:
        # The runner reports with the tag this searcher issued in
        # next_trial_config (TrialRunner tracks it as trial.search_tag).
        config = self._live.pop(trial_id, None)
        if config is None or error or not result:
            return
        if self._metric in result:
            self._observe(config, result)

    def is_finished(self) -> bool:
        return self._suggested >= self._num_samples and not self._live

    # ---- shared internals ----

    def _encode(self, config: Dict[str, Any]) -> List[float]:
        return [self._domains[n].encode(config[n]) for n in self._names]

    def _random_config(self) -> Dict[str, Any]:
        return {n: d.sample(self._rng) for n, d in self._domains.items()}

    # ---- subclass hooks ----

    def _suggest(self) -> Dict[str, Any]:
        raise NotImplementedError

    def _observe(self, config: Dict[str, Any], result: Dict) -> None:
        raise NotImplementedError


class SuggestSearcher(_SpaceSearcher):
    _tag_prefix = "suggest"

    def __init__(self, space: Dict[str, Any], *, metric: str,
                 mode: str = "max", num_samples: int = 16,
                 max_concurrent: int = 4, num_candidates: int = 128,
                 k: int = 3, explore_weight: float = 0.3,
                 num_startup: int = 5, seed: int = 0,
                 base_config: Optional[Dict[str, Any]] = None):
        super().__init__(space, metric=metric, mode=mode,
                         num_samples=num_samples,
                         max_concurrent=max_concurrent, seed=seed,
                         base_config=base_config)
        self._num_candidates = num_candidates
        self._k = k
        self._explore = explore_weight
        self._num_startup = num_startup
        self._observations: List[Tuple[List[float], float]] = []

    def _observe(self, config: Dict[str, Any], result: Dict) -> None:
        self._observations.append(
            (self._encode(config), self._sign * float(result[self._metric])))

    def _suggest(self) -> Dict[str, Any]:
        if len(self._observations) < self._num_startup:
            return self._random_config()
        candidates = [self._random_config()
                      for _ in range(self._num_candidates)]
        best, best_score = None, -math.inf
        for cand in candidates:
            x = self._encode(cand)
            score = self._acquisition(x)
            if score > best_score:
                best, best_score = cand, score
        return best

    def _acquisition(self, x: List[float]) -> float:
        dists = sorted(
            (math.dist(x, ox), val) for ox, val in self._observations)
        nearest = dists[: self._k]
        # inverse-distance-weighted value estimate
        num = den = 0.0
        for d, val in nearest:
            w = 1.0 / (d + 1e-6)
            num += w * val
            den += w
        estimate = num / den
        # exploration: reward distance from the nearest observation
        return estimate + self._explore * nearest[0][0]


def best_config(searcher: SuggestSearcher) -> Optional[Dict[str, Any]]:
    """Decode nothing — convenience: the caller should read the analysis;
    kept for API symmetry with reference suggest wrappers."""
    if not searcher._observations:
        return None
    return max(searcher._observations, key=lambda o: o[1])[0]


class BOHBSearcher(_SpaceSearcher):
    """BOHB's model-based sampler (reference: tune/schedulers/bohb.py +
    tune/suggest/bohb.py wrapping HpBandSter; self-contained here).

    TPE-style density modeling per budget: completed trials are grouped by
    the budget they were trained to (``training_iteration`` at completion —
    HyperBand/ASHA rungs produce the budget spectrum); the largest budget
    with enough observations is split into good/bad fractions; candidates
    maximize l(x)/g(x) under per-dimension Gaussian KDEs in the [0,1]
    encoding. A ``random_fraction`` of suggestions stays uniform, like the
    original BOHB, to keep the model honest. Pair with the HyperBand or
    ASHA scheduler for the full algorithm.
    """

    _tag_prefix = "bohb"

    def __init__(self, space: Dict[str, Any], *, metric: str,
                 mode: str = "max", num_samples: int = 32,
                 max_concurrent: int = 4, num_candidates: int = 64,
                 min_points_in_model: Optional[int] = None,
                 top_fraction: float = 0.3, random_fraction: float = 0.2,
                 bandwidth: float = 0.12, seed: int = 0,
                 base_config: Optional[Dict[str, Any]] = None):
        super().__init__(space, metric=metric, mode=mode,
                         num_samples=num_samples,
                         max_concurrent=max_concurrent, seed=seed,
                         base_config=base_config)
        self._num_candidates = num_candidates
        self._min_points = (min_points_in_model
                            or (len(self._names) + 2))
        self._top_fraction = top_fraction
        self._random_fraction = random_fraction
        self._bw = bandwidth
        # budget -> list of (encoded x, signed value)
        self._by_budget: Dict[int, List[Tuple[List[float], float]]] = {}

    def _observe(self, config: Dict[str, Any], result: Dict) -> None:
        budget = int(result.get("training_iteration", 1))
        self._by_budget.setdefault(budget, []).append(
            (self._encode(config), self._sign * float(result[self._metric])))

    # ---- internals ----

    def _model_budget(self) -> Optional[int]:
        eligible = [b for b, obs in self._by_budget.items()
                    if len(obs) >= self._min_points]
        return max(eligible) if eligible else None

    def _kde_logpdf(self, x: List[float],
                    points: List[List[float]]) -> float:
        """Product of per-dimension Gaussian KDEs (TPE factorization)."""
        total = 0.0
        for d, xd in enumerate(x):
            s = 0.0
            for p in points:
                z = (xd - p[d]) / self._bw
                s += math.exp(-0.5 * z * z)
            total += math.log(max(s / len(points), 1e-12))
        return total

    def _suggest(self) -> Dict[str, Any]:
        budget = self._model_budget()
        if budget is None or self._rng.random() < self._random_fraction:
            return self._random_config()
        obs = sorted(self._by_budget[budget], key=lambda o: -o[1])
        n_good = max(2, int(len(obs) * self._top_fraction))
        good = [x for x, _ in obs[:n_good]]
        bad = [x for x, _ in obs[n_good:]] or good  # degenerate early case
        best, best_score = None, -math.inf
        for _ in range(self._num_candidates):
            # Sample around a random good point (BOHB's KDE sampling),
            # clipped into the unit cube via resampling the domain.
            anchor = self._rng.choice(good)
            cand = {}
            for d, name in enumerate(self._names):
                dom = self._domains[name]
                # local perturbation in encoded space, decoded by rejection
                for _ in range(8):
                    val = dom.sample(self._rng)
                    if abs(dom.encode(val) - anchor[d]) <= 2 * self._bw:
                        break
                cand[name] = val
            x = self._encode(cand)
            score = (self._kde_logpdf(x, good)
                     - self._kde_logpdf(x, bad))
            if score > best_score:
                best, best_score = cand, score
        return best

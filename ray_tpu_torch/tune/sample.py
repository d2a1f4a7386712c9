"""Search-space sampling primitives (reference: tune's grid_search /
sample_from / tune.uniform-family helpers)."""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Sequence


def grid_search(values: Sequence[Any]) -> Dict[str, Any]:
    """Mark a config key for exhaustive expansion."""
    return {"grid_search": list(values)}


class sample_from:
    """Defer a config value to a callable of the resolved spec."""

    def __init__(self, func: Callable[[Dict], Any]):
        self.func = func

    def __repr__(self):
        return f"sample_from({self.func})"


class Domain(sample_from):
    """A sample_from that is also introspectable: adaptive searchers
    (tune/suggest.py) need the distribution's support to encode configs as
    vectors, while BasicVariantGenerator just calls it. Mirrors the split
    between tune.sample_from and the typed Domain API in the reference."""

    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError

    def encode(self, value: Any) -> float:
        """Map a sampled value to [0, 1] for surrogate distance metrics."""
        raise NotImplementedError


class Uniform(Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = float(low), float(high)
        super().__init__(lambda _: random.uniform(self.low, self.high))

    def sample(self, rng):
        return rng.uniform(self.low, self.high)

    def encode(self, value):
        return (value - self.low) / (self.high - self.low or 1.0)


class LogUniform(Domain):
    def __init__(self, low: float, high: float):
        import math

        self.low, self.high = float(low), float(high)
        self._llo, self._lhi = math.log(self.low), math.log(self.high)
        super().__init__(lambda _: self.sample(random))

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(self._llo, self._lhi))

    def encode(self, value):
        import math

        return (math.log(value) - self._llo) / ((self._lhi - self._llo) or 1.0)


class Randint(Domain):
    def __init__(self, low: int, high: int):
        self.low, self.high = int(low), int(high)
        super().__init__(lambda _: random.randint(self.low, self.high - 1))

    def sample(self, rng):
        return rng.randrange(self.low, self.high)

    def encode(self, value):
        return (value - self.low) / ((self.high - 1 - self.low) or 1)


class Choice(Domain):
    def __init__(self, options: Sequence[Any]):
        self.options = list(options)
        super().__init__(lambda _: random.choice(self.options))

    def sample(self, rng):
        return rng.choice(self.options)

    def encode(self, value):
        try:
            return self.options.index(value) / (len(self.options) - 1 or 1)
        except ValueError:
            return 0.0


def uniform(low: float, high: float) -> Domain:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> Domain:
    return LogUniform(low, high)


def randint(low: int, high: int) -> Domain:
    return Randint(low, high)


def choice(options: Sequence[Any]) -> Domain:
    return Choice(options)


def randn(mean: float = 0.0, sd: float = 1.0) -> sample_from:
    return sample_from(lambda _: random.gauss(mean, sd))

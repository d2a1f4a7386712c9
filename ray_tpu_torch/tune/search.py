"""Search algorithms: variant expansion for grid/random search.

Reference behavior: ``python/ray/tune/suggest/basic_variant.py`` +
``variant_generator.py`` — grid_search dict values expand cross-product;
``sample_from``/callable values resolve per sample; ``num_samples``
replicates the whole spec.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .sample import sample_from


def _find_grid_axes(spec: Any, path=()) -> List[Tuple[tuple, List[Any]]]:
    """Collect (path, values) for every {"grid_search": [...]} node."""
    axes = []
    if isinstance(spec, dict):
        if set(spec.keys()) == {"grid_search"}:
            axes.append((path, list(spec["grid_search"])))
        else:
            for k, v in spec.items():
                axes.extend(_find_grid_axes(v, path + (k,)))
    return axes


def _set_path(config: Dict, path: tuple, value: Any) -> None:
    node = config
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value


def _deep_copy_spec(spec: Any) -> Any:
    if isinstance(spec, dict):
        return {k: _deep_copy_spec(v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_deep_copy_spec(v) for v in spec]
    return spec


def _resolve_samples(config: Any, full_spec: Dict) -> Any:
    if isinstance(config, sample_from):
        return _resolve_samples(config.func(full_spec), full_spec)
    if callable(config) and not isinstance(config, type) \
            and getattr(config, "__name__", "") == "<lambda>":
        return _resolve_samples(config(full_spec), full_spec)
    if isinstance(config, dict):
        return {k: _resolve_samples(v, full_spec) for k, v in config.items()}
    return config


def generate_variants(spec: Dict) -> Iterator[Tuple[str, Dict]]:
    """Yield (variant_tag, resolved_config) for one pass over the spec."""
    axes = _find_grid_axes(spec)
    if not axes:
        combos = [()]
    else:
        combos = itertools.product(*[vals for _, vals in axes])
    for combo in combos:
        config = _deep_copy_spec(spec)
        tags = []
        for (path, _), value in zip(axes, combo):
            _set_path(config, path, value)
            tags.append(f"{'.'.join(map(str, path))}={value}")
        config = _resolve_samples(config, config)
        yield ",".join(tags), config


class SearchAlgorithm:
    """Interface: feeds trial configs to the runner."""

    def next_trial_config(self) -> Optional[Tuple[str, Dict]]:
        raise NotImplementedError

    def is_finished(self) -> bool:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, result: Optional[Dict] = None,
                          error: bool = False) -> None:
        pass


class BasicVariantGenerator(SearchAlgorithm):
    """Grid x random search over a config spec (the reference default)."""

    def __init__(self, config: Dict, num_samples: int = 1):
        self._queue: List[Tuple[str, Dict]] = []
        for sample_i in range(num_samples):
            for i, (tag, cfg) in enumerate(generate_variants(config)):
                suffix = f"{sample_i}_{i}" if num_samples > 1 else str(i)
                full_tag = f"{suffix}_{tag}" if tag else suffix
                self._queue.append((full_tag, cfg))
        self._total = len(self._queue)

    def next_trial_config(self) -> Optional[Tuple[str, Dict]]:
        if self._queue:
            return self._queue.pop(0)
        return None

    def is_finished(self) -> bool:
        return not self._queue

    @property
    def total_samples(self) -> int:
        return self._total

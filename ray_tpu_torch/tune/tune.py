"""``tune.run``: the user entry point.

Reference behavior: ``python/ray/tune/tune.py:68`` — accepts a Trainable
class, a function trainable, or a registered name; expands the config spec
via grid/random search; runs the TrialRunner loop under the chosen
scheduler; returns an analysis of all trials.
"""

from __future__ import annotations

import inspect
import os
import time
from typing import Any, Callable, Dict, List, Optional, Union

import ray_tpu_torch

from .logger import CSVLogger, JsonLogger, Logger
from .progress_reporter import CLIReporter, ProgressReporter
from .result import DEFAULT_RESULTS_DIR
from .schedulers import FIFOScheduler, TrialScheduler
from .search import BasicVariantGenerator
from .trainable import Trainable, wrap_function
from .trial import Trial
from .trial_executor import RayTrialExecutor
from .trial_runner import TrialRunner

_registry: Dict[str, type] = {}


def register_trainable(name: str, trainable: Union[type, Callable]) -> None:
    """Register under a string name (reference tune/registry.py)."""
    _registry[name] = _as_trainable_cls(trainable)


def _as_trainable_cls(run_or_experiment) -> type:
    if isinstance(run_or_experiment, str):
        if run_or_experiment not in _registry:
            raise ValueError(f"Unknown trainable: {run_or_experiment!r}")
        return _registry[run_or_experiment]
    if inspect.isclass(run_or_experiment) and \
            issubclass(run_or_experiment, Trainable):
        return run_or_experiment
    if callable(run_or_experiment):
        return wrap_function(run_or_experiment)
    raise TypeError(f"Cannot interpret {run_or_experiment!r} as a trainable")


class _TrialLoggerAdapter(Logger):
    """Bridges TrialRunner's (trial, result) logging to per-trial loggers."""

    def __init__(self, logger):
        self._logger = logger

    def on_result(self, trial, result):
        self._logger.on_result(trial, result)

    def close(self):
        self._logger.close()


class ExperimentAnalysis:
    """Result object of tune.run (reference analysis/experiment_analysis.py)."""

    def __init__(self, trials: List[Trial], local_dir: str):
        self.trials = trials
        self.local_dir = local_dir

    def get_best_trial(self, metric: str, mode: str = "max") -> Optional[Trial]:
        candidates = [t for t in self.trials if metric in t.last_result]
        if not candidates:
            return None
        key = lambda t: t.last_result[metric]
        return max(candidates, key=key) if mode == "max" \
            else min(candidates, key=key)

    def get_best_config(self, metric: str, mode: str = "max") -> Optional[Dict]:
        best = self.get_best_trial(metric, mode)
        if best is None:
            return None
        return {k: v for k, v in best.config.items()
                if not k.startswith("__")}

    def get_best_checkpoint(self, metric: str, mode: str = "max"):
        """Checkpoint path/blob of the best trial by ``metric``."""
        best = self.get_best_trial(metric, mode)
        if best is not None and best.checkpoint is not None:
            return best.checkpoint.value
        return None

    @property
    def best_checkpoint(self):
        """Most recent checkpoint across trials; prefer
        ``get_best_checkpoint(metric)`` for metric-aware selection."""
        ckpts = [t.checkpoint for t in self.trials if t.checkpoint]
        return ckpts[-1].value if ckpts else None

    def dataframe(self):
        import pandas as pd

        return pd.DataFrame([t.last_result for t in self.trials])


def run(run_or_experiment,
        *,
        name: Optional[str] = None,
        stop: Optional[Dict[str, Any]] = None,
        config: Optional[Dict[str, Any]] = None,
        resources_per_trial: Optional[Dict[str, float]] = None,
        num_samples: int = 1,
        local_dir: Optional[str] = None,
        checkpoint_freq: int = 0,
        checkpoint_at_end: bool = False,
        keep_checkpoints_num: Optional[int] = None,
        checkpoint_score_attr: str = "training_iteration",
        max_failures: int = 0,
        fail_fast: bool = False,
        restore: Optional[str] = None,
        scheduler: Optional[TrialScheduler] = None,
        search_alg=None,
        verbose: int = 1,
        progress_reporter: Optional[ProgressReporter] = None,
        loggers: Optional[List] = None,
        reuse_actors: bool = False,
        raise_on_failed_trial: bool = True) -> ExperimentAnalysis:
    """Run an experiment; blocks until all trials finish."""
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()

    trainable_cls = _as_trainable_cls(run_or_experiment)
    name = name or getattr(trainable_cls, "__name__", "experiment")
    local_dir = local_dir or DEFAULT_RESULTS_DIR
    exp_dir = os.path.join(local_dir, f"{name}_{int(time.time())}")
    os.makedirs(exp_dir, exist_ok=True)

    scheduler = scheduler or FIFOScheduler()
    variant_gen = search_alg or BasicVariantGenerator(
        config or {}, num_samples=num_samples)

    logger_objs: List[Logger] = []
    if loggers is None:
        logger_objs = [JsonLogger(exp_dir), CSVLogger(exp_dir)]
    else:
        for lg in loggers:
            logger_objs.append(lg(exp_dir) if isinstance(lg, type) else lg)

    def make_trial(tag, cfg):
        trial = Trial(
            trainable_cls, cfg,
            experiment_tag=tag,
            resources=resources_per_trial,
            stopping_criterion=stop,
            checkpoint_freq=checkpoint_freq,
            checkpoint_at_end=checkpoint_at_end,
            keep_checkpoints_num=keep_checkpoints_num,
            checkpoint_score_attr=checkpoint_score_attr,
            max_failures=max_failures,
        )
        if restore:
            trial.restore_path = restore
        return trial

    # The search algorithm feeds the runner lazily (every step), so adaptive
    # algorithms that suggest configs only after observing results work.
    runner = TrialRunner(
        scheduler=scheduler,
        search_alg=variant_gen,
        trial_creator=make_trial,
        trial_executor=RayTrialExecutor(reuse_actors=reuse_actors),
        fail_fast=fail_fast,
        loggers=logger_objs,
    )

    reporter = progress_reporter or (CLIReporter() if verbose else None)
    while not runner.is_finished():
        runner.step()
        if reporter is not None and reporter.should_report(runner.get_trials()):
            reporter.report(runner.get_trials())
    runner._shutdown_all()
    for lg in logger_objs:
        lg.close()
    if reporter is not None:
        reporter.report(runner.get_trials(), done=True)

    trials = runner.get_trials()
    errored = [t for t in trials if t.status == Trial.ERROR]
    if errored and raise_on_failed_trial:
        raise RuntimeError(
            f"{len(errored)} trials failed: "
            + "; ".join(f"{t}: {t.error_msg}" for t in errored[:3]))
    return ExperimentAnalysis(trials, exp_dir)

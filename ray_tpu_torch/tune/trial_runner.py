"""TrialRunner: the tune event loop.

Reference behavior: ``python/ray/tune/trial_runner.py:70`` — per step():
start pending trials while resources allow, fetch one result, route it
through the scheduler (CONTINUE/PAUSE/STOP), handle checkpointing and
failure retry (max_failures), until all trials finish.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from .schedulers import FIFOScheduler, TrialScheduler
from .search import SearchAlgorithm
from .trial import Trial
from .trial_executor import RayTrialExecutor


class TrialRunner:
    def __init__(self, scheduler: Optional[TrialScheduler] = None,
                 search_alg: Optional[SearchAlgorithm] = None,
                 trial_executor: Optional[RayTrialExecutor] = None,
                 fail_fast: bool = False,
                 loggers: Optional[List] = None,
                 trial_creator=None):
        self._scheduler = scheduler or FIFOScheduler()
        self._search_alg = search_alg
        self._trial_creator = trial_creator or (
            lambda tag, cfg: Trial(None, cfg, experiment_tag=tag))
        self._executor = trial_executor or RayTrialExecutor()
        self._trials: List[Trial] = []
        self._fail_fast = fail_fast
        self._loggers = loggers or []

    # ------------------------------------------------------------- trials
    def add_trial(self, trial: Trial) -> None:
        self._trials.append(trial)
        self._scheduler.on_trial_add(self, trial)

    def get_trials(self) -> List[Trial]:
        return list(self._trials)

    def has_resources(self, resources: Dict[str, float]) -> bool:
        return self._executor.has_resources(resources)

    def is_finished(self) -> bool:
        if self._search_alg is not None and not self._search_alg.is_finished():
            return False
        return all(t.is_finished() for t in self._trials)

    # ------------------------------------------------------------- loop
    def _pull_from_search_alg(self) -> None:
        """Drain whatever configs the search algorithm has ready right now.

        Adaptive algorithms (BO-style) return None while waiting on results
        and produce more configs after on_trial_complete — so this runs every
        step, not once up front (reference: trial_runner's
        _update_trial_queue)."""
        if self._search_alg is None:
            return
        while True:
            nxt = self._search_alg.next_trial_config()
            if nxt is None:
                return
            tag, cfg = nxt
            trial = self._trial_creator(tag, cfg)
            trial.search_tag = tag  # searcher-issued id for on_trial_complete
            self.add_trial(trial)

    def step(self) -> None:
        self._pull_from_search_alg()
        self._maybe_start_trials()
        trial, result = self._executor.get_next_available_result(timeout=120.0)
        if trial is None:
            if not self._executor.in_flight() and not self.is_finished():
                # Nothing running and nothing startable: deadlock guard.
                for t in self._trials:
                    if t.status == Trial.PENDING:
                        t.status = Trial.ERROR
                        t.error_msg = ("insufficient cluster resources for "
                                       f"{t.resources}")
            return
        if isinstance(result, Exception):
            self._process_failure(trial, result)
        else:
            self._process_result(trial, result)

    def _maybe_start_trials(self) -> None:
        while True:
            trial = self._scheduler.choose_trial_to_run(self)
            if trial is None:
                return
            started = self._executor.start_trial(trial)
            if not started and self._fail_fast:
                raise RuntimeError(
                    f"Trial {trial} failed to start: {trial.error_msg}")

    def _process_result(self, trial: Trial, result: Dict) -> None:
        trial.last_result = result
        for logger in self._loggers:
            logger.on_result(trial, result)

        if trial.should_stop(result):
            self._complete_trial(trial, result)
            return

        runner_before = trial.runner
        decision = self._scheduler.on_trial_result(self, trial, result)
        restarted = trial.runner is not runner_before
        if trial.should_checkpoint() and not restarted:
            self._executor.save(trial)
        if decision == TrialScheduler.CONTINUE:
            # A scheduler-triggered restart (PBT exploit) already queued the
            # next train() — don't double-submit.
            if trial.status == Trial.RUNNING and not restarted:
                self._executor.continue_training(trial)
        elif decision == TrialScheduler.PAUSE:
            self._executor.pause_trial(trial)
        elif decision == TrialScheduler.STOP:
            self._complete_trial(trial, result)

    def _complete_trial(self, trial: Trial, result: Dict) -> None:
        if trial.checkpoint_at_end:
            self._executor.save(trial)
        self._scheduler.on_trial_complete(self, trial, result)
        if self._search_alg is not None:
            self._search_alg.on_trial_complete(
                getattr(trial, "search_tag", trial.trial_id), result)
        self._executor.stop_trial(trial, Trial.TERMINATED)

    def _process_failure(self, trial: Trial, exc: Exception) -> None:
        trial.num_failures += 1
        self._scheduler.on_trial_error(self, trial)
        if trial.num_failures <= trial.max_failures:
            # Retry from the last checkpoint (searcher not notified: the
            # trial is still live and may yet report a result).
            self._executor.stop_trial(trial, Trial.PENDING)
            self._executor.start_trial(trial)
        else:
            if self._search_alg is not None:
                self._search_alg.on_trial_complete(
                    getattr(trial, "search_tag", trial.trial_id), error=True)
            self._executor.stop_trial(trial, Trial.ERROR, error_msg=str(exc))
            if self._fail_fast:
                self._shutdown_all()
                raise exc

    # PBT exploit hook (called by PopulationBasedTraining).
    def transfer_trial_state(self, donor: Trial, trial: Trial,
                             new_config: Dict) -> None:
        import ray_tpu_torch

        state = ray_tpu_torch.get(donor.runner.save_to_object.remote())
        self._executor.restart_trial(trial, new_config, state)

    def _shutdown_all(self) -> None:
        for t in self._trials:
            if t.runner is not None:
                self._executor.stop_trial(
                    t, t.status if t.is_finished() else Trial.TERMINATED)

    def run_until_done(self, max_steps: int = 10**9) -> None:
        steps = 0
        while not self.is_finished() and steps < max_steps:
            self.step()
            steps += 1
        self._shutdown_all()

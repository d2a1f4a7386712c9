"""Trainable: the unit of work Tune schedules.

Reference behavior: ``python/ray/tune/trainable.py:167`` — subclasses
implement ``setup/step/save_checkpoint/load_checkpoint``; the base class
provides the ``train()`` result contract (auto-filled ``training_iteration``,
``time_total_s``, ``done``), disk + in-memory checkpointing, and ``stop()``.
Function trainables (``def f(config)`` calling ``tune.report(...)``) are
adapted via FunctionTrainable, which runs the function on a thread and hands
results over a queue (reference function_runner.py).
"""

from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import threading
import time
import uuid
from typing import Any, Callable, Dict, Optional

from .result import DONE, TIME_THIS_ITER_S, TIME_TOTAL_S, TRAINING_ITERATION


class Trainable:
    def __init__(self, config: Optional[Dict] = None,
                 logger_creator: Optional[Callable] = None):
        self.config = config or {}
        self._iteration = 0
        self._time_total = 0.0
        self._timesteps_total = 0
        self._done = False
        self.trial_id = self.config.get("__trial_id__", uuid.uuid4().hex[:8])
        self._logdir: Optional[str] = None
        if logger_creator:
            self._result_logger = logger_creator(self.config)
            self._logdir = getattr(self._result_logger, "logdir", None)
        else:
            self._result_logger = None
        self.setup(self.config)

    # -- subclass API ------------------------------------------------------

    def setup(self, config: Dict) -> None:
        pass

    def step(self) -> Dict:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> str:
        raise NotImplementedError

    def load_checkpoint(self, checkpoint_path: str) -> None:
        raise NotImplementedError

    def cleanup(self) -> None:
        pass

    def reset_config(self, new_config: Dict) -> bool:
        """Return True if the trainable supports in-place config resets
        (enables reuse_actors)."""
        return False

    # -- runner-facing API -------------------------------------------------

    @property
    def logdir(self) -> str:
        if self._logdir is None:
            self._logdir = tempfile.mkdtemp(prefix=f"trainable_{self.trial_id}_")
        return self._logdir

    @property
    def iteration(self) -> int:
        return self._iteration

    def train(self) -> Dict:
        start = time.time()
        result = self.step()
        if result is None:
            result = {}
        result = dict(result)
        self._iteration += 1
        this_iter = time.time() - start
        self._time_total += this_iter
        result.setdefault(TRAINING_ITERATION, self._iteration)
        result.setdefault(TIME_THIS_ITER_S, this_iter)
        result.setdefault(TIME_TOTAL_S, self._time_total)
        result.setdefault(DONE, False)
        result.setdefault("trial_id", self.trial_id)
        if self._result_logger is not None:
            self._result_logger.on_result(result)
        return result

    def save(self, checkpoint_dir: Optional[str] = None) -> str:
        checkpoint_dir = checkpoint_dir or os.path.join(
            self.logdir, f"checkpoint_{self._iteration}")
        os.makedirs(checkpoint_dir, exist_ok=True)
        path = self.save_checkpoint(checkpoint_dir)
        # Persist runner state next to the user checkpoint.
        with open(os.path.join(checkpoint_dir, ".trainable_state"), "wb") as f:
            pickle.dump({
                "iteration": self._iteration,
                "time_total": self._time_total,
            }, f)
        return path if isinstance(path, str) else checkpoint_dir

    def save_to_object(self) -> bytes:
        """Checkpoint into a memory blob (used by PBT exploit)."""
        tmp = tempfile.mkdtemp(prefix="tune_ckpt_obj_")
        try:
            path = self.save(tmp)
            payload = {}
            for root, _, files in os.walk(tmp):
                for fname in files:
                    full = os.path.join(root, fname)
                    rel = os.path.relpath(full, tmp)
                    with open(full, "rb") as f:
                        payload[rel] = f.read()
            return pickle.dumps({"files": payload,
                                 "path_rel": os.path.relpath(path, tmp)
                                 if isinstance(path, str) else None})
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def restore(self, checkpoint_path: str) -> None:
        state_file = os.path.join(
            checkpoint_path if os.path.isdir(checkpoint_path)
            else os.path.dirname(checkpoint_path), ".trainable_state")
        if os.path.exists(state_file):
            with open(state_file, "rb") as f:
                state = pickle.load(f)
            self._iteration = state["iteration"]
            self._time_total = state["time_total"]
        self.load_checkpoint(checkpoint_path)

    def restore_from_object(self, obj: bytes) -> None:
        blob = pickle.loads(obj)
        tmp = tempfile.mkdtemp(prefix="tune_ckpt_obj_")
        try:
            for rel, data in blob["files"].items():
                full = os.path.join(tmp, rel)
                os.makedirs(os.path.dirname(full), exist_ok=True)
                with open(full, "wb") as f:
                    f.write(data)
            self.restore(os.path.join(tmp, blob["path_rel"])
                         if blob["path_rel"] else tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def stop(self) -> None:
        if self._result_logger is not None:
            self._result_logger.close()
        self.cleanup()

    # Used by the executor for reuse_actors.
    def reset(self, new_config: Dict) -> bool:
        if not self.reset_config(new_config):
            return False
        self.config = new_config
        self._iteration = 0
        self._time_total = 0.0
        self._done = False
        return True


class _StatusReporter:
    """Handed to function trainables; ``reporter(**metrics)`` enqueues one
    result and blocks until the runner consumes it."""

    def __init__(self, result_queue: "queue.Queue", continue_event: threading.Event):
        self._queue = result_queue
        self._continue = continue_event

    def __call__(self, **metrics):
        self._queue.put(dict(metrics))
        self._continue.wait()
        self._continue.clear()


class FunctionTrainable(Trainable):
    """Adapts ``def f(config)`` (+ optional reporter arg) to the Trainable
    API; each train() call releases the function thread until it reports
    the next result (reference function_runner.py)."""

    _function: Callable = None  # patched in by wrap_function

    def setup(self, config: Dict) -> None:
        self._results: "queue.Queue" = queue.Queue()
        self._continue = threading.Event()
        self._error: Optional[BaseException] = None
        self._finished = False
        reporter = _StatusReporter(self._results, self._continue)

        def runner():
            import inspect

            try:
                clean = {k: v for k, v in config.items()
                         if not k.startswith("__")}
                sig = inspect.signature(self._function)
                _report_ctx.reporter = reporter
                try:
                    if len(sig.parameters) >= 2:
                        self._function(clean, reporter)
                    else:
                        self._function(clean)
                finally:
                    _report_ctx.reporter = None
            except BaseException as e:  # surfaced on next train()
                self._error = e
            finally:
                self._finished = True
                self._results.put(None)  # unblock the consumer

        self._thread = threading.Thread(target=runner, daemon=True)
        self._started = False

    def step(self) -> Dict:
        if not self._started:
            self._thread.start()
            self._started = True
        else:
            self._continue.set()
        result = self._results.get()
        if result is None:
            if self._error is not None:
                raise self._error
            # Function returned: final result carries the last metrics.
            return {**getattr(self, "_last_reported", {}), DONE: True}
        self._last_reported = dict(result)
        return result

    def save_checkpoint(self, checkpoint_dir: str) -> str:
        # Function trainables own their checkpointing; persist nothing.
        marker = os.path.join(checkpoint_dir, "function_state.pkl")
        with open(marker, "wb") as f:
            pickle.dump({}, f)
        return checkpoint_dir

    def load_checkpoint(self, checkpoint_path: str) -> None:
        pass


class _ReportContext(threading.local):
    reporter: Optional[_StatusReporter] = None


_report_ctx = _ReportContext()


def report(**metrics) -> None:
    """``ray_tpu_torch.tune.report(...)`` from inside a function trainable."""
    reporter = _report_ctx.reporter
    if reporter is None:
        raise RuntimeError("tune.report() called outside a tune function")
    reporter(**metrics)


def wrap_function(fn: Callable) -> type:
    """Build a FunctionTrainable subclass around ``fn``."""

    class WrappedFunc(FunctionTrainable):
        _function = staticmethod(fn)

    WrappedFunc.__name__ = getattr(fn, "__name__", "func") + "_trainable"
    return WrappedFunc

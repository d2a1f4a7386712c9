"""Result loggers (reference: python/ray/tune/logger.py — CSV/JSON writers
per trial under the experiment directory)."""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, Optional


class Logger:
    def on_result(self, trial, result: Dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


def _trial_dir(base: str, trial) -> str:
    d = os.path.join(base, f"trial_{trial.trial_id}")
    os.makedirs(d, exist_ok=True)
    return d


def _scrub(result: Dict) -> Dict:
    out = {}
    for k, v in result.items():
        if isinstance(v, (int, float, str, bool)) or v is None:
            out[k] = v
    return out


class JsonLogger(Logger):
    def __init__(self, logdir: str):
        self.logdir = logdir
        self._files: Dict[str, object] = {}

    def on_result(self, trial, result: Dict) -> None:
        tid = trial.trial_id
        if tid not in self._files:
            path = os.path.join(_trial_dir(self.logdir, trial), "result.json")
            self._files[tid] = open(path, "a")
            with open(os.path.join(_trial_dir(self.logdir, trial),
                                   "params.json"), "w") as f:
                json.dump(_scrub(trial.config), f)
        self._files[tid].write(json.dumps(_scrub(result)) + "\n")
        self._files[tid].flush()

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()


class CSVLogger(Logger):
    def __init__(self, logdir: str):
        self.logdir = logdir
        self._writers: Dict[str, tuple] = {}

    def on_result(self, trial, result: Dict) -> None:
        tid = trial.trial_id
        row = _scrub(result)
        if tid not in self._writers:
            path = os.path.join(_trial_dir(self.logdir, trial), "progress.csv")
            f = open(path, "a")
            writer = csv.DictWriter(f, fieldnames=sorted(row.keys()),
                                    extrasaction="ignore")
            writer.writeheader()
            self._writers[tid] = (f, writer)
        f, writer = self._writers[tid]
        writer.writerow(row)
        f.flush()

    def close(self) -> None:
        for f, _ in self._writers.values():
            f.close()
        self._writers.clear()


DEFAULT_LOGGERS = (JsonLogger, CSVLogger)

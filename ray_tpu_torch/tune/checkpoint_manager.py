"""Checkpoint bookkeeping per trial.

Reference behavior: ``python/ray/tune/checkpoint_manager.py`` — keeps the
newest checkpoint always, plus the best ``keep_num`` by a score attribute.
"""

from __future__ import annotations

import heapq
import itertools
import os
import shutil
from typing import Dict, List, Optional


class Checkpoint:
    DISK = "disk"
    MEMORY = "memory"

    def __init__(self, storage: str, value, result: Optional[Dict] = None):
        self.storage = storage
        self.value = value  # path (disk) or bytes (memory)
        self.result = result or {}

    def __repr__(self):
        return f"Checkpoint({self.storage}, {self.value!r:.60})"


class CheckpointManager:
    def __init__(self, keep_num: Optional[int] = None,
                 score_attr: str = "training_iteration", mode: str = "max"):
        self.keep_num = keep_num
        self.score_attr = score_attr
        self.mode = mode
        self.newest: Optional[Checkpoint] = None
        self._best: List = []  # heap of (score, seq, ckpt)
        self._seq = itertools.count()

    def on_checkpoint(self, checkpoint: Checkpoint) -> None:
        if checkpoint.storage == Checkpoint.MEMORY:
            self.newest = checkpoint
            return
        self.newest = checkpoint
        if self.keep_num is None:
            return
        score = checkpoint.result.get(self.score_attr, 0)
        if self.mode == "min":
            score = -score
        heapq.heappush(self._best, (score, next(self._seq), checkpoint))
        # Evict worst-scored beyond keep_num; the newest checkpoint is never
        # deleted (needed for resume) — it stays tracked and becomes
        # evictable once superseded.
        retained = []
        while len(self._best) > self.keep_num:
            item = heapq.heappop(self._best)
            if item[2] is self.newest:
                retained.append(item)
                if not self._best:
                    break
                continue
            self._delete(item[2])
        for item in retained:
            heapq.heappush(self._best, item)

    def best_checkpoints(self) -> List[Checkpoint]:
        return [c for _, _, c in sorted(self._best)]

    @staticmethod
    def _delete(checkpoint: Checkpoint) -> None:
        if checkpoint.storage == Checkpoint.DISK and checkpoint.value:
            path = checkpoint.value
            target = path if os.path.isdir(path) else os.path.dirname(path)
            shutil.rmtree(target, ignore_errors=True)
